// K8 and K8C: the vertex transform in one launch, one thread a vertex.
// K8 writes its column of the (16, V) int32 table [clip4 | colour4 | world
// normal3 | uv2 | world pos3] (float32 bits) that K1 (setup.cu) and K6
// (clip_tail.cu) read; K8C (the classic route and the non-meshlet
// fallback) writes the same 16 values as the row-major clip (V, 4) and
// attribute (V, 12) [colour4 | world normal3 | uv2 | world pos3] float32
// tables that K10 (geometry.cu) reads.  The plain torch versions are
// ash_renderer_tpu_torch/ops/vertex_transform.py:transform_vertices_T_plain
// and ops/geometry.py:transform_vertices_plain (geometry.vertex_rows
// stacked).
//
// Neither replaces a Pallas kernel.  The reference's transform is XLA glue
// under one jit (ash_renderer_tpu/pipeline.py:413, _fstage_transform over
// ops/setup_kernel.py:87, and pipeline.py:680, _stage_geometry over
// ops/geometry.py:43), which XLA fuses; eager torch pays ~64 launches
// for the same chain (6 a row of apply_mat4_point for two matrices, 15 for
// apply_mat3_vec, the stack).
//
// Bound by bytes: 48 bytes in (position, normal, colour, uv, object id)
// and 64 out a vertex, no reuse.  So the design is one coalesced pass: K8's
// warp writes 32 neighbouring vertices of each table row, K8C's thread its
// vertex's 16-byte clip row and 48-byte attribute row as 16-byte stores;
// the matrices of up to SMEM_OBJECTS objects sit in shared memory (more
// are read from global memory through the cache).
//
// Exactness, as specmath.apply_mat4_point / apply_mat3_vec compute it:
// * a 4x4 row is ((m0*x + m1*y) + (m2*z + m3)), a 3x3 row
//   (m0*x + m1*y) + m2*z, every op rounded (fmul / fadd under
//   --fmad=false), subnormals kept;
// * colour and uv are copied as bits (a NaN payload survives);
// * with one object its matrices are broadcast; with several, each vertex
//   takes those of vert_obj[v], clamped to [0, n_obj) as XLA's gather
//   clamps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int THREADS = 256;
constexpr int MAT = 16;  // floats of a 4x4 matrix
constexpr int SMEM_OBJECTS = 128;  // objects whose matrices go to shared memory
// table rows
constexpr int N_ROWS = 16;
constexpr int R_CLIP = 0, R_COLOR = 4, R_NORMAL = 8, R_UV = 11, R_WORLD = 13;

// apply_mat4_point's row r: ((m0*x + m1*y) + (m2*z + m3))
__device__ __forceinline__ float mat4_row(const float* m, int r, float x,
                                          float y, float z) {
  return fadd(fadd(fmul(m[r * 4 + 0], x), fmul(m[r * 4 + 1], y)),
              fadd(fmul(m[r * 4 + 2], z), m[r * 4 + 3]));
}

// apply_mat3_vec's row r: (m0*x + m1*y) + m2*z
__device__ __forceinline__ float mat3_row(const float* m, int r, float x,
                                          float y, float z) {
  return fadd(fadd(fmul(m[r * 4 + 0], x), fmul(m[r * 4 + 1], y)),
              fmul(m[r * 4 + 2], z));
}

// the table K8 writes (16, V) or the rows K8C writes: clip (V, 4) and
// attrs (V, 12)
enum Layout { TABLE_T, ROWS };

template <Layout L>
__global__ void __launch_bounds__(THREADS)
transform_kernel(const float* __restrict__ pos, const int* __restrict__ vobj,
                 const float* __restrict__ nrm, const int* __restrict__ col,
                 const int* __restrict__ uv, const float* __restrict__ model,
                 const float* __restrict__ mvp, int* __restrict__ out,
                 int* __restrict__ out_attrs, int n_verts, int n_obj) {
  extern __shared__ float mats[];  // model [n_sm][16], then mvp [n_sm][16]
  const int n_sm = min(n_obj, SMEM_OBJECTS);
  for (int i = threadIdx.x; i < n_sm * MAT; i += THREADS) {
    mats[i] = model[i];
    mats[n_sm * MAT + i] = mvp[i];
  }
  __syncthreads();
  const int v = blockIdx.x * THREADS + threadIdx.x;
  if (v >= n_verts) return;
  const int o = n_obj > 1 ? min(max(vobj[v], 0), n_obj - 1) : 0;
  const float* mm = o < n_sm ? mats + o * MAT : model + (size_t)o * MAT;
  const float* mp =
      o < n_sm ? mats + (n_sm + o) * MAT : mvp + (size_t)o * MAT;
  const float px = pos[(size_t)v * 3], py = pos[(size_t)v * 3 + 1],
              pz = pos[(size_t)v * 3 + 2];
  const float nx = nrm[(size_t)v * 3], ny = nrm[(size_t)v * 3 + 1],
              nz = nrm[(size_t)v * 3 + 2];
  int r[N_ROWS];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[R_CLIP + k] = bits(mat4_row(mp, k, px, py, pz));
#pragma unroll
  for (int k = 0; k < 4; ++k) r[R_COLOR + k] = col[(size_t)v * 4 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[R_NORMAL + k] = bits(mat3_row(mm, k, nx, ny, nz));
#pragma unroll
  for (int k = 0; k < 2; ++k) r[R_UV + k] = uv[(size_t)v * 2 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[R_WORLD + k] = bits(mat4_row(mm, k, px, py, pz));
  if constexpr (L == TABLE_T) {
    const size_t V = (size_t)n_verts;
#pragma unroll
    for (int k = 0; k < N_ROWS; ++k) out[k * V + v] = r[k];
  } else {
    reinterpret_cast<int4*>(out)[v] = make_int4(r[0], r[1], r[2], r[3]);
    int4* a = reinterpret_cast<int4*>(out_attrs) + (size_t)v * 3;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      a[q] = make_int4(r[4 + 4 * q], r[5 + 4 * q], r[6 + 4 * q], r[7 + 4 * q]);
  }
}

template <Layout L>
int launch_transform(const float* pos, const int* vobj, const float* nrm,
                     const int* col, const int* uv, const float* model,
                     const float* mvp, int* out, int* out_attrs, int n_verts,
                     int n_obj, void* stream) {
  const int blocks = (n_verts + THREADS - 1) / THREADS;
  const size_t smem = 2 * (size_t)min(n_obj, SMEM_OBJECTS) * MAT * sizeof(float);
  if (blocks > 0)
    transform_kernel<L><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        pos, vobj, nrm, col, uv, model, mvp, out, out_attrs, n_verts, n_obj);
  return (int)cudaGetLastError();
}

}  // namespace

// K8: the (16, V) table
extern "C" int ash_vertex_transform(const float* pos, const int* vobj,
                                    const float* nrm, const int* col,
                                    const int* uv, const float* model,
                                    const float* mvp, int* out, int n_verts,
                                    int n_obj, void* stream) {
  return launch_transform<TABLE_T>(pos, vobj, nrm, col, uv, model, mvp, out,
                                   nullptr, n_verts, n_obj, stream);
}

// K8C: clip (V, 4) and attrs (V, 12), float32 as int32 words
extern "C" int ash_vertex_transform_rows(const float* pos, const int* vobj,
                                         const float* nrm, const int* col,
                                         const int* uv, const float* model,
                                         const float* mvp, int* clip,
                                         int* attrs, int n_verts, int n_obj,
                                         void* stream) {
  return launch_transform<ROWS>(pos, vobj, nrm, col, uv, model, mvp, clip,
                                attrs, n_verts, n_obj, stream);
}
