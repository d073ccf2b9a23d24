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
// Exactness: the arithmetic is vertex.cuh's (specmath.apply_mat4_point /
// apply_mat3_vec op for op, colour and uv copied as bits, vert_obj
// clamped), which K10 (geometry.cu) runs too where it transforms the
// vertices itself.
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"
#include "vertex.cuh"

namespace {

using namespace ash;
using vertex::MAT;
using vertex::N_ROWS;
using vertex::SMEM_OBJECTS;

constexpr int THREADS = 256;

// the table K8 writes (16, V) or the rows K8C writes: clip (V, 4) and
// attrs (V, 12)
enum Layout { TABLE_T, ROWS };

template <Layout L>
__global__ void __launch_bounds__(THREADS)
transform_kernel(const vertex::Scene S, int* __restrict__ out,
                 int* __restrict__ out_attrs, int n_verts) {
  extern __shared__ float mats[];  // model [n_sm][16], then mvp [n_sm][16]
  vertex::stage_mats(S, mats, threadIdx.x, THREADS);
  __syncthreads();
  const int v = blockIdx.x * THREADS + threadIdx.x;
  if (v >= n_verts) return;
  int r[N_ROWS];
  vertex::values(S, mats, v, r);
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
        vertex::Scene{pos, vobj, nrm, col, uv, model, mvp, n_obj}, out,
        out_attrs, n_verts);
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
