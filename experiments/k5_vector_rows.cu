// K5 design B, measured against csrc/gather.cu by
// experiments/torch_k5_variants.py (same C entry point, same contract):
// no shared memory.  One thread per (triangle, corner) j = 3t + k over all
// triangles reads its local id, then copies its corner's row of the
// meshlet's table slab (128 contiguous rows, in L1 / L2 after the
// meshlet's first reads) to its F output words at j * F: F / 4 16-byte
// loads and stores when F % 4 == 0, else a word at a time.  The ids are
// read once, coalesced; the stores of one instruction land 4F bytes apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MESHLET = 128;
constexpr int CORNERS = 3 * MESHLET;  // (triangle, corner) pairs a meshlet
constexpr int THREADS = 256;

template <int F>
__global__ void __launch_bounds__(THREADS)
vector_rows_kernel(const int* __restrict__ tbl, const int* __restrict__ ids,
                   int* __restrict__ out, int n_corners, int nf_run) {
  const int nf = F > 0 ? F : nf_run;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_corners) return;
  const int* slab = tbl + (size_t)(j / CORNERS) * MESHLET * nf;
  int* dst = out + (size_t)j * nf;
  const int loc = __ldg(ids + j);
  const bool ok = (unsigned)loc < (unsigned)MESHLET;
  const int* src = slab + (ok ? loc : 0) * nf;
  if (nf % 4 == 0) {
    const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < nf / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src) + q);
      reinterpret_cast<int4*>(dst)[q] = ok ? v : zero;
    }
  } else {
#pragma unroll
    for (int f = 0; f < nf; ++f) dst[f] = ok ? __ldg(src + f) : 0;
  }
}

template <int F>
int launch(const int* tbl, const int* ids, int* out, int n_corners, int nf,
           cudaStream_t stream) {
  const int blocks = (n_corners + THREADS - 1) / THREADS;
  vector_rows_kernel<F><<<blocks, THREADS, 0, stream>>>(tbl, ids, out,
                                                         n_corners, nf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ash_gather_tri_rows(const int* tbl, const int* local_tri,
                                   int* out, int n_tris, int nf,
                                   void* stream) {
  const int n_corners = (n_tris / MESHLET) * CORNERS;
  if (nf < 0 || nf > 32) return (int)cudaErrorInvalidValue;
  if (n_corners == 0 || nf == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nf) {
    case 8: return launch<8>(tbl, local_tri, out, n_corners, nf, st);
    case 12: return launch<12>(tbl, local_tri, out, n_corners, nf, st);
    default: return launch<0>(tbl, local_tri, out, n_corners, nf, st);
  }
}
