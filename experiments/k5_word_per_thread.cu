// K5's first design, the csrc/gather.cu that the tile copy replaced, kept
// for the record and measured against it by experiments/torch_k5_variants.py.
//
// out[t, k*F + f] = tbl[(t / 128) * 128 + local_tri[t, k], f], and 0 where
// the local id is outside [0, 128).  One thread per output word: a thread
// block covers consecutive words of consecutive triangles, so the stores
// are coalesced and the loads hit the meshlet's 128 contiguous table rows
// (128 * F words, in L2).  Each word divides a 64-bit index by the row
// width and reloads its corner's id, and every access is 4 bytes wide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MESHLET = 128;

__global__ void gather_rows_kernel(const int* __restrict__ tbl,
                                   const int* __restrict__ local_tri,
                                   int* __restrict__ out, int64_t n_words,
                                   int nf) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  const int row_w = 3 * nf;
  const int64_t t = i / row_w;
  const int c = (int)(i - t * row_w);
  const int k = c / nf, f = c - k * nf;
  const int loc = local_tri[t * 3 + k];
  int v = 0;
  if (loc >= 0 && loc < MESHLET)
    v = tbl[((t / MESHLET) * MESHLET + loc) * nf + f];
  out[i] = v;
}

}  // namespace

extern "C" int ash_gather_tri_rows(const int* tbl, const int* local_tri,
                                   int* out, int n_tris, int nf,
                                   void* stream) {
  const int64_t n_words = (int64_t)n_tris * 3 * nf;
  const int threads = 256;
  const int64_t blocks = (n_words + threads - 1) / threads;
  if (n_words > 0)
    gather_rows_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(tbl, local_tri, out, n_words,
                                                 nf);
  return (int)cudaGetLastError();
}
