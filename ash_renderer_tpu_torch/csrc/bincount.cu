// K2: run bounds of an ascending key stream.  Replaces the Pallas kernel
// ash_renderer_tpu/ops/bincount.py (_kernel, via sorted_run_bounds); the
// plain torch version is ops/bincount.py:sorted_run_bounds_plain
// (torch.searchsorted).
//
// bounds[v] = first i with key[i] >= v.  The keys ascend, so the thread of
// position i writes i into every bin v in (key[i-1], key[i]]; the thread
// one past the end writes n into the bins above the largest key.  Every bin
// has exactly one writer, so no atomics.  Bound by launch latency at the
// headline (~5 MB moved).
#include <cuda_runtime.h>

namespace {

__global__ void run_bounds_kernel(const int* __restrict__ keys,
                                  int* __restrict__ bounds, int n,
                                  int n_bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int lo = i == 0 ? 0 : keys[i - 1] + 1;
  const int hi = i == n ? n_bins - 1 : min(keys[i], n_bins - 1);
  for (int v = max(lo, 0); v <= hi; ++v) bounds[v] = i;
}

}  // namespace

extern "C" int ash_run_bounds(const int* keys, int* bounds, int n, int n_bins,
                              void* stream) {
  const int threads = 256;
  const int blocks = (n + 1 + threads - 1) / threads;
  if (n_bins > 0)
    run_bounds_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        keys, bounds, n, n_bins);
  return (int)cudaGetLastError();
}
