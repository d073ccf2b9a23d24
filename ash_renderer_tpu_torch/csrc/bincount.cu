// K2: run bounds of an ascending key stream.  Replaces the Pallas kernel
// ash_renderer_tpu/ops/bincount.py (_kernel, via sorted_run_bounds; the
// pallas_call at :129); the plain torch version is
// ops/bincount.py:sorted_run_bounds_plain (torch.searchsorted).
//
// bounds[v] = first i with key[i] >= v.  The keys ascend, so position i
// owns every bin v in (key[i-1], key[i]] and writes i there; position n
// (one past the end) owns the bins above the largest key and writes n.
// Every bin has exactly one writer, so no atomics.
//
// Each thread owns CHUNK consecutive positions [CHUNK*g, CHUNK*g + CHUNK),
// read with two 16-byte loads (the wrapper requires a 16-byte aligned key
// pointer; a chunk cut by the end of the keys reads word by word).  It
// takes key[CHUNK*g - 1] from the thread before it with __shfl_up_sync;
// lane 0 of a warp reads it itself.  The thread whose chunk holds position
// n writes the bins above the largest key; n = 0 gives every bin 0.
//
// What bounds it: one read of the n keys and one write of the bins (~5.5
// MB at the headline, n ~ 1.34M, 24,302 bins, 0.0016 ms at 3.35 TB/s), so
// it is launch-latency sized: CHUNK = 8 makes the headline's ~168K threads
// one wave on 132 SMs (the design of a thread per key took five).
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
run_bounds_kernel(const int* __restrict__ keys, int* __restrict__ bounds,
                  int n, int n_bins) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const long long i0 = (long long)g * CHUNK;
  int k[CHUNK];
  if (i0 + CHUNK <= n) {
    const int4* k4 = reinterpret_cast<const int4*>(keys) + 2 * (size_t)g;
    const int4 a = k4[0], b = k4[1];
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) k[j] = i0 + j < n ? keys[i0 + j] : 0;
  }
  // key[i0 - 1]: the last key of the thread before (read where that thread
  // is in another warp); unused for i0 = 0
  int prev = __shfl_up_sync(0xFFFFFFFFu, k[CHUNK - 1], 1);
  if (lane == 0 && i0 > 0 && i0 <= n) prev = keys[i0 - 1];
  if (i0 > n) return;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int i = (int)i0 + j;
    if (i > n) break;
    const int lo = i == 0 ? 0 : prev + 1;
    const int hi = i == n ? n_bins - 1 : min(k[j], n_bins - 1);
    for (int v = max(lo, 0); v <= hi; ++v) bounds[v] = i;
    prev = k[j];
  }
}

}  // namespace

// keys: n int32, ascending, 16-byte aligned; bounds: n_bins int32, every
// bin written
extern "C" int ash_run_bounds(const int* keys, int* bounds, int n, int n_bins,
                              void* stream) {
  const int threads_needed = n / CHUNK + 1;  // the chunks holding 0..n
  const int blocks = (threads_needed + THREADS - 1) / THREADS;
  if (n_bins > 0)
    run_bounds_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        keys, bounds, n, n_bins);
  return (int)cudaGetLastError();
}
