// The grid of a cooperative launch, one definition for the cooperative
// kernels (K6 clip_tail.cu, K9 front_meta.cu, K10 geometry.cu, K12
// binning.cu), and the block-wide sums and scans K9 and K12 split their
// rows into chunks with.
#pragma once

#include <cuda_runtime.h>

namespace ash {

// blocks a SM at most: every grid sync waits on every block, and two
// resident blocks a SM already keep enough loads in flight (PERF.md: one
// block a SM was slower, four no faster than two)
constexpr int COOP_MAX_BLOCKS_PER_SM = 2;

// `kernel`'s cooperative grid on the current device at `threads` a block:
// the SMs times the blocks resident on each (at most
// COOP_MAX_BLOCKS_PER_SM), queried once a device; the cache is one per
// instantiation, and each cooperative kernel takes its own parameter struct
template <class K>
int coop_grid(K kernel, int threads, int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0, coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * (per_sm < COOP_MAX_BLOCKS_PER_SM ? per_sm
                                                   : COOP_MAX_BLOCKS_PER_SM);
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

// sum of v over a block of THREADS threads; every thread gets it.  `red`
// holds THREADS / 32 ints of shared memory
template <int THREADS>
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// exclusive prefix of v over the block in thread order, and the block's
// total in *total
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    before += w < warp ? red[w] : 0;
    all += red[w];
  }
  *total = all;
  return before + incl - v;
}

// the sum over the block of x[k * stride + off] for k < n
template <int THREADS>
__device__ __forceinline__ int block_sum_of(const int* x, int n, int stride,
                                            int off, int* red) {
  int s = 0;
  for (int k = threadIdx.x; k < n; k += THREADS) s += x[k * stride + off];
  return block_sum<THREADS>(s, red);
}

}  // namespace ash
