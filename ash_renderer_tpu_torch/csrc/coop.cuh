// The grid of a cooperative launch: one definition for the front's
// cooperative kernels, K9 (front_meta.cu) and K6 (clip_tail.cu).
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

}  // namespace ash
