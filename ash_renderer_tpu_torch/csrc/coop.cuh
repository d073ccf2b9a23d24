// The grid of a cooperative launch, one definition for the cooperative
// kernels (K6 clip_tail.cu, K9 front_meta.cu, K10 geometry.cu, K12
// binning.cu); the launch of thread block clusters and a zero fill of
// 16-byte stores (K10 at the classic route's sizes); and the block-wide
// sums and scans K9 and K12 split their rows into chunks with.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ash {

// blocks a SM at most: every grid sync waits on every block, and two
// resident blocks a SM already keep enough loads in flight (PERF.md: one
// block a SM was slower, four no faster than two)
constexpr int COOP_MAX_BLOCKS_PER_SM = 2;

// `kernel`'s cooperative grid on the current device at `threads` a block
// and `smem` bytes of dynamic shared memory (the most a launch takes; one
// that takes less fits the same grid): the SMs times the blocks resident
// on each (at most COOP_MAX_BLOCKS_PER_SM), queried once a device; the
// cache is one per instantiation, and each cooperative kernel takes its
// own parameter struct
template <class K>
int coop_grid(K kernel, int threads, int* blocks, size_t smem = 0) {
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
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * (per_sm < COOP_MAX_BLOCKS_PER_SM ? per_sm
                                                   : COOP_MAX_BLOCKS_PER_SM);
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

// Launch `kernel` as thread block clusters of `blocks` blocks (above 8 the
// cluster size is non-portable, which the kernel is allowed here) of
// `threads` threads and `smem` bytes of dynamic shared memory, with its
// one parameter struct, on `stream`: as many clusters as the card holds
// at once at `smem_max` bytes (the most any launch of the kernel takes),
// at most one a `blocks` SMs, at least one (the kernel's first cluster
// does the work that needs its barriers, the others only work that needs
// none; no cluster waits on another).  The attributes and the occupancy
// query are made once a device per instantiation (each cluster kernel
// takes its own parameter struct and passes the same `smem_max` on every
// call).  Returns the launch's CUDA error, or
// cudaErrorLaunchOutOfResources where the device holds no such cluster
// (cudaOccupancyMaxActiveClusters gives 0): the caller raises, it does not
// fall back.
template <class K, class Params>
int launch_cluster(K kernel, int blocks, int threads, size_t smem,
                   size_t smem_max, void* stream, const Params& params) {
  static int clusters[64];  // per device: 0 not asked, -1 none fits
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_max;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* fn = (const void*)kernel;
  int n = dev < 64 ? clusters[dev] : 0;
  if (n == 0) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e == cudaSuccess && smem_max > 0)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_max);
    int active = 0, sms = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    n = active < 1 ? -1 : (active < sms / blocks ? active : sms / blocks);
    if (n == 0) n = 1;
    if (dev < 64) clusters[dev] = n;
  }
  if (n < 0) return (int)cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(blocks * n);
  cfg.dynamicSmemBytes = smem;
  void* args[] = {const_cast<Params*>(&params)};
  return (int)cudaLaunchKernelExC(&cfg, fn, args);
}

// a cluster's barrier in two halves: arrive when this thread's reads of
// the other blocks' shared memory are done (release), wait before the
// block ends or reads again (acquire); every thread of the block calls
// both, the warp converged
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// zero the n bytes from p as thread t of nt: the bytes before the first
// 16-byte boundary and after the last one alone, 16-byte stores between
__device__ __forceinline__ void zero_fill(void* p, long long n, long long t,
                                          long long nt) {
  unsigned char* b = static_cast<unsigned char*>(p);
  const long long mis = (long long)((uintptr_t)b & 15);
  const long long head = mis ? (16 - mis < n ? 16 - mis : n) : 0;
  const long long body = (n - head) >> 4;
  const long long tail = n - head - 16 * body;
  if (t < head) b[t] = 0;
  int4* q = reinterpret_cast<int4*>(b + head);
  for (long long i = t; i < body; i += nt) q[i] = make_int4(0, 0, 0, 0);
  if (t < tail) b[head + 16 * body + t] = 0;
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
