// K5: meshlet-local corner gather.  Replaces the Pallas kernel
// ash_renderer_tpu/ops/meshlet_gather.py (_rows_kernel, via
// gather_tri_rows; the pallas_call at :97); the plain torch version is
// ops/meshlet_gather.py:gather_tri_rows_plain.
//
// out[t, k*F + f] = tbl[(t / 128) * 128 + local_tri[t, k], f], and 0 where
// the local id is outside [0, 128).  A meshlet is one tile in and one tile
// out: its 128 table rows (128 F words), its (128, 3) ids and its
// (128, 3F) output rows are each contiguous, and (triangle, corner)
// j = 3t + k of a meshlet owns id word j and the F output words at j * F.
//
// What bounds it: memory.  Each slab is moved once: 35 words a triangle at
// F = 8, 184 MB at the headline (1.31 M triangles), 0.055 ms at 3.35 TB/s.
//
// Design: persistent blocks of 384 threads, one thread per (triangle,
// corner), as many blocks as fit on every SM at once, walk the meshlets
// blockIdx.x, + gridDim.x, ... through a two-stage ring in shared memory.
// Thread 0 brings a meshlet's table slab and ids with two 1-D bulk copies
// (cp.async.bulk) against the stage's mbarrier, two meshlets ahead, so
// meshlet i + 1's loads are in flight while meshlet i is assembled.  Each
// thread copies its corner's row from the staged slab into a staged
// output tile (16-byte words when F % 4 == 0), and thread 0 writes the
// tile with one bulk copy to global memory.  Two output tiles alternate;
// tile s is rewritten only after the bulk store two meshlets back has read
// it.  Index math stays in 32 bits inside a meshlet; each meshlet's three
// slab addresses are 64-bit; nothing is divided.
//
// The bulk copies move whole 16-byte units between 16-byte aligned
// addresses.  Every slab is a multiple of 16 bytes for any F (512 F, 1536
// and 1536 F bytes); the wrapper requires tbl and local_tri to start
// 16-byte aligned (out is its own allocation).  Instantiations: F = 8 (the
// classic setup's vertex rows), F = 12 (the attribute rows of the
// reference's tritables.build_comb_table), F = 0 for every other F <= 32,
// with the width at run time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MESHLET = 128;          // triangles, and table rows, a meshlet
constexpr int THREADS = 3 * MESHLET;  // one per (triangle, corner)
constexpr int IDS_BYTES = THREADS * 4;
constexpr int MAX_COLS = 32;
// a stage wait longer than this (~9 s at 1.98 GHz) is a fault: trap rather
// than hold the card
constexpr long long WAIT_LIMIT_CYCLES = 1LL << 34;

// dynamic shared memory at nf columns: two stages of (table slab, ids),
// two output tiles, then the two stages' mbarriers
__host__ __device__ constexpr int slab_bytes(int nf) { return MESHLET * nf * 4; }
__host__ __device__ constexpr int tile_bytes(int nf) { return THREADS * nf * 4; }
__host__ __device__ constexpr int smem_bytes(int nf) {
  return 2 * (slab_bytes(nf) + IDS_BYTES + tile_bytes(nf)) + 2 * 8;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// thread 0: meshlet m's table slab and ids into one stage, completing on
// its mbarrier
__device__ __forceinline__ void load_stage(void* slab_s, void* ids_s,
                                           uint64_t* bar, const int* tbl,
                                           const int* ids, int m, int nf) {
  const uint32_t sb = slab_bytes(nf);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(bar)), "r"(sb + IDS_BYTES) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(saddr(slab_s)), "l"(tbl + (size_t)m * MESHLET * nf), "r"(sb),
         "r"(saddr(bar)) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(saddr(ids_s)), "l"(ids + (size_t)m * THREADS), "r"(IDS_BYTES),
         "r"(saddr(bar)) : "memory");
}

// until the mbarrier's phase of this parity has completed
__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

template <int F>
__global__ void __launch_bounds__(THREADS)
gather_tile_kernel(const int* __restrict__ tbl, const int* __restrict__ ids,
                   int* __restrict__ out, int n_m, int nf_run) {
  const int nf = F > 0 ? F : nf_run;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const slab0 = smem;
  unsigned char* const ids0 = smem + 2 * slab_bytes(nf);
  unsigned char* const tile0 = ids0 + 2 * IDS_BYTES;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(tile0 + 2 * tile_bytes(nf));
  const int j = threadIdx.x;  // (triangle, corner) 3t + k of the tile
  const int step = gridDim.x;

  if (j == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(saddr(bar)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(saddr(bar + 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (j == 0) {
    for (int s = 0; s < 2; ++s) {
      const int m = blockIdx.x + s * step;
      if (m < n_m)
        load_stage(slab0 + s * slab_bytes(nf), ids0 + s * IDS_BYTES, bar + s,
                   tbl, ids, m, nf);
    }
  }
  for (int i = 0, m = blockIdx.x; m < n_m; ++i, m += step) {
    const int s = i & 1;
    const int* slab_s = reinterpret_cast<const int*>(slab0 + s * slab_bytes(nf));
    const int* ids_s = reinterpret_cast<const int*>(ids0 + s * IDS_BYTES);
    int* tile_s = reinterpret_cast<int*>(tile0 + s * tile_bytes(nf));
    // the bulk store of meshlet i - 2 has read tile s
    if (j == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncthreads();
    wait_stage(bar + s, (i >> 1) & 1);

    const int loc = ids_s[j];
    const bool ok = (unsigned)loc < (unsigned)MESHLET;
    const int* src = slab_s + (ok ? loc : 0) * nf;
    int* dst = tile_s + j * nf;
    if (nf % 4 == 0) {
      const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int q = 0; q < nf / 4; ++q) {
        const int4 v = reinterpret_cast<const int4*>(src)[q];
        reinterpret_cast<int4*>(dst)[q] = ok ? v : zero;
      }
    } else {
#pragma unroll
      for (int f = 0; f < nf; ++f) dst[f] = ok ? src[f] : 0;
    }
    // the tile's generic-proxy writes, before the bulk copy reads it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    if (j == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(out + (size_t)m * THREADS * nf), "r"(saddr(tile_s)),
                      "r"(tile_bytes(nf)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // every thread has read stage s: refill it two meshlets ahead
      if (m + 2 * step < n_m)
        load_stage(slab0 + s * slab_bytes(nf), ids0 + s * IDS_BYTES, bar + s,
                   tbl, ids, m + 2 * step, nf);
    }
  }
  if (j == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// blocks of gather_tile_kernel<F> that fit on one SM at nf columns: the
// same on every card this sm_90a library runs on, so kept per nf
template <int F>
cudaError_t blocks_per_sm(int nf, int* per_sm) {
  static int cached[MAX_COLS + 1];
  const int bytes = smem_bytes(nf);
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  // (per device, so on every call)
  cudaError_t e = cudaFuncSetAttribute(
      gather_tile_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (cached[nf] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached[nf], gather_tile_kernel<F>, THREADS, bytes);
    if (e != cudaSuccess) return e;
    if (cached[nf] == 0) return cudaErrorInvalidConfiguration;
  }
  *per_sm = cached[nf];
  return cudaSuccess;
}

// the persistent grid on the current device: every block resident at once
template <int F>
cudaError_t wave_blocks(int nf, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = blocks_per_sm<F>(nf, &per_sm);
  *blocks = sms * per_sm;
  return e;
}

template <int F>
int launch(const int* tbl, const int* ids, int* out, int n_m, int nf,
           cudaStream_t stream) {
  int wave = 0;
  cudaError_t e = wave_blocks<F>(nf, &wave);
  if (e != cudaSuccess) return (int)e;
  const int grid = n_m < wave ? n_m : wave;
  gather_tile_kernel<F><<<grid, THREADS, smem_bytes(nf), stream>>>(
      tbl, ids, out, n_m, nf);
  return (int)cudaGetLastError();
}

}  // namespace

// tbl (n_tris, nf) and local_tri (n_tris, 3) int32, each 16-byte aligned,
// n_tris a multiple of 128, nf <= 32; out (n_tris, 3 nf) int32, every word
// written
extern "C" int ash_gather_tri_rows(const int* tbl, const int* local_tri,
                                   int* out, int n_tris, int nf,
                                   void* stream) {
  const int n_m = n_tris / MESHLET;
  if (nf < 0 || nf > MAX_COLS) return (int)cudaErrorInvalidValue;
  if (n_m == 0 || nf == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nf) {
    case 8: return launch<8>(tbl, local_tri, out, n_m, nf, st);
    case 12: return launch<12>(tbl, local_tri, out, n_m, nf, st);
    default: return launch<0>(tbl, local_tri, out, n_m, nf, st);
  }
}

// the persistent grid ash_gather_tri_rows launches at nf columns on the
// current device (blocks, each resident): from n_tris / 128 above it, a
// block walks more than one meshlet
extern "C" int ash_gather_tri_rows_wave(int nf, int* blocks) {
  if (nf <= 0 || nf > MAX_COLS) return (int)cudaErrorInvalidValue;
  switch (nf) {
    case 8: return (int)wave_blocks<8>(nf, blocks);
    case 12: return (int)wave_blocks<12>(nf, blocks);
    default: return (int)wave_blocks<0>(nf, blocks);
  }
}
