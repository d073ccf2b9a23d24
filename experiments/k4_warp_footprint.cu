// A design variant of K4 (ash_renderer_tpu_torch/csrc/raster_classic.cu),
// with the same C entry point, for experiments/torch_k4_variants.py:
//
//     python3 experiments/torch_k4_variants.py
//         --source footprint=experiments/k4_warp_footprint.cu
//
// (a copy with PX = 4, made with sed, gives the 512-thread variant).
//
// Warp footprints, K3's design (csrc/raster.cu): one block per 16 x 128
// tile stages the tile's records CHUNK at a time with a 32-bit mask of the
// warps whose footprint their pixel box (rec_box) touches.  Each warp owns
// a footprint of FOOT_H rows x 8 columns (PX pixels per lane, rows 4
// apart), walks each chunk's masks with __ballot_sync and evaluates only
// the records that touch it; each lane keeps its pixels' minima of
// (d16, -id) in registers (no atomics) and stores them at the end, each
// store of a warp 4 rows of 8 consecutive words.  Exact for the reason
// csrc/raster_classic.cu gives.  On the subdiv-8 classic frame it took
// 2.2x the record-parallel kernel's time (PERF.md, K4 findings): a record
// of a few pixels costs a whole footprint, 2 pixels in each of 32 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int TILE_H = 16;
constexpr int N_PIX = TILE_H * TILE_W;
// Pixels per thread: 2 (1024 threads, 8 x 8 footprints) or 4 (512
// threads, 8 x 16 footprints).
constexpr int PX = 2;
static_assert(PX == 2 || PX == 4, "a lane holds the pixels of rows r + 4k");
constexpr int THREADS = N_PIX / PX;
constexpr int FOOT_W = 8;       // warp footprint: 8 columns (lane % 8) ...
constexpr int FOOT_H = 4 * PX;  // ... by 4*PX rows (lane / 8, + 4 per pixel)
constexpr int COL_GROUPS = TILE_W / FOOT_W;
constexpr int ROW_GROUPS = TILE_H / FOOT_H;
static_assert(COL_GROUPS * ROW_GROUPS == THREADS / 32, "one bit per warp");
constexpr int CHUNK = 512;
static_assert(CHUNK <= THREADS, "one staging thread per record");
constexpr int N_WORDS = 14;  // record rows 0-13

// staged records, one field group per array so a warp reads a record with
// four broadcast 16-byte loads
struct Smem {
  int4 e[CHUNK];   // E0, E1, E2 at the tile's first sample; zq0
  int4 ex[CHUNK];  // per-column steps a*ss; zq1
  int4 ey[CHUNK];  // per-row steps b*ss; zq2
  int4 id[CHUNK];  // id, inv_area2 bits, top-left bits, 0
  unsigned mask[CHUNK];  // bit w: the pixel box touches warp w
};

__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
raster_classic_kernel(const int* __restrict__ rec_i,
                      const float* __restrict__ rec_f,
                      const int* __restrict__ rec_box,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count,
                      int* __restrict__ vis_d, int* __restrict__ vis_t,
                      int n_rec, int grid_w, int ss) {
  __shared__ Smem S;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32, warp = p / 32;
  const int start = tile_start[t], count = tile_count[t];
  const int vcol = (warp % COL_GROUPS) * FOOT_W + lane % FOOT_W;
  const int vrow = (warp / COL_GROUPS) * FOOT_H + lane / FOOT_W;

  int best_d[PX], best_t[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    best_d[k] = DEPTH_MAX;
    best_t[k] = BG_TRI;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    if (base > 0) __syncthreads();  // every warp is done with the last chunk
    if (p < n) {
      const int r = start + base + p;
      int w[N_WORDS];
#pragma unroll
      for (int i = 0; i < N_WORDS; ++i) w[i] = rec_i[(size_t)i * n_rec + r];
      S.e[p] = make_int4(w[6], w[7], w[8], w[9]);
      S.ex[p] = make_int4(wmul(w[0], ss), wmul(w[2], ss), wmul(w[4], ss), w[10]);
      S.ey[p] = make_int4(wmul(w[1], ss), wmul(w[3], ss), wmul(w[5], ss), w[11]);
      S.id[p] = make_int4(w[12], __float_as_int(rec_f[r]), w[13], 0);
      const int box = rec_box[r];
      const int c0 = box & 0x7F, c1 = (box >> 7) & 0x7F;
      const int r0 = (box >> 14) & 0xF, r1 = (box >> 18) & 0xF;
      unsigned mask = 0;
      if (c0 <= c1 && r0 <= r1) {
        const unsigned cols = (2u << (c1 / FOOT_W)) - (1u << (c0 / FOOT_W));
#pragma unroll
        for (int g = 0; g < ROW_GROUPS; ++g)
          if (r0 / FOOT_H <= g && g <= r1 / FOOT_H) mask |= cols << (g * COL_GROUPS);
      }
      S.mask[p] = mask;
    }
    __syncthreads();
    for (int b = 0; b < n; b += 32) {
      const int s = b + lane;
      const bool hit = s < n && ((S.mask[s] >> warp) & 1u);
      unsigned todo = __ballot_sync(0xFFFFFFFFu, hit);
      while (todo) {
        const int j = b + __ffs(todo) - 1;
        todo &= todo - 1;
        const int4 e = S.e[j], ex = S.ex[j], ey = S.ey[j], m = S.id[j];
        const int t0 = 1 - (m.z & 1);
        const int t1 = 1 - ((m.z >> 1) & 1);
        const int t2 = 1 - ((m.z >> 2) & 1);
        int e0 = wadd(wadd(e.x, wmul(ex.x, vcol)), wmul(ey.x, vrow));
        int e1 = wadd(wadd(e.y, wmul(ex.y, vcol)), wmul(ey.y, vrow));
        int e2 = wadd(wadd(e.z, wmul(ex.z, vcol)), wmul(ey.z, vrow));
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (k > 0) {  // 4 rows down
            e0 = wadd(e0, wmul(ey.x, 4));
            e1 = wadd(e1, wmul(ey.y, 4));
            e2 = wadd(e2, wmul(ey.z, 4));
          }
          if (e0 >= t0 && e1 >= t1 && e2 >= t2) {
            const int d = interp_depth16(e0, e1, e2, fbits(m.y), e.w, ex.w, ey.w);
            if (depth_key_better(d, m.x, best_d[k], best_t[k])) {
              best_d[k] = d;
              best_t[k] = m.x;
            }
          }
        }
      }
    }
  }

  const size_t wp = (size_t)grid_w * TILE_W;
  const int tile_x = t % grid_w, tile_y = t / grid_w;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const size_t i = ((size_t)tile_y * TILE_H + vrow + 4 * k) * wp +
                     (size_t)tile_x * TILE_W + vcol;
    vis_d[i] = best_d[k];
    vis_t[i] = best_t[k];
  }
}

}  // namespace

// rec_i: (14, n_rec) int32 rows; rec_f: (1, n_rec) float; rec_box: (1,
// n_rec) int32 packed boxes; vis_d / vis_t: (grid_h * 16, grid_w * 128)
// int32, every pixel written
extern "C" int ash_rasterize_visibility(const int* rec_i, const float* rec_f,
                                        const int* rec_box,
                                        const int* tile_start,
                                        const int* tile_count, int* vis_d,
                                        int* vis_t, int n_rec, int n_tiles,
                                        int grid_w, int ss, void* stream) {
  if (n_tiles > 0)
    raster_classic_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rec_i, rec_f, rec_box, tile_start, tile_count, vis_d, vis_t, n_rec,
        grid_w, ss);
  return (int)cudaGetLastError();
}
