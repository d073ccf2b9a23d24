// K4: tile-binned visibility raster of the classic pipeline, 16 x 128
// tiles.  Replaces the Pallas kernel ash_renderer_tpu/ops/raster_pallas.py
// (_kernel, via rasterize_visibility); the plain torch version is
// ops/raster_visibility.py:rasterize_visibility_plain.
//
// One block per tile, 256 threads; thread p owns column p % 128 and the 8
// rows (p / 128) + 2j, so each of its stores is one coalesced 128-wide row.
// The block stages the tile's records [start, start + count) in shared
// memory, CHUNK at a time (14 int32 words and the float inv_area2 each,
// loaded field by field so neighbouring threads read neighbouring words);
// each thread keeps the minimum (d16, -id) of its 8 pixels in registers --
// exact and order-free, so no atomics.  Per record and pixel:
// e_i = (e_ic + a_i * col_s) + b_i * row_s in wrapping int32 (the config's
// extent bound keeps the true values in range), covered iff every
// e_i >= 1 - bias bit i, then interp_depth16 and depth_key_better.
//
// Bound by integer issue: every record is evaluated at all 2048 pixels of
// its tile (~20 ops each).
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int TILE_H = 16;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;  // 8
constexpr int ROW_STEP = THREADS / TILE_W;                  // 2
constexpr int CHUNK = 256;
constexpr int N_WORDS = 14;  // record rows 0-13

__global__ void __launch_bounds__(THREADS)
raster_classic_kernel(const int* __restrict__ rec_i,
                      const float* __restrict__ rec_f,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count,
                      int* __restrict__ vis_d, int* __restrict__ vis_t,
                      int n_rec, int grid_w, int ss) {
  __shared__ int s_w[N_WORDS][CHUNK];
  __shared__ float s_inv[CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int col = p % TILE_W, row0 = p / TILE_W;
  const int start = tile_start[t], count = tile_count[t];
  const int col_s = col * ss;

  int best_d[ROWS_PER_THREAD], best_t[ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    best_d[j] = DEPTH_MAX;
    best_t[j] = BG_TRI;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();
    if (p < n) {
      const int r = start + base + p;
#pragma unroll
      for (int w = 0; w < N_WORDS; ++w)
        s_w[w][p] = rec_i[(size_t)w * n_rec + r];
      s_inv[p] = rec_f[r];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int a0 = s_w[0][s], b0 = s_w[1][s];
      const int a1 = s_w[2][s], b1 = s_w[3][s];
      const int a2 = s_w[4][s], b2 = s_w[5][s];
      const int z0 = s_w[9][s], z1 = s_w[10][s], z2 = s_w[11][s];
      const int id = s_w[12][s], bias = s_w[13][s];
      const float inv_area = s_inv[s];
      const int t0 = 1 - (bias & 1);
      const int t1 = 1 - ((bias >> 1) & 1);
      const int t2 = 1 - ((bias >> 2) & 1);
      // the column term once per record; the row term per pixel
      const int c0 = wadd(s_w[6][s], wmul(a0, col_s));
      const int c1 = wadd(s_w[7][s], wmul(a1, col_s));
      const int c2 = wadd(s_w[8][s], wmul(a2, col_s));
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const int row_s = (row0 + ROW_STEP * j) * ss;
        const int e0 = wadd(c0, wmul(b0, row_s));
        const int e1 = wadd(c1, wmul(b1, row_s));
        const int e2 = wadd(c2, wmul(b2, row_s));
        if (e0 >= t0 && e1 >= t1 && e2 >= t2) {
          const int d = interp_depth16(e0, e1, e2, inv_area, z0, z1, z2);
          if (depth_key_better(d, id, best_d[j], best_t[j])) {
            best_d[j] = d;
            best_t[j] = id;
          }
        }
      }
    }
  }

  const size_t wp = (size_t)grid_w * TILE_W;
  const int tile_x = t % grid_w, tile_y = t / grid_w;
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const size_t i =
        ((size_t)tile_y * TILE_H + row0 + ROW_STEP * j) * wp +
        (size_t)tile_x * TILE_W + col;
    vis_d[i] = best_d[j];
    vis_t[i] = best_t[j];
  }
}

}  // namespace

// rec_i: (14, n_rec) int32 rows; rec_f: (1, n_rec) float; vis_d / vis_t:
// (grid_h * 16, grid_w * 128) int32, every pixel written
extern "C" int ash_rasterize_visibility(const int* rec_i, const float* rec_f,
                                        const int* tile_start,
                                        const int* tile_count, int* vis_d,
                                        int* vis_t, int n_rec, int n_tiles,
                                        int grid_w, int ss, void* stream) {
  if (n_tiles > 0)
    raster_classic_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rec_i, rec_f, tile_start, tile_count, vis_d, vis_t, n_rec, grid_w,
        ss);
  return (int)cudaGetLastError();
}
