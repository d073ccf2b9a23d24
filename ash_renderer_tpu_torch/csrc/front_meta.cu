// K9: the fused front's wide-pair expansion and range metadata in four
// launches with no host read.  From the sorted order's run bounds of a
// tile-row window it writes the wide pairs' per-tile runs (pair_starts,
// pair_rows), the raster's range meta (rmeta) and a small counts buffer
// [ws, we, new_ws, n_pairs, n_fit] that the host reads once after the
// launches.  The plain torch version is
// ash_renderer_tpu_torch/ops/front_meta.py:front_meta_plain
// (binsort.expand_wide_pairs, fused_kernel.build_range_meta).
//
// It replaces no Pallas kernel.  The reference runs the same stage as XLA
// glue under one jit (ash_renderer_tpu/pipeline.py:458-500), its empty
// case under lax.cond; eager torch pays ~40-70 launches and five host
// reads (the wide run's bounds, the fitted count, the pair count).
//
// Bound by the launch floor: it moves well under 1 MB (3 comb words per
// wide row, the bounds, ~14 words of rmeta a tile).  So the design keeps
// four launches whatever the frame, sizes every grid from the host's
// budgets (never from the data) and lets the kernels read the data's sizes
// from the device:
//
// 1. rows (one block): the first min(n_wide, wide_rows) rows of the wide
//    run, each one's tile rectangle in the window (pixel_aabb_of's integer
//    arithmetic, the window's row clamps), the inclusive scan of their
//    pair counts, the positional cut (a row is consumed while the scan is
//    within wide_pairs; a dead row inside the prefix is consumed as a
//    0-pair row), and the counts;
// 2. count (one block per tile row): the consumed rows that cover each
//    tile of the row;
// 3. scan (one block): pair_starts, the exclusive scan of the tile counts;
// 4. write (one block per tile row): the row's rmeta (build_range_meta's
//    7 ranges a tile, the wide run from new_ws), then each tile's covering
//    rows in row order, which is the order the plain version's stable sort
//    by tile gives.
//
// Passes 2 and 4 read every consumed row's rectangle once per tile row
// (terrain's ~4,500 wide rows: ~72 KB for each of 135 rows) and stage the
// ones that cover the row in shared memory, where one warp per tile tests
// them.  The first design (experiments/k9_tile_blocks.cu) ran one block
// per tile in passes 2 and 4, each reading every rectangle (15x the
// bytes), and built rmeta in the one block of pass 3; PERF.md has both
// designs' times.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binsort.cuh"
#include "specmath.cuh"

namespace {

using namespace ash;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int ONE_BLOCK = 1024;  // threads of the rows and scan passes
constexpr int ROW_BLOCK = 512;  // threads of the count and write passes
constexpr int MAX_GRID_W = 512;  // tiles a row (ops/front_meta.MAX_GRID_W)
constexpr int N_RANGES = 7;  // fused_kernel.N_RANGES
// the counts buffer (ops/front_meta.COUNTS, then n_fit)
constexpr int M_WS = 0, M_WE = 1, M_NEW_WS = 2, M_PAIRS = 3, M_FIT = 4;

struct MetaParams {
  int n_tiles, grid_w, tile_h, row0, py_lo, py_hi;
  int width, height, ss, min_c;
  int wide_rows, wide_pairs, s_rows;
};

// the pairs of a row's tile rectangle in the window (tx0, tx1, ty0, ty1;
// (0, -1, 0, -1) when the row is dead after the clamps)
__device__ __forceinline__ int pairs_of(const int4& r) {
  return (r.y - r.x + 1) * (r.w - r.z + 1);
}

// exclusive prefix of v over the block (THREADS threads) and the block's
// total; warp_tot holds THREADS / 32 ints
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();  // warp_tot may still be read from a previous call
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    all += warp_tot[w];
  }
  *total = all;
  return before + incl - v;
}

// 1. the wide rows' rectangles, their scan and the cut
__global__ void __launch_bounds__(ONE_BLOCK)
rows_kernel(const int* __restrict__ comb, const int* __restrict__ order,
            const int* __restrict__ bounds, int4* __restrict__ rects,
            int* __restrict__ wrow, int* __restrict__ meta, MetaParams P) {
  __shared__ int warp_tot[ONE_BLOCK / 32];
  const int nk = P.n_tiles * KEYS_PER_TILE;
  const int ws = bounds[nk], we = bounds[nk + 1];
  const int n_live = max(0, min(we - ws, P.wide_rows));
  const int off = -P.min_c;
  // the rectangles, one row a thread in turn (the loads of neighbouring
  // threads are independent), then each thread scans a contiguous chunk
  for (int i = threadIdx.x; i < n_live; i += ONE_BLOCK) {
    const int row = min(max(order[ws + i], 0), P.s_rows - 1);
    const int* cr = comb + (size_t)row * TBL_COLS;
    int xs[3], ys[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = cr[k];
      xs[k] = (p & 0xFFFF) - off;
      ys[k] = ((p >> 16) & 0xFFFF) - off;
    }
    const PixelBox b = pixel_box(
        min(min(xs[0], xs[1]), xs[2]), max(max(xs[0], xs[1]), xs[2]),
        min(min(ys[0], ys[1]), ys[2]), max(max(ys[0], ys[1]), ys[2]), P.ss,
        P.width, P.height);
    const int pymin = max(b.pymin, P.py_lo), pymax = min(b.pymax, P.py_hi);
    const bool live = b.pxmax >= b.pxmin && pymax >= pymin;
    rects[i] =
        live ? make_int4(floordiv(b.pxmin, TILE_W), floordiv(b.pxmax, TILE_W),
                         floordiv(pymin, P.tile_h) - P.row0,
                         floordiv(pymax, P.tile_h) - P.row0)
             : make_int4(0, -1, 0, -1);
    wrow[i] = row;
  }
  __syncthreads();  // the rectangles are read across the block below
  const int per = (n_live + ONE_BLOCK - 1) / ONE_BLOCK;
  const int lo = min((int)threadIdx.x * per, n_live);
  const int hi = min(lo + per, n_live);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += pairs_of(rects[i]);
  int all;
  int end = block_scan<ONE_BLOCK>(sum, warp_tot, &all);
  // the cut: the inclusive ends are non-decreasing, so the rows within the
  // budget are a prefix
  int n_fit = 0, fit_pairs = 0;
  for (int i = lo; i < hi; ++i) {
    const int c = pairs_of(rects[i]);
    end += c;
    if (end <= P.wide_pairs) {
      ++n_fit;
      fit_pairs += c;
    }
  }
  int fit_all, pairs_all;
  block_scan<ONE_BLOCK>(n_fit, warp_tot, &fit_all);
  block_scan<ONE_BLOCK>(fit_pairs, warp_tot, &pairs_all);
  if (threadIdx.x == 0) {
    meta[M_WS] = ws;
    meta[M_WE] = we;
    meta[M_NEW_WS] = ws + fit_all;
    meta[M_PAIRS] = pairs_all;
    meta[M_FIT] = fit_all;
  }
}

// 3. pair_starts: the exclusive scan of the tile counts
__global__ void __launch_bounds__(ONE_BLOCK)
scan_kernel(const int* __restrict__ tile_cnt, int* __restrict__ pair_starts,
            int n_tiles) {
  __shared__ int warp_tot[ONE_BLOCK / 32];
  const int per = (n_tiles + ONE_BLOCK - 1) / ONE_BLOCK;
  const int lo = min((int)threadIdx.x * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += tile_cnt[t];
  int all;
  int start = block_scan<ONE_BLOCK>(sum, warp_tot, &all);
  for (int t = lo; t < hi; ++t) {
    pair_starts[t] = start;
    start += tile_cnt[t];
  }
  if (threadIdx.x == 0) pair_starts[n_tiles] = all;
}

// build_range_meta's range r of tile t, [rs, max(re, rs)]: own coarse run,
// ABOVE prefix {dr, r, d}, LEFT prefix {dr, r}, DIAGONAL prefix {dr} (0, 0
// where the neighbour is off the grid), the global wide run past the
// consumed rows, the tile's wide pairs, its fine run
__device__ __forceinline__ int2 range_of(int r, int t, int n_tiles,
                                         int grid_w, const int* bounds,
                                         const int* pair_starts, int new_ws,
                                         int we) {
  const bool tx_ok = t % grid_w > 0, ty_ok = t / grid_w > 0;
  const int fb = N_GRP * n_tiles;
  int rs = 0, re = 0;
  switch (r) {
    case 0: rs = bounds[t * N_GRP]; re = bounds[(t + 1) * N_GRP]; break;
    case 1:
      if (ty_ok) {
        rs = bounds[(t - grid_w) * N_GRP];
        re = bounds[(t - grid_w) * N_GRP + 3];
      }
      break;
    case 2:
      if (tx_ok) {
        rs = bounds[(t - 1) * N_GRP];
        re = bounds[(t - 1) * N_GRP + 2];
      }
      break;
    case 3:
      if (tx_ok && ty_ok) {
        rs = bounds[(t - grid_w - 1) * N_GRP];
        re = bounds[(t - grid_w - 1) * N_GRP + 1];
      }
      break;
    case 4: rs = new_ws; re = we; break;
    case 5: rs = pair_starts[t]; re = pair_starts[t + 1]; break;
    default: rs = bounds[fb + t * N_FINE]; re = bounds[fb + (t + 1) * N_FINE];
  }
  return make_int2(rs, max(re, rs));
}

// 2 and 4: one block per tile row of the window.  Each step stages, in
// row order, the consumed rows of the next ROW_BLOCK that cover the tile
// row in shared memory; then one warp per tile of the row counts them
// (WRITE false: tile_cnt) or writes those that cover its tile after the
// ones it wrote before (WRITE true: pair_rows from pair_starts, and first
// the row's rmeta)
template <bool WRITE>
__global__ void __launch_bounds__(ROW_BLOCK)
tile_row_kernel(const int4* __restrict__ rects, const int* __restrict__ wrow,
                const int* __restrict__ meta, const int* __restrict__ bounds,
                int* __restrict__ tile_cnt, const int* __restrict__ pair_starts,
                int* __restrict__ pair_rows, int2* __restrict__ rmeta,
                int n_tiles, int grid_w) {
  __shared__ int warp_tot[ROW_BLOCK / 32];
  __shared__ int4 s_rect[ROW_BLOCK];
  __shared__ int s_row[ROW_BLOCK];
  __shared__ int s_done[MAX_GRID_W];  // per tile: rows counted or written
  const int ty = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int n_fit = meta[M_FIT];
  if (WRITE) {
    const int new_ws = meta[M_NEW_WS], we = meta[M_WE];
    for (int k = threadIdx.x; k < grid_w * N_RANGES; k += ROW_BLOCK) {
      const int t = ty * grid_w + k / N_RANGES;
      rmeta[(size_t)t * N_RANGES + k % N_RANGES] = range_of(
          k % N_RANGES, t, n_tiles, grid_w, bounds, pair_starts, new_ws, we);
    }
  }
  for (int tx = threadIdx.x; tx < grid_w; tx += ROW_BLOCK) s_done[tx] = 0;
  for (int i0 = 0; i0 < n_fit; i0 += ROW_BLOCK) {
    const int i = i0 + threadIdx.x;
    const int4 r = i < n_fit ? rects[i] : make_int4(0, -1, 0, -1);
    const bool on_row = r.z <= ty && ty <= r.w;
    int m;  // block_scan syncs: the last step's readers are done
    const int pos = block_scan<ROW_BLOCK>(on_row ? 1 : 0, warp_tot, &m);
    if (on_row) {
      s_rect[pos] = r;
      if (WRITE) s_row[pos] = wrow[i];
    }
    __syncthreads();
    for (int tx = warp; tx < grid_w; tx += ROW_BLOCK / 32) {
      const int start = WRITE ? pair_starts[ty * grid_w + tx] : 0;
      int done = s_done[tx];
      for (int k0 = 0; k0 < m; k0 += 32) {
        const int k = k0 + lane;
        const bool hit = k < m && s_rect[k].x <= tx && tx <= s_rect[k].y;
        const unsigned b = __ballot_sync(FULL, hit);
        if (WRITE && hit) pair_rows[start + done + __popc(b & lt)] = s_row[k];
        done += __popc(b);
      }
      if (lane == 0) s_done[tx] = done;
    }
  }
  if (!WRITE) {
    __syncthreads();
    for (int tx = threadIdx.x; tx < grid_w; tx += ROW_BLOCK)
      tile_cnt[ty * grid_w + tx] = s_done[tx];
  }
}

}  // namespace

extern "C" int ash_front_meta(const int* comb, const int* order,
                              const int* bounds, void* rects, int* wrow,
                              int* tile_cnt, int* meta, int* pair_rows,
                              int* pair_starts, int* rmeta, int n_tiles,
                              int grid_w, int tile_h, int row0, int py_lo,
                              int py_hi, int width, int height, int ss,
                              int min_c, int wide_rows, int wide_pairs,
                              int s_rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  MetaParams P{n_tiles, grid_w, tile_h,    row0,       py_lo,     py_hi, width,
               height,  ss,     min_c,     wide_rows,  wide_pairs, s_rows};
  const int4* r = (const int4*)rects;
  const int tile_rows = n_tiles / grid_w;
  rows_kernel<<<1, ONE_BLOCK, 0, s>>>(comb, order, bounds, (int4*)rects, wrow,
                                      meta, P);
  int2* rm = (int2*)rmeta;
  if (tile_rows > 0)
    tile_row_kernel<false><<<tile_rows, ROW_BLOCK, 0, s>>>(
        r, wrow, meta, bounds, tile_cnt, pair_starts, pair_rows, rm, n_tiles,
        grid_w);
  scan_kernel<<<1, ONE_BLOCK, 0, s>>>(tile_cnt, pair_starts, n_tiles);
  if (tile_rows > 0)
    tile_row_kernel<true><<<tile_rows, ROW_BLOCK, 0, s>>>(
        r, wrow, meta, bounds, tile_cnt, pair_starts, pair_rows, rm, n_tiles,
        grid_w);
  return (int)cudaGetLastError();
}
