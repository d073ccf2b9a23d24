// K9's first design, kept to time against csrc/front_meta.cu
// (experiments/torch_k9_variants.py): passes 2 and 4 run one block per
// tile, each reading every consumed row's rectangle from global memory.
// The same C entry point and results as csrc/front_meta.cu.
//
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
// 2. count (one block per tile): the consumed rows whose rectangle covers
//    the tile;
// 3. scan (one block): pair_starts, the exclusive scan of the tile counts,
//    and rmeta (build_range_meta's 7 ranges a tile, the wide run from
//    new_ws);
// 4. write (one block per tile): the tile's covering rows in row order,
//    which is the order the plain version's stable sort by tile gives.
//
// Passes 2 and 4 test every consumed row's rectangle against their tile:
// at terrain's 4,170 wide rows and 2,025 tiles ~8.4 M tests each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binsort.cuh"
#include "specmath.cuh"

namespace {

using namespace ash;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int ONE_BLOCK = 1024;  // threads of the rows and scan passes
constexpr int TILE_THREADS = 256;  // threads of the count and write passes
constexpr int N_RANGES = 7;  // fused_kernel.N_RANGES
// the counts buffer (ops/front_meta.COUNTS, then n_fit)
constexpr int M_WS = 0, M_WE = 1, M_NEW_WS = 2, M_PAIRS = 3, M_FIT = 4;

struct MetaParams {
  int n_tiles, grid_w, tile_h, row0, py_lo, py_hi;
  int width, height, ss, min_c;
  int wide_rows, wide_pairs, s_rows;
};

// a row's tile rectangle in the window: tx0, tx1, ty0, ty1 (empty when the
// row is dead after the clamps)
__device__ __forceinline__ bool covers(const int4& r, int tx, int ty) {
  return tx >= r.x && tx <= r.y && ty >= r.z && ty <= r.w;
}

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
  const int per = (n_live + ONE_BLOCK - 1) / ONE_BLOCK;
  const int lo = min((int)threadIdx.x * per, n_live);
  const int hi = min(lo + per, n_live);
  const int off = -P.min_c;
  int sum = 0;
  for (int i = lo; i < hi; ++i) {
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
    const int4 r =
        live ? make_int4(floordiv(b.pxmin, TILE_W), floordiv(b.pxmax, TILE_W),
                         floordiv(pymin, P.tile_h) - P.row0,
                         floordiv(pymax, P.tile_h) - P.row0)
             : make_int4(0, -1, 0, -1);
    rects[i] = r;
    wrow[i] = row;
    sum += pairs_of(r);
  }
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

// 2. per tile, the consumed rows that cover it
__global__ void __launch_bounds__(TILE_THREADS)
count_kernel(const int4* __restrict__ rects, const int* __restrict__ meta,
             int* __restrict__ tile_cnt, int grid_w) {
  __shared__ int warp_tot[TILE_THREADS / 32];
  const int t = blockIdx.x, tx = t % grid_w, ty = t / grid_w;
  const int n_fit = meta[M_FIT];
  int c = 0;
  for (int i = threadIdx.x; i < n_fit; i += TILE_THREADS)
    c += covers(rects[i], tx, ty) ? 1 : 0;
  int all;
  block_scan<TILE_THREADS>(c, warp_tot, &all);
  if (threadIdx.x == 0) tile_cnt[t] = all;
}

// 3. pair_starts and rmeta
__global__ void __launch_bounds__(ONE_BLOCK)
scan_kernel(const int* __restrict__ bounds, const int* __restrict__ tile_cnt,
            const int* __restrict__ meta, int* __restrict__ pair_starts,
            int* __restrict__ rmeta, int n_tiles, int grid_w) {
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
  __syncthreads();  // pair_starts is read across the block below

  const int fb = N_GRP * n_tiles;
  const int new_ws = meta[M_NEW_WS], we = meta[M_WE];
  for (int t = threadIdx.x; t < n_tiles; t += ONE_BLOCK) {
    const bool tx_ok = t % grid_w > 0, ty_ok = t / grid_w > 0;
    // a neighbour's coarse bound k (0 where it is off the grid)
    auto nb = [&](bool ok, int tile, int k) {
      return ok ? bounds[tile * N_GRP + k] : 0;
    };
    int m[N_RANGES][2] = {
        {bounds[t * N_GRP], bounds[(t + 1) * N_GRP]},  // own coarse run
        {nb(ty_ok, t - grid_w, 0), nb(ty_ok, t - grid_w, 3)},  // above
        {nb(tx_ok, t - 1, 0), nb(tx_ok, t - 1, 2)},  // left
        {nb(tx_ok && ty_ok, t - grid_w - 1, 0),
         nb(tx_ok && ty_ok, t - grid_w - 1, 1)},  // diagonal
        {new_ws, we},  // the global wide run past the consumed rows
        {pair_starts[t], pair_starts[t + 1]},  // the tile's wide pairs
        {bounds[fb + t * N_FINE], bounds[fb + (t + 1) * N_FINE]},  // fine
    };
    int* out = rmeta + (size_t)t * N_RANGES * 2;
#pragma unroll
    for (int r = 0; r < N_RANGES; ++r) {
      out[2 * r] = m[r][0];
      out[2 * r + 1] = max(m[r][1], m[r][0]);
    }
  }
}

// 4. per tile, its covering rows in row order
__global__ void __launch_bounds__(TILE_THREADS)
write_kernel(const int4* __restrict__ rects, const int* __restrict__ wrow,
             const int* __restrict__ meta, const int* __restrict__ pair_starts,
             int* __restrict__ pair_rows, int grid_w) {
  __shared__ int warp_tot[TILE_THREADS / 32];
  const int t = blockIdx.x, tx = t % grid_w, ty = t / grid_w;
  const int start = pair_starts[t], cnt = pair_starts[t + 1] - start;
  if (cnt == 0) return;
  const int n_fit = meta[M_FIT];
  int base = 0;  // the same in every thread: the loop is uniform
  for (int i0 = 0; i0 < n_fit && base < cnt; i0 += TILE_THREADS) {
    const int i = i0 + threadIdx.x;
    const bool hit = i < n_fit && covers(rects[i], tx, ty);
    int all;
    const int pos = block_scan<TILE_THREADS>(hit ? 1 : 0, warp_tot, &all);
    if (hit) pair_rows[start + base + pos] = wrow[i];
    base += all;
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
  int4* r = (int4*)rects;
  rows_kernel<<<1, ONE_BLOCK, 0, s>>>(comb, order, bounds, r, wrow, meta, P);
  if (n_tiles > 0)
    count_kernel<<<n_tiles, TILE_THREADS, 0, s>>>(r, meta, tile_cnt, grid_w);
  scan_kernel<<<1, ONE_BLOCK, 0, s>>>(bounds, tile_cnt, meta, pair_starts,
                                      rmeta, n_tiles, grid_w);
  if (n_tiles > 0)
    write_kernel<<<n_tiles, TILE_THREADS, 0, s>>>(r, wrow, meta, pair_starts,
                                                  pair_rows, grid_w);
  return (int)cudaGetLastError();
}
