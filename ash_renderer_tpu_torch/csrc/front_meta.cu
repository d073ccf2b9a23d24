// K9: the fused front's wide-pair expansion, range metadata and sorted-table
// records in one cooperative launch with no host read.  From the sorted
// order's run bounds of a tile-row window it writes the wide pairs' per-tile
// runs (pair_starts, pair_rows), the raster's range meta (rmeta), the
// records K3 streams (rec_sorted, rec_ext: 8 words a row, ops/tritables
// REC_COLS) and a counts buffer [ws, we, new_ws, n_pairs, n_wide,
// wide_leftover, n_fit] that callers read after the frame.  The plain torch
// version is ash_renderer_tpu_torch/ops/front_meta.py:front_meta_plain
// (binsort.expand_wide_pairs, fused_kernel.build_range_meta,
// tritables.sorted_table).
//
// It replaces no Pallas kernel.  The reference runs the same stage as XLA
// glue under one jit (ash_renderer_tpu/pipeline.py:458-500), its empty
// case under lax.cond, and gathers whole 128-column comb rows: on the TPU,
// 128 columns are XLA's fast gather path (experiments/gather_width_probe.py).
// K3 reads 7 words of a row, so the H100 gathers those 7 and a pad word.
//
// What bounds it: the records' bytes (each live row's order word and 7 comb
// words read, 8 words written: ~19 MB at the 1.31M-triangle orbit, 0.006 ms
// at 3.35 TB/s) and the latency of the expansion's dependent steps.  The
// design is one launch, its grid sized from the occupancy (never from the
// data), the steps split by two grid syncs:
//
// 0. rows: each block takes chunks of THREADS wide rows, a row a thread:
//    its record, its tile rectangle in the window (pixel_aabb_of's integer
//    arithmetic, the window's row clamps) and the chunk's pair total;
//    -- grid sync --
// 1. the cut: each chunk's inclusive ends from the totals of the chunks
//    before it (a row is consumed while its end is within wide_pairs; a
//    dead row inside the prefix is consumed as a 0-pair row), the chunk's
//    consumed rows and pairs, and atomic adds of the consumed pairs, spread
//    over the chunk's threads, into per-tile and per-tile-row counts;
//    -- grid sync --
// 2. each block takes tile rows: the pairs of the rows before its own give
//    its pair_starts, then rmeta (build_range_meta's 7 ranges a tile), then
//    it walks the consumed rows in row order, WALK rows a step, stages
//    those that cover its row in shared memory and one warp a tile writes
//    the ones that cover its tile after those it wrote before: the order
//    the plain version's stable sort by tile gives, each pair's record
//    beside its row id (both from step 0's scratch, in L2);
// 3. the sorted records: blocks take chunks of the live prefix
//    order[:we] from an atomic counter as they come free of step 2, so the
//    gather runs beside the walk.
//
// An earlier design ran four launches (rows, count, scan, write) and left
// the gathers to two index_selects of whole rows sized by a host read;
// PERF.md has both designs' times.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "binsort.cuh"
#include "coop.cuh"
#include "specmath.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ash;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 512;
constexpr int N_WARPS = THREADS / 32;
constexpr int MAX_GRID_W = 512;  // tiles a row (ops/front_meta.MAX_GRID_W)
constexpr int N_RANGES = 7;  // fused_kernel.N_RANGES
// sorted records a thread per gather chunk: chunks of one row a thread
// spread the gather over every block (4 a thread left half the blocks idle
// at the terrain walk frame, 0.052 against 0.042 ms)
constexpr int GATHER_ROWS = 1;
constexpr int GATHER_CHUNK = GATHER_ROWS * THREADS;
constexpr int WALK_ROWS = 4;  // consumed rows a thread per step of the walk
constexpr int WALK = WALK_ROWS * THREADS;
// the counts buffer (ops/front_meta.COUNTS, then n_fit)
constexpr int M_WS = 0, M_WE = 1, M_NEW_WS = 2, M_PAIRS = 3, M_WIDE = 4,
              M_LEFT = 5, M_FIT = 6;
// per chunk of wide rows: pair total, consumed rows, consumed pairs
constexpr int C_PAIRS = 0, C_FIT = 1, C_FIT_PAIRS = 2, N_CHUNK_SUMS = 3;

struct MetaParams {
  const int* comb;
  const int* order;
  const int* bounds;
  int4* rects;       // (wide_rows,) scratch
  int* wrow;         // (wide_rows,) scratch: the wide rows' comb rows
  int4* wrec;        // (wide_rows * 2,) scratch: their records
  int* tile_cnt;     // (n_tiles,) scratch: consumed pairs a tile
  int* row_cnt;      // (tile_rows,) scratch: consumed pairs a tile row
  int* chunk_sums;   // (n_chunks * N_CHUNK_SUMS,) scratch
  int* work;         // (1,) scratch: the gather's next row
  int* meta;         // counts
  int* pair_rows;    // (wide_pairs,)
  int* pair_starts;  // (n_tiles + 1,)
  int2* rmeta;       // (n_tiles * N_RANGES,)
  int4* rec_sorted;  // (s_rows * 2,): two int4 a record
  int4* rec_ext;     // (wide_pairs * 2,)
  int n_tiles, grid_w, tile_h, row0, py_lo, py_hi;
  int width, height, ss, min_c;
  int wide_rows, wide_pairs, s_rows;
};

// the pairs of a row's tile rectangle in the window (tx0, tx1, ty0, ty1;
// (0, -1, 0, -1) when the row is dead after the clamps)
__device__ __forceinline__ int pairs_of(const int4& r) {
  return (r.y - r.x + 1) * (r.w - r.z + 1);
}

// comb row `row`'s record: columns 0-3, then 4, 5, the row's index and 0.
// The index is the row's ID_COL word (K1, K6 and build_comb_table write
// each row's own index there, and K3's phase D reads the winner's row by
// it), so the record needs the row's first sector alone: reading ID_COL's
// sector too took 13 of K9's 52 us at the terrain walk frame
// (experiments/torch_front_variants.py)
__device__ __forceinline__ void load_record(const int* comb, int row,
                                            int4* a, int4* b) {
  const int* p = comb + (size_t)row * TBL_COLS;
  *a = *reinterpret_cast<const int4*>(p);
  const int2 zi = *reinterpret_cast<const int2*>(p + 4);
  *b = make_int4(zi.x, zi.y, row, 0);
}

// build_range_meta's range r of tile t, [rs, max(re, rs)]: own coarse run,
// ABOVE prefix {dr, r, d}, LEFT prefix {dr, r}, DIAGONAL prefix {dr} (0, 0
// where the neighbour is off the grid), the global wide run past the
// consumed rows, the tile's wide pairs [ps, pe), its fine run
__device__ __forceinline__ int2 range_of(int r, int t, int n_tiles,
                                         int grid_w, const int* bounds,
                                         int ps, int pe, int new_ws, int we) {
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
    case 5: rs = ps; re = pe; break;
    default: rs = bounds[fb + t * N_FINE]; re = bounds[fb + (t + 1) * N_FINE];
  }
  return make_int2(rs, max(re, rs));
}

__global__ void __launch_bounds__(THREADS)
front_meta_kernel(MetaParams P) {
  __shared__ int red[N_WARPS];
  __shared__ union {
    struct {
      int4 rect[THREADS];  // a chunk's rectangles
      int incl[THREADS];   // their inclusive pair ends
    } cut;                 // step 1
    struct {
      int span[WALK];      // staged rows' tx0 | tx1 << 16
      int idx[WALK];       // staged rows' wide row index
    } walk;                // step 2
  } S;
  int4* s_rect = S.cut.rect;
  int* s_incl = S.cut.incl;
  int* s_span = S.walk.span;
  int* s_idx = S.walk.idx;
  __shared__ int s_start[MAX_GRID_W];
  __shared__ int s_cnt[MAX_GRID_W];
  __shared__ int s_done[MAX_GRID_W];  // per tile: rows written
  __shared__ int s_next;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_rows = P.n_tiles / P.grid_w;
  const int nk = P.n_tiles * KEYS_PER_TILE;
  const int ws = P.bounds[nk], we = P.bounds[nk + 1];
  const int n_live = max(0, min(we - ws, P.wide_rows));
  const int n_chunks = (n_live + THREADS - 1) / THREADS;
  const int off = -P.min_c;
  const int4 dead = make_int4(0, -1, 0, -1);

  // 0. the counts start at 0; each wide row's rectangle and record
  for (int i = blockIdx.x * THREADS + tid; i < P.n_tiles + tile_rows;
       i += gridDim.x * THREADS) {
    if (i < P.n_tiles) P.tile_cnt[i] = 0;
    else P.row_cnt[i - P.n_tiles] = 0;
  }
  if (blockIdx.x == 0 && tid == 0) *P.work = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int i = c * THREADS + tid;
    int pairs = 0;
    if (i < n_live) {
      const int row = min(max(P.order[ws + i], 0), P.s_rows - 1);
      int4 ra, rb;  // the record
      load_record(P.comb, row, &ra, &rb);
      const int cr[3] = {ra.x, ra.y, ra.z};  // the packed corners
      int xs[3], ys[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xs[k] = (cr[k] & 0xFFFF) - off;
        ys[k] = ((cr[k] >> 16) & 0xFFFF) - off;
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
               : dead;
      P.rects[i] = r;
      P.wrow[i] = row;
      P.wrec[2 * i] = ra;
      P.wrec[2 * i + 1] = rb;
      pairs = pairs_of(r);
    }
    const int tot = block_sum<THREADS>(pairs, red);
    if (tid == 0) P.chunk_sums[c * N_CHUNK_SUMS + C_PAIRS] = tot;
  }
  grid.sync();

  // 1. the cut, and the consumed rows' pairs counted a tile and a tile row:
  // the chunk's consumed pairs are spread over its threads, a pair a thread
  // at a time (a row's pairs are one thread's otherwise, and a wide row's
  // hundreds of atomic adds would hold the block)
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int before =
        block_sum_of<THREADS>(P.chunk_sums, c, N_CHUNK_SUMS, C_PAIRS, red);
    const int i = c * THREADS + tid;
    const int4 r = i < n_live ? P.rects[i] : dead;
    const int cnt = pairs_of(r);
    int all;
    const int incl = block_scan<THREADS>(cnt, red, &all) + cnt;
    // the inclusive ends are non-decreasing, so the rows within the budget
    // are a prefix
    const bool fit = i < n_live && before + incl <= P.wide_pairs;
    const int n_fit = block_sum<THREADS>(fit ? 1 : 0, red);
    const int fit_pairs = block_sum<THREADS>(fit ? cnt : 0, red);
    if (tid == 0) {
      P.chunk_sums[c * N_CHUNK_SUMS + C_FIT] = n_fit;
      P.chunk_sums[c * N_CHUNK_SUMS + C_FIT_PAIRS] = fit_pairs;
    }
    s_rect[tid] = r;
    s_incl[tid] = incl;
    __syncthreads();
    for (int j = tid; j < fit_pairs; j += THREADS) {
      // the consumed row of the chunk's pair j: the first with its
      // inclusive end past j (a 0-pair row never is)
      int lo = 0, hi = n_fit - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_incl[mid] > j) hi = mid;
        else lo = mid + 1;
      }
      const int4 q = s_rect[lo];
      const int ntx = q.y - q.x + 1;
      const int o = j - (s_incl[lo] - pairs_of(q));
      const int dy = o / ntx, dx = o - dy * ntx;
      atomicAdd(&P.tile_cnt[(q.z + dy) * P.grid_w + q.x + dx], 1);
      if (dx == 0) atomicAdd(&P.row_cnt[q.z + dy], ntx);
    }
    __syncthreads();  // s_rect and s_incl are rewritten for the next chunk
  }
  grid.sync();

  // 2. every block: the cut's totals; then its tile rows
  const int n_fit = block_sum_of<THREADS>(P.chunk_sums, n_chunks,
                                          N_CHUNK_SUMS, C_FIT, red);
  const int n_pairs = block_sum_of<THREADS>(P.chunk_sums, n_chunks,
                                            N_CHUNK_SUMS, C_FIT_PAIRS, red);
  const int new_ws = ws + n_fit;
  if (blockIdx.x == 0 && tid == 0) {
    P.meta[M_WS] = ws;
    P.meta[M_WE] = we;
    P.meta[M_NEW_WS] = new_ws;
    P.meta[M_PAIRS] = n_pairs;
    P.meta[M_WIDE] = we - ws;
    P.meta[M_LEFT] = we - new_ws;
    P.meta[M_FIT] = n_fit;
    P.pair_starts[P.n_tiles] = n_pairs;
  }
  const unsigned lt = (1u << lane) - 1u;
  for (int ty = blockIdx.x; ty < tile_rows; ty += gridDim.x) {
    const int t0 = ty * P.grid_w;
    const int base = block_sum_of<THREADS>(P.row_cnt, ty, 1, 0, red);
    const int cnt = tid < P.grid_w ? P.tile_cnt[t0 + tid] : 0;
    int row_all;
    const int start = base + block_scan<THREADS>(cnt, red, &row_all);
    if (tid < P.grid_w) {
      s_start[tid] = start;
      s_cnt[tid] = cnt;
      s_done[tid] = 0;
      P.pair_starts[t0 + tid] = start;
    }
    __syncthreads();
    for (int k = tid; k < P.grid_w * N_RANGES; k += THREADS) {
      const int tx = k / N_RANGES, rg = k % N_RANGES;
      P.rmeta[(size_t)(t0 + tx) * N_RANGES + rg] =
          range_of(rg, t0 + tx, P.n_tiles, P.grid_w, P.bounds, s_start[tx],
                   s_start[tx] + s_cnt[tx], new_ws, we);
    }
    // the consumed rows, WALK_ROWS consecutive ones a thread a step: those
    // that cover the tile row are staged in row order
    for (int i0 = 0; i0 < n_fit; i0 += WALK) {
      int4 r[WALK_ROWS];
      int n_on = 0;
#pragma unroll
      for (int k = 0; k < WALK_ROWS; ++k) {
        const int i = i0 + tid * WALK_ROWS + k;
        r[k] = i < n_fit ? P.rects[i] : dead;
        n_on += r[k].z <= ty && ty <= r[k].w;
      }
      int m;  // block_scan syncs: the last step's readers are done
      int pos = block_scan<THREADS>(n_on, red, &m);
#pragma unroll
      for (int k = 0; k < WALK_ROWS; ++k) {
        if (r[k].z <= ty && ty <= r[k].w) {
          s_span[pos] = r[k].x | (r[k].y << 16);  // tx < MAX_GRID_W
          s_idx[pos] = i0 + tid * WALK_ROWS + k;
          ++pos;
        }
      }
      __syncthreads();
      for (int tx = warp; tx < P.grid_w; tx += N_WARPS) {
        int done = s_done[tx];
        for (int k0 = 0; k0 < m; k0 += 32) {
          const int k = k0 + lane;
          const int sp = k < m ? s_span[k] : 0;
          const bool hit = k < m && (sp & 0xFFFF) <= tx && tx <= (sp >> 16);
          const unsigned b = __ballot_sync(FULL, hit);
          if (hit) {
            const int j = s_start[tx] + done + __popc(b & lt);
            const int w = s_idx[k];
            P.pair_rows[j] = P.wrow[w];
            P.rec_ext[2 * j] = P.wrec[2 * w];
            P.rec_ext[2 * j + 1] = P.wrec[2 * w + 1];
          }
          done += __popc(b);
        }
        if (lane == 0) s_done[tx] = done;
      }
    }
    __syncthreads();  // s_start, s_done are rewritten for the next row
  }

  // 3. the sorted records of the live prefix, chunks taken as blocks free up
  for (;;) {
    if (tid == 0) s_next = atomicAdd(P.work, GATHER_CHUNK);
    __syncthreads();
    const int c0 = s_next;
    __syncthreads();  // s_next is rewritten next round
    if (c0 >= we) break;
    int4 a[GATHER_ROWS], b[GATHER_ROWS];
#pragma unroll
    for (int k = 0; k < GATHER_ROWS; ++k) {
      const int i = c0 + k * THREADS + tid;
      if (i < we)
        load_record(P.comb, min(max(P.order[i], 0), P.s_rows - 1), &a[k],
                    &b[k]);
    }
#pragma unroll
    for (int k = 0; k < GATHER_ROWS; ++k) {
      const int i = c0 + k * THREADS + tid;
      if (i < we) {
        P.rec_sorted[2 * (size_t)i] = a[k];
        P.rec_sorted[2 * (size_t)i + 1] = b[k];
      }
    }
  }
}

}  // namespace

extern "C" int ash_front_meta(const int* comb, const int* order,
                              const int* bounds, void* rects, int* wrow,
                              int* wrec, int* tile_cnt, int* row_cnt,
                              int* chunk_sums, int* work, int* meta,
                              int* pair_rows, int* pair_starts, int* rmeta,
                              int* rec_sorted, int* rec_ext, int n_tiles,
                              int grid_w, int tile_h, int row0, int py_lo,
                              int py_hi, int width, int height, int ss,
                              int min_c, int wide_rows, int wide_pairs,
                              int s_rows, void* stream) {
  MetaParams P{comb,          order,        bounds,
               (int4*)rects,  wrow,         (int4*)wrec,
               tile_cnt,      row_cnt,      chunk_sums,
               work,          meta,         pair_rows,
               pair_starts,   (int2*)rmeta, (int4*)rec_sorted,
               (int4*)rec_ext, n_tiles,     grid_w,
               tile_h,        row0,         py_lo,
               py_hi,         width,        height,
               ss,            min_c,        wide_rows,
               wide_pairs,    s_rows};
  int blocks = 0;
  const int rc = ash::coop_grid(front_meta_kernel, THREADS, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)front_meta_kernel,
                                          dim3(blocks), dim3(THREADS), args, 0,
                                          (cudaStream_t)stream);
}
