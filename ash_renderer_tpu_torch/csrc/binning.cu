// K12: the classic route's binning in one cooperative launch with no host
// read.  From K10's setup table (rtypes.SETUP_ROW_FIELDS, (S, 20) int32)
// and its valid flags, for a tile-row window, it writes every kept
// triangle-tile pair's record (14 int32 words, inv_area2, the pixel box:
// ops/binning.py documents the layout), each tile's start and count, and
// the counters pairs_total and pairs_overflow.  The plain torch version is
// ash_renderer_tpu_torch/ops/binning.py:bin_triangles_plain.
//
// It replaces no Pallas kernel.  The reference runs binning as XLA glue
// under one jit (ash_renderer_tpu/ops/binning.py:73-168, called at
// ash_renderer_tpu/pipeline.py:694): a cumsum, a searchsorted of every
// pair slot, a sort of the pairs by tile and a row gather, which eager
// torch pays as ~60 launches and ~3 ms of host issue a frame.
//
// What it computes, rule for rule as the plain version does:
// * per setup row: the pixel AABB (binsort.cuh pixel_box), its rows clamped
//   to the window, live = valid && the box is not empty, the tile
//   rectangle with tile rows counted from the window's first, and its
//   pair count ntx * nty;
// * pair k of a row (k row-major in its rectangle: dy = k / ntx,
//   dx = k % ntx) has the global index offset + k, offset the exclusive
//   prefix of the counts in row order; only indices below max_pairs are
//   kept, so the row that straddles the budget keeps its first pairs;
// * a tile's records in pair-index order, which is row order (a row meets
//   a tile at most once): the order of a stable sort by tile;
// * the record's words as the plain version's, the edge values E0c, E1c
//   at the tile's first sample and E2c = area2 - E0c - E1c in wrapping
//   int32 (wmul / wadd / wsub: signed overflow is undefined in C++);
// * every column past the kept pairs zero in all 16 record rows.
//
// What bounds it: bytes, and few of them (each setup row's 11 words and
// its valid byte read once, 16 words a record column and 2 a tile
// written: ~2.4 MB at the gate frame, under a microsecond at 3.35 TB/s),
// so its time is the launch and the latency of the dependent steps.
// Most setup rows are dead clip slots: a dead row costs its valid byte.
// The design is K9's (front_meta.cu): one launch, its grid sized from the
// occupancy and never from the data, the steps split by two grid syncs:
//
// 0. rows: chunks of THREADS rows, a row a thread: each chunk's pair and
//    live-row totals; the tile counts start at 0;
//    -- grid sync --
// 1. the cut: each row's offset from the totals of the chunks before its
//    own and a block scan, its kept pairs, the live rows compacted in row
//    order (rectangle, row index, kept pairs), and atomic adds of the kept
//    pairs, spread over the chunk's threads, into tile_count;
//    -- grid sync --
// 2. every block zeroes its share of the dead columns and the counters
//    are written; then a block a tile row: tile_start from the counts
//    before its row, then it walks the compacted rows with kept pairs in
//    row order, WALK rows a step, stages those with a kept pair in its row
//    in shared memory, and one warp a tile writes the records of the ones
//    that cover its tile after those it wrote before.
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
constexpr int MAX_GRID_W = 512;  // tiles a row (ops/binning.MAX_GRID_W)
constexpr int WALK_ROWS = 4;     // compacted rows a thread per walk step
constexpr int WALK = WALK_ROWS * THREADS;
// the setup table (rtypes.SETUP_ROW_FIELDS): 20 words a row
constexpr int SETUP_COLS = 20;
// the record rows: 0-13 the int32 words, 14 inv_area2, 15 the box
constexpr int REC_ROWS = 16;
constexpr int BOX_COL1 = 7, BOX_ROW0 = 14, BOX_ROW1 = 18;  // binning.pack_box
// per chunk of rows: pairs, live rows, rows with kept pairs
constexpr int C_PAIRS = 0, C_LIVE = 1, C_FIT = 2, N_CHUNK_SUMS = 3;

struct BinParams {
  const int* rows;              // (s_rows, SETUP_COLS)
  const unsigned char* valid;   // (s_rows,)
  int4* crect;                  // (s_rows,) scratch: live rows' rectangles
  int2* cmeta;                  // (s_rows,) scratch: their row, kept pairs
  int* chunk_sums;              // (n_chunks * N_CHUNK_SUMS,) scratch
  int* rec;                     // (REC_ROWS, max_pairs)
  int* tile_start;              // (n_tiles,)
  int* tile_count;              // (n_tiles,)
  int* stats;                   // pairs_total, pairs_overflow
  int s_rows, max_pairs, n_tiles, grid_w, tile_w, tile_h, row0, py_lo, py_hi;
  int width, height, ss;
};

// a row's pixel AABB, its rows clamped to the window (pixel_aabb_of, then
// bin_triangles_plain's clamps); x0 y0 x1 y1 in a, x2 y2 in b.x, b.y
__device__ __forceinline__ PixelBox window_box(const int4& a, int bx, int by,
                                               const BinParams& P) {
  PixelBox pb = pixel_box(min(min(a.x, a.z), bx), max(max(a.x, a.z), bx),
                          min(min(a.y, a.w), by), max(max(a.y, a.w), by),
                          P.ss, P.width, P.height);
  pb.pymin = max(pb.pymin, P.py_lo);
  pb.pymax = min(pb.pymax, P.py_hi);
  return pb;
}

// row i's tile rectangle in the window (tx0, tx1, ty0, ty1); (0, -1, 0,
// -1) for a row that is invalid, past the table or empty after the clamps.
// A dead row reads its valid byte alone
__device__ __forceinline__ int4 row_rect(const BinParams& P, int i) {
  const int4 dead = make_int4(0, -1, 0, -1);
  if (i >= P.s_rows || !P.valid[i]) return dead;
  const int* r = P.rows + (size_t)i * SETUP_COLS;
  const int4 a = *reinterpret_cast<const int4*>(r);
  const int2 b = *reinterpret_cast<const int2*>(r + 4);
  const PixelBox pb = window_box(a, b.x, b.y, P);
  if (pb.pxmax < pb.pxmin || pb.pymax < pb.pymin) return dead;
  return make_int4(floordiv(pb.pxmin, P.tile_w), floordiv(pb.pxmax, P.tile_w),
                   floordiv(pb.pymin, P.tile_h) - P.row0,
                   floordiv(pb.pymax, P.tile_h) - P.row0);
}

__device__ __forceinline__ int pairs_of(const int4& r) {
  return (r.y - r.x + 1) * (r.w - r.z + 1);
}

// the record of setup row `row` in tile (tx, ty) of the window, at column
// `slot`: bin_triangles_plain's 14 words, inv_area2's bits and the box
__device__ __forceinline__ void write_record(const BinParams& P, int row,
                                             int tx, int ty, int slot) {
  const int* r = P.rows + (size_t)row * SETUP_COLS;
  const int4 a = *reinterpret_cast<const int4*>(r);       // x0 y0 x1 y1
  const int4 b = *reinterpret_cast<const int4*>(r + 4);   // x2 y2 inv_area2 -
  const int4 c = *reinterpret_cast<const int4*>(r + 12);  // - - area2 zq0
  const int4 d = *reinterpret_cast<const int4*>(r + 16);  // zq1 zq2 - -
  const Edge e0 = edge_coeffs(a.z, a.w, b.x, b.y);
  const Edge e1 = edge_coeffs(b.x, b.y, a.x, a.y);
  const Edge e2 = edge_coeffs(a.x, a.y, a.z, a.w);
  const int tl = (e0.bias == 0) | ((e1.bias == 0) << 1) | ((e2.bias == 0) << 2);
  const int px0 = tx * P.tile_w, py0 = (ty + P.row0) * P.tile_h;
  const int half = P.ss / 2;
  const int sx = wadd(wmul(px0, P.ss), half), sy = wadd(wmul(py0, P.ss), half);
  const int e0c = edge_at(e0.a, e0.b, a.z, a.w, sx, sy);
  const int e1c = edge_at(e1.a, e1.b, b.x, b.y, sx, sy);
  const int e2c = wsub(wsub(c.z, e0c), e1c);
  // the box as the plain version packs and unpacks it: the AABB as
  // min | max << 16 words, the max back through an arithmetic >>
  const PixelBox pb = window_box(a, b.x, b.y, P);
  const int xr = pb.pxmin | (int)((uint32_t)pb.pxmax << 16);
  const int yr = pb.pymin | (int)((uint32_t)pb.pymax << 16);
  const int col0 = max((xr & 0xFFFF) - px0, 0);
  const int col1 = min((xr >> 16) - px0, P.tile_w - 1);
  const int brow0 = max((yr & 0xFFFF) - py0, 0);
  const int brow1 = min((yr >> 16) - py0, P.tile_h - 1);
  const int box = col0 | (col1 << BOX_COL1) | (brow0 << BOX_ROW0)
                  | (brow1 << BOX_ROW1);
  const int w[REC_ROWS] = {e0.a, e0.b, e1.a, e1.b, e2.a, e2.b, e0c, e1c, e2c,
                           c.w,  d.x,  d.y,  row,  tl,   b.z,  box};
  int* out = P.rec + slot;
#pragma unroll
  for (int k = 0; k < REC_ROWS; ++k) out[(size_t)k * P.max_pairs] = w[k];
}

__global__ void __launch_bounds__(THREADS) bin_kernel(BinParams P) {
  __shared__ int red[N_WARPS];
  __shared__ union {
    struct {
      int4 rect[THREADS];  // a chunk's rectangles
      int kincl[THREADS];  // the inclusive prefix of their kept pairs
    } cut;                 // step 1
    struct {
      int span[WALK];      // staged rows' kept tiles: tx0 | tx1 << 16
      int row[WALK];       // staged rows' setup row index
    } walk;                // step 2
  } S;
  __shared__ int s_start[MAX_GRID_W];
  __shared__ int s_done[MAX_GRID_W];  // per tile: records written
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (P.s_rows + THREADS - 1) / THREADS;
  const int tile_rows = P.n_tiles / P.grid_w;

  // 0. the tile counts start at 0; each chunk's pairs and live rows
  for (int t = blockIdx.x * THREADS + tid; t < P.n_tiles;
       t += gridDim.x * THREADS)
    P.tile_count[t] = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int4 r = row_rect(P, c * THREADS + tid);
    const int pairs = block_sum<THREADS>(pairs_of(r), red);
    const int live = block_sum<THREADS>(r.y >= r.x ? 1 : 0, red);
    if (tid == 0) {
      P.chunk_sums[c * N_CHUNK_SUMS + C_PAIRS] = pairs;
      P.chunk_sums[c * N_CHUNK_SUMS + C_LIVE] = live;
    }
  }
  grid.sync();

  // 1. the cut; the live rows compacted; the kept pairs counted a tile,
  // spread over the chunk's threads a pair a thread at a time (a row's
  // pairs are one thread's otherwise)
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int pairs_before =
        block_sum_of<THREADS>(P.chunk_sums, c, N_CHUNK_SUMS, C_PAIRS, red);
    const int live_before =
        block_sum_of<THREADS>(P.chunk_sums, c, N_CHUNK_SUMS, C_LIVE, red);
    const int i = c * THREADS + tid;
    const int4 r = row_rect(P, i);
    const int cnt = pairs_of(r);
    int all;
    const int offset = pairs_before + block_scan<THREADS>(cnt, red, &all);
    const int kept = min(max(P.max_pairs - offset, 0), cnt);
    const int pos = live_before + block_scan<THREADS>(cnt > 0, red, &all);
    if (cnt > 0) {
      P.crect[pos] = r;
      P.cmeta[pos] = make_int2(i, kept);
    }
    int kept_all;
    const int kincl = block_scan<THREADS>(kept, red, &kept_all) + kept;
    const int n_fit = block_sum<THREADS>(kept > 0, red);
    if (tid == 0) P.chunk_sums[c * N_CHUNK_SUMS + C_FIT] = n_fit;
    S.cut.rect[tid] = r;
    S.cut.kincl[tid] = kincl;
    __syncthreads();
    for (int j = tid; j < kept_all; j += THREADS) {
      // the chunk's kept pair j: the first row whose inclusive end is past
      // j (a row with no kept pair never is)
      int lo = 0, hi = THREADS - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (S.cut.kincl[mid] > j) hi = mid;
        else lo = mid + 1;
      }
      const int4 q = S.cut.rect[lo];
      const int ntx = q.y - q.x + 1;
      const int o = j - (lo > 0 ? S.cut.kincl[lo - 1] : 0);
      const int dy = o / ntx, dx = o - dy * ntx;
      atomicAdd(&P.tile_count[(q.z + dy) * P.grid_w + q.x + dx], 1);
    }
    __syncthreads();  // the staging is rewritten for the next chunk
  }
  grid.sync();

  // 2. every block: the cut's totals, its share of the dead columns; then
  // its tile rows
  const int n_fit =
      block_sum_of<THREADS>(P.chunk_sums, n_chunks, N_CHUNK_SUMS, C_FIT, red);
  const int total = block_sum_of<THREADS>(P.chunk_sums, n_chunks,
                                          N_CHUNK_SUMS, C_PAIRS, red);
  const int n_kept = min(total, P.max_pairs);
  if (blockIdx.x == 0 && tid == 0) {
    P.stats[0] = total;
    P.stats[1] = max(total - P.max_pairs, 0);
  }
  const long long tail = P.max_pairs - n_kept;
  for (long long k = (long long)blockIdx.x * THREADS + tid; k < REC_ROWS * tail;
       k += (long long)gridDim.x * THREADS)
    P.rec[(k / tail) * P.max_pairs + n_kept + k % tail] = 0;

  const unsigned lt = (1u << lane) - 1u;
  for (int ty = blockIdx.x; ty < tile_rows; ty += gridDim.x) {
    const int t0 = ty * P.grid_w;
    const int base = block_sum_of<THREADS>(P.tile_count, t0, 1, 0, red);
    const int cnt = tid < P.grid_w ? P.tile_count[t0 + tid] : 0;
    int row_all;
    const int start = base + block_scan<THREADS>(cnt, red, &row_all);
    if (tid < P.grid_w) {
      s_start[tid] = start;
      s_done[tid] = 0;
      P.tile_start[t0 + tid] = start;
    }
    __syncthreads();
    // the rows with kept pairs, WALK_ROWS consecutive ones a thread a
    // step: those with a kept pair in this tile row are staged in row
    // order with the span of their kept tiles in it
    for (int i0 = 0; i0 < n_fit; i0 += WALK) {
      int span[WALK_ROWS], row[WALK_ROWS];
      int n_on = 0;
#pragma unroll
      for (int k = 0; k < WALK_ROWS; ++k) {
        const int i = i0 + tid * WALK_ROWS + k;
        span[k] = -1;
        row[k] = 0;
        if (i < n_fit) {
          const int4 q = P.crect[i];
          const int2 m = P.cmeta[i];
          const int ntx = q.y - q.x + 1;
          // the row's kept pairs from this tile row's first on
          const int rem = m.y - (ty - q.z) * ntx;
          if (q.z <= ty && ty <= q.w && rem > 0) {
            span[k] = q.x | ((q.x + min(ntx, rem) - 1) << 16);  // < 2^15
            row[k] = m.x;
            ++n_on;
          }
        }
      }
      int m;  // block_scan syncs: the last step's readers are done
      int pos = block_scan<THREADS>(n_on, red, &m);
#pragma unroll
      for (int k = 0; k < WALK_ROWS; ++k) {
        if (span[k] >= 0) {
          S.walk.span[pos] = span[k];
          S.walk.row[pos] = row[k];
          ++pos;
        }
      }
      __syncthreads();
      for (int tx = warp; tx < P.grid_w; tx += N_WARPS) {
        int done = s_done[tx];
        for (int k0 = 0; k0 < m; k0 += 32) {
          const int k = k0 + lane;
          const int sp = k < m ? S.walk.span[k] : 0;
          const bool hit = k < m && (sp & 0xFFFF) <= tx && tx <= (sp >> 16);
          const unsigned bal = __ballot_sync(FULL, hit);
          if (hit)
            write_record(P, S.walk.row[k], tx, ty,
                         s_start[tx] + done + __popc(bal & lt));
          done += __popc(bal);
        }
        if (lane == 0) s_done[tx] = done;
      }
    }
    __syncthreads();  // s_start, s_done are rewritten for the next row
  }
}

}  // namespace

extern "C" int ash_bin_triangles(const int* rows, const void* valid,
                                 void* crect, void* cmeta, int* chunk_sums,
                                 int* rec, int* tile_start, int* tile_count,
                                 int* stats, int s_rows, int max_pairs,
                                 int n_tiles, int grid_w, int tile_w,
                                 int tile_h, int row0, int py_lo, int py_hi,
                                 int width, int height, int ss,
                                 void* stream) {
  BinParams P{rows,
              static_cast<const unsigned char*>(valid),
              static_cast<int4*>(crect),
              static_cast<int2*>(cmeta),
              chunk_sums,
              rec,
              tile_start,
              tile_count,
              stats,
              s_rows,
              max_pairs,
              n_tiles,
              grid_w,
              tile_w,
              tile_h,
              row0,
              py_lo,
              py_hi,
              width,
              height,
              ss};
  int blocks = 0;
  const int rc = ash::coop_grid(bin_kernel, THREADS, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)bin_kernel,
                                          dim3(blocks), dim3(THREADS), args, 0,
                                          (cudaStream_t)stream);
}
