// K6: the fused route's clip tail in one cooperative launch with no host
// read: count the clip candidates, select the first clip_budget of them,
// then clip, fan, snap and pack each.  The plain torch version is
// ash_renderer_tpu_torch/ops/clip_tail.py:clip_tail_plain
// (geometry.clip_tail_fused, tritables.comb_rows, binsort.stream_keys).
//
// It replaces no Pallas kernel.  The reference's clip tail is XLA glue
// under one jit (ash_renderer_tpu/pipeline.py:416-447), which XLA fuses;
// eager torch pays ~1,200 launches and two host reads for the same chain
// over the whole budget.
//
// Bound by bytes it barely moves: ~20 MB (the flags, the selected corners'
// table rows, 7 x budget comb rows of 512 bytes and their keys), a few
// microseconds at 3.35 TB/s, which three launch floors already exceed.  So
// the design is one launch, its grid sized from the occupancy, in three
// grid-stride passes split by grid syncs:
//
// 1. count: each chunk of CHUNK flags' clip candidates (bit 1), valid rows
//    (bit 0) and fast rows (bit 2), by warp ballots;
//    -- grid sync --
// 2. select: each chunk's first-candidate rank from the counts of the
//    chunks before it, its candidates written into sel in ascending order
//    while the rank is under the budget; block 0 writes the -1 fill and
//    the counters (the fan adds the tail's valid rows);
//    -- grid sync --
// 3. fan: SLOTS budget slots a block at a time, 16 lanes a slot, one per
//    table channel, each keeping its channel of the 12 polygon slots in
//    registers (the plane distances are computed by every lane of the slot
//    from the x, y, z, w lanes' values) and placing each plane's output
//    through its column of the slot's polygon in shared memory; then 7
//    lanes fan, snap, cull and rewind the slot's triangles, and the 16
//    write its 7 comb rows and keys.
//
// The select, the guard planes, Sutherland-Hodgman, the snap and the fan
// cull are clip.cuh's, which K10 (geometry.cu) runs too; it says how each
// follows the plain chain bit for bit.  A dead slot (no candidate) or fan
// index (j + 2 >= count) is a row of zeroed fields: its packed coordinates
// are (0 - min_c) twice.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "binsort.cuh"
#include "clip.cuh"
#include "coop.cuh"
#include "specmath.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ash;

using clip::ATTR;
using clip::FAN;
using clip::N_TBL;
using clip::POLY;
constexpr int THREADS = 256;
constexpr int COUNT_ITERS = 16;
constexpr int CHUNK = THREADS * COUNT_ITERS;  // ops/clip_tail.CHUNK
constexpr int N_WARPS = THREADS / 32;
constexpr int HDR = 10;      // comb columns 0-9
constexpr int SLOTS = THREADS / N_TBL;  // budget slots a block at a time
// the scratch (ops/clip_tail): the counters (ops/clip_tail.COUNTERS), then
// the per-chunk counts, then sel
constexpr int C_CLIPPED = 0, C_OVERFLOW = 1, C_VALID = 2, C_FAST = 3;
constexpr int N_COUNTERS = 4;
constexpr int N_COUNTS = 3;  // per chunk: clip candidates, valid, fast

__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)((uint32_t)lo | ((uint32_t)hi << 16));
}

struct FanParams {
  const int* flags;
  const int* tblT;
  const int* tri_v;
  const int* tri_mat;
  int* scratch;
  int* comb;  // the tail rows
  int* keys;
  int n_verts, n_tris, budget, id_base;
  clip::SnapCfg snap;
  float gx, gy;
  KeyWindow win;
};

__global__ void __launch_bounds__(THREADS) clip_tail_kernel(FanParams P) {
  __shared__ int red[N_WARPS];
  __shared__ int wsum[COUNT_ITERS][N_WARPS];
  __shared__ float poly[SLOTS][POLY][N_TBL];
  __shared__ int hdr[SLOTS][FAN][HDR];
  __shared__ int poly_n[SLOTS];
  __shared__ unsigned row_valid[SLOTS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int n = P.n_tris, budget = P.budget;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const int* flags = P.flags;
  const int* tblT = P.tblT;
  const int* tri_v = P.tri_v;
  const int* tri_mat = P.tri_mat;
  int* counters = P.scratch;
  int* counts = P.scratch + N_COUNTERS;
  int* sel = counts + N_COUNTS * n_chunks;
  int* comb = P.comb;
  int* keys = P.keys;

  // 1. per chunk: the clip candidates, valid rows and fast rows
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int base = c * CHUNK;
    int f[COUNT_ITERS];  // loaded at once: COUNT_ITERS loads in flight
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) {
      const int i = base + k * THREADS + tid;
      f[k] = i < n ? flags[i] : 0;
    }
    clip::FlagCounts fc{0, 0, 0};
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) clip::add_flags(fc, f[k]);
    clip::store_counts<N_WARPS>(fc, c, counts, red);
  }
  grid.sync();

  // 2. the first `budget` candidates in ascending row order into sel, -1
  // fill; block 0 also writes the counters
  if (blockIdx.x == 0) {
    int n_clip = 0, valid = 0, fast = 0;
    for (int i = tid; i < n_chunks; i += THREADS) {
      n_clip += counts[i * N_COUNTS + 0];
      valid += counts[i * N_COUNTS + 1];
      fast += counts[i * N_COUNTS + 2];
    }
    n_clip = clip::block_sum<N_WARPS>(n_clip, red);
    valid = clip::block_sum<N_WARPS>(valid, red);
    fast = clip::block_sum<N_WARPS>(fast, red);
    const int kept = min(n_clip, budget);
    for (int i = kept + tid; i < budget; i += THREADS) sel[i] = -1;
    if (tid == 0) {
      counters[C_CLIPPED] = n_clip;
      counters[C_OVERFLOW] = n_clip - kept;
      counters[C_VALID] = valid;
      counters[C_FAST] = fast;
    }
  }
  clip::select_candidates<THREADS, COUNT_ITERS>(flags, n, counts, sel,
                                                budget, red, wsum);
  grid.sync();

  // 3. SLOTS budget slots at a time, N_TBL lanes a slot: Sutherland-Hodgman
  // against the 6 guard planes, the fan, and each slot's 7 comb rows and
  // keys
  const int n_groups = (budget + SLOTS - 1) / SLOTS;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int g = threadIdx.x / N_TBL;  // slot in the block
    const int ch = threadIdx.x % N_TBL;  // this lane's table channel
    const unsigned gmask = 0xFFFFu << (threadIdx.x & 16);
    const int slot = grp * SLOTS + g;
    const int si = slot < P.budget ? sel[slot] : -1;

    if (si >= 0) {
      const int tri = min(si, P.n_tris - 1);
      float buf[POLY];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int vi = min(max(tri_v[tri * 3 + k], 0), P.n_verts - 1);
        buf[k] = fbits(tblT[(size_t)ch * P.n_verts + vi]);
      }
#pragma unroll
      for (int s = 3; s < POLY; ++s) buf[s] = 0.0f;
      const int count =
          clip::clip_polygon(buf, gmask, ch, poly[g], P.gx, P.gy);
#pragma unroll
      for (int s = 0; s < POLY; ++s) poly[g][s][ch] = buf[s];
      if (ch == 0) poly_n[g] = count;
    } else if (ch == 0) {
      poly_n[g] = 0;
    }
    __syncthreads();

    // the fan: lane j < FAN makes triangle (0, j + 1, j + 2)
    bool valid = false;
    if (ch < FAN) {
      const int j = ch;
      const clip::FanTri T = clip::fan_tri(poly[g], poly_n[g], j, P.snap);
      const clip::Snap &A = T.a, &B = T.b, &C = T.c;
      const int mat = j + 2 < poly_n[g] ? tri_mat[min(si, P.n_tris - 1)] : 0;
      valid = T.valid;
      auto zi = [&](int v) { return valid ? v : 0; };
      const int off = -P.snap.min_c;
      // winding rewind (a, c, b); coordinates zeroed before the +off pack
      int* h = hdr[g][j];
      h[0] = pack16(zi(A.x) + off, zi(A.y) + off);
      h[1] = pack16(zi(C.x) + off, zi(C.y) + off);
      h[2] = pack16(zi(B.x) + off, zi(B.y) + off);
      h[3] = zi(pack16(A.zq, C.zq));
      h[4] = zi(B.zq);
      h[5] = zi(bits(T.inv_area2));
      h[6] = zi(bits(A.iw));
      h[7] = zi(bits(C.iw));
      h[8] = zi(bits(B.iw));
      h[9] = zi(mat);
      if (slot < P.budget) {
        const PixelBox box = pixel_box(
            zi(min(min(A.x, B.x), C.x)), zi(max(max(A.x, B.x), C.x)),
            zi(min(min(A.y, B.y), C.y)), zi(max(max(A.y, B.y), C.y)),
            P.snap.ss, P.snap.width, P.snap.height);
        keys[slot * FAN + j] = stream_key(valid, box, P.win);
      }
    }
    const unsigned vb = __ballot_sync(clip::FULL, valid) & gmask;
    if (ch == 0) {
      row_valid[g] = vb >> (threadIdx.x & 16);
      if (vb) atomicAdd(&counters[C_VALID], __popc(vb));
    }
    __syncthreads();

    // the slot's 7 rows, 128 columns each, 16 lanes a row
    if (slot < P.budget) {
      for (int r = 0; r < FAN; ++r) {
        const bool rv = (row_valid[g] >> r) & 1;
        const int row = slot * FAN + r;
        int* out = comb + (size_t)row * TBL_COLS;
#pragma unroll
        for (int m = 0; m < TBL_COLS / N_TBL; ++m) {
          const int col = m * N_TBL + ch;
          int v = 0;
          if (col < HDR) {
            v = hdr[g][r][col];
          } else if (col < HDR + 3 * ATTR) {
            // a_v0 | a_v1 | a_v2 = fan corners 0, 2, 1 = slots 0, r + 2, r + 1
            const int a = (col - HDR) / ATTR, k = (col - HDR) % ATTR;
            const int src = a == 0 ? 0 : (a == 1 ? r + 2 : r + 1);
            v = rv ? bits(poly[g][src][4 + k]) : 0;
          } else if (col == ID_COL) {
            v = P.id_base + row;
          }
          out[col] = v;
        }
      }
    }
    __syncthreads();  // poly, hdr and row_valid are rewritten next group
  }
}

}  // namespace

extern "C" int ash_clip_tail(const int* flags, const int* tblT,
                             const int* tri_v, const int* tri_mat,
                             int* scratch, int* comb_tail, int* keys,
                             int n_verts, int n_tris, int budget, int width,
                             int height, int min_c, int max_cx, int max_cy,
                             int ss, float gx, float gy, int row0, int py_lo,
                             int py_hi, int tile_h, int grid_w, int n_tiles,
                             void* stream) {
  FanParams P{flags,   tblT,   tri_v,  tri_mat,
              scratch, comb_tail, keys, n_verts,
              n_tris,  budget, n_tris,
              clip::SnapCfg{width, height, min_c, max_cx, max_cy, ss},
              gx,      gy,
              KeyWindow{row0, py_lo, py_hi, tile_h, grid_w, n_tiles}};
  int blocks = 0;
  const int rc = ash::coop_grid(clip_tail_kernel, THREADS, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)clip_tail_kernel,
                                          dim3(blocks), dim3(THREADS), args, 0,
                                          (cudaStream_t)stream);
}
