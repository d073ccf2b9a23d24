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
// A clipping slot is one warp's dependent chain of 6 planes, so the clip's
// instruction count is its latency: placing each plane's output with a
// select over the 12 x 12 (slot, position) pairs, ~1,700 instructions a
// plane, held the fan pass ~30 us where the other passes take ~8
// (experiments/torch_front_variants.py; PERF.md has the times of that
// design, three launches, and of this one).
//
// Exactness, as the plain chain computes it:
// * the select-accumulate placement turns every emitted value v into
//   0.0f + v (so -0.0 becomes +0.0) and leaves unused slots +0.0;
// * t = d_a * recip_spec(d_a - d_b), inter = v_a + t * (v_b - v_a), each
//   op rounded (fmul / fadd / fsub under --fmad=false), a non-finite
//   inter set to 0;
// * snap with recip_spec(w) (non-finite -> 0), snap_coord and
//   quantize_depth, as K1's corner();
// * a dead slot (no candidate) or fan index (j + 2 >= count) is a row of
//   zeroed fields: its packed coordinates are (0 - min_c) twice.
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
constexpr int THREADS = 256;
constexpr int COUNT_ITERS = 16;
constexpr int CHUNK = THREADS * COUNT_ITERS;  // ops/clip_tail.CHUNK
constexpr int N_WARPS = THREADS / 32;
constexpr int N_TBL = 16;    // table channels: clip x, y, z, w + 12 attrs
constexpr int ATTR = 12;
constexpr int POLY = 12;     // polygon slots (geometry.POLY_SLOTS)
constexpr int FAN = 7;       // fan triangles a polygon (MAX_CLIP_TRIS)
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

// sum of v over the block; every thread gets it
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < N_WARPS; ++w) s += red[w];
  return s;
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
  int width, height, min_c, max_cx, max_cy, ss;
  float gx, gy;
  KeyWindow win;
};

// plane p's signed distance (geometry._plane_dists: near z, far w - z,
// left gx * w + x, right gx * w - x, top gy * w + y, bottom gy * w - y),
// each the same rounded ops, chosen by selects, not a branch
__device__ __forceinline__ float plane_dist(int p, float x, float y, float z,
                                            float w, float gx, float gy) {
  const float gw = fmul(p < 4 ? gx : gy, w), c = p < 4 ? x : y;
  const float side = (p & 1) ? fsub(gw, c) : fadd(gw, c);
  return p == 0 ? z : (p == 1 ? fsub(w, z) : side);
}

struct Snap {
  int x, y, zq;
  float iw;
};

// geometry._snap_corner of a polygon vertex (clip x, y, z, w)
__device__ __forceinline__ Snap snap(const float* v, const FanParams& P) {
  const float iw_raw = recip_spec(v[3]);
  const float iw = finite(iw_raw) ? iw_raw : 0.0f;
  auto nd = [&](float a) {
    const float r = fmul(a, iw);
    return finite(r) ? r : 0.0f;
  };
  Snap s;
  s.x = snap_coord(nd(v[0]), P.width, P.ss, P.min_c, P.max_cx);
  s.y = snap_coord(nd(v[1]), P.height, P.ss, P.min_c, P.max_cy);
  s.zq = quantize_depth(nd(v[2]));
  s.iw = iw;
  return s;
}

__global__ void __launch_bounds__(THREADS) clip_tail_kernel(FanParams P) {
  __shared__ int red[N_WARPS];
  __shared__ int wsum[COUNT_ITERS][N_WARPS];
  __shared__ float poly[SLOTS][POLY][N_TBL];
  __shared__ int hdr[SLOTS][FAN][HDR];
  __shared__ int poly_n[SLOTS];
  __shared__ unsigned row_valid[SLOTS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
    int c_clip = 0, c_valid = 0, c_fast = 0;
    int f[COUNT_ITERS];  // loaded at once: COUNT_ITERS loads in flight
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) {
      const int i = base + k * THREADS + tid;
      f[k] = i < n ? flags[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) {
      c_valid += __popc(__ballot_sync(FULL, f[k] & 1));
      c_clip += __popc(__ballot_sync(FULL, (f[k] >> 1) & 1));
      c_fast += __popc(__ballot_sync(FULL, (f[k] >> 2) & 1));
    }
    // each lane holds its warp's counts: one lane a warp contributes
    const bool lead = lane == 0;
    c_clip = block_sum(lead ? c_clip : 0, red);
    c_valid = block_sum(lead ? c_valid : 0, red);
    c_fast = block_sum(lead ? c_fast : 0, red);
    if (tid == 0) {
      counts[c * N_COUNTS + 0] = c_clip;
      counts[c * N_COUNTS + 1] = c_valid;
      counts[c * N_COUNTS + 2] = c_fast;
    }
  }
  grid.sync();

  // 2. the first `budget` candidates in ascending row order into sel, -1
  // fill; block 0 also writes the counters
  if (blockIdx.x == 0) {
    int clip = 0, valid = 0, fast = 0;
    for (int i = tid; i < n_chunks; i += THREADS) {
      clip += counts[i * N_COUNTS + 0];
      valid += counts[i * N_COUNTS + 1];
      fast += counts[i * N_COUNTS + 2];
    }
    clip = block_sum(clip, red);
    valid = block_sum(valid, red);
    fast = block_sum(fast, red);
    const int kept = min(clip, budget);
    for (int i = kept + tid; i < budget; i += THREADS) sel[i] = -1;
    if (tid == 0) {
      counters[C_CLIPPED] = clip;
      counters[C_OVERFLOW] = clip - kept;
      counters[C_VALID] = valid;
      counters[C_FAST] = fast;
    }
  }
  // a chunk's flags are loaded at once and ranked by their warps' ballots
  // in row order (iteration k, then warp, then lane), one block sync a chunk
  const unsigned lt = (1u << lane) - 1u;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    if (counts[c * N_COUNTS] == 0) continue;
    int before = 0;  // candidates in the chunks before this one
    for (int i = tid; i < c; i += THREADS) before += counts[i * N_COUNTS];
    before = block_sum(before, red);
    if (before >= budget) continue;
    const int base = c * CHUNK;
    bool f[COUNT_ITERS];
    unsigned b[COUNT_ITERS];
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) {
      const int i = base + k * THREADS + tid;
      f[k] = i < n && ((flags[i] >> 1) & 1);
    }
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) {
      b[k] = __ballot_sync(FULL, f[k]);
      if (lane == 0) wsum[k][warp] = __popc(b[k]);
    }
    __syncthreads();
    int run = before;
#pragma unroll
    for (int k = 0; k < COUNT_ITERS; ++k) {
      int off = 0, total = 0;
#pragma unroll
      for (int w = 0; w < N_WARPS; ++w) {
        off += w < warp ? wsum[k][w] : 0;
        total += wsum[k][w];
      }
      const int pos = run + off + __popc(b[k] & lt);
      if (f[k] && pos < budget) sel[pos] = base + k * THREADS + tid;
      run += total;
    }
    __syncthreads();  // wsum is rewritten for the next chunk
  }
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
      int count = 3;
#pragma unroll 1
      for (int p = 0; p < 6; ++p) {
        float d[POLY];
#pragma unroll
        for (int s = 0; s < POLY; ++s)
          d[s] = plane_dist(p, __shfl_sync(gmask, buf[s], 0, N_TBL),
                            __shfl_sync(gmask, buf[s], 1, N_TBL),
                            __shfl_sync(gmask, buf[s], 2, N_TBL),
                            __shfl_sync(gmask, buf[s], 3, N_TBL), P.gx, P.gy);
        // edge s -> next(s): what it emits and where (exclusive prefix)
        float inter[POLY];
        int pos_a[POLY], pos_i[POLY];
        unsigned a_in = 0, cross = 0;
        int offs = 0;
#pragma unroll
        for (int s = 0; s < POLY; ++s) {
          const bool in_poly = s < count;
          const bool wrap = s + 1 >= count;
          const float db = wrap ? d[0] : d[(s + 1) % POLY];
          const float vb = wrap ? buf[0] : buf[(s + 1) % POLY];
          const bool ai = d[s] >= 0.0f && in_poly;
          const bool cr = ((d[s] >= 0.0f) != (db >= 0.0f)) && in_poly;
          const float t = fmul(d[s], recip_spec(fsub(d[s], db)));
          const float iv = fadd(buf[s], fmul(t, fsub(vb, buf[s])));
          inter[s] = finite(iv) ? iv : 0.0f;
          pos_a[s] = offs;
          pos_i[s] = offs + (ai ? 1 : 0);
          offs += (ai ? 1 : 0) + (cr ? 1 : 0);
          a_in |= (ai ? 1u : 0u) << s;
          cross |= (cr ? 1u : 0u) << s;
        }
        // placement: each emitted vertex at its position, as 0.0f + v, the
        // unused slots +0.0.  The positions are 0 .. offs - 1, each taken
        // once, so the lane scatters its channel's values into its column
        // of the slot's polygon in shared memory and reads them back in
        // order (positions past the POLY slots are dropped, as a select
        // over the slots drops them)
#pragma unroll
        for (int s = 0; s < POLY; ++s) {
          if (((a_in >> s) & 1) && pos_a[s] < POLY)
            poly[g][pos_a[s]][ch] = buf[s];
          if (((cross >> s) & 1) && pos_i[s] < POLY)
            poly[g][pos_i[s]][ch] = inter[s];
        }
#pragma unroll
        for (int q = 0; q < POLY; ++q)
          buf[q] = q < offs ? fadd(0.0f, poly[g][q][ch]) : 0.0f;
        count = count > 0 ? offs : 0;
      }
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
      const bool alive = j + 2 < poly_n[g];
      Snap A{0, 0, 0, 0.0f}, B = A, C = A;
      int mat = 0;
      if (alive) {
        A = snap(poly[g][0], P);
        B = snap(poly[g][j + 1], P);
        C = snap(poly[g][j + 2], P);
        mat = tri_mat[min(si, P.n_tris - 1)];
      }
      const int sl = wsub(wmul(wsub(B.x, A.x), wsub(C.y, A.y)),
                          wmul(wsub(B.y, A.y), wsub(C.x, A.x)));
      valid = alive && sl < 0;
      const int area2 = valid ? wsub(0, sl) : 1;
      const float inv_area2 = recip_spec(i2f(area2));
      auto zi = [&](int v) { return valid ? v : 0; };
      const int off = -P.min_c;
      // winding rewind (a, c, b); coordinates zeroed before the +off pack
      int* h = hdr[g][j];
      h[0] = pack16(zi(A.x) + off, zi(A.y) + off);
      h[1] = pack16(zi(C.x) + off, zi(C.y) + off);
      h[2] = pack16(zi(B.x) + off, zi(B.y) + off);
      h[3] = zi(pack16(A.zq, C.zq));
      h[4] = zi(B.zq);
      h[5] = zi(bits(inv_area2));
      h[6] = zi(bits(A.iw));
      h[7] = zi(bits(C.iw));
      h[8] = zi(bits(B.iw));
      h[9] = zi(mat);
      if (slot < P.budget) {
        const PixelBox box = pixel_box(
            zi(min(min(A.x, B.x), C.x)), zi(max(max(A.x, B.x), C.x)),
            zi(min(min(A.y, B.y), C.y)), zi(max(max(A.y, B.y), C.y)), P.ss,
            P.width, P.height);
        keys[slot * FAN + j] = stream_key(valid, box, P.win);
      }
    }
    const unsigned vb = __ballot_sync(FULL, valid) & gmask;
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
  FanParams P{flags,  tblT,   tri_v,  tri_mat, scratch, comb_tail, keys,
              n_verts, n_tris, budget, n_tris,  width,   height,    min_c,
              max_cx, max_cy, ss,     gx,      gy,
              KeyWindow{row0, py_lo, py_hi, tile_h, grid_w, n_tiles}};
  int blocks = 0;
  const int rc = ash::coop_grid(clip_tail_kernel, THREADS, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)clip_tail_kernel,
                                          dim3(blocks), dim3(THREADS), args, 0,
                                          (cudaStream_t)stream);
}
