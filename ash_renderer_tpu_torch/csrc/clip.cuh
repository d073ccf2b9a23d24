// The clip path's device code, one definition for the fused route's clip
// tail K6 (clip_tail.cu) and the classic route's triangle setup K10
// (geometry.cu): the budgeted select of the first clip candidates, the
// guard planes, Sutherland-Hodgman with the reference's select-accumulate
// placement, the corner snap and the fan's cull.  Counterpart of
// ash_renderer_tpu_torch/ops/geometry.py (_select_budgeted,
// _plane_dists, _clip_polygons, _snap_corner, clip_fan_path,
// _finish_tri).
//
// Exactness, as the plain chain computes it:
// * the select-accumulate placement turns every emitted value v into
//   0.0f + v (so -0.0 becomes +0.0) and leaves unused slots +0.0;
// * t = d_a * recip_spec(d_a - d_b), inter = v_a + t * (v_b - v_a), each
//   op rounded (fmul / fadd / fsub under --fmad=false), a non-finite
//   inter set to 0;
// * snap with recip_spec(w) (non-finite -> 0), snap_coord and
//   quantize_depth, as K1's corner();
// * a fan index past the polygon (j + 2 >= count) is not alive.
#pragma once

#include <stdint.h>

#include "specmath.cuh"

namespace ash {
namespace clip {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int N_TBL = 16;   // channels a polygon vertex: clip x, y, z, w + 12 attrs
constexpr int ATTR = 12;
constexpr int POLY = 12;    // polygon slots (geometry.POLY_SLOTS)
constexpr int FAN = 7;      // fan triangles a polygon (MAX_CLIP_TRIS)
constexpr int MAX_VERTS = 9;  // geometry.MAX_CLIP_VERTS

// the snap's frame: geometry._snap_corner's cfg fields
struct SnapCfg {
  int width, height, min_c, max_cx, max_cy, ss;
};

// sum of v over a block of n_warps warps; every thread gets it
template <int N_WARPS>
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

// A chunk's row flags counted by warp ballots: clip candidates (bit 1),
// valid rows (bit 0) and fast rows (bit 2); each lane holds its warp's
// counts.
struct FlagCounts {
  int clip, valid, fast;
};

__device__ __forceinline__ void add_flags(FlagCounts& n, int f) {
  n.valid += __popc(__ballot_sync(FULL, f & 1));
  n.clip += __popc(__ballot_sync(FULL, (f >> 1) & 1));
  n.fast += __popc(__ballot_sync(FULL, (f >> 2) & 1));
}

// chunk c's counts summed over the block's warps, written by thread 0 at
// counts[c * 3]: clip candidates, valid rows, fast rows
template <int N_WARPS>
__device__ __forceinline__ void store_counts(const FlagCounts& n, int c,
                                             int* counts, int* red) {
  const bool lead = (threadIdx.x & 31) == 0;  // one lane a warp contributes
  const int c_clip = block_sum<N_WARPS>(lead ? n.clip : 0, red);
  const int c_valid = block_sum<N_WARPS>(lead ? n.valid : 0, red);
  const int c_fast = block_sum<N_WARPS>(lead ? n.fast : 0, red);
  if (threadIdx.x == 0) {
    counts[c * 3 + 0] = c_clip;
    counts[c * 3 + 1] = c_valid;
    counts[c * 3 + 2] = c_fast;
  }
}

// The first `budget` clip candidates (flag bit 1) in ascending row order
// into sel (geometry._select_budgeted), over blocks: each chunk
// of THREADS * ITERS rows ranks its candidates from the counts of the
// chunks before it (counts[i * 3]) and its warps' ballots, in row order
// (iteration k, then warp, then lane).  The -1 fill past the candidates is
// the caller's.  The chunks are split over `parts` blocks, this one
// `part` of them: one cluster's, or (the overload below) the grid's.
template <int THREADS, int ITERS>
__device__ __forceinline__ void select_candidates(
    const int* flags, int n, const int* counts, int* sel, int budget,
    int* red, int (*wsum)[THREADS / 32], int part, int parts) {
  constexpr int CHUNK = THREADS * ITERS;
  constexpr int W = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const unsigned lt = (1u << lane) - 1u;
  for (int c = part; c < n_chunks; c += parts) {
    if (counts[c * 3] == 0) continue;
    int before = 0;  // candidates in the chunks before this one
    for (int i = tid; i < c; i += THREADS) before += counts[i * 3];
    before = block_sum<W>(before, red);
    if (before >= budget) continue;
    const int base = c * CHUNK;
    bool f[ITERS];
    unsigned b[ITERS];
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = base + k * THREADS + tid;
      f[k] = i < n && ((flags[i] >> 1) & 1);
    }
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      b[k] = __ballot_sync(FULL, f[k]);
      if (lane == 0) wsum[k][warp] = __popc(b[k]);
    }
    __syncthreads();
    int run = before;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      int off = 0, total = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        off += w < warp ? wsum[k][w] : 0;
        total += wsum[k][w];
      }
      const int pos = run + off + __popc(b[k] & lt);
      if (f[k] && pos < budget) sel[pos] = base + k * THREADS + tid;
      run += total;
    }
    __syncthreads();  // wsum is rewritten for the next chunk
  }
}

template <int THREADS, int ITERS>
__device__ __forceinline__ void select_candidates(const int* flags, int n,
                                                  const int* counts,
                                                  int* sel, int budget,
                                                  int* red,
                                                  int (*wsum)[THREADS / 32]) {
  select_candidates<THREADS, ITERS>(flags, n, counts, sel, budget, red, wsum,
                                    blockIdx.x, gridDim.x);
}

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
__device__ __forceinline__ Snap snap(const float* v, const SnapCfg& S) {
  const float iw_raw = recip_spec(v[3]);
  const float iw = finite(iw_raw) ? iw_raw : 0.0f;
  auto nd = [&](float a) {
    const float r = fmul(a, iw);
    return finite(r) ? r : 0.0f;
  };
  Snap s;
  s.x = snap_coord(nd(v[0]), S.width, S.ss, S.min_c, S.max_cx);
  s.y = snap_coord(nd(v[1]), S.height, S.ss, S.min_c, S.max_cy);
  s.zq = quantize_depth(nd(v[2]));
  s.iw = iw;
  return s;
}

// Sutherland-Hodgman of one polygon against the 6 guard planes, N_TBL
// lanes of one half-warp (gmask) a polygon: lane ch holds channel ch of
// every polygon slot in buf (slots 0-2 the triangle's corners, the rest
// 0), and the x, y, z, w lanes' values give every lane the plane
// distances.  Each plane's output is placed through the lane's column of
// the polygon's [POLY][N_TBL] staging in shared memory.  Returns the
// vertex count; buf holds the clipped polygon.
//
// A clipping polygon is one warp's dependent chain of 6 planes, so the
// clip's instruction count is its latency: placing each plane's output
// with a select over the 12 x 12 (slot, position) pairs, ~1,700
// instructions a plane, held K6's fan pass ~30 us where the other passes
// take ~8 (experiments/torch_front_variants.py).
__device__ __forceinline__ int clip_polygon(float (&buf)[POLY],
                                            unsigned gmask, int ch,
                                            float (*poly)[N_TBL], float gx,
                                            float gy) {
  int count = 3;
#pragma unroll 1
  for (int p = 0; p < 6; ++p) {
    float d[POLY];
#pragma unroll
    for (int s = 0; s < POLY; ++s)
      d[s] = plane_dist(p, __shfl_sync(gmask, buf[s], 0, N_TBL),
                        __shfl_sync(gmask, buf[s], 1, N_TBL),
                        __shfl_sync(gmask, buf[s], 2, N_TBL),
                        __shfl_sync(gmask, buf[s], 3, N_TBL), gx, gy);
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
    // once, so the lane scatters its channel's values into its column of
    // the polygon in shared memory and reads them back in order
    // (positions past the POLY slots are dropped, as a select over the
    // slots drops them)
#pragma unroll
    for (int s = 0; s < POLY; ++s) {
      if (((a_in >> s) & 1) && pos_a[s] < POLY) poly[pos_a[s]][ch] = buf[s];
      if (((cross >> s) & 1) && pos_i[s] < POLY) poly[pos_i[s]][ch] = inter[s];
    }
#pragma unroll
    for (int q = 0; q < POLY; ++q)
      buf[q] = q < offs ? fadd(0.0f, poly[q][ch]) : 0.0f;
    count = count > 0 ? offs : 0;
  }
  return count;
}

// One fan triangle (0, j + 1, j + 2) of a clipped polygon of poly_n
// vertices (rows of N_TBL channels): its snapped corners, the shoelace
// cull (valid: alive and front-facing) and the area terms _finish_tri
// gives a valid row (area2 = -shoelace, inv_area2 = recip_spec(area2));
// a dead fan index snaps nothing (corners 0).
struct FanTri {
  Snap a, b, c;
  bool valid;
  int area2;
  float inv_area2;
};

__device__ __forceinline__ FanTri fan_tri(const float (*poly)[N_TBL],
                                          int poly_n, int j,
                                          const SnapCfg& S) {
  FanTri t;
  t.a = Snap{0, 0, 0, 0.0f};
  t.b = t.a;
  t.c = t.a;
  const bool alive = j + 2 < poly_n;
  if (alive) {
    t.a = snap(poly[0], S);
    t.b = snap(poly[j + 1], S);
    t.c = snap(poly[j + 2], S);
  }
  const int sl = wsub(wmul(wsub(t.b.x, t.a.x), wsub(t.c.y, t.a.y)),
                      wmul(wsub(t.b.y, t.a.y), wsub(t.c.x, t.a.x)));
  t.valid = alive && sl < 0;
  t.area2 = t.valid ? wsub(0, sl) : 1;
  t.inv_area2 = recip_spec(i2f(t.area2));
  return t;
}

}  // namespace clip
}  // namespace ash
