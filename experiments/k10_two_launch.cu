// K10's first design, the csrc/geometry.cu of two launches (the
// vertex pass, then one cooperative launch), kept for the record and timed
// against it by experiments/torch_classic_variants.py (same C entry points
// and arguments as its ops/geometry.py called them).
//
// K10: the classic route's triangle setup in two launches with no host
// read.  The plain torch version is
// ash_renderer_tpu_torch/ops/geometry.py:geometry_device_plain.
//
// It replaces no Pallas kernel.  The reference computes this stage as XLA
// glue under one jit (ash_renderer_tpu/pipeline.py:680, _stage_geometry
// over ops/geometry.py:367, geometry_device), which XLA fuses; eager torch
// pays hundreds of launches for the same chain, a host read of the
// candidate count every frame and the budgeted select's nonzero on every
// frame that clips.
//
// Bound by bytes it barely moves: the vertex rows (16 bytes of clip
// position and 48 of attributes read, 48 of copied attributes written a
// vertex), the triangles' ids and materials, 73 bytes of setup fields a
// setup row (the 18 words and the valid byte) over the triangles and the
// 7 x clip_budget tail rows, and 9 x clip_budget attribute rows, ~4 MB at
// the default budget of 4096: about a microsecond at 3.35 TB/s, which the
// launches exceed.  So the design is two launches (the 32-byte snapped
// vertex rows between them are scratch):
//
// ash_geometry_vertices, one thread a vertex: the snap, 1/w and the
// 10-bit outcode (geometry._vertex_post) as an (8,) int32 row, and the
// vertex's attribute row copied into attrs_full.  On a meshlet-packed
// scene K5 then gathers the three corner rows of each triangle from these
// rows (the caller's launch).
//
// ash_geometry_tris, one cooperative launch, its grid sized from the
// occupancy, in three passes split by grid syncs (as K6's):
// 1. setup: one thread a triangle classifies it from its corners'
//    outcodes (fast, clip candidate or culled), writes its setup row
//    (_finish_tri of a fast triangle, else zeros) and its flags, and each
//    chunk of CHUNK rows counts its flags by warp ballots;
//    -- grid sync --
// 2. select: the first clip_budget candidates in ascending row order
//    (clip.cuh), -1 fill; block 0 writes the counters;
//    -- grid sync --
// 3. clip: 16 lanes a budget slot clip the selected triangle against the
//    6 guard planes (clip.cuh), 7 lanes fan, snap and cull its triangles
//    into setup rows T + 7 * slot + j, and the 16 write its 9 attribute
//    rows V + 9 * slot + i.  A slot past the candidates writes zeros: at
//    the default budget most slots are dead, and each costs its rows'
//    bytes.
//
// The setup rows are one (S, SETUP_COLS) int32 table in the order of
// rtypes.SETUP_ROW_FIELDS (x0, y0, x1, y1, x2, y2, inv_area2, iw0-2,
// v0-2, mat, then area2, zq0-2 and two zero words; floats as bits): the
// TriangleSetup fields are its columns, and K11 (shade_pack.cu) reads a
// pixel's winner as the row's first 14 words.  Beside it a (S,) bool
// array of the valid flags, which is no column of the table.
//
// Exactness, as the plain chain computes it:
// * the vertex snap is K1's corner() (setup.cu) and _vertex_post's:
//   recip_spec(w) (non-finite -> 0), snap_coord, quantize_depth, the
//   plane distances with fmul / fadd / fsub, no FMA;
// * a fast row's corners are (vtx[clamp(tri_v)], or K5's gathered rows),
//   the shoelace and rewind (a, c, b) in wrapping int32, inv_area2 =
//   recip_spec(f32(area2)); every field of an invalid row is 0 (+0.0);
// * the clip path is clip.cuh's, which K6 runs too; its attribute rows
//   are the placed polygon's first 9 slots (0.0 + v, unused slots +0.0),
//   zeros where the slot has no candidate.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "clip.cuh"
#include "coop.cuh"
#include "specmath.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ash;

using clip::ATTR;
using clip::FAN;
using clip::MAX_VERTS;
using clip::N_TBL;
using clip::POLY;
constexpr int VTX_THREADS = 256;
constexpr int THREADS = 256;
constexpr int ITERS = 16;
constexpr int CHUNK = THREADS * ITERS;  // ops/geometry.K10_CHUNK
constexpr int N_WARPS = THREADS / 32;
constexpr int SLOTS = THREADS / N_TBL;  // budget slots a block at a time
constexpr int VTX_COLS = 8;       // geometry.VTX_COLS
constexpr int SETUP_COLS = 20;    // rtypes.SETUP_COLS
// the scratch (ops/geometry): the counters (geometry.COUNTERS), the
// per-chunk counts, sel, the row flags
constexpr int C_CLIPPED = 0, C_OVERFLOW = 1, C_VALID = 2, C_FAST = 3;
constexpr int N_COUNTERS = 4;
constexpr int N_COUNTS = 3;

struct VtxParams {
  const float4* cpos;   // (V, 4) clip positions
  const float4* attrs;  // (V, 12) as 3 float4 a row
  int4* vtx;            // (V, 8) as 2 int4 a row
  float4* attrs_full;   // (V + 9 * budget, 12): rows [0, V) here
  int n_verts;
  clip::SnapCfg snap;
  float gx, gy;
};

// geometry._vertex_post of one vertex, and its attribute row copied
__global__ void __launch_bounds__(VTX_THREADS)
vertex_kernel(const VtxParams P) {
  const int v = blockIdx.x * VTX_THREADS + threadIdx.x;
  if (v >= P.n_verts) return;
  const float4 c = P.cpos[v];
  const float cv[4] = {c.x, c.y, c.z, c.w};
  const clip::Snap s = clip::snap(cv, P.snap);
  // bits 0-5: the guard planes (_plane_dists' order); 6-9: the screen side
  // planes
  const float ds[10] = {
      c.z,
      fsub(c.w, c.z),
      fadd(fmul(P.gx, c.w), c.x),
      fsub(fmul(P.gx, c.w), c.x),
      fadd(fmul(P.gy, c.w), c.y),
      fsub(fmul(P.gy, c.w), c.y),
      fadd(c.w, c.x),
      fsub(c.w, c.x),
      fadd(c.w, c.y),
      fsub(c.w, c.y),
  };
  int oc = 0;
#pragma unroll
  for (int p = 0; p < 10; ++p) oc |= (ds[p] < 0.0f ? 1 : 0) << p;
  P.vtx[2 * (size_t)v] = make_int4(s.x, s.y, s.zq, bits(s.iw));
  P.vtx[2 * (size_t)v + 1] = make_int4(oc, 0, 0, 0);
#pragma unroll
  for (int q = 0; q < ATTR / 4; ++q)
    P.attrs_full[(size_t)v * (ATTR / 4) + q] = P.attrs[(size_t)v * (ATTR / 4) + q];
}

struct TriParams {
  const int* vtx;      // (V, 8)
  const int* corners;  // (T, 24) K5's gathered corner rows, or null
  const float* cpos;   // (V, 4) clip positions
  const float* attrs;  // (V, 12)
  const int* tri_v;    // (T, 3)
  const int* tri_mat;  // (T,)
  int* scratch;
  int* table;          // (S, SETUP_COLS)
  unsigned char* valid;  // (S,) bool
  float* attrs_full;   // (V + 9 * budget, 12)
  int n_verts, n_tris, budget;
  clip::SnapCfg snap;
  float gx, gy;
};

// one setup row's 20 words from its fields, zeroed unless valid
__device__ __forceinline__ void write_row(int* row, bool valid, int ax,
                                          int ay, int bx, int by, int cx,
                                          int cy, int area2, float inv_area2,
                                          int azq, int bzq, int czq, int aiw,
                                          int biw, int ciw, int va, int vb,
                                          int vc, int mat) {
  auto zi = [&](int v) { return valid ? v : 0; };
  // winding rewind (a, c, b)
  int4* r4 = reinterpret_cast<int4*>(row);
  r4[0] = make_int4(zi(ax), zi(ay), zi(cx), zi(cy));
  r4[1] = make_int4(zi(bx), zi(by), zi(bits(inv_area2)), zi(aiw));
  r4[2] = make_int4(zi(ciw), zi(biw), zi(va), zi(vc));
  r4[3] = make_int4(zi(vb), zi(mat), zi(area2), zi(azq));
  r4[4] = make_int4(zi(czq), zi(bzq), 0, 0);
}

// pass 1 for triangle t: classify, write its setup row and valid flag;
// returns its flags (valid | clip candidate << 1 | fast << 2)
__device__ __forceinline__ int setup_tri(const TriParams& P, int t) {
  const int* tv = P.tri_v + (size_t)t * 3;
  int vid[3];
  int4 cr[3];  // x, y, zq, iw bits
  int oc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vid[k] = min(max(tv[k], 0), P.n_verts - 1);
    const int* row = P.corners != nullptr
                         ? P.corners + (size_t)t * 3 * VTX_COLS + k * VTX_COLS
                         : P.vtx + (size_t)vid[k] * VTX_COLS;
    cr[k] = *reinterpret_cast<const int4*>(row);
    oc[k] = row[4];
  }
  const bool vid_ok = tv[0] >= 0;
  const int oc_and = oc[0] & oc[1] & oc[2];
  const bool out_any = (oc_and & 0x3F) != 0;
  const bool all_in = ((oc[0] | oc[1] | oc[2]) & 0x3F) == 0;
  const bool out_screen = (oc_and >> 6) != 0;
  const bool fast = vid_ok && all_in;
  const bool needs_clip = vid_ok && !all_in && !out_any && !out_screen;
  const int4 &A = cr[0], &B = cr[1], &C = cr[2];
  const int sl = wsub(wmul(wsub(B.x, A.x), wsub(C.y, A.y)),
                      wmul(wsub(B.y, A.y), wsub(C.x, A.x)));
  const bool valid = fast && sl < 0;
  const int area2 = valid ? wsub(0, sl) : 1;
  write_row(P.table + (size_t)t * SETUP_COLS, valid, A.x, A.y, B.x, B.y, C.x,
            C.y, area2, recip_spec(i2f(area2)), A.z, B.z, C.z, A.w, B.w, C.w,
            vid[0], vid[1], vid[2], P.tri_mat[t]);
  P.valid[t] = valid ? 1 : 0;
  return (valid ? 1 : 0) | (needs_clip ? 2 : 0) | (fast ? 4 : 0);
}

__global__ void __launch_bounds__(THREADS) tri_kernel(const TriParams P) {
  __shared__ int red[N_WARPS];
  __shared__ int wsum[ITERS][N_WARPS];
  __shared__ float poly[SLOTS][POLY][N_TBL];
  __shared__ int poly_n[SLOTS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int n = P.n_tris, budget = P.budget;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  int* counters = P.scratch;
  int* counts = P.scratch + N_COUNTERS;
  int* sel = counts + N_COUNTS * n_chunks;
  int* flags = sel + budget;

  // 1. each triangle's setup row and flags; each chunk's counts
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    clip::FlagCounts fc{0, 0, 0};
#pragma unroll 1
    for (int k = 0; k < ITERS; ++k) {
      const int t = c * CHUNK + k * THREADS + tid;
      int f = 0;
      if (t < n) {
        f = setup_tri(P, t);
        flags[t] = f;
      }
      clip::add_flags(fc, f);
    }
    clip::store_counts<N_WARPS>(fc, c, counts, red);
  }
  grid.sync();

  // 2. the first `budget` candidates into sel, -1 fill; block 0 writes the
  // counters (the clip pass adds the tail's valid rows)
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
  clip::select_candidates<THREADS, ITERS>(flags, n, counts, sel, budget, red,
                                          wsum);
  grid.sync();

  // 3. SLOTS budget slots at a time, N_TBL lanes a slot: the clip, the 7
  // fan rows and the 9 attribute rows of each
  const int n_groups = (budget + SLOTS - 1) / SLOTS;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int g = tid / N_TBL;   // slot in the block
    const int ch = tid % N_TBL;  // this lane's channel: clip 0-3, attrs 4-15
    const unsigned gmask = 0xFFFFu << (tid & 16);
    const int slot = grp * SLOTS + g;
    const int si = slot < budget ? sel[slot] : -1;
    const int tri = min(max(si, 0), n - 1);

    if (si >= 0) {
      float buf[POLY];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int vi = min(max(P.tri_v[(size_t)tri * 3 + k], 0),
                           P.n_verts - 1);
        buf[k] = ch < 4 ? P.cpos[(size_t)vi * 4 + ch]
                        : P.attrs[(size_t)vi * ATTR + ch - 4];
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

    // the fan: lane j < FAN makes triangle (0, j + 1, j + 2) into setup
    // row T + 7 * slot + j, its vertex ids the slot's attribute rows
    bool valid = false;
    if (ch < FAN && slot < budget) {
      const int j = ch;
      const clip::FanTri F = clip::fan_tri(poly[g], poly_n[g], j, P.snap);
      valid = F.valid;
      const int vbase = P.n_verts + MAX_VERTS * slot;
      const int row = n + slot * FAN + j;
      write_row(P.table + (size_t)row * SETUP_COLS, valid, F.a.x, F.a.y,
                F.b.x, F.b.y, F.c.x, F.c.y, F.area2, F.inv_area2, F.a.zq,
                F.b.zq, F.c.zq, bits(F.a.iw), bits(F.b.iw), bits(F.c.iw),
                vbase, vbase + j + 1, vbase + j + 2,
                si >= 0 ? P.tri_mat[tri] : 0);
      P.valid[row] = valid ? 1 : 0;
    }
    const unsigned vb = __ballot_sync(clip::FULL, valid) & gmask;
    if (ch == 0 && vb) atomicAdd(&counters[C_VALID], __popc(vb));

    // the slot's 9 attribute rows: the placed polygon's first 9 slots
    if (slot < budget) {
      float* out = P.attrs_full + ((size_t)P.n_verts + (size_t)MAX_VERTS * slot) * ATTR;
      for (int w = ch; w < MAX_VERTS * ATTR; w += N_TBL)
        out[w] = si >= 0 ? poly[g][w / ATTR][4 + w % ATTR] : 0.0f;
    }
    __syncthreads();  // poly and poly_n are rewritten next group
  }
}

}  // namespace

extern "C" int ash_geometry_vertices(const float* cpos, const float* attrs,
                                     int* vtx, float* attrs_full,
                                     int n_verts, int width, int height,
                                     int min_c, int max_cx, int max_cy,
                                     int ss, float gx, float gy,
                                     void* stream) {
  const VtxParams P{reinterpret_cast<const float4*>(cpos),
                    reinterpret_cast<const float4*>(attrs),
                    reinterpret_cast<int4*>(vtx),
                    reinterpret_cast<float4*>(attrs_full),
                    n_verts,
                    clip::SnapCfg{width, height, min_c, max_cx, max_cy, ss},
                    gx,
                    gy};
  const int blocks = (n_verts + VTX_THREADS - 1) / VTX_THREADS;
  if (blocks > 0)
    vertex_kernel<<<blocks, VTX_THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int ash_geometry_tris(const int* vtx, const int* corners,
                                 const float* cpos, const float* attrs,
                                 const int* tri_v, const int* tri_mat,
                                 int* scratch, int* table, void* valid,
                                 float* attrs_full, int n_verts, int n_tris,
                                 int budget, int width, int height, int min_c,
                                 int max_cx, int max_cy, int ss, float gx,
                                 float gy, void* stream) {
  TriParams P{vtx,
              corners,
              cpos,
              attrs,
              tri_v,
              tri_mat,
              scratch,
              table,
              static_cast<unsigned char*>(valid),
              attrs_full,
              n_verts,
              n_tris,
              budget,
              clip::SnapCfg{width, height, min_c, max_cx, max_cy, ss},
              gx,
              gy};
  int blocks = 0;
  const int rc = ash::coop_grid(tri_kernel, THREADS, &blocks);
  if (rc != 0) return rc;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)tri_kernel,
                                          dim3(blocks), dim3(THREADS), args,
                                          0, (cudaStream_t)stream);
}
