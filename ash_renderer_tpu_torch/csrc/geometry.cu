// K10: the classic route's vertex transform and triangle setup in one
// launch with no host read on a plain-packed scene (a vertex launch first
// on a meshlet-packed one).  The plain torch version is
// ash_renderer_tpu_torch/ops/geometry.py:transform_vertices_plain, then
// geometry_device_plain (the _scene entries, which the frame calls); the
// entries without _scene take K8C's clip and attribute rows instead of
// transforming (geometry_device_plain alone).
//
// It replaces no Pallas kernel.  The reference computes this stage as XLA
// glue under one jit (ash_renderer_tpu/pipeline.py:680, _stage_geometry
// over ops/geometry.py:367, geometry_device), which XLA fuses; eager torch
// pays hundreds of launches for the same chain, a host read of the
// candidate count every frame and the budgeted select's nonzero on every
// frame that clips.
//
// Bound by bytes it barely moves: the scene's vertex tensors (52 bytes a
// vertex: position, normal, colour, uv, object id) and the matrices read,
// 48 bytes of transformed attributes written a vertex, the triangles' ids
// and materials, 73 bytes of setup fields a
// setup row (the 18 words and the valid byte) over the triangles and the
// 7 x clip_budget tail rows, and 9 x clip_budget attribute rows, ~4 MB at
// the default budget of 4096, nearly all of it the zeros of dead budget
// slots: about a microsecond at 3.35 TB/s, which the launch exceeds.  So
// the design is one launch (tri_kernel) in three passes split by two
// barriers:
// 0. each block stages the matrices of up to SMEM_OBJECTS objects in
//    dynamic shared memory sized to the scene's objects at launch
//    (vertex.cuh; more are read through the cache), so the
//    transform has no launch of its own (K8C's arithmetic, op for op);
// 1. setup: one thread a triangle transforms and snaps its three corners
//    itself (geometry._vertex_post: vertex_post below), or on a
//    meshlet-packed scene reads them from K5's gathered rows,
//    classifies the triangle (fast, clip candidate or culled), writes its
//    setup row (_finish_tri of a fast triangle, else zeros) and its flags,
//    and each chunk of CHUNK rows counts its flags by warp ballots; on a
//    plain-packed scene the launch also writes the V transformed attribute
//    rows into attrs_full;
//    -- barrier --
// 2. select: the first clip_budget candidates in ascending row order
//    (clip.cuh), -1 fill; every block knows the candidates in all, and the
//    dead budget slots' setup rows, valid bytes and attribute rows are
//    zeroed as 16-byte stores (those past the triangles, dead whatever the
//    candidates, already in pass 1); block 0 writes the counters;
//    -- barrier --
// 3. clip: 16 lanes a live budget slot (one with a candidate) clip the
//    selected triangle against the 6 guard planes (clip.cuh), 7 lanes
//    fan, snap and cull its triangles into setup rows T + 7 * slot + j,
//    and the 16 write its 9 attribute rows V + 9 * slot + i.
// The barriers are a cluster's at the classic route's sizes
// (tri_kernel<true>): one thread block cluster of CL_BLOCKS blocks runs
// the passes, its barrier the hardware's within one GPC, where a
// card-wide cooperative grid pays two grid syncs of ~2 us over blocks that
// mostly have no triangle; the launch holds as many more clusters as the
// card runs at once beside it, and each of those classifies the triangles
// again, counts the candidates and zeroes its share of the dead slots
// (one GPC writes the ~4 MB of zeros at a fraction of the card's rate),
// waiting on no other cluster.  Past the crossover the wrapper measured
// (ops/geometry.py k10_design), the same passes run as one cooperative
// launch, its grid sized from the occupancy (tri_kernel<false>).  On a
// meshlet-packed scene the vertex launch (vertex_kernel: the vertex
// transformed, its snap, 1/w and the 10-bit outcode as an (8,) int32 row,
// and its attribute row written into attrs_full) runs first, then K5
// gathers the three corner rows of each triangle from those rows (the
// caller's launch).  The clip pass transforms its candidates' corners
// again, one channel a lane, rather than keep every vertex's clip
// position in scratch.
//
// The setup rows are one (S, SETUP_COLS) int32 table in the order of
// rtypes.SETUP_ROW_FIELDS (x0, y0, x1, y1, x2, y2, inv_area2, iw0-2,
// v0-2, mat, then area2, zq0-2 and two zero words; floats as bits): the
// TriangleSetup fields are its columns, and K11 (shade_pack.cu) reads a
// pixel's winner as the row's first 14 words.  Beside it a (S,) bool
// array of the valid flags, which is no column of the table.
//
// Exactness, as the plain chain computes it:
// * the transform is vertex.cuh's, K8C's arithmetic (specmath's
//   apply_mat4_point / apply_mat3_vec op for op, colour and uv as bits),
//   so a value transformed here is the one K8C writes;
// * the vertex snap is K1's corner() (setup.cu) and _vertex_post's:
//   recip_spec(w) (non-finite -> 0), snap_coord, quantize_depth, the
//   plane distances with fmul / fadd / fsub, no FMA; a corner snapped in
//   the tri pass is the same function of the same clip position;
// * a fast row's corners are (the snap of clip[clamp(tri_v)], or K5's
//   gathered rows), the shoelace and rewind (a, c, b) in wrapping int32,
//   inv_area2 = recip_spec(f32(area2)); every field of an invalid row is
//   0 (+0.0);
// * the clip path is clip.cuh's, which K6 runs too; its attribute rows
//   are the placed polygon's first 9 slots (0.0 + v, unused slots +0.0),
//   zeros where the slot has no candidate.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "clip.cuh"
#include "coop.cuh"
#include "specmath.cuh"
#include "vertex.cuh"

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
constexpr int CL_BLOCKS = 16;  // blocks a cluster
constexpr int ITERS = 4;
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
// the most dynamic shared memory a block takes: the matrices it stages
// (vertex.cuh), model, then MVP, of SMEM_OBJECTS objects
constexpr size_t MATS_MAX_BYTES =
    2 * (size_t)vertex::SMEM_OBJECTS * vertex::MAT * sizeof(float);

// a launch's vertices: the scene's (scene.pos set: each value the launch
// needs is transformed here, vertex.cuh), or K8C's rows (cpos, attrs)
struct Verts {
  const float4* cpos;   // (V, 4) clip positions
  const float4* attrs;  // (V, 12) as 3 float4 a row
  vertex::Scene scene;
};

// the dynamic shared memory a launch on V takes: the matrices of the
// scene's first SMEM_OBJECTS objects, none on K8C's rows
size_t mats_bytes(const Verts& V) {
  if (V.scene.pos == nullptr) return 0;
  const int o = V.scene.n_obj;
  const int n = o < 0 ? 0 : o < vertex::SMEM_OBJECTS ? o : vertex::SMEM_OBJECTS;
  return 2 * (size_t)n * vertex::MAT * sizeof(float);
}

// stage the scene's matrices into `mats` (nothing for K8C's rows); the
// block synchronizes before reading them
__device__ __forceinline__ void stage_mats(const Verts& V, float* mats) {
  if (V.scene.pos != nullptr)
    vertex::stage_mats(V.scene, mats, threadIdx.x, blockDim.x);
  __syncthreads();
}

// vertex v's clip position
__device__ __forceinline__ float4 clip_pos(const Verts& V, const float* mats,
                                           int v) {
  return V.scene.pos != nullptr ? vertex::clip_of(V.scene, mats, v)
                                : V.cpos[v];
}

// vertex v's attribute row (12 floats as 3 float4) into dst
__device__ __forceinline__ void copy_attrs(const Verts& V, const float* mats,
                                           int v, float4* dst) {
  if (V.scene.pos != nullptr) {
    int r[vertex::N_ROWS];
    vertex::values(V.scene, mats, v, r);
#pragma unroll
    for (int q = 0; q < ATTR / 4; ++q)
      dst[q] = make_float4(fbits(r[4 + 4 * q]), fbits(r[5 + 4 * q]),
                           fbits(r[6 + 4 * q]), fbits(r[7 + 4 * q]));
  } else {
#pragma unroll
    for (int q = 0; q < ATTR / 4; ++q)
      dst[q] = V.attrs[(size_t)v * (ATTR / 4) + q];
  }
}

// value ch of vertex v: clip 0-3, then the 12 attributes
__device__ __forceinline__ float channel(const Verts& V, const float* mats,
                                         int v, int ch) {
  if (V.scene.pos != nullptr) return vertex::value(V.scene, mats, v, ch);
  return ch < 4 ? reinterpret_cast<const float*>(V.cpos)[(size_t)v * 4 + ch]
                : reinterpret_cast<const float*>(V.attrs)[(size_t)v * ATTR
                                                          + ch - 4];
}

struct VtxParams {
  Verts verts;
  int4* vtx;            // (V, 8) as 2 int4 a row
  float4* attrs_full;   // (V + 9 * budget, 12): rows [0, V) here
  int n_verts;
  clip::SnapCfg snap;
  float gx, gy;
};

// geometry._vertex_post of one vertex: the snapped x, y, zq and iw's bits,
// and the outcode (bits 0-5: the guard planes, _plane_dists' order; 6-9:
// the screen side planes)
struct VtxPost {
  int x, y, zq, iw, oc;
};

__device__ __forceinline__ VtxPost vertex_post(const float4 c,
                                               const clip::SnapCfg& S,
                                               float gx, float gy) {
  const float cv[4] = {c.x, c.y, c.z, c.w};
  const clip::Snap s = clip::snap(cv, S);
  const float ds[10] = {
      c.z,
      fsub(c.w, c.z),
      fadd(fmul(gx, c.w), c.x),
      fsub(fmul(gx, c.w), c.x),
      fadd(fmul(gy, c.w), c.y),
      fsub(fmul(gy, c.w), c.y),
      fadd(c.w, c.x),
      fsub(c.w, c.x),
      fadd(c.w, c.y),
      fsub(c.w, c.y),
  };
  int oc = 0;
#pragma unroll
  for (int p = 0; p < 10; ++p) oc |= (ds[p] < 0.0f ? 1 : 0) << p;
  return VtxPost{s.x, s.y, s.zq, bits(s.iw), oc};
}

// a vertex's row, and its attribute row transformed (or copied from K8C's)
__global__ void __launch_bounds__(VTX_THREADS)
vertex_kernel(const VtxParams P) {
  extern __shared__ float mats[];  // mats_bytes(P.verts)
  stage_mats(P.verts, mats);
  const int v = blockIdx.x * VTX_THREADS + threadIdx.x;
  if (v >= P.n_verts) return;
  const VtxPost q =
      vertex_post(clip_pos(P.verts, mats, v), P.snap, P.gx, P.gy);
  P.vtx[2 * (size_t)v] = make_int4(q.x, q.y, q.zq, q.iw);
  P.vtx[2 * (size_t)v + 1] = make_int4(q.oc, 0, 0, 0);
  copy_attrs(P.verts, mats, v, P.attrs_full + (size_t)v * (ATTR / 4));
}

struct TriParams {
  const int* corners;  // (T, 24) K5's gathered corner rows, or null: snap
  Verts verts;
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

// pass 1 for triangle t: classify, write its setup row and valid flag
// (with `write`); returns its flags (valid | clip candidate << 1 | fast
// << 2)
__device__ __forceinline__ int setup_tri(const TriParams& P,
                                         const float* mats, int t,
                                         bool write) {
  const int* tv = P.tri_v + (size_t)t * 3;
  int vid[3];
  int4 cr[3];  // x, y, zq, iw bits
  int oc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vid[k] = min(max(tv[k], 0), P.n_verts - 1);
    if (P.corners != nullptr) {
      const int* row = P.corners + (size_t)t * 3 * VTX_COLS + k * VTX_COLS;
      cr[k] = *reinterpret_cast<const int4*>(row);
      oc[k] = row[4];
    } else {
      const VtxPost q =
          vertex_post(clip_pos(P.verts, mats, vid[k]), P.snap, P.gx, P.gy);
      cr[k] = make_int4(q.x, q.y, q.zq, q.iw);
      oc[k] = q.oc;
    }
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
  if (write) {
    write_row(P.table + (size_t)t * SETUP_COLS, valid, A.x, A.y, B.x, B.y,
              C.x, C.y, area2, recip_spec(i2f(area2)), A.z, B.z, C.z, A.w,
              B.w, C.w, vid[0], vid[1], vid[2], P.tri_mat[t]);
    P.valid[t] = valid ? 1 : 0;
  }
  return (valid ? 1 : 0) | (needs_clip ? 2 : 0) | (fast ? 4 : 0);
}

// the setup rows, valid bytes and attribute rows of budget slots [from,
// to) zeroed, as thread t of nt: 16-byte stores
__device__ __forceinline__ void zero_slots(const TriParams& P, int from,
                                           int to, long long t,
                                           long long nt) {
  if (to <= from) return;
  const size_t n = P.n_tris, v = P.n_verts;
  zero_fill(P.table + (n + (size_t)FAN * from) * SETUP_COLS,
            4LL * FAN * SETUP_COLS * (to - from), t, nt);
  zero_fill(P.valid + n + (size_t)FAN * from, (long long)FAN * (to - from), t,
            nt);
  zero_fill(P.attrs_full + (v + (size_t)MAX_VERTS * from) * ATTR,
            4LL * MAX_VERTS * ATTR * (to - from), t, nt);
}

// every block of the launch waits here: the cluster's barrier, or the
// cooperative grid's
template <bool CLUSTER>
__device__ __forceinline__ void barrier() {
  if constexpr (CLUSTER) cg::this_cluster().sync();
  else cg::this_grid().sync();
}

template <bool CLUSTER>
__global__ void __launch_bounds__(THREADS) tri_kernel(const TriParams P) {
  __shared__ int red[N_WARPS];
  __shared__ int wsum[ITERS][N_WARPS];
  __shared__ float poly[SLOTS][POLY][N_TBL];
  __shared__ int poly_n[SLOTS];
  __shared__ int s_clip;  // a cluster block's candidates, read by its ranks
  extern __shared__ float mats[];  // mats_bytes(P.verts)
  stage_mats(P.verts, mats);
  const int tid = threadIdx.x;
  const int n = P.n_tris, budget = P.budget;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const long long gt = (long long)blockIdx.x * THREADS + tid;
  const long long nt = (long long)gridDim.x * THREADS;
  // the blocks that set the triangles up, select and clip: the grid's, or
  // the first cluster's; in a cluster launch every cluster counts the
  // candidates, and the others zero the dead slots' rows (the first too
  // when it is alone)
  int part = blockIdx.x, parts = gridDim.x, cid = 0, n_cl = 1;
  if constexpr (CLUSTER) {
    part = (int)cg::this_cluster().block_rank();
    parts = CL_BLOCKS;
    cid = blockIdx.x / CL_BLOCKS;
    n_cl = gridDim.x / CL_BLOCKS;
  }
  const bool main = cid == 0;
  // the threads that zero dead slots: the other clusters', which zero
  // those past the triangles (dead whatever the candidates) at once; or,
  // alone, all of them after the count
  const long long skip = n_cl == 1 ? 0 : (long long)CL_BLOCKS * THREADS;
  const bool zeroer = !main || n_cl == 1;
  const int sure = n_cl == 1 ? budget : min(n, budget);
  int* counters = P.scratch;
  int* counts = P.scratch + N_COUNTERS;
  int* sel = counts + N_COUNTS * n_chunks;
  int* flags = sel + budget;

  // 1. each triangle's setup row and flags; each chunk's counts; on a
  // plain-packed scene the vertices' attribute rows; the slots past the
  // triangles zeroed
  if (zeroer) zero_slots(P, sure, budget, gt - skip, nt - skip);
  if (P.corners == nullptr) {
    float4* dst = reinterpret_cast<float4*>(P.attrs_full);
    for (long long v = gt; v < P.n_verts; v += nt)
      copy_attrs(P.verts, mats, (int)v, dst + v * (ATTR / 4));
  }
  int n_clip_w = 0;  // a warp's candidates (each lane holds its warp's)
  for (int c = part; c < n_chunks; c += parts) {
    clip::FlagCounts fc{0, 0, 0};
#pragma unroll 1
    for (int k = 0; k < ITERS; ++k) {
      const int t = c * CHUNK + k * THREADS + tid;
      int f = 0;
      if (t < n) {
        f = setup_tri(P, mats, t, main);
        if (main) flags[t] = f;
      }
      clip::add_flags(fc, f);
    }
    if (main) clip::store_counts<N_WARPS>(fc, c, counts, red);
    n_clip_w += fc.clip;
  }
  if (!main) {
    const int b =
        clip::block_sum<N_WARPS>((tid & 31) == 0 ? n_clip_w : 0, red);
    if (tid == 0) s_clip = b;
  }
  barrier<CLUSTER>();

  // 2. the candidates in all (the chunks' counts; another cluster its
  // ranks' counts, read remotely), so the slots past them are dead, and
  // their rows are zeroed; block 0 writes the counters (the clip pass adds
  // the tail's valid rows) and the -1 fill; the first `budget` candidates
  // into sel
  int n_clip = 0;
  if (main) {
    for (int i = tid; i < n_chunks; i += THREADS)
      n_clip += counts[i * N_COUNTS];
  } else if constexpr (CLUSTER) {
    n_clip = tid < CL_BLOCKS
                 ? *cg::this_cluster().map_shared_rank(&s_clip, tid)
                 : 0;
  }
  n_clip = clip::block_sum<N_WARPS>(n_clip, red);
  const int n_sel = min(n_clip, budget);
  if (!main) {  // the others' counts are read: they end at the barrier
    cluster_arrive();
    zero_slots(P, n_sel, sure, gt - skip, nt - skip);
    cluster_wait();
    return;
  }
  if (zeroer) zero_slots(P, n_sel, sure, gt, nt);
  {
    if (blockIdx.x == 0) {
      int valid = 0, fast = 0;
      for (int i = tid; i < n_chunks; i += THREADS) {
        valid += counts[i * N_COUNTS + 1];
        fast += counts[i * N_COUNTS + 2];
      }
      valid = clip::block_sum<N_WARPS>(valid, red);
      fast = clip::block_sum<N_WARPS>(fast, red);
      for (int i = n_sel + tid; i < budget; i += THREADS) sel[i] = -1;
      if (tid == 0) {
        counters[C_CLIPPED] = n_clip;
        counters[C_OVERFLOW] = n_clip - n_sel;
        counters[C_VALID] = valid;
        counters[C_FAST] = fast;
      }
    }
    clip::select_candidates<THREADS, ITERS>(flags, n, counts, sel, budget,
                                            red, wsum, part, parts);
  }
  if (n_sel == 0) return;  // no slot to clip: every block knows it
  barrier<CLUSTER>();

  // 3. SLOTS live budget slots at a time, N_TBL lanes a slot: the clip, the
  // 7 fan rows and the 9 attribute rows of each
  const int n_groups = (n_sel + SLOTS - 1) / SLOTS;
  for (int grp = part; grp < n_groups; grp += parts) {
    const int g = tid / N_TBL;   // slot in the block
    const int ch = tid % N_TBL;  // this lane's channel: clip 0-3, attrs 4-15
    const unsigned gmask = 0xFFFFu << (tid & 16);
    const int slot = grp * SLOTS + g;
    const bool live = slot < n_sel;
    const int tri = live ? min(max(sel[slot], 0), n - 1) : 0;

    if (live) {
      float buf[POLY];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int vi = min(max(P.tri_v[(size_t)tri * 3 + k], 0),
                           P.n_verts - 1);
        buf[k] = channel(P.verts, mats, vi, ch);
      }
#pragma unroll
      for (int s = 3; s < POLY; ++s) buf[s] = 0.0f;
      const int count =
          clip::clip_polygon(buf, gmask, ch, poly[g], P.gx, P.gy);
#pragma unroll
      for (int s = 0; s < POLY; ++s) poly[g][s][ch] = buf[s];
      if (ch == 0) poly_n[g] = count;
    }
    __syncthreads();

    // the fan: lane j < FAN makes triangle (0, j + 1, j + 2) into setup
    // row T + 7 * slot + j, its vertex ids the slot's attribute rows
    bool valid = false;
    if (ch < FAN && live) {
      const int j = ch;
      const clip::FanTri F = clip::fan_tri(poly[g], poly_n[g], j, P.snap);
      valid = F.valid;
      const int vbase = P.n_verts + MAX_VERTS * slot;
      const int row = n + slot * FAN + j;
      write_row(P.table + (size_t)row * SETUP_COLS, valid, F.a.x, F.a.y,
                F.b.x, F.b.y, F.c.x, F.c.y, F.area2, F.inv_area2, F.a.zq,
                F.b.zq, F.c.zq, bits(F.a.iw), bits(F.b.iw), bits(F.c.iw),
                vbase, vbase + j + 1, vbase + j + 2, P.tri_mat[tri]);
      P.valid[row] = valid ? 1 : 0;
    }
    const unsigned vb = __ballot_sync(clip::FULL, valid) & gmask;
    if (ch == 0 && vb) atomicAdd(&counters[C_VALID], __popc(vb));

    // the slot's 9 attribute rows: the placed polygon's first 9 slots
    if (live) {
      float* out = P.attrs_full + ((size_t)P.n_verts + (size_t)MAX_VERTS * slot) * ATTR;
      for (int w = ch; w < MAX_VERTS * ATTR; w += N_TBL)
        out[w] = poly[g][w / ATTR][4 + w % ATTR];
    }
    __syncthreads();  // poly and poly_n are rewritten next group
  }
}

int launch_vertices(const Verts& V, int* vtx, float* attrs_full,
                    int n_verts, int width, int height, int min_c,
                    int max_cx, int max_cy, int ss, float gx, float gy,
                    void* stream) {
  const VtxParams P{V,
                    reinterpret_cast<int4*>(vtx),
                    reinterpret_cast<float4*>(attrs_full),
                    n_verts,
                    clip::SnapCfg{width, height, min_c, max_cx, max_cy, ss},
                    gx,
                    gy};
  const int blocks = (n_verts + VTX_THREADS - 1) / VTX_THREADS;
  if (blocks > 0)
    vertex_kernel<<<blocks, VTX_THREADS, mats_bytes(V),
                    (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

int launch_tris(const int* corners, const Verts& V, const int* tri_v,
                const int* tri_mat, int* scratch, int* table, void* valid,
                float* attrs_full, int n_verts, int n_tris, int budget,
                int width, int height, int min_c, int max_cx, int max_cy,
                int ss, float gx, float gy, int cluster, void* stream) {
  TriParams P{corners,
              V,
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
  // the grids are sized at the most shared memory a launch takes, so a
  // grid that fits holds at any launch's
  const size_t smem = mats_bytes(V);
  if (cluster)
    return ash::launch_cluster(tri_kernel<true>, CL_BLOCKS, THREADS, smem,
                               MATS_MAX_BYTES, stream, P);
  int blocks = 0;
  const int rc =
      ash::coop_grid(tri_kernel<false>, THREADS, &blocks, MATS_MAX_BYTES);
  if (rc != 0) return rc;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)tri_kernel<false>,
                                          dim3(blocks), dim3(THREADS), args,
                                          smem, (cudaStream_t)stream);
}

Verts scene_verts(const float* pos, const int* vobj, const float* nrm,
                  const int* col, const int* uv, const float* model,
                  const float* mvp, int n_obj) {
  return Verts{nullptr, nullptr,
               vertex::Scene{pos, vobj, nrm, col, uv, model, mvp, n_obj}};
}

Verts row_verts(const float* cpos, const float* attrs) {
  return Verts{reinterpret_cast<const float4*>(cpos),
               reinterpret_cast<const float4*>(attrs),
               vertex::Scene{nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, 0}};
}

}  // namespace

// on K8C's rows: clip (V, 4), attrs (V, 12)
extern "C" int ash_geometry_vertices(const float* cpos, const float* attrs,
                                     int* vtx, float* attrs_full,
                                     int n_verts, int width, int height,
                                     int min_c, int max_cx, int max_cy,
                                     int ss, float gx, float gy,
                                     void* stream) {
  return launch_vertices(row_verts(cpos, attrs), vtx, attrs_full, n_verts,
                         width, height, min_c, max_cx, max_cy, ss, gx, gy,
                         stream);
}

extern "C" int ash_geometry_tris(const int* corners, const float* cpos,
                                 const float* attrs, const int* tri_v,
                                 const int* tri_mat, int* scratch, int* table,
                                 void* valid, float* attrs_full, int n_verts,
                                 int n_tris, int budget, int width, int height,
                                 int min_c, int max_cx, int max_cy, int ss,
                                 float gx, float gy, int cluster,
                                 void* stream) {
  return launch_tris(corners, row_verts(cpos, attrs), tri_v, tri_mat,
                     scratch, table, valid, attrs_full, n_verts, n_tris,
                     budget, width, height, min_c, max_cx, max_cy, ss, gx,
                     gy, cluster, stream);
}

// on the scene's vertices and matrices (K8C's inputs), transformed here
extern "C" int ash_geometry_vertices_scene(
    const float* pos, const int* vobj, const float* nrm, const int* col,
    const int* uv, const float* model, const float* mvp, int n_obj, int* vtx,
    float* attrs_full, int n_verts, int width, int height, int min_c,
    int max_cx, int max_cy, int ss, float gx, float gy, void* stream) {
  return launch_vertices(
      scene_verts(pos, vobj, nrm, col, uv, model, mvp, n_obj), vtx,
      attrs_full, n_verts, width, height, min_c, max_cx, max_cy, ss, gx, gy,
      stream);
}

extern "C" int ash_geometry_tris_scene(
    const int* corners, const float* pos, const int* vobj, const float* nrm,
    const int* col, const int* uv, const float* model, const float* mvp,
    int n_obj, const int* tri_v, const int* tri_mat, int* scratch,
    int* table, void* valid, float* attrs_full, int n_verts, int n_tris,
    int budget, int width, int height, int min_c, int max_cx, int max_cy,
    int ss, float gx, float gy, int cluster, void* stream) {
  return launch_tris(corners,
                     scene_verts(pos, vobj, nrm, col, uv, model, mvp, n_obj),
                     tri_v, tri_mat, scratch, table, valid, attrs_full,
                     n_verts, n_tris, budget, width, height, min_c, max_cx,
                     max_cy, ss, gx, gy, cluster, stream);
}
