// K6: the fused route's clip tail in three launches with no host read:
// count the clip candidates, select the first clip_budget of them, then
// clip, fan, snap and pack each.  The plain torch version is
// ash_renderer_tpu_torch/ops/clip_tail.py:clip_tail_plain
// (geometry.clip_tail_fused, tritables.comb_rows, binsort.stream_keys).
//
// It replaces no Pallas kernel.  The reference's clip tail is XLA glue
// under one jit (ash_renderer_tpu/pipeline.py:416-447), which XLA fuses;
// eager torch pays ~1,200 launches and two host reads for the same chain
// over the whole budget.
//
// Bound by the launch floor: ~20 MB move (the flags, the selected corners'
// table rows, 7 x budget comb rows of 512 bytes and their keys), a few
// microseconds at 3.35 TB/s.  So the design keeps to three launches and
// no host read, and spends no effort on the clip's arithmetic, which is
// tiny: 16 lanes per budget slot, one per table channel, each keeping its
// channel of the 12 polygon slots in registers; the plane distances are
// computed by every lane of the slot from the x, y, z, w lanes' values.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "binsort.cuh"
#include "specmath.cuh"

namespace {

using namespace ash;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int COUNT_THREADS = 256;
constexpr int COUNT_ITERS = 16;
constexpr int CHUNK = COUNT_THREADS * COUNT_ITERS;  // ops/clip_tail.CHUNK
constexpr int N_WARPS = COUNT_THREADS / 32;
constexpr int N_TBL = 16;    // table channels: clip x, y, z, w + 12 attrs
constexpr int ATTR = 12;
constexpr int POLY = 12;     // polygon slots (geometry.POLY_SLOTS)
constexpr int FAN = 7;       // fan triangles a polygon (MAX_CLIP_TRIS)
constexpr int HDR = 10;      // comb columns 0-9
constexpr int SLOTS = 8;     // budget slots a fan block, N_TBL lanes each
// counter buffer (ops/clip_tail.COUNTERS) and the per-chunk counts
constexpr int C_CLIPPED = 0, C_OVERFLOW = 1, C_VALID = 2, C_FAST = 3;
constexpr int N_COUNTS = 3;  // per chunk: clip candidates, valid, fast

__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)((uint32_t)lo | ((uint32_t)hi << 16));
}

// sum of v over the block (COUNT_THREADS threads); every thread gets it
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

// 1. per chunk of CHUNK flags: the clip candidates (bit 1), valid rows
// (bit 0) and fast rows (bit 2)
__global__ void __launch_bounds__(COUNT_THREADS)
count_kernel(const int* __restrict__ flags, int n, int* __restrict__ counts) {
  __shared__ int red[N_WARPS];
  const int base = blockIdx.x * CHUNK;
  int c_clip = 0, c_valid = 0, c_fast = 0;
#pragma unroll 4
  for (int k = 0; k < COUNT_ITERS; ++k) {
    const int i = base + k * COUNT_THREADS + threadIdx.x;
    const int f = i < n ? flags[i] : 0;
    c_valid += __popc(__ballot_sync(FULL, f & 1));
    c_clip += __popc(__ballot_sync(FULL, (f >> 1) & 1));
    c_fast += __popc(__ballot_sync(FULL, (f >> 2) & 1));
  }
  // each lane holds its warp's counts: one lane a warp contributes
  const bool lead = (threadIdx.x & 31) == 0;
  c_clip = block_sum(lead ? c_clip : 0, red);
  c_valid = block_sum(lead ? c_valid : 0, red);
  c_fast = block_sum(lead ? c_fast : 0, red);
  if (threadIdx.x == 0) {
    counts[blockIdx.x * N_COUNTS + 0] = c_clip;
    counts[blockIdx.x * N_COUNTS + 1] = c_valid;
    counts[blockIdx.x * N_COUNTS + 2] = c_fast;
  }
}

// 2. the first `budget` candidates in ascending row order into sel, -1
// fill; block 0 also writes the counters (the tail's valid rows are added
// by the fan kernel)
__global__ void __launch_bounds__(COUNT_THREADS)
select_kernel(const int* __restrict__ flags, int n,
              const int* __restrict__ counts, int n_chunks, int budget,
              int* __restrict__ sel, int* __restrict__ counters) {
  __shared__ int red[N_WARPS];
  __shared__ int wsum[N_WARPS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (c == 0) {
    int clip = 0, valid = 0, fast = 0;
    for (int i = tid; i < n_chunks; i += COUNT_THREADS) {
      clip += counts[i * N_COUNTS + 0];
      valid += counts[i * N_COUNTS + 1];
      fast += counts[i * N_COUNTS + 2];
    }
    clip = block_sum(clip, red);
    valid = block_sum(valid, red);
    fast = block_sum(fast, red);
    const int kept = min(clip, budget);
    for (int i = kept + tid; i < budget; i += COUNT_THREADS) sel[i] = -1;
    if (tid == 0) {
      counters[C_CLIPPED] = clip;
      counters[C_OVERFLOW] = clip - kept;
      counters[C_VALID] = valid;
      counters[C_FAST] = fast;
    }
  }
  if (c >= n_chunks || counts[c * N_COUNTS] == 0) return;
  int before = 0;  // candidates in the chunks before this one
  for (int i = tid; i < c; i += COUNT_THREADS) before += counts[i * N_COUNTS];
  before = block_sum(before, red);
  const int base = c * CHUNK;
  const unsigned lt = (1u << lane) - 1u;
  for (int k = 0; k < COUNT_ITERS && before < budget; ++k) {
    const int i = base + k * COUNT_THREADS + tid;
    const bool f = i < n && ((flags[i] >> 1) & 1);
    const unsigned b = __ballot_sync(FULL, f);
    if (lane == 0) wsum[warp] = __popc(b);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < N_WARPS; ++w) {
      off += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    const int pos = before + off + __popc(b & lt);
    if (f && pos < budget) sel[pos] = i;
    before += total;
    __syncthreads();  // wsum is rewritten next round
  }
}

struct FanParams {
  int n_verts, n_tris, budget, id_base;
  int width, height, min_c, max_cx, max_cy, ss;
  float gx, gy;
  KeyWindow win;
};

// plane p's signed distance (geometry._plane_dists: near, far, left, right,
// top, bottom)
__device__ __forceinline__ float plane_dist(int p, float x, float y, float z,
                                            float w, float gx, float gy) {
  switch (p) {
    case 0: return z;
    case 1: return fsub(w, z);
    case 2: return fadd(fmul(gx, w), x);
    case 3: return fsub(fmul(gx, w), x);
    case 4: return fadd(fmul(gy, w), y);
    default: return fsub(fmul(gy, w), y);
  }
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

// 3. one budget slot per N_TBL lanes: Sutherland-Hodgman against the 6
// guard planes, the fan, and the slot's 7 comb rows and keys
__global__ void __launch_bounds__(SLOTS * N_TBL)
fan_kernel(const int* __restrict__ tblT, const int* __restrict__ tri_v,
           const int* __restrict__ tri_mat, const int* __restrict__ sel,
           int* __restrict__ comb, int* __restrict__ keys,
           int* __restrict__ counters, FanParams P) {
  __shared__ float poly[SLOTS][POLY][N_TBL];
  __shared__ int hdr[SLOTS][FAN][HDR];
  __shared__ int poly_n[SLOTS];
  __shared__ unsigned row_valid[SLOTS];
  const int g = threadIdx.x / N_TBL;  // slot in the block
  const int ch = threadIdx.x % N_TBL;  // this lane's table channel
  const unsigned gmask = 0xFFFFu << (threadIdx.x & 16);
  const int slot = blockIdx.x * SLOTS + g;
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
      // placement: each emitted vertex at its position, as 0.0f + v
      float out[POLY];
#pragma unroll
      for (int q = 0; q < POLY; ++q) {
        float v = 0.0f;
        bool hit = false;
#pragma unroll
        for (int s = 0; s < POLY; ++s) {
          const bool ha = ((a_in >> s) & 1) && pos_a[s] == q;
          const bool hi = ((cross >> s) & 1) && pos_i[s] == q;
          v = ha ? buf[s] : (hi ? inter[s] : v);
          hit = hit || ha || hi;
        }
        out[q] = hit ? fadd(0.0f, v) : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < POLY; ++s) buf[s] = out[s];
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
  if (slot >= P.budget) return;
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

}  // namespace

extern "C" int ash_clip_count(const int* flags, int n, int* counts,
                              void* stream) {
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  if (n_chunks > 0)
    count_kernel<<<n_chunks, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
        flags, n, counts);
  return (int)cudaGetLastError();
}

extern "C" int ash_clip_select(const int* flags, int n, const int* counts,
                               int n_chunks, int budget, int* sel,
                               int* counters, void* stream) {
  select_kernel<<<n_chunks > 0 ? n_chunks : 1, COUNT_THREADS, 0,
                  (cudaStream_t)stream>>>(flags, n, counts, n_chunks, budget,
                                          sel, counters);
  return (int)cudaGetLastError();
}

extern "C" int ash_clip_fan(const int* tblT, const int* tri_v,
                            const int* tri_mat, const int* sel,
                            int* comb_tail, int* keys, int* counters,
                            int n_verts, int n_tris, int budget, int width,
                            int height, int min_c, int max_cx, int max_cy,
                            int ss, float gx, float gy, int row0, int py_lo,
                            int py_hi, int tile_h, int grid_w, int n_tiles,
                            void* stream) {
  FanParams P{n_verts, n_tris, budget, n_tris, width, height, min_c, max_cx,
              max_cy,  ss,     gx,     gy,
              KeyWindow{row0, py_lo, py_hi, tile_h, grid_w, n_tiles}};
  const int blocks = (budget + SLOTS - 1) / SLOTS;
  if (blocks > 0)
    fan_kernel<<<blocks, SLOTS * N_TBL, 0, (cudaStream_t)stream>>>(
        tblT, tri_v, tri_mat, sel, comb_tail, keys, counters, P);
  return (int)cudaGetLastError();
}
