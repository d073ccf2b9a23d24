// K1: triangle setup, one thread per triangle, one 128-thread block per
// meshlet.  Replaces the Pallas kernel ash_renderer_tpu/ops/setup_kernel.py
// (_kernel, via triangle_setup); the plain torch version is
// ash_renderer_tpu_torch/ops/setup_kernel.py:triangle_setup_plain.
//
// Bound by memory: ~0.7 GB per headline frame, nearly all of it the comb
// rows.  Rows are staged in shared memory so each block writes its 128 x 128
// block coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int MESHLET = 128;  // triangles (and vertices) per meshlet
constexpr int N_TBL = 16;     // clip x,y,z,w + 12 attrs
constexpr int LIVE_COLS = ID_COL + 1;
constexpr int SROW = LIVE_COLS + 2;  // padded shared row

struct Params {
  int n_verts, width, height, min_c, max_cx, max_cy, ss;
  float gx, gy;
  int grid_w, tile_h, n_tiles;
};

struct Corner {
  int x, y, zq, oc;
  float iw;
  int g[N_TBL];
};

__device__ Corner corner(const int* __restrict__ tblT, int vi, bool ok,
                         const Params& P) {
  Corner c;
#pragma unroll
  for (int f = 0; f < N_TBL; ++f)
    c.g[f] = ok ? tblT[(size_t)f * P.n_verts + vi] : 0;
  float cx = fbits(c.g[0]), cy = fbits(c.g[1]);
  float cz = fbits(c.g[2]), cw = fbits(c.g[3]);
  float iw_raw = recip_spec(cw);
  float iw = finite(iw_raw) ? iw_raw : 0.0f;
  auto nd = [&](float v) {
    float r = fmul(v, iw);
    return finite(r) ? r : 0.0f;
  };
  c.x = snap_coord(nd(cx), P.width, P.ss, P.min_c, P.max_cx);
  c.y = snap_coord(nd(cy), P.height, P.ss, P.min_c, P.max_cy);
  c.zq = quantize_depth(nd(cz));
  c.iw = iw;
  // bits 0-5: guard planes; bits 6-9: screen side planes (g = 1)
  const float ds[10] = {
      cz,
      fsub(cw, cz),
      fadd(fmul(P.gx, cw), cx),
      fsub(fmul(P.gx, cw), cx),
      fadd(fmul(P.gy, cw), cy),
      fsub(fmul(P.gy, cw), cy),
      fadd(cw, cx),
      fsub(cw, cx),
      fadd(cw, cy),
      fsub(cw, cy),
  };
  int oc = 0;
#pragma unroll
  for (int p = 0; p < 10; ++p) oc |= (ds[p] < 0.0f ? 1 : 0) << p;
  c.oc = oc;
  return c;
}

__device__ __forceinline__ int pack16(int lo, int hi) {
  return (int)((uint32_t)lo | ((uint32_t)hi << 16));
}

__global__ void __launch_bounds__(MESHLET)
setup_kernel(const int* __restrict__ tblT, const int* __restrict__ ltT,
             const int* __restrict__ matT, int* __restrict__ comb,
             int* __restrict__ keys, int* __restrict__ flags,
             int* __restrict__ extx, int* __restrict__ exty, Params P) {
  __shared__ int srow[MESHLET][SROW];
  const int m = blockIdx.x;
  const int j = threadIdx.x;
  const int tri = m * MESHLET + j;
  const int* lt = ltT + (size_t)m * 3 * MESHLET;
  const int la = lt[j], lb = lt[MESHLET + j], lc = lt[2 * MESHLET + j];
  const int vbase = m * MESHLET;
  const Corner A = corner(tblT, vbase + la, la >= 0, P);
  const Corner B = corner(tblT, vbase + lb, lb >= 0, P);
  const Corner C = corner(tblT, vbase + lc, lc >= 0, P);

  const bool alive = la >= 0;
  const int oc_and = A.oc & B.oc & C.oc;
  const bool out_any = (oc_and & 0x3F) != 0;
  const bool all_in = ((A.oc | B.oc | C.oc) & 0x3F) == 0;
  const bool out_screen = (oc_and >> 6) != 0;
  const bool fast = alive && all_in;
  const bool needs_clip = alive && !all_in && !out_any && !out_screen;
  const int sl = wsub(wmul(wsub(B.x, A.x), wsub(C.y, A.y)),
                      wmul(wsub(B.y, A.y), wsub(C.x, A.x)));
  const bool valid = fast && sl < 0;
  const int area2 = valid ? -sl : 1;
  const float inv_area2 = recip_spec(i2f(area2));
  auto zi = [&](int v) { return valid ? v : 0; };

  // meshlet-level cull: no valid and no clip-candidate triangle -> zeros
  const bool alive_any = __syncthreads_or(valid || needs_clip);
  int* out = comb + (size_t)m * MESHLET * TBL_COLS;
  if (alive_any) {
    const int off = -P.min_c;
    int* s = srow[j];
    // winding rewind (a, c, b); coords zeroed before the +off pack
    s[0] = pack16(zi(A.x) + off, zi(A.y) + off);
    s[1] = pack16(zi(C.x) + off, zi(C.y) + off);
    s[2] = pack16(zi(B.x) + off, zi(B.y) + off);
    s[3] = zi(pack16(A.zq, C.zq));
    s[4] = zi(B.zq);
    s[5] = zi(bits(inv_area2));
    s[6] = zi(bits(A.iw));
    s[7] = zi(bits(C.iw));
    s[8] = zi(bits(B.iw));
    s[9] = zi(matT[tri]);
    // attribute corners in rewound order, not masked by validity
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      s[10 + k] = A.g[4 + k];
      s[22 + k] = C.g[4 + k];
      s[34 + k] = B.g[4 + k];
    }
    s[ID_COL] = tri;
    __syncthreads();
    for (int i = j; i < MESHLET * TBL_COLS; i += MESHLET) {
      const int r = i / TBL_COLS, c = i % TBL_COLS;
      out[i] = c < LIVE_COLS ? srow[r][c] : 0;
    }
  } else {
    for (int i = j; i < MESHLET * TBL_COLS; i += MESHLET) out[i] = 0;
  }

  // streaming key (ops/binsort.stream_keys formulas on the zeroed coords)
  const int ss = P.ss, half = P.ss / 2;
  const int xmin = zi(min(min(A.x, B.x), C.x));
  const int xmax = zi(max(max(A.x, B.x), C.x));
  const int ymin = zi(min(min(A.y, B.y), C.y));
  const int ymax = zi(max(max(A.y, B.y), C.y));
  const int pxmin = max(0, floordiv(xmin - half + ss - 1, ss));
  const int pxmax = min(P.width - 1, floordiv(xmax - half, ss));
  const int pymin = max(0, floordiv(ymin - half + ss - 1, ss));
  const int pymax = min(P.height - 1, floordiv(ymax - half, ss));
  const bool live = valid && pxmax >= pxmin && pymax >= pymin;
  const int tx0 = floordiv(pxmin, TILE_W), tx1 = floordiv(pxmax, TILE_W);
  const int ty0 = floordiv(pymin, P.tile_h), ty1 = floordiv(pymax, P.tile_h);
  const bool spill_r = tx1 > tx0, spill_d = ty1 > ty0;
  const bool wide = (tx1 - tx0 > 1) || (ty1 - ty0 > 1);
  const int grp = spill_r && spill_d ? 0 : (spill_r ? 1 : (spill_d ? 2 : 3));
  const int tile = ty0 * P.grid_w + tx0;
  const bool fine =
      grp == 3 && floordiv(pxmin, FINE_W) == floordiv(pxmax, FINE_W);
  const int subc = floormod(floordiv(pxmin, FINE_W), TILE_W / FINE_W);
  const int key_fine = P.n_tiles * N_GRP + tile * N_FINE + subc;
  keys[tri] = live ? (wide ? P.n_tiles * KEYS_PER_TILE
                           : (fine ? key_fine : tile * N_GRP + grp))
                   : P.n_tiles * KEYS_PER_TILE + 1;
  flags[tri] = (valid ? 1 : 0) | (needs_clip ? 2 : 0) | (fast ? 4 : 0);
  extx[tri] = pack16(pxmin & 0xFFFF, pxmax);
  exty[tri] = pack16(pymin & 0xFFFF, pymax);
}

}  // namespace

extern "C" int ash_triangle_setup(const int* tblT, const int* ltT,
                                  const int* matT, int* comb, int* keys,
                                  int* flags, int* extx, int* exty,
                                  int n_meshlets, int n_verts, int width,
                                  int height, int min_c, int max_cx,
                                  int max_cy, int ss, float gx, float gy,
                                  int grid_w, int tile_h, int n_tiles,
                                  void* stream) {
  Params P{n_verts, width, height, min_c, max_cx, max_cy, ss,
           gx,      gy,    grid_w, tile_h, n_tiles};
  if (n_meshlets > 0)
    setup_kernel<<<n_meshlets, MESHLET, 0, (cudaStream_t)stream>>>(
        tblT, ltT, matT, comb, keys, flags, extx, exty, P);
  return (int)cudaGetLastError();
}
