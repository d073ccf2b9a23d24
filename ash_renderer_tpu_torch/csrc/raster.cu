// K3: raster + distribute (phases V, D, E) for 8 x 128 tiles.  Replaces the
// Pallas kernel ash_renderer_tpu/ops/fused_kernel.py (_kernel, via
// rasterize_distribute, shade_mode=None); the plain torch version is
// ops/fused_kernel.py:rasterize_distribute_plain.
//
// One block per tile, one thread per pixel.  Phase V: the block walks the
// tile's 7 ranges (rmeta), staging CHUNK records at a time in shared memory
// (unpacked coords, edge coefficients, depths); each thread keeps the
// minimum (d16, -id) of its own pixel -- exact and order-free, so no
// atomics.  Fine-range rows only touch their own 16-px window.  Phase D:
// the winner's fields come straight from the unsorted comb table (row index
// = triangle id).  Phase E: shade.interp_fields_stacked, op for op.
//
// Bound by integer issue in phase V (every streamed slot is evaluated at all
// 1024 pixels of its tile) and by the planes write in phase E.
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int TILE_H = 8;
constexpr int N_PIX = TILE_H * TILE_W;
constexpr int N_RANGES = 7;
constexpr int EXT_RANGE = 5;
constexpr int FINE_RANGE = 6;
constexpr int OUT_COLS = 24;
constexpr int VIS_ROW = 17;
constexpr int CHUNK = 256;

struct Rec {
  int x0, y0, x1, y1, x2, y2;
  int a0, b0, t0, a1, b1, t1, a2, b2, t2;
  int z0, z1, z2;
  float inv_area;
  int id;
  int win;  // fine window (0-7) or -1 for the whole tile
};

__global__ void __launch_bounds__(N_PIX)
raster_kernel(const int* __restrict__ rmeta, const int* __restrict__ tbl,
              const int* __restrict__ ext, const int* __restrict__ comb,
              int* __restrict__ vis_d, int* __restrict__ vis_t,
              int* __restrict__ planes, int grid_w, int min_c, int ss) {
  __shared__ Rec recs[CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int row = p / TILE_W, col = p % TILE_W;
  const int tile_x = t % grid_w, tile_y = t / grid_w;
  const int half = ss / 2;
  const int px = tile_x * TILE_W + col;
  const int py = tile_y * TILE_H + row;
  const int sx = px * ss + half, sy = py * ss + half;

  // ---------------- phase V ----------------
  int best_d = DEPTH_MAX, best_t = BG_TRI;
  for (int r = 0; r < N_RANGES; ++r) {
    const int rs = rmeta[(t * N_RANGES + r) * 2];
    const int re = rmeta[(t * N_RANGES + r) * 2 + 1];
    const int* src = r == EXT_RANGE ? ext : tbl;
    for (int base = rs; base < re; base += CHUNK) {
      const int n = min(CHUNK, re - base);
      __syncthreads();
      if (p < n) {
        const int* row_p = src + (size_t)(base + p) * TBL_COLS;
        const int c0 = row_p[0], c1 = row_p[1], c2 = row_p[2];
        const int zq01 = row_p[3];
        Rec q;
        q.x0 = (c0 & 0xFFFF) + min_c;
        q.y0 = ((c0 >> 16) & 0xFFFF) + min_c;
        q.x1 = (c1 & 0xFFFF) + min_c;
        q.y1 = ((c1 >> 16) & 0xFFFF) + min_c;
        q.x2 = (c2 & 0xFFFF) + min_c;
        q.y2 = ((c2 >> 16) & 0xFFFF) + min_c;
        const Edge e0 = edge_coeffs(q.x1, q.y1, q.x2, q.y2);
        const Edge e1 = edge_coeffs(q.x2, q.y2, q.x0, q.y0);
        const Edge e2 = edge_coeffs(q.x0, q.y0, q.x1, q.y1);
        q.a0 = e0.a; q.b0 = e0.b; q.t0 = e0.bias;
        q.a1 = e1.a; q.b1 = e1.b; q.t1 = e1.bias;
        q.a2 = e2.a; q.b2 = e2.b; q.t2 = e2.bias;
        q.z0 = zq01 & 0xFFFF;
        q.z1 = (zq01 >> 16) & 0xFFFF;
        q.z2 = row_p[4];
        q.inv_area = fbits(row_p[5]);
        q.id = row_p[ID_COL];
        q.win = -1;
        if (r == FINE_RANGE) {
          const int xmin = min(min(q.x0, q.x1), q.x2);
          const int pxmin = max(0, floordiv(xmin - half + ss - 1, ss));
          q.win = (pxmin % TILE_W) / FINE_W;
        }
        recs[p] = q;
      }
      __syncthreads();
      for (int s = 0; s < n; ++s) {
        const Rec& q = recs[s];
        if (q.win >= 0 && col / FINE_W != q.win) continue;
        const int e0 = edge_at(q.a0, q.b0, q.x1, q.y1, sx, sy);
        const int e1 = edge_at(q.a1, q.b1, q.x2, q.y2, sx, sy);
        const int e2 = edge_at(q.a2, q.b2, q.x0, q.y0, sx, sy);
        if (e0 >= q.t0 && e1 >= q.t1 && e2 >= q.t2) {
          const int d = interp_depth16(e0, e1, e2, q.inv_area, q.z0, q.z1,
                                       q.z2);
          if (depth_key_better(d, q.id, best_d, best_t)) {
            best_d = d;
            best_t = q.id;
          }
        }
      }
    }
  }
  const size_t wp = (size_t)grid_w * TILE_W;
  const size_t vi = ((size_t)tile_y * TILE_H + row) * wp + px;
  vis_d[vi] = best_d;
  vis_t[vi] = best_t;

  // ---------------- phase D: the winner's comb fields ----------------
  const int* w = comb + (size_t)(best_t >= 0 ? best_t : 0) * TBL_COLS;
  auto O = [&](int c) { return best_t >= 0 ? w[c] : 0; };

  // ---------------- phase E: interp_fields_stacked ----------------
  const int off = -min_c;
  const int o0 = O(0), o1 = O(1), o2 = O(2);
  const int x0 = (o0 & 0xFFFF) - off, y0 = ((o0 >> 16) & 0xFFFF) - off;
  const int x1 = (o1 & 0xFFFF) - off, y1 = ((o1 >> 16) & 0xFFFF) - off;
  const int x2 = (o2 & 0xFFFF) - off, y2 = ((o2 >> 16) & 0xFFFF) - off;
  const float inv_area = fbits(O(5));
  const float iw0 = fbits(O(6)), iw1 = fbits(O(7)), iw2 = fbits(O(8));
  const Edge ea0 = edge_coeffs(x1, y1, x2, y2);
  const Edge ea1 = edge_coeffs(x2, y2, x0, y0);
  const Edge ea2 = edge_coeffs(x0, y0, x1, y1);
  const int e0 = edge_at(ea0.a, ea0.b, x1, y1, sx, sy);
  const int e1 = edge_at(ea1.a, ea1.b, x2, y2, sx, sy);
  const int e2 = edge_at(ea2.a, ea2.b, x0, y0, sx, sy);
  const float l0 = fmul(i2f(e0), inv_area);
  const float l1 = fmul(i2f(e1), inv_area);
  const float l2 = fmul(i2f(e2), inv_area);
  const float p0 = fmul(l0, iw0), p1 = fmul(l1, iw1), p2 = fmul(l2, iw2);
  const float inv_s = recip_spec(fadd(fadd(p0, p1), p2));
  const float m0 = fmul(p0, inv_s), m1 = fmul(p1, inv_s), m2 = fmul(p2, inv_s);

  int* out = planes + (size_t)t * OUT_COLS * N_PIX + p;
  float u = 0.0f, v = 0.0f;
#pragma unroll 1
  for (int ch = 0; ch < 12; ++ch) {
    const float a = dot3(m0, fbits(O(10 + ch)), m1, fbits(O(22 + ch)), m2,
                         fbits(O(34 + ch)));
    if (ch == 7) u = a;
    if (ch == 8) v = a;
    out[ch * N_PIX] = bits(a);
  }
  const float scale = i2f(ss);
  const float gx0 = fmul(fmul(fmul(i2f(ea0.a), scale), inv_area), iw0);
  const float gx1 = fmul(fmul(fmul(i2f(ea1.a), scale), inv_area), iw1);
  const float gx2 = fmul(fmul(fmul(i2f(ea2.a), scale), inv_area), iw2);
  const float gy0 = fmul(fmul(fmul(i2f(x2 - x1), scale), inv_area), iw0);
  const float gy1 = fmul(fmul(fmul(i2f(x0 - x2), scale), inv_area), iw1);
  const float gy2 = fmul(fmul(fmul(i2f(x1 - x0), scale), inv_area), iw2);
  const float u0 = fbits(O(17)), v0 = fbits(O(18));
  const float u1 = fbits(O(29)), v1 = fbits(O(30));
  const float u2 = fbits(O(41)), v2 = fbits(O(42));
  auto raws = [&](float d0, float d1, float d2, int k) {
    const float dsx = dot3(d0, 1.0f, d1, 1.0f, d2, 1.0f);
    const float dux = dot3(d0, u0, d1, u1, d2, u2);
    const float dvx = dot3(d0, v0, d1, v1, d2, v2);
    out[k * N_PIX] = bits(fmul(fsub(dux, fmul(u, dsx)), inv_s));
    out[(k + 1) * N_PIX] = bits(fmul(fsub(dvx, fmul(v, dsx)), inv_s));
  };
  raws(gx0, gx1, gx2, 12);
  raws(gy0, gy1, gy2, 14);
  out[16 * N_PIX] = O(9);
  out[VIS_ROW * N_PIX] = best_t;
#pragma unroll
  for (int k = VIS_ROW + 1; k < OUT_COLS; ++k) out[k * N_PIX] = 0;
}

}  // namespace

extern "C" int ash_rasterize_distribute(const int* rmeta, const int* tbl,
                                        const int* ext, const int* comb,
                                        int* vis_d, int* vis_t, int* planes,
                                        int n_tiles, int grid_w, int min_c,
                                        int ss, void* stream) {
  if (n_tiles > 0)
    raster_kernel<<<n_tiles, N_PIX, 0, (cudaStream_t)stream>>>(
        rmeta, tbl, ext, comb, vis_d, vis_t, planes, grid_w, min_c, ss);
  return (int)cudaGetLastError();
}
