// K3: raster + distribute (phases V, D, E) for 8 x 128 tiles, and K3F, the
// same kernel with phase F.  Replaces the Pallas kernel
// ash_renderer_tpu/ops/fused_kernel.py (_kernel, via rasterize_distribute;
// shade_mode=None for K3, set for K3F); the plain torch version is
// ops/fused_kernel.py:rasterize_distribute_plain.
//
// One block per tile, one thread per pixel.  Phase V: the block walks the
// tile's 7 ranges (rmeta), staging CHUNK records at a time in shared memory
// (unpacked coords, edge coefficients, depths); each thread keeps the
// minimum (d16, -id) of its own pixel -- exact and order-free, so no
// atomics.  Fine-range rows only touch their own 16-px window.  Phase D:
// the winner's fields come straight from the unsorted comb table (row index
// = triangle id).  Phase E: shade.interp_fields_stacked, op for op.
// Phase F (K3F, the SHADE instantiation): the reference's _phase_f, op for
// op (shade.py:surface_prelight), on the pixel's interpolated values;
// its select trees over the material / mip / light tables become indexed
// loads from the shade constants, which each block stages in shared memory.
//
// Bound by integer issue in phase V (every streamed slot is evaluated at all
// 1024 pixels of its tile) and by the planes write in phase E.  Phase F adds
// per-pixel float work (three rsqrt chains, a powi); under
// __launch_bounds__(1024) ptxas gives it 32 registers, no spills, and a
// 48-byte stack frame for the attribute array (-Xptxas -v on sm_90a).
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
constexpr int MAX_LEVELS = 13;
// 16 materials * 7 + 2 textures * (3 * 13 + 1) + light 7 + camera 3
constexpr int MAX_CONSTS = 16 * 7 + 2 * (3 * MAX_LEVELS + 1) + 7 + 3;
// phase F plane rows
constexpr int F_P = 0, F_DIFF = 4, F_SPEC = 7, F_LIT = 8, F_TAP = 9,
              F_FU = 10, F_FV = 11, F_TEXMASK = 12;

struct Rec {
  int x0, y0, x1, y1, x2, y2;
  int a0, b0, t0, a1, b1, t1, a2, b2, t2;
  int z0, z1, z2;
  float inv_area;
  int id;
  int win;  // fine window (0-7) or -1 for the whole tile
};

// offsets of the shade constants (shade.py:shade_consts_layout)
struct ShadeLayout {
  int base, texid, spec, shin, loff, lw, lh, nlev, ldir, lcol, amb, cam;
};

struct ShadeMode {
  const int* consts;
  int n_consts, m_n, t_n, has_m, has_a, has_l;
};

__device__ ShadeLayout shade_layout(const ShadeMode& sm) {
  ShadeLayout L{};
  int pos = 0;
  if (sm.has_m) {
    L.base = pos; pos += 4 * sm.m_n;
    L.texid = pos; pos += sm.m_n;
    L.spec = pos; pos += sm.m_n;
    L.shin = pos; pos += sm.m_n;
  }
  if (sm.has_a) {
    L.loff = pos; pos += sm.t_n * MAX_LEVELS;
    L.lw = pos; pos += sm.t_n * MAX_LEVELS;
    L.lh = pos; pos += sm.t_n * MAX_LEVELS;
    L.nlev = pos; pos += sm.t_n;
  }
  if (sm.has_l) {
    L.ldir = pos; pos += 3;
    L.lcol = pos; pos += 3;
    L.amb = pos; pos += 1;
  }
  L.cam = pos;
  return L;
}

// Phase F: writes planes rows 0-16 of one pixel (out points at row 0).
// a: the 12 interpolated attributes; durx..dvry: the raw uv derivatives;
// mat_row: the winner's material; sc: the shade constants.
__device__ void phase_f(int* out, const float* a, float durx, float dvrx,
                        float dury, float dvry, int mat_row, const int* sc,
                        const ShadeMode& sm) {
  const ShadeLayout L = shade_layout(sm);
  float pch[4] = {a[0], a[1], a[2], a[3]};
  float diff[3] = {0.0f, 0.0f, 0.0f};
  float spec = 0.0f, fu = 0.0f, fv = 0.0f;
  int lit = 0, tap = 0, texmask = 0, mat = 0;
  if (sm.has_m) {
    mat = min(max(mat_row, 0), sm.m_n - 1);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      pch[ch] = fmul(pch[ch], fbits(sc[L.base + 4 * mat + ch]));
    if (sm.has_a) {
      const int tex_id = sc[L.texid + mat];
      // the mip level from the raw uv derivatives
      const int tex_c = min(max(tex_id, 0), sm.t_n - 1);
      const float bw = i2f(sc[L.lw + tex_c * MAX_LEVELS]);
      const float bh = i2f(sc[L.lh + tex_c * MAX_LEVELS]);
      const int nl = sc[L.nlev + tex_c];
      auto fp2 = [&](float dur, float dvr) {
        const float du = fmul(dur, bw), dv = fmul(dvr, bh);
        return fadd(fmul(du, du), fmul(dv, dv));
      };
      float rho2 = fmax_nan(fp2(durx, dvrx), fp2(dury, dvry));
      rho2 = fmax_nan(rho2, 1e-20f);
      const int level =
          min(max(float_exponent(rho2) >> 1, 0), max(nl - 1, 0));
      // the tap address (shade.tex_address)
      const int flat = tex_c * MAX_LEVELS + level;
      const int off_t = sc[L.loff + flat];
      const int w_t = sc[L.lw + flat], h_t = sc[L.lh + flat];
      const float us = isfinite(a[7]) ? a[7] : 0.0f;
      const float vs = isfinite(a[8]) ? a[8] : 0.0f;
      const float ut = fsub(fmul(us, i2f(w_t)), 0.5f);
      const float vt = fsub(fmul(vs, i2f(h_t)), 0.5f);
      const int iu0 = f32_to_i32_sat(floorf(ut));
      const int iv0 = f32_to_i32_sat(floorf(vt));
      fu = fsub(ut, i2f(iu0));
      fv = fsub(vt, i2f(iv0));
      tap = wadd(wadd(off_t, wmul(floormod(iv0, h_t), w_t)),
                 floormod(iu0, w_t));
      texmask = tex_id >= 0 ? 1 : 0;
    }
  }
  if (sm.has_l) {
    // Blinn-Phong diffuse and specular
    const float nx = a[4], ny = a[5], nz = a[6];
    const float n2 = dot3(nx, nx, ny, ny, nz, nz);
    const float invn = rsqrt_spec(fmax_nan(n2, 1e-30f));
    const float nhx = fmul(nx, invn), nhy = fmul(ny, invn),
                nhz = fmul(nz, invn);
    lit = n2 > 1e-12f ? 1 : 0;
    const float l0 = fbits(sc[L.ldir]), l1 = fbits(sc[L.ldir + 1]),
                l2 = fbits(sc[L.ldir + 2]);
    const float invd = rsqrt_spec(fmax_nan(dot3(l0, l0, l1, l1, l2, l2),
                                           1e-30f));
    const float ldx = fmul(l0, invd), ldy = fmul(l1, invd),
                ldz = fmul(l2, invd);
    const float ndotl =
        fmax_nan(-dot3(nhx, ldx, nhy, ldy, nhz, ldz), 0.0f);
    const float amb = fbits(sc[L.amb]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      diff[i] = fadd(amb, fmul(ndotl, fbits(sc[L.lcol + i])));
    if (sm.has_m) {
      const float sk = fbits(sc[L.spec + mat]);
      const int sh = sc[L.shin + mat];
      const float vx = fsub(fbits(sc[L.cam]), a[9]);
      const float vy = fsub(fbits(sc[L.cam + 1]), a[10]);
      const float vz = fsub(fbits(sc[L.cam + 2]), a[11]);
      const float invv =
          rsqrt_spec(fmax_nan(dot3(vx, vx, vy, vy, vz, vz), 1e-30f));
      const float hx = fsub(fmul(vx, invv), ldx);
      const float hy = fsub(fmul(vy, invv), ldy);
      const float hz = fsub(fmul(vz, invv), ldz);
      const float invh =
          rsqrt_spec(fmax_nan(dot3(hx, hx, hy, hy, hz, hz), 1e-30f));
      const float ndoth = fmax_nan(
          dot3(nhx, fmul(hx, invh), nhy, fmul(hy, invh), nhz, fmul(hz, invh)),
          0.0f);
      spec = fmul(powi(ndoth, sh, 8), sk);
    }
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) out[(F_P + ch) * N_PIX] = bits(pch[ch]);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[(F_DIFF + i) * N_PIX] = bits(diff[i]);
  out[F_SPEC * N_PIX] = bits(spec);
  out[F_LIT * N_PIX] = lit;
  out[F_TAP * N_PIX] = tap;
  out[F_FU * N_PIX] = bits(fu);
  out[F_FV * N_PIX] = bits(fv);
  out[F_TEXMASK * N_PIX] = texmask;
#pragma unroll
  for (int k = F_TEXMASK + 1; k < VIS_ROW; ++k) out[k * N_PIX] = 0;
}

template <bool SHADE>
__global__ void __launch_bounds__(N_PIX)
raster_kernel(const int* __restrict__ rmeta, const int* __restrict__ tbl,
              const int* __restrict__ ext, const int* __restrict__ comb,
              int* __restrict__ vis_d, int* __restrict__ vis_t,
              int* __restrict__ planes, int grid_w, int min_c, int ss,
              ShadeMode smode) {
  __shared__ Rec recs[CHUNK];
  __shared__ int sc[SHADE ? MAX_CONSTS : 1];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  if constexpr (SHADE) {
    for (int i = p; i < smode.n_consts; i += N_PIX) sc[i] = smode.consts[i];
    // the first read is after phase V's barriers, but a tile with no
    // streamed rows passes none
    __syncthreads();
  }
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
  float attr[SHADE ? 12 : 1];
#pragma unroll 1
  for (int ch = 0; ch < 12; ++ch) {
    const float a = dot3(m0, fbits(O(10 + ch)), m1, fbits(O(22 + ch)), m2,
                         fbits(O(34 + ch)));
    if (ch == 7) u = a;
    if (ch == 8) v = a;
    if constexpr (SHADE)
      attr[ch] = a;
    else
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
  auto raws = [&](float d0, float d1, float d2, float& du, float& dv) {
    const float dsx = dot3(d0, 1.0f, d1, 1.0f, d2, 1.0f);
    const float dux = dot3(d0, u0, d1, u1, d2, u2);
    const float dvx = dot3(d0, v0, d1, v1, d2, v2);
    du = fmul(fsub(dux, fmul(u, dsx)), inv_s);
    dv = fmul(fsub(dvx, fmul(v, dsx)), inv_s);
  };
  float durx, dvrx, dury, dvry;
  raws(gx0, gx1, gx2, durx, dvrx);
  raws(gy0, gy1, gy2, dury, dvry);
  if constexpr (SHADE) {
    phase_f(out, attr, durx, dvrx, dury, dvry, O(9), sc, smode);
  } else {
    out[12 * N_PIX] = bits(durx);
    out[13 * N_PIX] = bits(dvrx);
    out[14 * N_PIX] = bits(dury);
    out[15 * N_PIX] = bits(dvry);
    out[16 * N_PIX] = O(9);
  }
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
    raster_kernel<false><<<n_tiles, N_PIX, 0, (cudaStream_t)stream>>>(
        rmeta, tbl, ext, comb, vis_d, vis_t, planes, grid_w, min_c, ss,
        ShadeMode{nullptr, 0, 0, 0, 0, 0, 0});
  return (int)cudaGetLastError();
}

// K3F: as above, with phase F from the shade constants (fused_kernel.py:
// pack_shade_consts); 1 = invalid argument if they exceed the kernel's caps
extern "C" int ash_rasterize_shade(const int* rmeta, const int* tbl,
                                   const int* ext, const int* comb,
                                   int* vis_d, int* vis_t, int* planes,
                                   int n_tiles, int grid_w, int min_c, int ss,
                                   const int* consts, int n_consts, int m_n,
                                   int t_n, int has_m, int has_a, int has_l,
                                   void* stream) {
  if (n_consts > MAX_CONSTS || m_n > 16 || t_n > 2)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    raster_kernel<true><<<n_tiles, N_PIX, 0, (cudaStream_t)stream>>>(
        rmeta, tbl, ext, comb, vis_d, vis_t, planes, grid_w, min_c, ss,
        ShadeMode{consts, n_consts, m_n, t_n, has_m, has_a, has_l});
  return (int)cudaGetLastError();
}
