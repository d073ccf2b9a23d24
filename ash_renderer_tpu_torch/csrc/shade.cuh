// The surface half of shading up to the texture tap, one definition for
// K3F's phase F (raster.cu) and the classic route's shade + pack K11
// (shade_pack.cu): ops/shade.py:surface_prelight op for op, the reference's
// _phase_f (ash_renderer_tpu/ops/fused_kernel.py:128-270).  Its select trees
// over the material / mip / light tables become indexed loads from the
// shade constants (shade.py:pack_shade_consts), on the same clamped
// indices.
#pragma once

#include <stdint.h>

#include "specmath.cuh"

namespace ash {

constexpr int MAX_LEVELS = 13;  // textures.MAX_LEVELS

// offsets of the shade constants (shade.py:shade_consts_layout)
struct ShadeLayout {
  int base, texid, spec, shin, loff, lw, lh, nlev, ldir, lcol, amb, cam;
};

struct ShadeMode {
  const int* consts;
  int n_consts, m_n, t_n, has_m, has_a, has_l;
};

__device__ __forceinline__ ShadeLayout shade_layout(const ShadeMode& sm) {
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

// surface_prelight's outputs for one pixel: colour * base, diffuse,
// specular, the lit mask, the texture tap's quad row, fu, fv and texmask
struct Prelight {
  float p[4], diff[3], spec, fu, fv;
  int lit, tap, texmask;
};

// a: the 12 interpolated attributes; durx..dvry: the raw uv derivatives;
// mat_row: the winner's material; sc: the shade constants
__device__ __forceinline__ Prelight prelight(const float (&a)[12], float durx,
                                             float dvrx, float dury,
                                             float dvry, int mat_row,
                                             const int* sc,
                                             const ShadeMode& sm) {
  const ShadeLayout L = shade_layout(sm);
  Prelight s;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) s.p[ch] = a[ch];
#pragma unroll
  for (int i = 0; i < 3; ++i) s.diff[i] = 0.0f;
  s.spec = 0.0f;
  s.fu = 0.0f;
  s.fv = 0.0f;
  s.lit = 0;
  s.tap = 0;
  s.texmask = 0;
  int mat = 0;
  if (sm.has_m) {
    mat = min(max(mat_row, 0), sm.m_n - 1);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      s.p[ch] = fmul(s.p[ch], fbits(sc[L.base + 4 * mat + ch]));
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
      s.fu = fsub(ut, i2f(iu0));
      s.fv = fsub(vt, i2f(iv0));
      s.tap = wadd(wadd(off_t, wmul(floormod(iv0, h_t), w_t)),
                   floormod(iu0, w_t));
      s.texmask = tex_id >= 0 ? 1 : 0;
    }
  }
  if (sm.has_l) {
    // Blinn-Phong diffuse and specular
    const float nx = a[4], ny = a[5], nz = a[6];
    const float n2 = dot3(nx, nx, ny, ny, nz, nz);
    const float invn = rsqrt_spec(fmax_nan(n2, 1e-30f));
    const float nhx = fmul(nx, invn), nhy = fmul(ny, invn),
                nhz = fmul(nz, invn);
    s.lit = n2 > 1e-12f ? 1 : 0;
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
      s.diff[i] = fadd(amb, fmul(ndotl, fbits(sc[L.lcol + i])));
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
      s.spec = fmul(powi(ndoth, sh, 8), sk);
    }
  }
  return s;
}

}  // namespace ash
