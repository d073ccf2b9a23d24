// The spec's bit-exact formulas as __device__ code, shared by the port's
// kernels.  Counterpart of ash_renderer_tpu_torch/specmath.py, function for
// function.
//
// Rules (the reasons are in the Python module):
// * every float mul/add/sub is an explicit __fmul_rn/__fadd_rn/__fsub_rn,
//   and the library is built with --fmad=false, so nothing contracts to FMA;
// * round half to even is rintf / __float2int_rn, never roundf;
// * integer division and modulo floor (floordiv / floormod below);
// * edge functions wrap modulo 2^32 like the spec's int32, so they are
//   computed in uint32_t and cast back;
// * no hardware division, sqrt or transcendental: recip_spec / rsqrt_spec.
#pragma once

#include <stdint.h>

namespace ash {

constexpr int DEPTH_MAX = 65535;
constexpr int BG_TRI = -1;
constexpr int TILE_W = 128;
constexpr int FINE_W = 16;
constexpr int N_FINE = 8;
constexpr int N_GRP = 4;
constexpr int KEYS_PER_TILE = N_GRP + N_FINE;
constexpr int TBL_COLS = 128;
constexpr int ID_COL = 46;
// the record K3 streams of a comb row (ops/tritables.REC_COLS): columns
// 0-5, then ID_COL at word REC_ID, then a zero word; 32 bytes
constexpr int REC_WORDS = 8;
constexpr int REC_ID = 6;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {  // b > 0
  int r = a % b;
  return r < 0 ? r + b : r;
}

// wrapping int32 arithmetic
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ float i2f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ int bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ float fbits(int v) { return __int_as_float(v); }

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

// (w0*a0 + w1*a1) + w2*a2
__device__ __forceinline__ float dot3(float w0, float a0, float w1, float a1,
                                      float w2, float a2) {
  return fadd(fadd(fmul(w0, a0), fmul(w1, a1)), fmul(w2, a2));
}

__device__ __forceinline__ float recip_spec(float x) {
  int b = bits(x);
  int sign = b & (int)0x80000000u;
  int mag = b & 0x7FFFFFFF;
  float r = fbits(0x7EF311C3 - mag);
  float ax = fbits(mag);
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fmul(r, fsub(2.0f, fmul(ax, r)));
  return fbits(bits(r) ^ sign);
}

__device__ __forceinline__ float rsqrt_spec(float x) {
  float r = fbits(0x5F375A86 - (bits(x) >> 1));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r = fmul(r, fsub(1.5f, fmul(fmul(fmul(0.5f, x), r), r)));
  return r;
}

// clamp(round_half_even(v), lo, hi) as int; v finite
__device__ __forceinline__ int round_clamp(float v, float lo, float hi) {
  float r = rintf(v);
  r = fminf(fmaxf(r, lo), hi);
  return __float2int_rn(r);
}

// snap: round(ndc * half + half) clamped to the guard rect
__device__ __forceinline__ int snap_coord(float ndc, int size_px, int ss,
                                          int min_c, int max_c) {
  float half = fmul((float)(size_px * ss), 0.5f);
  return round_clamp(fadd(fmul(ndc, half), half), (float)min_c, (float)max_c);
}

__device__ __forceinline__ int quantize_depth(float z) {
  return round_clamp(fmul(z, (float)DEPTH_MAX), 0.0f, (float)DEPTH_MAX);
}

// directed edge a->b: E(p) = A*(px - xa) + B*(py - ya); top-left accepts 0
struct Edge {
  int a, b, bias;  // coverage: E >= bias (bias 0 on top-left edges, else 1)
};

__device__ __forceinline__ Edge edge_coeffs(int xa, int ya, int xb, int yb) {
  int dx = xb - xa, dy = yb - ya;
  bool tl = (dy == 0 && dx > 0) || dy < 0;
  return Edge{-dy, dx, tl ? 0 : 1};
}

__device__ __forceinline__ int edge_at(int a, int b, int xa, int ya, int px,
                                       int py) {
  return wadd(wmul(a, wsub(px, xa)), wmul(b, wsub(py, ya)));
}

// round(((e0*z0 + e1*z1) + e2*z2) * inv_area2) clamped to D16
__device__ __forceinline__ int interp_depth16(int e0, int e1, int e2,
                                              float inv_area2, int z0, int z1,
                                              int z2) {
  float num = dot3(i2f(e0), i2f(z0), i2f(e1), i2f(z1), i2f(e2), i2f(z2));
  return round_clamp(fmul(num, inv_area2), 0.0f, (float)DEPTH_MAX);
}

// the minimum of (d16, -id) wins
__device__ __forceinline__ bool depth_key_better(int d_new, int id_new,
                                                 int d_old, int id_old) {
  return d_new < d_old || (d_new == d_old && id_new > id_old);
}

// float32 -> int32 as XLA's convert gives it (specmath.f32_to_i32_sat):
// truncation toward zero, NaN -> 0, >= 2^31 -> INT_MAX, < -2^31 -> INT_MIN.
// __float2int_rz is cvt.rzi.s32.f32, which saturates exactly so; it is
// written out rather than left to a plain (int) cast.
__device__ __forceinline__ int f32_to_i32_sat(float x) {
  return __float2int_rz(x);
}

// torch.maximum / jnp.maximum: a NaN operand propagates (fmaxf would drop it)
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// floor(log2(|x|)) of a normalized float, from its exponent bits
__device__ __forceinline__ int float_exponent(float x) {
  return ((bits(x) >> 23) & 0xFF) - 127;
}

constexpr float FLT_MIN_NORMAL = 1.1754944e-38f;

// subnormals map to exactly 0 (the spec's definition)
__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < FLT_MIN_NORMAL ? 0.0f : v;
}

// x ** e for x in [0, 1], integer e < 2^max_bits: square and multiply in
// the spec's fixed order, underflow flushed to 0
__device__ __forceinline__ float powi(float x, int e, int max_bits) {
  float result = 1.0f;
  float base = x;
  for (int bit = 0; bit < max_bits; ++bit) {
    if ((e >> bit) & 1) result = fmul(result, base);
    if (bit + 1 < max_bits) base = fmul(base, base);
  }
  return flush_subnormal(result);
}

}  // namespace ash
