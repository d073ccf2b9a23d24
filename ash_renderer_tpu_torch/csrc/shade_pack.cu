// K7: shade + pack, K3F's phase F planes to the RGBA8 frame in one
// launch; and K11, the classic route's shade + pack, from the visibility
// buffer (below).  K7's plain torch version is
// ash_renderer_tpu_torch/ops/shade_pack.py:shade_pack_plain
// (shade.combine_from_prelight, the tile-to-image relayout,
// shade.resolve_and_pack).
//
// It replaces no Pallas kernel.  The reference computes this stage as XLA
// glue after the fused kernel (ash_renderer_tpu/pipeline.py:147-295, the
// phase F branch :239-258), which XLA fuses; eager torch pays 20-30
// launches and ~10 full-frame temporaries of 8-33 MB for the same chain.
//
// Bound by bytes: each render sample's winner id (plane row 17) and, where
// it is covered, the rows its shading needs (P; lit, and diffuse and
// specular where lit, with a light; texmask, and tap, fu, fv and the
// 16-byte quad where textured, with an atlas), each read once, and 4
// bytes a pixel written.  The arithmetic is ~80 flops a sample.  So the
// design reads each word once, from the planes straight into registers:
// one thread per output pixel, a warp on 32 consecutive pixels of one
// row, so neighbouring threads read neighbouring plane columns of one
// tile row; a background sample reads row 17 alone.  The sRGB LUT (16 KB)
// sits in shared memory; the grid is the card's resident blocks, each
// striding over the pixels, so a block loads the LUT once.
//
// Exactness, as the plain chain computes it:
// * every float op is fmul / fadd / fsub, rounded, under --fmad=false, so
//   neither lerp nor rgb + spec * color contracts to FMA;
// * a texel byte is float(byte) * f32(1/255), a multiply, and
//   lerp(a, b, t) = a + (b - a) * t;
// * the SSAA box starts from sample (0, 0) and adds the others in order
//   (i outer, j inner), then multiplies by f32(1/s^2);
// * clamp keeps NaN (torch.clamp), round is rint, half to even
//   (torch.round); a NaN channel packs to 0 and takes the LUT's entry 0
//   (the plain chain casts NaN to an integer, which C++ leaves undefined).
//
// K11: the classic route's shade + pack in one launch, from vis_tri, K10's
// setup rows (geometry.cu) and the combined attribute table to the RGBA8
// frame.  The plain torch version is
// ash_renderer_tpu_torch/ops/shade.py:shade_pack_classic_plain
// (shade.shade, then shade.resolve_and_pack).  It replaces no Pallas
// kernel: the reference computes the stage as XLA glue under one jit
// (ash_renderer_tpu/pipeline.py:698, _stage_shade over ops/shade.py:286
// and :596), which XLA fuses; eager torch pays hundreds of launches and
// as many full-frame temporaries for the same chain.  Each render sample
// takes, as the plain chain does: the 14 shading words that open its
// winner's 80-byte setup row and three 48-byte corner attribute rows (the
// winner ids clamped as _take clamps); the edge values at the pixel's
// sample from the setup coordinates (_edges_at_pixels) and
// interp_fields_stacked, op for op as K3's phase E; surface_prelight
// (shade.cuh, K3F's phase F code); the combine, the SSAA box, the sRGB
// LUT and the pack, K7's code.  A background sample takes the clear
// colour and reads its winner id alone.  Bound by bytes: the winner ids,
// and each visible triangle's 14 words and corners once, which
// neighbouring samples share through the cache, and 4 bytes a pixel
// written.  The shade constants (any number of materials and textures)
// are read through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include "shade.cuh"
#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int THREADS = 256;
constexpr int N_ROWS = 24;   // plane rows a tile (fused_kernel.OUT_COLS)
constexpr int VIS_ROW = 17;  // fused_kernel.VIS_ROW
// the phase F rows (fused_kernel.F_*)
constexpr int F_P = 0, F_DIFF = 4, F_SPEC = 7, F_LIT = 8, F_TAP = 9,
              F_FU = 10, F_FV = 11, F_TEXMASK = 12;
constexpr int LUT_N = 4096;  // specmath.srgb_encode_lut
constexpr int MAX_DEVICES = 64;

struct Params {
  const int* planes;   // (n_tiles, N_ROWS, tile_h * TILE_W)
  const int4* quads;   // (n_quads, 4) texel quads; null: no atlas
  const float* lcol;   // (3,) light colour; null: no light
  const float* lut;    // (LUT_N,) sRGB encode LUT; null: linear output
  uint32_t* out;       // (out_h, out_w) RGBA8 words
  int n_quads, grid_w, tile_h, out_h, out_w, ss, has_m;
  float inv_ss2;       // f32(1 / ss^2)
  float clear[4];
};

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return fadd(a, fmul(fsub(b, a), t));
}

// torch.clamp(c, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float c) {
  return isnan(c) ? c : fminf(fmaxf(c, 0.0f), 1.0f);
}

// rint(clamp(c, 0, 1) * scale) as an int; NaN -> 0
__device__ __forceinline__ int quantize(float c, float scale) {
  const float v = rintf(fmul(clamp01(c), scale));
  return isnan(v) ? 0 : (int)v;
}

// channel `sh` of the bilinear tap: bytes to [0, 1], two lerps along u,
// one along v
__device__ __forceinline__ float texel(const int4& q, int sh, float fu,
                                       float fv) {
  const float k = __int_as_float(0x3b808081);  // f32(1 / 255)
  const float c0 = fmul(i2f((q.x >> sh) & 255), k);
  const float c1 = fmul(i2f((q.y >> sh) & 255), k);
  const float c2 = fmul(i2f((q.z >> sh) & 255), k);
  const float c3 = fmul(i2f((q.w >> sh) & 255), k);
  return lerp(lerp(c0, c1, fu), lerp(c2, c3, fu), fv);
}

// combine_from_prelight on one covered sample whose prelight values src
// gives (each read only where the combine needs it): the texture tap
// where textured (quads non-null and texmask set), the lighting combine
// where lit (a light colour given), the specular term with materials
template <class Src>
__device__ __forceinline__ float4 combine(const Src& src, const int4* quads,
                                          int n_quads, bool light, int has_m,
                                          float lr, float lg, float lb) {
  float r = src.p(0), g = src.p(1), b = src.p(2), a = src.p(3);
  if (quads != nullptr && src.texmask() != 0) {
    const int tap = min(max(src.tap(), 0), n_quads - 1);
    const float fu = src.fu(), fv = src.fv();
    const int4 q = __ldg(quads + tap);
    r = fmul(r, texel(q, 0, fu, fv));
    g = fmul(g, texel(q, 8, fu, fv));
    b = fmul(b, texel(q, 16, fu, fv));
    a = fmul(a, texel(q, 24, fu, fv));
  }
  if (light && src.lit() != 0) {
    float nr = fmul(r, src.diff(0));
    float ng = fmul(g, src.diff(1));
    float nb = fmul(b, src.diff(2));
    if (has_m) {
      const float spec = src.spec();
      nr = fadd(nr, fmul(spec, lr));
      ng = fadd(ng, fmul(spec, lg));
      nb = fadd(nb, fmul(spec, lb));
    }
    r = nr;
    g = ng;
    b = nb;
  }
  return make_float4(r, g, b, a);
}

// The RGBA8 word of output pixel (x, y): sample(ry, rx) gives each render
// sample's RGBA, the SSAA box starts from sample (0, 0) and adds the
// others in order (i outer, j inner), then multiplies by inv_ss2; then
// the sRGB LUT (lut null: linear) and the pack
template <class SampleFn>
__device__ __forceinline__ uint32_t resolve_pack(int x, int y, int ss,
                                                 float inv_ss2,
                                                 const float* lut,
                                                 SampleFn sample) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int si = 0; si < ss; ++si) {
    for (int sj = 0; sj < ss; ++sj) {
      const float4 s = sample(y * ss + si, x * ss + sj);
      if (si == 0 && sj == 0) {
        acc = s;
      } else {
        acc.x = fadd(acc.x, s.x);
        acc.y = fadd(acc.y, s.y);
        acc.z = fadd(acc.z, s.z);
        acc.w = fadd(acc.w, s.w);
      }
    }
  }
  if (ss > 1) {
    acc.x = fmul(acc.x, inv_ss2);
    acc.y = fmul(acc.y, inv_ss2);
    acc.z = fmul(acc.z, inv_ss2);
    acc.w = fmul(acc.w, inv_ss2);
  }
  if (lut != nullptr) {
    acc.x = lut[quantize(acc.x, 4095.0f)];
    acc.y = lut[quantize(acc.y, 4095.0f)];
    acc.z = lut[quantize(acc.z, 4095.0f)];
  }
  return (uint32_t)quantize(acc.x, 255.0f)
         | ((uint32_t)quantize(acc.y, 255.0f) << 8)
         | ((uint32_t)quantize(acc.z, 255.0f) << 16)
         | ((uint32_t)quantize(acc.w, 255.0f) << 24);
}

// the sRGB LUT into shared memory (lut null: none); uniform over the grid
__device__ __forceinline__ const float* stage_lut(const float* lut,
                                                  float* smem) {
  if (lut == nullptr) return nullptr;
  for (int i = threadIdx.x; i < LUT_N; i += THREADS) smem[i] = lut[i];
  __syncthreads();
  return smem;
}

// K7's prelight source: the phase F plane rows of one sample (row k at
// px[k * npix])
struct PlaneSample {
  const int* __restrict__ px;
  int npix;
  __device__ int word(int row) const { return __ldg(px + row * npix); }
  __device__ float p(int ch) const { return fbits(word(F_P + ch)); }
  __device__ float diff(int i) const { return fbits(word(F_DIFF + i)); }
  __device__ float spec() const { return fbits(word(F_SPEC)); }
  __device__ int lit() const { return word(F_LIT); }
  __device__ int tap() const { return word(F_TAP); }
  __device__ float fu() const { return fbits(word(F_FU)); }
  __device__ float fv() const { return fbits(word(F_FV)); }
  __device__ int texmask() const { return word(F_TEXMASK); }
};

__global__ void __launch_bounds__(THREADS) shade_pack_kernel(const Params p) {
  __shared__ float lut_s[LUT_N];
  const float* lut = stage_lut(p.lut, lut_s);
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  if (p.lcol != nullptr) {
    lr = p.lcol[0];
    lg = p.lcol[1];
    lb = p.lcol[2];
  }
  const int npix = p.tile_h * TILE_W;
  const size_t tile_words = (size_t)N_ROWS * npix;
  const long long n = (long long)p.out_h * p.out_w;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int y = (int)(i / p.out_w);
    const int x = (int)(i - (long long)y * p.out_w);
    p.out[i] = resolve_pack(x, y, p.ss, p.inv_ss2, lut, [&](int ry, int rx) {
      const int ty = ry / p.tile_h;
      const int row = ry - ty * p.tile_h;
      const size_t tile = (size_t)ty * p.grid_w + (rx / TILE_W);
      const PlaneSample src{
          p.planes + tile * tile_words + row * TILE_W + rx % TILE_W, npix};
      if (src.word(VIS_ROW) < 0)
        return make_float4(p.clear[0], p.clear[1], p.clear[2], p.clear[3]);
      return combine(src, p.quads, p.n_quads, p.lcol != nullptr, p.has_m, lr,
                     lg, lb);
    });
  }
}

// ---------------- K11 ----------------

constexpr int SETUP_QUADS = 5;  // a setup row's 20 words (rtypes.SETUP_COLS)
constexpr int ATTR = 12;

struct ClassicParams {
  const int* vis;       // (rows, width) vis_tri, rows pitch words apart
  const int4* table;    // (n_setup, 20) K10's setup rows (SETUP_ROW_FIELDS)
  const float* attrs;   // (n_attrs, 12) the combined attribute table
  const int4* quads;    // (n_quads, 4) texel quads; null: no atlas
  const float* lcol;    // (3,) light colour; null: no light
  const float* lut;     // (LUT_N,) sRGB encode LUT; null: linear output
  uint32_t* out;        // (out_h, out_w) RGBA8 words
  ShadeMode sm;         // the shade constants, read through the cache
  int n_setup, n_attrs, n_quads, pitch, out_h, out_w, ss, sub, py_offset;
  float inv_ss2;        // f32(1 / ss^2)
  float clear[4];
};

// K11's prelight source: the values in registers
struct RegSample {
  const Prelight& s;
  __device__ float p(int ch) const { return s.p[ch]; }
  __device__ float diff(int i) const { return s.diff[i]; }
  __device__ float spec() const { return s.spec; }
  __device__ int lit() const { return s.lit; }
  __device__ int tap() const { return s.tap; }
  __device__ float fu() const { return s.fu; }
  __device__ float fv() const { return s.fv; }
  __device__ int texmask() const { return s.texmask; }
};

// shade.shade_gathered on one covered render sample at pixel (px, py)
// (py on the screen) whose winner is setup row t
__device__ __forceinline__ float4 shade_classic_sample(const ClassicParams& P,
                                                       int t, int px, int py,
                                                       float lr, float lg,
                                                       float lb) {
  const int4* row = P.table + (size_t)min(max(t, 0), P.n_setup - 1) * SETUP_QUADS;
  // the row's shading words: x0 y0 x1 y1 | x2 y2 inv_area2 iw0 | iw1 iw2
  // v0 v1 | v2 mat (then area2 and the depths, which shading leaves)
  const int4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2),
             q3 = __ldg(row + 3);
  const int x0 = q0.x, y0 = q0.y, x1 = q0.z, y1 = q0.w, x2 = q1.x,
            y2 = q1.y;
  const float inv_area = fbits(q1.z);
  const float iw0 = fbits(q1.w), iw1 = fbits(q2.x), iw2 = fbits(q2.y);
  const float* A0 = P.attrs + (size_t)min(max(q2.z, 0), P.n_attrs - 1) * ATTR;
  const float* A1 = P.attrs + (size_t)min(max(q2.w, 0), P.n_attrs - 1) * ATTR;
  const float* A2 = P.attrs + (size_t)min(max(q3.x, 0), P.n_attrs - 1) * ATTR;

  // interp_fields_stacked: the edges at the pixel's sample
  const int half = P.sub / 2;
  const int sx = px * P.sub + half, sy = py * P.sub + half;
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
  const float scale = i2f(P.sub);
  const float gx0 = fmul(fmul(fmul(i2f(ea0.a), scale), inv_area), iw0);
  const float gx1 = fmul(fmul(fmul(i2f(ea1.a), scale), inv_area), iw1);
  const float gx2 = fmul(fmul(fmul(i2f(ea2.a), scale), inv_area), iw2);
  const float gy0 = fmul(fmul(fmul(i2f(x2 - x1), scale), inv_area), iw0);
  const float gy1 = fmul(fmul(fmul(i2f(x0 - x2), scale), inv_area), iw1);
  const float gy2 = fmul(fmul(fmul(i2f(x1 - x0), scale), inv_area), iw2);
  float a[ATTR], c0[ATTR], c1[ATTR], c2[ATTR];
#pragma unroll
  for (int q = 0; q < ATTR / 4; ++q) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(A0) + q);
    const float4 v = __ldg(reinterpret_cast<const float4*>(A1) + q);
    const float4 w = __ldg(reinterpret_cast<const float4*>(A2) + q);
    c0[4 * q] = u.x; c0[4 * q + 1] = u.y; c0[4 * q + 2] = u.z; c0[4 * q + 3] = u.w;
    c1[4 * q] = v.x; c1[4 * q + 1] = v.y; c1[4 * q + 2] = v.z; c1[4 * q + 3] = v.w;
    c2[4 * q] = w.x; c2[4 * q + 1] = w.y; c2[4 * q + 2] = w.z; c2[4 * q + 3] = w.w;
  }
#pragma unroll
  for (int ch = 0; ch < ATTR; ++ch) a[ch] = dot3(m0, c0[ch], m1, c1[ch], m2, c2[ch]);
  const float u = a[7], v = a[8];
  auto raws = [&](float d0, float d1, float d2, float& du, float& dv) {
    const float dsx = dot3(d0, 1.0f, d1, 1.0f, d2, 1.0f);
    const float dux = dot3(d0, c0[7], d1, c1[7], d2, c2[7]);
    const float dvx = dot3(d0, c0[8], d1, c1[8], d2, c2[8]);
    du = fmul(fsub(dux, fmul(u, dsx)), inv_s);
    dv = fmul(fsub(dvx, fmul(v, dsx)), inv_s);
  };
  float durx, dvrx, dury, dvry;
  raws(gx0, gx1, gx2, durx, dvrx);
  raws(gy0, gy1, gy2, dury, dvry);
  const Prelight s = prelight(a, durx, dvrx, dury, dvry, q3.y, P.sm.consts,
                              P.sm);
  return combine(RegSample{s}, P.quads, P.n_quads, P.lcol != nullptr,
                 P.sm.has_m, lr, lg, lb);
}

__global__ void __launch_bounds__(THREADS)
shade_classic_kernel(const ClassicParams P) {
  __shared__ float lut_s[LUT_N];
  const float* lut = stage_lut(P.lut, lut_s);
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  if (P.lcol != nullptr) {
    lr = P.lcol[0];
    lg = P.lcol[1];
    lb = P.lcol[2];
  }
  const long long n = (long long)P.out_h * P.out_w;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int y = (int)(i / P.out_w);
    const int x = (int)(i - (long long)y * P.out_w);
    P.out[i] = resolve_pack(x, y, P.ss, P.inv_ss2, lut, [&](int ry, int rx) {
      const int t = __ldg(P.vis + (size_t)ry * P.pitch + rx);
      if (t < 0)
        return make_float4(P.clear[0], P.clear[1], P.clear[2], P.clear[3]);
      return shade_classic_sample(P, t, rx, ry + P.py_offset, lr, lg, lb);
    });
  }
}

// resident blocks of `kernel` on the current device (SMs x blocks per
// SM), found once per device and kernel
template <class K>
int resident_blocks(K kernel) {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       THREADS, 0)
             != cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  if (dev < MAX_DEVICES) cached[dev] = blocks;
  return blocks;
}

// the grid of a pass over n output pixels: at most the resident blocks
template <class K>
int pixel_grid(K kernel, long long n) {
  const int resident = resident_blocks(kernel);
  if (resident <= 0) return 0;
  const long long need = (n + THREADS - 1) / THREADS;
  return (int)(need < resident ? need : resident);
}

}  // namespace

extern "C" int ash_shade_pack(const int* planes, const int* quads,
                              int n_quads, const float* lcol,
                              const float* lut, void* out, int grid_w,
                              int tile_h, int out_h, int out_w, int ss,
                              float inv_ss2, int has_m, float c0, float c1,
                              float c2, float c3, cudaStream_t stream) {
  const long long n = (long long)out_h * out_w;
  if (n <= 0) return 0;
  const int blocks = pixel_grid(shade_pack_kernel, n);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  Params p;
  p.planes = planes;
  p.quads = reinterpret_cast<const int4*>(quads);
  p.lcol = lcol;
  p.lut = lut;
  p.out = static_cast<uint32_t*>(out);
  p.n_quads = n_quads;
  p.grid_w = grid_w;
  p.tile_h = tile_h;
  p.out_h = out_h;
  p.out_w = out_w;
  p.ss = ss;
  p.has_m = has_m;
  p.inv_ss2 = inv_ss2;
  p.clear[0] = c0;
  p.clear[1] = c1;
  p.clear[2] = c2;
  p.clear[3] = c3;
  shade_pack_kernel<<<blocks, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// K11; consts: the shade constants (shade.pack_shade_consts); m_n, t_n,
// has_m, has_a, has_l: the shade mode (pipeline.surface_mode)
extern "C" int ash_shade_pack_classic(
    const int* vis, const int* table, const float* attrs, const int* consts,
    int n_consts, int m_n, int t_n, int has_m, int has_a, int has_l,
    const int* quads, int n_quads, const float* lcol, const float* lut,
    void* out, int n_setup, int n_attrs, int pitch, int out_h, int out_w,
    int ss, int sub, int py_offset, float inv_ss2, float c0, float c1,
    float c2, float c3, cudaStream_t stream) {
  const long long n = (long long)out_h * out_w;
  if (n <= 0) return 0;
  const int blocks = pixel_grid(shade_classic_kernel, n);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  ClassicParams P;
  P.vis = vis;
  P.table = reinterpret_cast<const int4*>(table);
  P.attrs = attrs;
  P.quads = reinterpret_cast<const int4*>(quads);
  P.lcol = lcol;
  P.lut = lut;
  P.out = static_cast<uint32_t*>(out);
  P.sm = ShadeMode{consts, n_consts, m_n, t_n, has_m, has_a, has_l};
  P.n_setup = n_setup;
  P.n_attrs = n_attrs;
  P.n_quads = n_quads;
  P.pitch = pitch;
  P.out_h = out_h;
  P.out_w = out_w;
  P.ss = ss;
  P.sub = sub;
  P.py_offset = py_offset;
  P.inv_ss2 = inv_ss2;
  P.clear[0] = c0;
  P.clear[1] = c1;
  P.clear[2] = c2;
  P.clear[3] = c3;
  shade_classic_kernel<<<blocks, THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}
