// K7: shade + pack, K3F's phase F planes to the RGBA8 frame in one
// launch.  The plain torch version is
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
#include <cuda_runtime.h>
#include <stdint.h>

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

// the RGBA of the render sample whose plane column starts at `px`
// (row k at px[k * npix]): combine_from_prelight on one sample
__device__ __forceinline__ float4 shade_sample(const Params& p,
                                               const int* __restrict__ px,
                                               int npix, float lr, float lg,
                                               float lb) {
  if (__ldg(px + VIS_ROW * npix) < 0)
    return make_float4(p.clear[0], p.clear[1], p.clear[2], p.clear[3]);
  float r = fbits(__ldg(px + (F_P + 0) * npix));
  float g = fbits(__ldg(px + (F_P + 1) * npix));
  float b = fbits(__ldg(px + (F_P + 2) * npix));
  float a = fbits(__ldg(px + (F_P + 3) * npix));
  if (p.quads != nullptr && __ldg(px + F_TEXMASK * npix) != 0) {
    const int tap = min(max(__ldg(px + F_TAP * npix), 0), p.n_quads - 1);
    const float fu = fbits(__ldg(px + F_FU * npix));
    const float fv = fbits(__ldg(px + F_FV * npix));
    const int4 q = __ldg(p.quads + tap);
    r = fmul(r, texel(q, 0, fu, fv));
    g = fmul(g, texel(q, 8, fu, fv));
    b = fmul(b, texel(q, 16, fu, fv));
    a = fmul(a, texel(q, 24, fu, fv));
  }
  if (p.lcol != nullptr && __ldg(px + F_LIT * npix) != 0) {
    float nr = fmul(r, fbits(__ldg(px + (F_DIFF + 0) * npix)));
    float ng = fmul(g, fbits(__ldg(px + (F_DIFF + 1) * npix)));
    float nb = fmul(b, fbits(__ldg(px + (F_DIFF + 2) * npix)));
    if (p.has_m) {
      const float spec = fbits(__ldg(px + F_SPEC * npix));
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

__global__ void __launch_bounds__(THREADS) shade_pack_kernel(const Params p) {
  __shared__ float lut[LUT_N];
  if (p.lut != nullptr) {  // uniform over the grid
    for (int i = threadIdx.x; i < LUT_N; i += THREADS) lut[i] = p.lut[i];
    __syncthreads();
  }
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
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int si = 0; si < p.ss; ++si) {
      const int ry = y * p.ss + si;
      const int ty = ry / p.tile_h;
      const int row = ry - ty * p.tile_h;
      for (int sj = 0; sj < p.ss; ++sj) {
        const int rx = x * p.ss + sj;
        const size_t tile = (size_t)ty * p.grid_w + (rx / TILE_W);
        const int* px = p.planes + tile * tile_words + row * TILE_W
                        + rx % TILE_W;
        const float4 s = shade_sample(p, px, npix, lr, lg, lb);
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
    if (p.ss > 1) {
      acc.x = fmul(acc.x, p.inv_ss2);
      acc.y = fmul(acc.y, p.inv_ss2);
      acc.z = fmul(acc.z, p.inv_ss2);
      acc.w = fmul(acc.w, p.inv_ss2);
    }
    if (p.lut != nullptr) {
      acc.x = lut[quantize(acc.x, 4095.0f)];
      acc.y = lut[quantize(acc.y, 4095.0f)];
      acc.z = lut[quantize(acc.z, 4095.0f)];
    }
    p.out[i] = (uint32_t)quantize(acc.x, 255.0f)
               | ((uint32_t)quantize(acc.y, 255.0f) << 8)
               | ((uint32_t)quantize(acc.z, 255.0f) << 16)
               | ((uint32_t)quantize(acc.w, 255.0f) << 24);
  }
}

// resident blocks of shade_pack_kernel on the current device (SMs x
// blocks per SM), found once per device
int resident_blocks() {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, shade_pack_kernel, THREADS, 0) != cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  if (dev < MAX_DEVICES) cached[dev] = blocks;
  return blocks;
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
  const int resident = resident_blocks();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long need = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(need < resident ? need : resident);
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
