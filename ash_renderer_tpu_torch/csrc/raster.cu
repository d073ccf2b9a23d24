// K3: raster + distribute (phases V, D and E) for tile_h x 128 tiles
// (tile_h 8, the default, or 4, as the reference's kernel takes), and K3F,
// the same kernel with phase F.  Replaces the Pallas kernel
// ash_renderer_tpu/ops/fused_kernel.py:_kernel (the pallas_call at :1087,
// via rasterize_distribute; shade_mode=None for K3, set for K3F, whose
// surface half is _phase_f); the plain torch version is
// ops/fused_kernel.py:rasterize_distribute_plain.
//
// One block per tile of the grid, or of a slab's tile-row window
// (parallel/sharding.py): row0, the window's first tile row, puts tile t at
// tile row t / grid_w + row0 of the screen.  Every sample, pixel box and
// warp footprint is in screen rows; only the vis planes are written in the
// window's own rows.
//
// Phase V streams the tile's 7 ranges (rmeta) as one
// sequence, CHUNK records at a time: the sorted tables hold 8-word records
// (ops/tritables REC_COLS: columns 0-5 and the id of a comb row, 32 bytes,
// two aligned 16-byte loads), which kernel K9 writes.  Each record is staged once in shared
// memory: its three edge values at the tile's first sample with their
// per-column and per-row steps (a*ss, b*ss), its depths and id, and a
// 32-bit mask of the warps its pixel box touches.  The pixel box is the
// samples px*ss + ss/2 inside the record's vertex bbox, clipped to the tile
// and, for own-fine rows, to the record's 16-px window (the reference's
// window rule; fused_kernel.slot_pixel_boxes is the same definition in
// torch).  Each warp owns a footprint of FOOT_H rows x 8 columns (PX pixels
// per lane, rows 4 apart), walks each chunk's masks with __ballot_sync and
// evaluates only the records that touch it.  Both tile heights run 512
// threads in 16 warps with one footprint row group, so the mask has one bit
// per warp in the same layout: 8 rows take PX = 2 (8 x 8 footprints), 4
// rows PX = 1 (4 x 8).  The brute-force design
// evaluated every streamed slot at all 1024 pixels (3.95e8 slot-pixel
// evaluations for 974,034 covered pixels on the static 1.31M-triangle
// headline frame); the boxes there hold 2.54e6 pixels, and the cull leaves
// only the warp footprints they touch.
//
// Why the cull is exact.  The winner is the order-free minimum of
// (d16, -id), so skipping records that cover nothing changes nothing.
// Under the fixed-point contract (config.py: every edge value over the
// guard extent and the tile-padded frame fits int32) the edge values do
// not wrap, and a sample is covered only if all three are >= 0: for a
// record of positive area that is the closed triangle, which lies in its
// vertex bbox; for negative area the three cannot all be >= 0 (they sum to
// twice the area); for zero area they are all 0 on the line and at least
// one edge is not top-left, so its bias of 1 fails.  A fine row's window
// is a rule, not a consequence of coverage; every 8-column footprint lies
// in one 16-px window, so a warp its box touches is inside the window.
//
// Edge values step in wrapping int32 (E0 + col*a*ss + row*b*ss), which is
// bit-identical to edge_at at the pixel's sample under any association.
// Phase V ends with each pixel's winner in shared memory; phases D and E
// then take pixels in row-major order (coalesced vis and planes writes).
// Phase D reads the winner's 48 comb columns as 12 aligned 16-byte loads,
// only for covered pixels, straight from the unsorted comb table (row =
// triangle id).  Phase E: shade.interp_fields_stacked, op for op.  Phase F
// (K3F, the SHADE instantiation): the reference's _phase_f, op for op
// (shade.py:surface_prelight), on the pixel's 12 attributes held in
// registers; its select trees over the material / mip / light tables
// become indexed loads from the shade constants, staged in shared memory.
// The surface code is shade.cuh's prelight(), which K11 (shade_pack.cu)
// runs too.
//
// What bounds it: device memory, no longer integer throughput in phase V.
// At the headline the work must move 274 MB (the 199 MB of planes, vis,
// the winners' 48 columns, the streamed records): 0.082 ms at 3.35 TB/s,
// against 0.175 ms measured on an H100 (PERF.md).  Phases D and E alone
// (rmeta zeroed) take 0.072 ms, writing at ~3 TB/s; the rest is phase V's
// staging round trip and shared-memory chains, which only the two blocks
// an SM holds (64 registers x 512 threads) overlap with each other's
// writes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "shade.cuh"
#include "specmath.cuh"

namespace {

using namespace ash;

// Threads per block at either tile height.  At 8 rows, 2 pixels a thread
// (512 threads, 8 x 8 footprints) measured ahead of 1 (1024 threads, 4 x 8)
// and of 4 (256 threads, 8 x 16 footprints; PERF.md,
// experiments/torch_k3_variants.py); 4 rows take 1 pixel a thread.
constexpr int THREADS = 512;
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds: 64 registers a thread
constexpr int FOOT_W = 8;      // columns of a warp's footprint
constexpr int COL_GROUPS = TILE_W / FOOT_W;
static_assert(FINE_W % FOOT_W == 0, "a footprint lies in one fine window");

// The shape of a tile of TILE_H rows
template <int TILE_H>
struct Tile {
  static constexpr int N_PIX = TILE_H * TILE_W;
  static constexpr int PX = N_PIX / THREADS;  // pixels a thread
  static_assert(PX == 1 || PX == 2, "a lane holds the pixels of rows r, r+4");
  static_assert(PX * THREADS == N_PIX, "every pixel has a thread");
  // a warp's footprint: FOOT_W columns (lane % 8) by 4 * PX rows (lane / 8,
  // + 4 a pixel)
  static constexpr int FOOT_H = 4 * PX;
  static constexpr int ROW_GROUPS = TILE_H / FOOT_H;
  static_assert(COL_GROUPS * ROW_GROUPS == THREADS / 32, "one bit per warp");
};
constexpr int N_RANGES = 7;
constexpr int EXT_RANGE = 5;
constexpr int FINE_RANGE = 6;
constexpr int OUT_COLS = 24;
constexpr int VIS_ROW = 17;
constexpr int COMB_QUADS = 12;  // the 48 comb columns phase D reads
constexpr int CHUNK = 512;
static_assert(CHUNK <= THREADS, "one staging thread per record");
// 16 materials * 7 + 2 textures * (3 * 13 + 1) + light 7 + camera 3
constexpr int MAX_CONSTS = 16 * 7 + 2 * (3 * MAX_LEVELS + 1) + 7 + 3;
// phase F plane rows
constexpr int F_P = 0, F_DIFF = 4, F_SPEC = 7, F_LIT = 8, F_TAP = 9,
              F_FU = 10, F_FV = 11, F_TEXMASK = 12;

// staged records, one field group per array so a warp reads a record with
// four broadcast 16-byte loads; after phase V the same memory holds the
// tile's winners
template <int N_PIX>
union Smem {
  struct {
    int4 e[CHUNK];   // E0, E1, E2 at the tile's first sample; zq01
    int4 ex[CHUNK];  // per-column steps a*ss; z2
    int4 ey[CHUNK];  // per-row steps b*ss; inv_area bits
    int4 id[CHUNK];  // id; the three edges' biases (0 top-left, else 1)
    unsigned mask[CHUNK];  // bit w: the pixel box touches warp w
  } rec;
  struct {
    int d[N_PIX], t[N_PIX];
  } win;
};

// Phase F: writes planes rows 0-16 of one pixel (out points at row 0; rows
// are N_PIX apart): shade.cuh's prelight of the 12 interpolated attributes
// a, the raw uv derivatives durx..dvry and the winner's material mat_row,
// from the shade constants sc.
template <int N_PIX>
__device__ __forceinline__ void phase_f(int* out, const float (&a)[12],
                                        float durx, float dvrx, float dury,
                                        float dvry, int mat_row,
                                        const int* sc, const ShadeMode& sm) {
  const Prelight s = prelight(a, durx, dvrx, dury, dvry, mat_row, sc, sm);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) out[(F_P + ch) * N_PIX] = bits(s.p[ch]);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[(F_DIFF + i) * N_PIX] = bits(s.diff[i]);
  out[F_SPEC * N_PIX] = bits(s.spec);
  out[F_LIT * N_PIX] = s.lit;
  out[F_TAP * N_PIX] = s.tap;
  out[F_FU * N_PIX] = bits(s.fu);
  out[F_FV * N_PIX] = bits(s.fv);
  out[F_TEXMASK * N_PIX] = s.texmask;
#pragma unroll
  for (int k = F_TEXMASK + 1; k < VIS_ROW; ++k) out[k * N_PIX] = 0;
}

// Phases D, E (and F with SHADE) for one pixel whose sample is (sx, sy) and
// whose winner is best_t; out points at the pixel's planes row 0 (rows are
// N_PIX apart).
template <int N_PIX, bool SHADE>
__device__ __forceinline__ void distribute(int* out, int best_t, int sx,
                                           int sy, int min_c, int ss,
                                           const int* __restrict__ comb,
                                           const int* sc,
                                           const ShadeMode& smode) {
  // phase D: the winner's 48 comb columns, 16 bytes at a time (rows are
  // 512 bytes, so columns 0-47 are aligned); background pixels read none
  const bool won = best_t >= 0;
  const int4* row4 =
      reinterpret_cast<const int4*>(comb + (size_t)(won ? best_t : 0) * TBL_COLS);
  int o[4 * COMB_QUADS];
  auto fetch = [&](int q) {
    const int4 v = won ? row4[q] : make_int4(0, 0, 0, 0);
    o[4 * q] = v.x; o[4 * q + 1] = v.y; o[4 * q + 2] = v.z; o[4 * q + 3] = v.w;
  };
#pragma unroll
  for (int q = 0; q < 3; ++q) fetch(q);

  // phase E: interp_fields_stacked
  const int off = -min_c;
  const int x0 = (o[0] & 0xFFFF) - off, y0 = ((o[0] >> 16) & 0xFFFF) - off;
  const int x1 = (o[1] & 0xFFFF) - off, y1 = ((o[1] >> 16) & 0xFFFF) - off;
  const int x2 = (o[2] & 0xFFFF) - off, y2 = ((o[2] >> 16) & 0xFFFF) - off;
  const float inv_area = fbits(o[5]);
  const float iw0 = fbits(o[6]), iw1 = fbits(o[7]), iw2 = fbits(o[8]);
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
  const float scale = i2f(ss);
  const float gx0 = fmul(fmul(fmul(i2f(ea0.a), scale), inv_area), iw0);
  const float gx1 = fmul(fmul(fmul(i2f(ea1.a), scale), inv_area), iw1);
  const float gx2 = fmul(fmul(fmul(i2f(ea2.a), scale), inv_area), iw2);
  const float gy0 = fmul(fmul(fmul(i2f(x2 - x1), scale), inv_area), iw0);
  const float gy1 = fmul(fmul(fmul(i2f(x0 - x2), scale), inv_area), iw1);
  const float gy2 = fmul(fmul(fmul(i2f(x1 - x0), scale), inv_area), iw2);

#pragma unroll
  for (int q = 3; q < COMB_QUADS; ++q) fetch(q);
  float a[12];
#pragma unroll
  for (int ch = 0; ch < 12; ++ch) {
    a[ch] = dot3(m0, fbits(o[10 + ch]), m1, fbits(o[22 + ch]), m2,
                 fbits(o[34 + ch]));
    if constexpr (!SHADE) out[ch * N_PIX] = bits(a[ch]);
  }
  const float u = a[7], v = a[8];
  const float u0 = fbits(o[17]), v0 = fbits(o[18]);
  const float u1 = fbits(o[29]), v1 = fbits(o[30]);
  const float u2 = fbits(o[41]), v2 = fbits(o[42]);
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
    phase_f<N_PIX>(out, a, durx, dvrx, dury, dvry, o[9], sc, smode);
  } else {
    out[12 * N_PIX] = bits(durx);
    out[13 * N_PIX] = bits(dvrx);
    out[14 * N_PIX] = bits(dury);
    out[15 * N_PIX] = bits(dvry);
    out[16 * N_PIX] = o[9];
  }
  out[VIS_ROW * N_PIX] = best_t;
#pragma unroll
  for (int k = VIS_ROW + 1; k < OUT_COLS; ++k) out[k * N_PIX] = 0;
}

template <int TILE_H, bool SHADE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
raster_kernel(const int* __restrict__ rmeta, const int* __restrict__ tbl,
              const int* __restrict__ ext, const int* __restrict__ comb,
              int* __restrict__ vis_d, int* __restrict__ vis_t,
              int* __restrict__ planes, int grid_w, int min_c, int ss,
              int row0, ShadeMode smode) {
  using T = Tile<TILE_H>;
  constexpr int N_PIX = T::N_PIX, PX = T::PX, FOOT_H = T::FOOT_H;
  __shared__ Smem<N_PIX> S;
  __shared__ int range_lo[N_RANGES + 1], range_start[N_RANGES];
  __shared__ int sc[SHADE ? MAX_CONSTS : 1];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32, warp = p / 32;
  if constexpr (SHADE)
    for (int i = p; i < smode.n_consts; i += THREADS) sc[i] = smode.consts[i];
  if (p == 0) {  // the 7 ranges as one sequence of total records
    int acc = 0;
#pragma unroll
    for (int r = 0; r < N_RANGES; ++r) {
      const int rs = rmeta[(t * N_RANGES + r) * 2];
      const int re = rmeta[(t * N_RANGES + r) * 2 + 1];
      range_start[r] = rs;
      range_lo[r] = acc;
      acc += max(re - rs, 0);
    }
    range_lo[N_RANGES] = acc;
  }
  __syncthreads();
  const int tile_x = t % grid_w, tile_y = t / grid_w;
  const int half = ss / 2;
  // py0: the tile's first row in the window's vis planes; screen_y0: its
  // first row on the screen, where its samples lie
  const int px0 = tile_x * TILE_W, py0 = tile_y * TILE_H;
  const int screen_y0 = (row0 + tile_y) * TILE_H;
  const int sx0 = px0 * ss + half, sy0 = screen_y0 * ss + half;

  // ---------------- phase V ----------------
  const int vcol = (warp % COL_GROUPS) * FOOT_W + lane % FOOT_W;
  const int vrow = (warp / COL_GROUPS) * FOOT_H + lane / FOOT_W;
  int best_d[PX], best_t[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    best_d[k] = DEPTH_MAX;
    best_t[k] = BG_TRI;
  }
  const int total = range_lo[N_RANGES];
  for (int base = 0; base < total; base += CHUNK) {
    const int n = min(CHUNK, total - base);
    if (base > 0) __syncthreads();  // every warp is done with the last chunk
    if (p < n) {
      const int k = base + p;
      int r = 0;
#pragma unroll
      for (int i = 1; i < N_RANGES; ++i) r += k >= range_lo[i];
      const int4* rec = reinterpret_cast<const int4*>(
          (r == EXT_RANGE ? ext : tbl) +
          (size_t)(range_start[r] + k - range_lo[r]) * REC_WORDS);
      const int4 c = rec[0];  // corners, zq01
      const int4 zi = rec[1];  // z2, inv_area, id (REC_ID), 0
      const int id = zi.z;
      const int x0 = (c.x & 0xFFFF) + min_c, y0 = ((c.x >> 16) & 0xFFFF) + min_c;
      const int x1 = (c.y & 0xFFFF) + min_c, y1 = ((c.y >> 16) & 0xFFFF) + min_c;
      const int x2 = (c.z & 0xFFFF) + min_c, y2 = ((c.z >> 16) & 0xFFFF) + min_c;
      const Edge q0 = edge_coeffs(x1, y1, x2, y2);
      const Edge q1 = edge_coeffs(x2, y2, x0, y0);
      const Edge q2 = edge_coeffs(x0, y0, x1, y1);
      S.rec.e[p] = make_int4(edge_at(q0.a, q0.b, x1, y1, sx0, sy0),
                             edge_at(q1.a, q1.b, x2, y2, sx0, sy0),
                             edge_at(q2.a, q2.b, x0, y0, sx0, sy0), c.w);
      S.rec.ex[p] = make_int4(wmul(q0.a, ss), wmul(q1.a, ss), wmul(q2.a, ss),
                              zi.x);
      S.rec.ey[p] = make_int4(wmul(q0.b, ss), wmul(q1.b, ss), wmul(q2.b, ss),
                              zi.y);
      S.rec.id[p] = make_int4(id, q0.bias, q1.bias, q2.bias);
      // the pixel box: px*ss + half in [xmin, xmax], py likewise
      const int pxl = floordiv(min(min(x0, x1), x2) - half + ss - 1, ss);
      const int pxh = floordiv(max(max(x0, x1), x2) - half, ss);
      const int pyl = floordiv(min(min(y0, y1), y2) - half + ss - 1, ss);
      const int pyh = floordiv(max(max(y0, y1), y2) - half, ss);
      int c0 = max(pxl - px0, 0), c1 = min(pxh - px0, TILE_W - 1);
      const int r0 = max(pyl - screen_y0, 0);
      const int r1 = min(pyh - screen_y0, TILE_H - 1);
      if (r == FINE_RANGE) {
        const int w0 = (max(pxl, 0) % TILE_W) / FINE_W * FINE_W;
        c0 = max(c0, w0);
        c1 = min(c1, w0 + FINE_W - 1);
      }
      unsigned mask = 0;
      if (c0 <= c1 && r0 <= r1) {
        const unsigned cols = (2u << (c1 / FOOT_W)) - (1u << (c0 / FOOT_W));
#pragma unroll
        for (int g = 0; g < T::ROW_GROUPS; ++g)
          if (r0 / FOOT_H <= g && g <= r1 / FOOT_H) mask |= cols << (g * COL_GROUPS);
      }
      S.rec.mask[p] = mask;
    }
    __syncthreads();
    for (int b = 0; b < n; b += 32) {
      const int s = b + lane;
      const bool hit = s < n && ((S.rec.mask[s] >> warp) & 1u);
      unsigned todo = __ballot_sync(0xFFFFFFFFu, hit);
      while (todo) {
        const int j = b + __ffs(todo) - 1;
        todo &= todo - 1;
        const int4 e = S.rec.e[j], ex = S.rec.ex[j], ey = S.rec.ey[j];
        const int4 m = S.rec.id[j];
        int e0 = wadd(wadd(e.x, wmul(ex.x, vcol)), wmul(ey.x, vrow));
        int e1 = wadd(wadd(e.y, wmul(ex.y, vcol)), wmul(ey.y, vrow));
        int e2 = wadd(wadd(e.z, wmul(ex.z, vcol)), wmul(ey.z, vrow));
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (k > 0) {  // 4 rows down
            e0 = wadd(e0, wmul(ey.x, 4));
            e1 = wadd(e1, wmul(ey.y, 4));
            e2 = wadd(e2, wmul(ey.z, 4));
          }
          if (e0 >= m.y && e1 >= m.z && e2 >= m.w) {
            const int d = interp_depth16(e0, e1, e2, fbits(ey.w), e.w & 0xFFFF,
                                         (e.w >> 16) & 0xFFFF, ex.w);
            if (depth_key_better(d, m.x, best_d[k], best_t[k])) {
              best_d[k] = d;
              best_t[k] = m.x;
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the records are dead: their memory takes the winners
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int pix = (vrow + 4 * k) * TILE_W + vcol;
    S.win.d[pix] = best_d[k];
    S.win.t[pix] = best_t[k];
  }
  __syncthreads();

  // ---------------- phases D, E (F): pixels in row-major order ----------
  const size_t wp = (size_t)grid_w * TILE_W;
#pragma unroll 1
  for (int k = 0; k < PX; ++k) {
    const int pix = p + k * THREADS;
    const int row = pix / TILE_W, col = pix % TILE_W;
    const int bt = S.win.t[pix];
    const size_t vi = ((size_t)py0 + row) * wp + px0 + col;
    vis_d[vi] = S.win.d[pix];
    vis_t[vi] = bt;
    distribute<N_PIX, SHADE>(planes + (size_t)t * OUT_COLS * N_PIX + pix, bt,
                      (px0 + col) * ss + half, (screen_y0 + row) * ss + half,
                      min_c, ss, comb, sc, smode);
  }
}

// K3 (SHADE false) or K3F on the tile height the caller gives: 8 or 4
template <bool SHADE>
int launch_raster(const int* rmeta, const int* tbl, const int* ext,
                  const int* comb, int* vis_d, int* vis_t, int* planes,
                  int n_tiles, int grid_w, int min_c, int ss, int row0,
                  int tile_h, ShadeMode smode, void* stream) {
  if (tile_h != 8 && tile_h != 4) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (tile_h == 8)
      raster_kernel<8, SHADE><<<n_tiles, THREADS, 0, s>>>(
          rmeta, tbl, ext, comb, vis_d, vis_t, planes, grid_w, min_c, ss,
          row0, smode);
    else
      raster_kernel<4, SHADE><<<n_tiles, THREADS, 0, s>>>(
          rmeta, tbl, ext, comb, vis_d, vis_t, planes, grid_w, min_c, ss,
          row0, smode);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K3; 1 = invalid argument for a tile height other than 8 or 4
extern "C" int ash_rasterize_distribute(const int* rmeta, const int* tbl,
                                        const int* ext, const int* comb,
                                        int* vis_d, int* vis_t, int* planes,
                                        int n_tiles, int grid_w, int min_c,
                                        int ss, int row0, int tile_h,
                                        void* stream) {
  return launch_raster<false>(rmeta, tbl, ext, comb, vis_d, vis_t, planes,
                              n_tiles, grid_w, min_c, ss, row0, tile_h,
                              ShadeMode{nullptr, 0, 0, 0, 0, 0, 0}, stream);
}

// K3F: as above, with phase F from the shade constants (fused_kernel.py:
// pack_shade_consts); 1 = invalid argument also if they exceed the kernel's
// caps
extern "C" int ash_rasterize_shade(const int* rmeta, const int* tbl,
                                   const int* ext, const int* comb,
                                   int* vis_d, int* vis_t, int* planes,
                                   int n_tiles, int grid_w, int min_c, int ss,
                                   int row0, int tile_h, const int* consts,
                                   int n_consts, int m_n, int t_n, int has_m,
                                   int has_a, int has_l, void* stream) {
  if (n_consts > MAX_CONSTS || m_n > 16 || t_n > 2)
    return (int)cudaErrorInvalidValue;
  return launch_raster<true>(
      rmeta, tbl, ext, comb, vis_d, vis_t, planes, n_tiles, grid_w, min_c, ss,
      row0, tile_h, ShadeMode{consts, n_consts, m_n, t_n, has_m, has_a, has_l},
      stream);
}
