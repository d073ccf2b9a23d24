// K4: tile-binned visibility raster of the classic pipeline, 16 x 128
// tiles.  Replaces the Pallas kernel ash_renderer_tpu/ops/raster_pallas.py
// (_kernel, via rasterize_visibility; the pallas_call at :203); the plain
// torch version is ops/raster_visibility.py:rasterize_visibility_plain.
//
// Per pixel and (triangle, tile) record: e_i = (e_ic + a_i * col_s) +
// b_i * row_s in wrapping int32, covered iff every e_i >= 1 - bias bit i
// (the top-left rule), then interp_depth16 and the minimum of (d16, -id).
//
// Record-parallel over the records' pixel boxes.  One block of 256
// threads per tile stages the tile's records [start, start + count) in
// shared memory, CHUNK at a time: each record's three edge values at the
// tile's first sample with their per-column and per-row steps (a*ss,
// b*ss), its depths, id, top-left bits, inv_area2 and its pixel box
// (rec_box, from binning.bin_triangles), and an exclusive scan of the
// boxes' pixel counts.  The chunk's box pixels are then one flat work
// list dealt to the threads in turn (a binary search of the scan finds an
// item's record, its row and column follow from the box width), so every
// thread evaluates the same number of record-pixels whatever the boxes'
// sizes, and a covered pixel takes a shared-memory atomicMin of the packed
// key (d16 << 32) | (0x7FFFFFFF - id): exact, the minimum is order-free.
// The tile's keys are written out row-major at the end.  The brute-force
// design evaluated every record at all 2048 pixels of its tile: 7.06e8
// record-pixels on the subdiv-8 classic frame, whose 344,836 boxes hold
// 2.54e6.  A warp-footprint design (experiments/k4_warp_footprint.cu,
// K3's: a warp evaluates every record whose box touches its 8x8 pixels)
// took 2.2x as long there (PERF.md).
//
// Why the cull is exact.  The winner is the order-free minimum of
// (d16, -id), so skipping records that cover nothing changes nothing.
// Under the fixed-point contract (config.py: every edge value over the
// guard extent and the tile-padded frame fits int32) the edge values do
// not wrap, and a sample is covered only if all three are >= 0: for a
// record of positive area that is the closed triangle, which lies in its
// vertex bbox; for negative area the three cannot all be >= 0 (they sum to
// twice the area); for zero area they are all 0 on the line and at least
// one edge is not top-left, so its bias of 1 fails.  The box holds every
// pixel of the tile whose sample px*ss + ss/2 lies in the vertex bbox.
// One K4 point: the box is clamped to the frame, so the padding pixels of
// the right and bottom edge tiles, which the brute-force kernel evaluated,
// stay background here; the wrapper crops to (height, width), so the two
// agree after the crop, as the plain version and the reference do.
//
// Edge values step in wrapping int32 (E + col*a*ss + row*b*ss), which is
// bit-identical to (e_ic + a * col_s) + b * row_s under any association.
//
// What bounds it: device memory.  The work must read each record's 16
// words (14 rows, inv_area2, box) and write vis_d and vis_t: 39 MB on the
// subdiv-8 classic frame, 0.0116 ms at 3.35 TB/s; the box pixels' ~20
// operations each are a fraction of that.  What the kernel waits on
// instead: each chunk's staging round trip and the dependent shared-memory
// loads of the search, longest in the tiles under the sphere (up to 2302
// records).
#include <cuda_runtime.h>
#include <stdint.h>

#include "specmath.cuh"

namespace {

using namespace ash;

constexpr int TILE_H = 16;
constexpr int N_PIX = TILE_H * TILE_W;
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS;  // one staging thread per record
constexpr int N_WORDS = 14;     // record rows 0-13
constexpr int N_WARPS = THREADS / 32;

// staged records, one field group per array (a record read is four
// 16-byte loads), the scan, and the tile's keys
struct Smem {
  int4 e[CHUNK];   // E0, E1, E2 at the tile's first sample; zq0
  int4 ex[CHUNK];  // per-column steps a*ss; zq1
  int4 ey[CHUNK];  // per-row steps b*ss; zq2
  int4 id[CHUNK];  // id, inv_area2 bits, top-left bits, box
  int off[CHUNK + 1];  // exclusive scan of the box pixel counts
  int warp_sum[N_WARPS];
  unsigned long long best[N_PIX];
};

__global__ void __launch_bounds__(THREADS)
raster_classic_kernel(const int* __restrict__ rec_i,
                      const float* __restrict__ rec_f,
                      const int* __restrict__ rec_box,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count,
                      int* __restrict__ vis_d, int* __restrict__ vis_t,
                      int n_rec, int grid_w, int ss) {
  __shared__ Smem S;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32, warp = p / 32;
  const int start = tile_start[t], count = tile_count[t];
  const unsigned long long bg =
      ((unsigned long long)DEPTH_MAX << 32) | (0x7FFFFFFFu - (uint32_t)BG_TRI);
  for (int i = p; i < N_PIX; i += THREADS) S.best[i] = bg;

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the last chunk is done (and best is initialised)
    int npx = 0;
    if (p < n) {
      const int r = start + base + p;
      int w[N_WORDS];
#pragma unroll
      for (int i = 0; i < N_WORDS; ++i) w[i] = rec_i[(size_t)i * n_rec + r];
      const int box = rec_box[r];
      S.e[p] = make_int4(w[6], w[7], w[8], w[9]);
      S.ex[p] = make_int4(wmul(w[0], ss), wmul(w[2], ss), wmul(w[4], ss), w[10]);
      S.ey[p] = make_int4(wmul(w[1], ss), wmul(w[3], ss), wmul(w[5], ss), w[11]);
      S.id[p] = make_int4(w[12], __float_as_int(rec_f[r]), w[13], box);
      const int c0 = box & 0x7F, c1 = (box >> 7) & 0x7F;
      const int r0 = (box >> 14) & 0xF, r1 = (box >> 18) & 0xF;
      npx = max(c1 - c0 + 1, 0) * max(r1 - r0 + 1, 0);
    }
    // exclusive scan of npx over the block
    int incl = npx;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) S.warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int i = 0; i < N_WARPS; ++i) before += i < warp ? S.warp_sum[i] : 0;
    S.off[p] = before + incl - npx;
    if (p == THREADS - 1) S.off[CHUNK] = before + incl;
    __syncthreads();
    const int total = S.off[CHUNK];
    for (int wi = p; wi < total; wi += THREADS) {
      int lo = 0, hi = CHUNK;  // off[lo] <= wi < off[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (S.off[mid] <= wi) lo = mid; else hi = mid;
      }
      const int4 e = S.e[lo], ex = S.ex[lo], ey = S.ey[lo], m = S.id[lo];
      const int c0 = m.w & 0x7F, c1 = (m.w >> 7) & 0x7F, r0 = (m.w >> 14) & 0xF;
      const int k = wi - S.off[lo], bw = c1 - c0 + 1;
      const int row = r0 + k / bw, col = c0 + k % bw;
      const int e0 = wadd(wadd(e.x, wmul(ex.x, col)), wmul(ey.x, row));
      const int e1 = wadd(wadd(e.y, wmul(ex.y, col)), wmul(ey.y, row));
      const int e2 = wadd(wadd(e.z, wmul(ex.z, col)), wmul(ey.z, row));
      if (e0 >= 1 - (m.z & 1) && e1 >= 1 - ((m.z >> 1) & 1) &&
          e2 >= 1 - ((m.z >> 2) & 1)) {
        const int d = interp_depth16(e0, e1, e2, fbits(m.y), e.w, ex.w, ey.w);
        const unsigned long long key =
            ((unsigned long long)d << 32) | (0x7FFFFFFFu - (uint32_t)m.x);
        atomicMin(&S.best[row * TILE_W + col], key);
      }
    }
  }
  __syncthreads();

  const size_t wp = (size_t)grid_w * TILE_W;
  const int tile_x = t % grid_w, tile_y = t / grid_w;
  for (int i = p; i < N_PIX; i += THREADS) {
    const unsigned long long key = S.best[i];
    const size_t o = ((size_t)tile_y * TILE_H + i / TILE_W) * wp +
                     (size_t)tile_x * TILE_W + i % TILE_W;
    vis_d[o] = (int)(key >> 32);
    vis_t[o] = (int)(0x7FFFFFFFu - (uint32_t)key);
  }
}

}  // namespace

// rec_i: (14, n_rec) int32 rows; rec_f: (1, n_rec) float; rec_box: (1,
// n_rec) int32 packed boxes; vis_d / vis_t: (grid_h * 16, grid_w * 128)
// int32, every pixel written
extern "C" int ash_rasterize_visibility(const int* rec_i, const float* rec_f,
                                        const int* rec_box,
                                        const int* tile_start,
                                        const int* tile_count, int* vis_d,
                                        int* vis_t, int n_rec, int n_tiles,
                                        int grid_w, int ss, void* stream) {
  if (n_tiles > 0)
    raster_classic_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rec_i, rec_f, rec_box, tile_start, tile_count, vis_d, vis_t, n_rec,
        grid_w, ss);
  return (int)cudaGetLastError();
}
