// The streaming-key formulas of ash_renderer_tpu_torch/ops/binsort.py
// (pixel_aabb_of, keys_from_aabb) as __device__ code: one definition for
// the setup kernel K1 (setup.cu) and the clip tail K6 (clip_tail.cu).
#pragma once

#include "specmath.cuh"

namespace ash {

// inclusive pixel box of the sample centres a triangle can cover
struct PixelBox {
  int pxmin, pxmax, pymin, pymax;
};

// The tile-row window [row0, row0 + tile_rows) that keys are counted in:
// its first and last pixel rows on the screen, and its n_tiles =
// tile_rows * grid_w tiles (binsort.window_rows).  The whole grid is
// {0, 0, height - 1, tile_h, grid_w, grid_h * grid_w}.
struct KeyWindow {
  int row0, py_lo, py_hi, tile_h, grid_w, n_tiles;
};

// binsort.pixel_aabb_of on a triangle's snapped coordinate extremes,
// clamped to the frame
__device__ __forceinline__ PixelBox pixel_box(int xmin, int xmax, int ymin,
                                              int ymax, int ss, int width,
                                              int height) {
  const int half = ss / 2;
  return PixelBox{max(0, floordiv(xmin - half + ss - 1, ss)),
                  min(width - 1, floordiv(xmax - half, ss)),
                  max(0, floordiv(ymin - half + ss - 1, ss)),
                  min(height - 1, floordiv(ymax - half, ss))};
}

// binsort.keys_from_aabb: rows clamped to the window, tiles counted from
// its first row; coarse tile * 4 + group, fine, wide or dead key
__device__ __forceinline__ int stream_key(bool valid, const PixelBox& b,
                                          const KeyWindow& W) {
  const int pymin = max(b.pymin, W.py_lo);
  const int pymax = min(b.pymax, W.py_hi);
  const bool live = valid && b.pxmax >= b.pxmin && pymax >= pymin;
  const int tx0 = floordiv(b.pxmin, TILE_W), tx1 = floordiv(b.pxmax, TILE_W);
  const int ty0 = floordiv(pymin, W.tile_h) - W.row0;
  const int ty1 = floordiv(pymax, W.tile_h) - W.row0;
  const bool spill_r = tx1 > tx0, spill_d = ty1 > ty0;
  const bool wide = (tx1 - tx0 > 1) || (ty1 - ty0 > 1);
  const int grp = spill_r && spill_d ? 0 : (spill_r ? 1 : (spill_d ? 2 : 3));
  const int tile = ty0 * W.grid_w + tx0;
  const bool fine =
      grp == 3 && floordiv(b.pxmin, FINE_W) == floordiv(b.pxmax, FINE_W);
  const int subc = floormod(floordiv(b.pxmin, FINE_W), TILE_W / FINE_W);
  const int key_fine = W.n_tiles * N_GRP + tile * N_FINE + subc;
  return live ? (wide ? W.n_tiles * KEYS_PER_TILE
                      : (fine ? key_fine : tile * N_GRP + grp))
              : W.n_tiles * KEYS_PER_TILE + 1;
}

}  // namespace ash
