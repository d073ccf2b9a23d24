"""The fused front's wide-pair expansion and range metadata: the sorted
order's run bounds of a tile-row window -> the wide pairs' per-tile runs,
the raster's range meta and the counts the host sizes the table gathers
with.

Kernel K9.  ``front_meta`` launches ``csrc/front_meta.cu`` on CUDA tensors
and runs ``front_meta_plain`` on CPU tensors: ``binsort.expand_wide_pairs``
then ``fused_kernel.build_range_meta``, each bit-equal to the JAX
package's.

It replaces no Pallas kernel.  The reference runs the stage as XLA glue
under one jit (``ash_renderer_tpu/pipeline.py:458-500``, the empty case
under ``lax.cond``); in eager torch the same chain is ~40-70 launches and
reads the device five times a front, each read draining the queue.

What bounds it on the card: the launch floor.  It moves well under 1 MB
(three comb words a wide row, the bounds, 14 words of range meta a tile),
so the kernel keeps to four launches whatever the frame, sizes their grids
from the budgets and the window (never from the data), and reads the
data's sizes on the device:

1. rows: one block takes the first ``min(n_wide, wide_rows)`` rows of the
   wide run, their tile rectangles, the scan of their pair counts and the
   positional cut;
2. count: one block a tile row stages the consumed rows that cover the
   row in shared memory, and one warp a tile counts those that cover it;
3. scan: one block writes ``pair_starts``;
4. write: as 2, the block first writing its row's ``rmeta``, then each
   warp its tile's rows in row order, the order the plain version's
   stable sort by tile gives.

The host reads the counts ``[ws, we, new_ws, n_pairs]`` once, after the
launches (``pipeline.expand_table``).
"""

from __future__ import annotations

import torch

from .. import _build
from . import binsort, fused_kernel, tritables

KERNEL = "K9_front_meta"
N_LAUNCHES = 4  # rows, count, scan, write
COUNTS = ("ws", "we", "new_ws", "n_pairs")
N_META = len(COUNTS) + 1  # the kernel's counts: COUNTS, the consumed rows
RECT_WORDS = 4  # tx0, tx1, ty0, ty1 a wide row
MAX_GRID_W = 512  # tiles a row the count and write passes hold (65,536 px)


def front_meta(comb, order, bounds, cfg, wide_rows: int, wide_pairs: int,
               tile_row0: int = 0, tile_rows=None):
    """Wide-pair expansion and range metadata of the tile-row window
    ``[tile_row0, tile_row0 + tile_rows)`` (the whole grid by default).

    comb: (S, 128) int32; order: (S,) int32 sorted row ids and bounds:
    (n_tiles * 12 + 3,) int32 run bounds, both from
    ``binsort.sort_and_bounds``.  Returns (pair_rows (wide_pairs,) int32,
    whose first n_pairs entries are the consumed rows by tile, each tile's
    in row order; pair_starts (n_tiles + 1,) int32; rmeta (n_tiles * 14,)
    int32, ``build_range_meta``'s layout; counts (4,) int32 [ws, we,
    new_ws, n_pairs] on the device).  CPU tensors take the plain version;
    CUDA tensors launch the kernels, which read nothing back to the
    host."""
    dev = comb.device
    if dev.type == "cpu":
        return front_meta_plain(comb, order, bounds, cfg, wide_rows,
                                wide_pairs, tile_row0, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"front_meta: unsupported device {dev}")
    tile_rows, py_lo, py_hi = binsort.window_rows(cfg, tile_row0, tile_rows)
    n_tiles = tile_rows * cfg.grid_w
    s_rows = order.shape[0]
    if cfg.grid_w > MAX_GRID_W:
        raise ValueError(f"front_meta: {cfg.grid_w} tiles a row, at most "
                         f"{MAX_GRID_W}")
    for name, x, shape in (
        ("comb", comb, (s_rows, tritables.TBL_COLS)),
        ("order", order, (s_rows,)),
        ("bounds", bounds, (n_tiles * binsort.KEYS_PER_TILE + 3,)),
    ):
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"front_meta: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    # one allocation for the scratch (rectangles, row ids, tile counts) and
    # the outputs; the rectangles first and rmeta next, since K9 moves them
    # 16 and 8 bytes at a time
    sizes = (RECT_WORDS * wide_rows, n_tiles * fused_kernel.N_RANGES * 2,
             n_tiles + 1, N_META, wide_pairs, wide_rows, n_tiles)
    rects, rmeta, pair_starts, meta, pair_rows, wrow, tile_cnt = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    _build.launch(
        KERNEL, "ash_front_meta", dev,
        comb.data_ptr(), order.data_ptr(), bounds.data_ptr(),
        rects.data_ptr(), wrow.data_ptr(), tile_cnt.data_ptr(),
        meta.data_ptr(), pair_rows.data_ptr(), pair_starts.data_ptr(),
        rmeta.data_ptr(), n_tiles, cfg.grid_w, cfg.tile_h, tile_row0, py_lo,
        py_hi, cfg.width, cfg.height, cfg.subpixel_scale, cfg.min_coord,
        wide_rows, wide_pairs, s_rows, count=N_LAUNCHES,
    )
    return pair_rows, pair_starts, rmeta, meta[: len(COUNTS)]


def front_meta_plain(comb, order, bounds, cfg, wide_rows: int,
                     wide_pairs: int, tile_row0: int = 0, tile_rows=None):
    """front_meta in torch ops (any device): ``binsort.expand_wide_pairs``
    then ``fused_kernel.build_range_meta``; it reads the device."""
    n_tiles = binsort.window_rows(cfg, tile_row0, tile_rows)[0] * cfg.grid_w
    pair_rows, pair_starts, new_ws = binsort.expand_wide_pairs(
        comb, order, bounds, cfg, wide_rows, wide_pairs, tile_row0, tile_rows)
    rmeta = fused_kernel.build_range_meta(bounds, n_tiles, cfg.grid_w,
                                          pair_starts, new_ws)
    nk = n_tiles * binsort.KEYS_PER_TILE
    counts = torch.cat([
        bounds[nk:nk + 2],
        torch.tensor([new_ws], dtype=torch.int32, device=bounds.device),
        pair_starts[-1:]])
    return pair_rows, pair_starts, rmeta, counts
