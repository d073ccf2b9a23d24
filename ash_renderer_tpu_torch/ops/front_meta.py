"""The fused front's wide-pair expansion, range metadata and sorted-table
records: the sorted order's run bounds of a tile-row window -> the wide
pairs' per-tile runs, the raster's range meta, the records the raster
kernel streams and the front's counts, with no host read.

Kernel K9.  ``front_meta`` launches ``csrc/front_meta.cu`` on CUDA tensors
and runs ``front_meta_plain`` on CPU tensors: ``binsort.expand_wide_pairs``,
``fused_kernel.build_range_meta`` and ``tritables.sorted_table``, each
bit-equal to the JAX package's.

It replaces no Pallas kernel.  The reference runs the stage as XLA glue
under one jit (``ash_renderer_tpu/pipeline.py:458-500``, the empty case
under ``lax.cond``) and gathers whole 128-column comb rows; in eager torch
the same chain is ~40-70 launches and reads the device five times a front,
each read draining the queue.

What bounds it on the card: the records' bytes (each live row's order
word and 7 comb words read, 8 words written) and the latency of the
expansion's dependent steps.  So it is one cooperative launch, its grid
sized from the occupancy and never from the data, which reads the data's
sizes on the device; two grid syncs split it into

0. rows: the first ``min(n_wide, wide_rows)`` rows of the wide run, a row a
   thread, their records, tile rectangles and each chunk's pair total;
1. the cut (positional: a row is consumed while the scan of the pair
   counts is within ``wide_pairs``), and atomic adds of the consumed pairs,
   spread over the chunk's threads, into per-tile and per-tile-row counts;
2. a block a tile row: its ``pair_starts`` from the rows before it, its
   ``rmeta``, then the consumed rows that cover it, staged in shared memory
   in row order, written by one warp a tile in that order (the plain
   version's stable sort by tile) with each pair's record from step 0;
3. the records of the live prefix ``order[:we]``, in chunks the blocks take
   as they come free of step 2.

The records (``tritables.REC_COLS``, 32 bytes) replace the two
``index_select`` gathers of whole 512-byte rows the front ran after a host
read of the counts; the tables are sized from host-known shapes (the comb
rows, ``wide_pairs``) and only their live prefixes are written.
"""

from __future__ import annotations

import torch

from .. import _build
from . import binsort, fused_kernel, tritables

KERNEL = "K9_front_meta"
N_LAUNCHES = 1
# the counts the kernel leaves on the device, in its buffer's order
COUNTS = ("ws", "we", "new_ws", "n_pairs", "n_wide", "wide_leftover")
N_META = len(COUNTS) + 1  # the kernel's buffer: COUNTS, the consumed rows
RECT_WORDS = 4  # tx0, tx1, ty0, ty1 a wide row
MAX_GRID_W = 512  # tiles a row the tile-row step holds (65,536 px)
ROWS_PER_CHUNK = 512  # wide rows a chunk of steps 0 and 1 (the block size)
N_CHUNK_SUMS = 3  # per chunk: pairs, consumed rows, consumed pairs


def front_meta(comb, order, bounds, cfg, wide_rows: int, wide_pairs: int,
               tile_row0: int = 0, tile_rows=None):
    """Wide-pair expansion, range metadata and sorted-table records of the
    tile-row window ``[tile_row0, tile_row0 + tile_rows)`` (the whole grid
    by default).

    comb: (S, 128) int32; order: (S,) int32 sorted row ids and bounds:
    (n_tiles * 12 + 3,) int32 run bounds, both from
    ``binsort.sort_and_bounds``.  Returns (pair_rows (wide_pairs,) int32,
    whose first n_pairs entries are the consumed rows by tile, each tile's
    in row order; pair_starts (n_tiles + 1,) int32; rmeta (n_tiles * 14,)
    int32, ``build_range_meta``'s layout; counts (6,) int32 ``COUNTS``;
    tbl_sorted, the records of ``order[:we]``; tbl_ext, the records of
    ``pair_rows[:n_pairs]``).  CPU tensors take the plain version, whose
    tables hold just those rows; CUDA tensors launch the kernel, which
    reads nothing back to the host, and the tables are (S, 8) and
    (wide_pairs, 8) int32 with the rows past those prefixes unwritten."""
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
    if comb.data_ptr() % 16:  # K9 reads records in 16-byte loads
        raise ValueError("front_meta: comb is not 16-byte aligned")
    # one allocation for the outputs and the scratch (the wide rows'
    # records, rectangles, row ids, counts); the records, the rectangles
    # and rmeta first, since K9 moves them 16 and 8 bytes at a time.  The
    # counts have their own: the counters read after the frame are views
    # of them, and must not hold the tables (a slab's would outlive it)
    rw = tritables.REC_WORDS
    n_chunks = -(-wide_rows // ROWS_PER_CHUNK)
    sizes = (rw * s_rows, rw * wide_pairs, rw * wide_rows,
             RECT_WORDS * wide_rows, n_tiles * fused_kernel.N_RANGES * 2,
             n_tiles + 1, wide_pairs, wide_rows, n_tiles, tile_rows,
             N_CHUNK_SUMS * n_chunks, 1)
    (rec_sorted, rec_ext, wrec, rects, rmeta, pair_starts, pair_rows, wrow,
     tile_cnt, row_cnt, chunk_sums, work) = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    meta = torch.empty(N_META, dtype=torch.int32, device=dev)
    _build.launch(
        KERNEL, "ash_front_meta", dev,
        comb.data_ptr(), order.data_ptr(), bounds.data_ptr(),
        rects.data_ptr(), wrow.data_ptr(), wrec.data_ptr(),
        tile_cnt.data_ptr(), row_cnt.data_ptr(), chunk_sums.data_ptr(),
        work.data_ptr(),
        meta.data_ptr(), pair_rows.data_ptr(), pair_starts.data_ptr(),
        rmeta.data_ptr(), rec_sorted.data_ptr(), rec_ext.data_ptr(),
        n_tiles, cfg.grid_w, cfg.tile_h, tile_row0, py_lo, py_hi, cfg.width,
        cfg.height, cfg.subpixel_scale, cfg.min_coord, wide_rows, wide_pairs,
        s_rows, count=N_LAUNCHES,
    )
    return (pair_rows, pair_starts, rmeta, meta[: len(COUNTS)],
            rec_sorted.view(s_rows, rw), rec_ext.view(wide_pairs, rw))


def front_meta_plain(comb, order, bounds, cfg, wide_rows: int,
                     wide_pairs: int, tile_row0: int = 0, tile_rows=None):
    """front_meta in torch ops (any device): ``binsort.expand_wide_pairs``,
    ``fused_kernel.build_range_meta`` and ``tritables.sorted_table``; it
    reads the device, and its tables hold just the live prefixes."""
    n_tiles = binsort.window_rows(cfg, tile_row0, tile_rows)[0] * cfg.grid_w
    pair_rows, pair_starts, new_ws = binsort.expand_wide_pairs(
        comb, order, bounds, cfg, wide_rows, wide_pairs, tile_row0, tile_rows)
    rmeta = fused_kernel.build_range_meta(bounds, n_tiles, cfg.grid_w,
                                          pair_starts, new_ws)
    nk = n_tiles * binsort.KEYS_PER_TILE
    ws, we = bounds[nk:nk + 2].tolist()
    n_pairs = int(pair_starts[-1])
    counts = torch.tensor([ws, we, new_ws, n_pairs, we - ws, we - new_ws],
                          dtype=torch.int32, device=bounds.device)
    return (pair_rows, pair_starts, rmeta, counts,
            tritables.sorted_table(comb, order[:we]),
            tritables.sorted_table(comb, pair_rows[:n_pairs]))


def front_stats(counts):
    """The front's counters from ``front_meta``'s counts, as 0-dim int32
    tensors on their device (views: no launch, no host read): n_wide,
    wide_pairs_n, wide_leftover and live_rows (the dead run's start)."""
    c = dict(zip(COUNTS, counts.unbind()))
    return {"n_wide": c["n_wide"], "wide_pairs_n": c["n_pairs"],
            "wide_leftover": c["wide_leftover"], "live_rows": c["we"]}
