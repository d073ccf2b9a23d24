"""Tile-binned visibility raster of the classic pipeline: kernel K4.

``rasterize_visibility`` launches ``csrc/raster_classic.cu`` on CUDA
tensors and runs ``rasterize_visibility_plain`` (the same function in torch
ops) on CPU tensors.  It replaces the Pallas kernel
``ash_renderer_tpu/ops/raster_pallas.py:_kernel`` (via
``rasterize_visibility``), which streams each tile's records through SMEM
with double-buffered DMA on the TPU's sequential grid; ``tri_block`` and
``tri_unroll`` size that stream and do not apply here.

Per 16x128 tile, over the tile's (triangle, tile) records from
``binning.bin_triangles``: the three int32 edge functions
``e_i = (e_ic + a_i * col_s) + b_i * row_s`` from the tile-corner values
(wrapping), the top-left rule (covered iff e_i >= 1 - bias bit i), D16
depth (``specmath.interp_depth16``) and the minimum of (d16, -id).  Pixels
of edge tiles past the frame are evaluated, then cropped.

One CUDA block per tile, 256 threads of 8 pixels each; every thread keeps
its pixels' minima in registers (exact and order-free, no atomics) while
the block stages the tile's records in shared memory in chunks.  What
bounds it on the card: integer issue, ~20 ops per (record, pixel): every
record is evaluated at all 2048 pixels of its tile.
"""

from __future__ import annotations

import torch

from .. import _build
from .. import specmath as sm
from .binning import F32_ROWS, RECORD_ROWS

KERNEL = "K4_raster_classic"
TILE_H = 16  # the classic pipeline's tile height (the Renderer's too)
TILE_W = 128
N_PIX = TILE_H * TILE_W
PLAIN_CHUNK = 512  # records per step of the plain version


def _check_cfg(cfg):
    if cfg.tile_h != TILE_H or cfg.tile_w != TILE_W:
        raise ValueError("rasterize_visibility: tiles must be 16x128")


def rasterize_visibility(rec_i, rec_f, tile_start, tile_count, cfg):
    """rec_i (14, P) int32 and rec_f (1, P) float32 records, tile_start and
    tile_count (n_tiles,) int32.  Returns (vis_d16, vis_tri) int32 cropped
    to (height, width).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check_cfg(cfg)
    dev = rec_i.device
    if dev.type == "cpu":
        return rasterize_visibility_plain(rec_i, rec_f, tile_start,
                                          tile_count, cfg)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_visibility: unsupported device {dev}")
    n_tiles = cfg.n_tiles
    p = rec_i.shape[1]
    for name, x, dtype, shape in (
        ("rec_i", rec_i, torch.int32, (RECORD_ROWS, p)),
        ("rec_f", rec_f, torch.float32, (F32_ROWS, p)),
        ("tile_start", tile_start, torch.int32, (n_tiles,)),
        ("tile_count", tile_count, torch.int32, (n_tiles,)),
    ):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"rasterize_visibility: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    hp, wp = cfg.grid_h * TILE_H, cfg.grid_w * TILE_W
    vis_d = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    vis_t = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    _build.launch(
        KERNEL, "ash_rasterize_visibility", dev,
        rec_i.data_ptr(), rec_f.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), vis_d.data_ptr(), vis_t.data_ptr(), p,
        n_tiles, cfg.grid_w, cfg.subpixel_scale,
    )
    return vis_d[: cfg.height, : cfg.width], vis_t[: cfg.height, : cfg.width]


def rasterize_visibility_plain(rec_i, rec_f, tile_start, tile_count, cfg):
    """rasterize_visibility in torch ops (any device): the tile's records
    in chunks, each evaluated at its tile's 2048 pixels, and the per-pixel
    minimum of (d16, -id) as a scatter-min of a packed 64-bit key."""
    _check_cfg(cfg)
    dev = rec_i.device
    i32, i64 = torch.int32, torch.int64
    n_tiles = cfg.n_tiles
    ss = cfg.subpixel_scale
    counts = tile_count.long()
    total = int(counts.sum())
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = tile_start.long()[tile] + (torch.arange(total, device=dev) - first[tile])
    pix = torch.arange(N_PIX, device=dev)
    col_s = ((pix % TILE_W) * ss).to(i32)
    row_s = ((pix // TILE_W) * ss).to(i32)
    bg_key = (sm.DEPTH_MAX << 32) | (0x7FFFFFFF - sm.BG_TRI)
    best = torch.full((n_tiles * N_PIX,), bg_key, dtype=i64, device=dev)

    for c0 in range(0, total, PLAIN_CHUNK):
        t_c, p_c = tile[c0 : c0 + PLAIN_CHUNK], pos[c0 : c0 + PLAIN_CHUNK]
        r = rec_i[:, p_c][..., None]  # (14, n, 1)
        inv_area = rec_f[0, p_c][:, None]
        e = [(r[6 + i] + r[2 * i] * col_s) + r[2 * i + 1] * row_s
             for i in range(3)]
        cov = torch.ones_like(e[0], dtype=torch.bool)
        for i in range(3):
            cov = cov & (e[i] >= 1 - ((r[13] >> i) & 1))
        d16 = sm.interp_depth16(e[0], e[1], e[2], inv_area, r[9], r[10], r[11])
        key = (d16.to(i64) << 32) | (0x7FFFFFFF - r[12]).to(i64)
        dst = (t_c[:, None] * N_PIX + pix).expand_as(key)
        best.scatter_reduce_(0, dst[cov], key[cov], reduce="amin")

    hp, wp = cfg.grid_h * TILE_H, cfg.grid_w * TILE_W

    def to_image(v):
        return (
            v.reshape(cfg.grid_h, cfg.grid_w, TILE_H, TILE_W).permute(0, 2, 1, 3)
            .reshape(hp, wp)[: cfg.height, : cfg.width]
        )

    vis_d = (best >> 32).to(i32)
    vis_t = (0x7FFFFFFF - (best & 0xFFFFFFFF)).to(i32)
    return to_image(vis_d), to_image(vis_t)
