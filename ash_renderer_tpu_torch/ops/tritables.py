"""Per-triangle comb rows for the raster kernel (counterpart of
``ash_renderer_tpu/ops/tritables.py``).

Row layout, (N, 128) int32, one row per setup slot:

    0-2  pack16 coords (x - min_coord | (y - min_coord) << 16)
    3    zq0 | zq1<<16     4  zq2
    5    inv_area2 bits
    6-8  iw0-2 bits        9  mat
    10-45  attr corners (a_v0 | a_v1 | a_v2, 12 f32 each)
    46   the row's own id (its index in the unsorted table)
    47-127  zero

Phase V of the raster kernel reads cols 0-5 and 46 of the sorted tables;
phase D reads cols 0-47 of a winner's row straight from the unsorted table,
whose row index is the triangle id.
"""

from __future__ import annotations

import torch

from .. import specmath as sm

COMB_FIELDS = 46
TBL_COLS = 128
ID_COL = 46


def comb_rows(f: dict, a_v0, a_v1, a_v2, cfg, id_base: int = 0):
    """Pack setup fields (dict with x0..y2, zq0..zq2, inv_area2, iw0..iw2,
    mat) and per-corner (N, 12) f32 attribute rows into (N, 128) comb rows;
    ids are ``id_base + row``."""
    off = -cfg.min_coord
    cols = [
        (f["x0"] + off) | ((f["y0"] + off) << 16),
        (f["x1"] + off) | ((f["y1"] + off) << 16),
        (f["x2"] + off) | ((f["y2"] + off) << 16),
        f["zq0"] | (f["zq1"] << 16),
        f["zq2"],
        sm.bitcast_i32(f["inv_area2"]),
        sm.bitcast_i32(f["iw0"]),
        sm.bitcast_i32(f["iw1"]),
        sm.bitcast_i32(f["iw2"]),
        f["mat"],
    ]
    n = cols[0].shape[0]
    out = torch.zeros((n, TBL_COLS), dtype=torch.int32, device=cols[0].device)
    out[:, :10] = torch.stack(cols, dim=1)
    out[:, 10:22] = sm.bitcast_i32(a_v0)
    out[:, 22:34] = sm.bitcast_i32(a_v1)
    out[:, 34:46] = sm.bitcast_i32(a_v2)
    out[:, ID_COL] = id_base + torch.arange(
        n, dtype=torch.int32, device=out.device
    )
    return out


def sorted_table(comb, order, live_end: int):
    """The live prefix of the comb table in streaming order: rows
    ``order[:live_end]``.  The raster kernel only streams positions before
    the dead run, so the prefix is all it reads (the reference's budget
    tiers only capped TPU program size)."""
    return comb.index_select(0, order[:live_end])
