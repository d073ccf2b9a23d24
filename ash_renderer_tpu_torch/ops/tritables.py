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

Phase V of the raster kernel reads cols 0-5 and 46 of a row, so the
sorted tables it streams hold records of ``REC_WORDS`` words (``REC_COLS``,
then a zero word: 32 bytes, two 16-byte loads) instead of rows; phase D
reads cols 0-47 of a winner's row straight from the unsorted table, whose
row index is the triangle id.

``build_comb_table`` assembles the whole table from a ``TriangleSetup``
(the non-meshlet fused pipeline); the meshlet pipeline's setup kernel K1
writes the main rows itself and ``comb_rows`` only the clip tail's.
"""

from __future__ import annotations

import torch

from .. import specmath as sm
from ..scene import MESHLET_TRIS, MESHLET_VERTS
from . import meshlet_gather

COMB_FIELDS = 46
TBL_COLS = 128
ID_COL = 46
# the record of a row that the raster kernel streams: its columns, then a
# zero word (csrc/specmath.cuh REC_WORDS, REC_ID); the id word is written
# from the row's index, which a comb table holds at ID_COL
REC_COLS = (0, 1, 2, 3, 4, 5, ID_COL)
REC_WORDS = 8
REC_ID = REC_COLS.index(ID_COL)  # the record's id word


_COMB_SETUP_FIELDS = (
    "x0 y0 x1 y1 x2 y2 zq0 zq1 zq2 inv_area2 iw0 iw1 iw2 mat".split())


def build_comb_table(su, attrs, cfg, local_tri=None):
    """(S, 128) int32 comb table of a ``TriangleSetup`` of S rows (row id =
    setup row).  attrs: (VA, 12) float32 combined attribute rows.

    Without ``local_tri`` each corner's row is gathered by ``su.v0/v1/v2``.
    With ``local_tri`` (T, 3) meshlet-local ids, the T main triangles'
    corners come from kernel K5 at F = 12 on the (T // 128) * 128 meshlet
    vertex rows, and only the clip tail (rows T onward) is gathered by
    vertex id.  K5 gives the corners in their original order, and the
    setup rewinds front faces (0, 2, 1), so its corner 2 is setup corner 1
    and the other way round.  Dead rows differ between the branches in the
    attribute columns (zeroed vertex ids gather vertex 0's row; K5 gathers
    the triangle's own corners), as they do in the reference."""
    if local_tri is not None:
        t_main = local_tri.shape[0]
        v_main = (t_main // MESHLET_TRIS) * MESHLET_VERTS
        a3 = sm.bitcast_f32(meshlet_gather.gather_tri_rows(
            sm.bitcast_i32(attrs[:v_main]), local_tri))  # corner k: 12k:12k+12
        tail = [attrs[v[t_main:].long()] for v in (su.v0, su.v1, su.v2)]
        a_v0 = torch.cat([a3[:, 0:12], tail[0]])
        a_v1 = torch.cat([a3[:, 24:36], tail[1]])
        a_v2 = torch.cat([a3[:, 12:24], tail[2]])
    else:
        a_v0, a_v1, a_v2 = (attrs[v.long()] for v in (su.v0, su.v1, su.v2))
    return comb_rows({k: getattr(su, k) for k in _COMB_SETUP_FIELDS},
                     a_v0, a_v1, a_v2, cfg)


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


def unpack_coord_planes(packed, cfg):
    """(x, y) snapped coordinates from packed coordinate words (comb columns
    0-2, or planes of them): the inverse of ``comb_rows``' packing, for
    tensors and numpy arrays alike."""
    off = -cfg.min_coord
    return (packed & 0xFFFF) - off, ((packed >> 16) & 0xFFFF) - off


def sorted_table(comb, rows):
    """The records of comb rows ``rows`` in that order: (len(rows),
    REC_WORDS) int32, ``REC_COLS`` then a zero word, the id word being
    the row's index (which is the row's ``ID_COL`` word: every comb table
    holds each row's own index there, and the raster kernel's phase D
    reads the winner's row by it).  With ``rows`` the
    live prefix of the sorted order (``order[:live_end]``) it is the table
    the raster kernel streams, which only reads positions before the dead
    run (the reference's budget tiers only capped TPU program size); with
    the wide pairs' rows it is the extension table.  Kernel K9
    (``front_meta.front_meta``) writes both on a card."""
    out = torch.zeros((rows.shape[0], REC_WORDS), dtype=torch.int32,
                      device=comb.device)
    out[:, :REC_ID] = comb[rows.long(), :REC_ID]  # REC_COLS before the id
    out[:, REC_ID] = rows
    return out
