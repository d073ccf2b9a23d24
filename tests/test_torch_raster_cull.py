"""K3's cull is exact: every pixel that the plain version's arithmetic
covers for a streamed (tile, slot) lies inside the slot's pixel box
(``fused_kernel.slot_pixel_boxes``, the boxes ``csrc/raster.cu`` culls to),
and a fine row's box never leaves its 16-px window.  Checked on the random
and graze parity cases (clip tail and wide pairs live), on the 150x64
fine-padding scene of ``test_torch_raster.py``, on slabs of a
multi-device frame (a nonzero first tile row: the boxes and the coverage
in screen rows), and as a hypothesis
property over single records anywhere in the guard extent, zero-area,
sliver and axis-aligned (top-left) edges included."""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_raster import _pixel_triangles  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch import specmath as sm  # noqa: E402
from ash_renderer_tpu_torch.config import derive_raster_config  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from ash_renderer_tpu_torch.ops.binsort import FINE_W  # noqa: E402

torch.set_num_threads(1)

I32 = torch.int32
PIX = torch.arange(fk.N_PIX)
COL, ROW = (PIX % fk.TILE_W).to(I32), (PIX // fk.TILE_W).to(I32)


def plain_coverage(tile, rng, pos, tbl_sorted, tbl_ext, cfg, tile_row0=0):
    """(N, 1024) bool: each slot's coverage of its tile's pixels, in the
    arithmetic of ``rasterize_distribute_plain`` (fine rows only inside
    their window); tile t lies at tile row t // grid_w + tile_row0."""
    ss, half, min_c = cfg.subpixel_scale, cfg.subpixel_scale // 2, cfg.min_coord
    ext = rng == fk.EXT_RANGE
    rec = torch.empty((pos.shape[0], 3), dtype=I32)
    rec[ext] = tbl_ext[pos[ext], :3]
    rec[~ext] = tbl_sorted[pos[~ext], :3]
    x = (rec & 0xFFFF) + min_c
    y = ((rec >> 16) & 0xFFFF) + min_c
    x0, x1, x2 = x[:, 0:1], x[:, 1:2], x[:, 2:3]
    y0, y1, y2 = y[:, 0:1], y[:, 1:2], y[:, 2:3]
    tx = (tile % cfg.grid_w).to(I32)[:, None]
    ty = (tile // cfg.grid_w + tile_row0).to(I32)[:, None]
    sx, sy = sm.pixel_sample_coords(tx * fk.TILE_W + COL, ty * fk.TILE_H + ROW, ss)
    cov = torch.ones((pos.shape[0], fk.N_PIX), dtype=torch.bool)
    for xa, ya, xb, yb in ((x1, y1, x2, y2), (x2, y2, x0, y0), (x0, y0, x1, y1)):
        a, b, tl = sm.edge_coeffs(xa, ya, xb, yb)
        cov &= sm.edge_at(a, b, xa, ya, sx, sy) >= 1 - tl.to(I32)
    pxmin = torch.clamp((torch.minimum(torch.minimum(x0, x1), x2) - half + ss - 1)
                        // ss, min=0)
    win = (pxmin % fk.TILE_W) // FINE_W
    return cov & ((rng != fk.FINE_RANGE)[:, None] | (COL // FINE_W == win))


def check_boxes(rmeta, tbl_sorted, tbl_ext, cfg, tile_row0=0, box_row0=None):
    """Asserts the cull's two properties on every streamed slot (of the
    window from ``tile_row0`` the range meta was built for; the boxes are
    taken at ``box_row0``, by default the same); returns (slots, covered
    slot-pixels, box slot-pixels, fine slots)."""
    tile, rng, box = fk.slot_pixel_boxes(
        rmeta, tbl_sorted, tbl_ext, cfg,
        tile_row0 if box_row0 is None else box_row0)
    _, _, pos = fk._range_pairs(rmeta, rmeta.shape[0] // (fk.N_RANGES * 2))
    n_cov = 0
    for c0 in range(0, pos.shape[0], fk.PLAIN_CHUNK):
        sl = slice(c0, c0 + fk.PLAIN_CHUNK)
        cov = plain_coverage(tile[sl], rng[sl], pos[sl], tbl_sorted, tbl_ext,
                             cfg, tile_row0)
        b = box[sl]
        inside = ((COL >= b[:, 0:1]) & (COL <= b[:, 1:2])
                  & (ROW >= b[:, 2:3]) & (ROW <= b[:, 3:4]))
        outside = cov & ~inside
        assert not outside.any(), (
            f"{int(outside.sum())} covered pixels outside their box, first "
            f"at slot {c0 + int(outside.any(1).nonzero()[0])}")
        n_cov += int(cov.sum())
    fine = (rng == fk.FINE_RANGE) & (box[:, 0] <= box[:, 1])
    w0 = box[fine, 0] // FINE_W * FINE_W
    assert bool((box[fine, 1] < w0 + FINE_W).all()), "a fine box leaves its window"
    return pos.shape[0], n_cov, int(fk.box_pixels(box).sum()), int(fine.sum())


def front(case):
    rmeta, tbl_sorted, tbl_ext, _, stats = pipeline.render_front(
        tp.port_statics(case), tp.port_state(case), tp.t(case.mm), tp.t(case.mvp))
    return rmeta, tbl_sorted, tbl_ext, stats


@pytest.mark.parametrize("name, ranges, box_share", [
    ("random", (0, 1, 2, 3, 5), 0.5),
    ("graze", (5,), 0.75),  # clip tail and wide pairs
    ("overflow", (4, 5), 0.5),  # the global wide run
    ("config3", (0, 1, 2, 3, 6), 0.01),  # small triangles, fine runs
])
def test_box_holds_every_covered_pixel(name, ranges, box_share):
    case = tp.make_case(name)
    rmeta, tbl_sorted, tbl_ext, stats = front(case)
    if name == "graze":
        assert stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0
    m = rmeta.reshape(-1, fk.N_RANGES, 2)
    live = ((m[..., 1] - m[..., 0]).sum(0) > 0).nonzero()[:, 0].tolist()
    assert tuple(live) == ranges
    n, n_cov, n_box, _ = check_boxes(rmeta, tbl_sorted, tbl_ext, case.cfg)
    assert n_cov > 500
    # the cull's point: the boxes are a part of the brute-force work
    assert n_cov <= n_box < n * fk.N_PIX * box_share


@pytest.mark.parametrize("name, window", [
    ("graze", (6, 6)),  # clip tail and wide pairs
    ("graze", (12, 6)),  # a last slab past the screen
    ("config3", (9, 1)),  # one tile row; fine runs
])
def test_box_holds_every_covered_pixel_in_a_slab(name, window):
    """A slab's boxes and its coverage in screen rows: a box taken in the
    slab's own rows against coverage in the frame's would leave pixels
    out (and the kernel would drop them)."""
    case = tp.make_case(name)
    tile_row0, tile_rows = window
    rmeta, tbl_sorted, tbl_ext, _, stats = pipeline.render_front(
        tp.port_statics(case), tp.port_state(case), tp.t(case.mm),
        tp.t(case.mvp), tile_row0=tile_row0, tile_rows=tile_rows)
    n, n_cov, n_box, n_fine = check_boxes(rmeta, tbl_sorted, tbl_ext,
                                          case.cfg, tile_row0)
    assert n_cov > 100 and n_cov <= n_box < n * fk.N_PIX
    if name == "config3":
        assert n_fine > 0
    # boxes taken in the slab's own rows miss covered pixels
    if name == "graze":
        with pytest.raises(AssertionError, match="outside their box"):
            check_boxes(rmeta, tbl_sorted, tbl_ext, case.cfg, tile_row0,
                        box_row0=0)


def test_fine_padding_scene():
    """Fine rows whose true extent runs past their window into the padding
    of a 150-px-wide frame: their boxes stop at the window."""
    from ash_renderer_tpu import RendererSettings

    tris = [((145.3, 17.2), (162.6, 18.4), (149.1, 22.7)),
            ((146.8, 9.1), (171.2, 11.3), (147.5, 14.6)),
            ((144.6, 1.4), (158.9, 6.2), (148.2, 6.9))]
    case = tp.case_from(_pixel_triangles(tris, 150, 64),
                        RendererSettings(width=150, height=64, clip_budget=64))
    rmeta, tbl_sorted, tbl_ext, _ = front(case)
    n, n_cov, n_box, n_fine = check_boxes(rmeta, tbl_sorted, tbl_ext, case.cfg)
    assert n_fine >= 3 and n_cov > 30


# One record per example, streamed by one tile of a 256x16 frame (2x2
# tiles of 8x128) from one of the 7 ranges, with its corners anywhere in
# the guard extent.
CFG = derive_raster_config(256, 16, tile_h=fk.TILE_H)
SS = CFG.subpixel_scale
LO_X, HI_X = CFG.min_coord, CFG.max_coord_x
LO_Y, HI_Y = CFG.min_coord, CFG.max_coord_y
KINDS = ("general", "point", "collinear", "sliver", "horizontal", "vertical")


@st.composite
def record(draw):
    tile = draw(st.integers(0, CFG.n_tiles - 1))
    scale = draw(st.sampled_from([2, 12, 40, 200, 1500, 6000]))
    if draw(st.booleans()):  # centred on the tile or just around it
        x0 = tile % CFG.grid_w * fk.TILE_W * SS
        y0 = tile // CFG.grid_w * fk.TILE_H * SS
        cx = draw(st.integers(x0 - 8 * SS, x0 + (fk.TILE_W + 8) * SS))
        cy = draw(st.integers(y0 - 4 * SS, y0 + (fk.TILE_H + 4) * SS))
    else:  # anywhere in the guard extent
        cx = draw(st.integers(LO_X, HI_X))
        cy = draw(st.integers(LO_Y, HI_Y))
    d = st.integers(-scale, scale)
    v = [[cx + draw(d), cy + draw(d)] for _ in range(3)]
    kind = draw(st.sampled_from(KINDS))
    if kind == "point":
        v[1] = list(v[0])
    elif kind == "collinear":
        v[2] = [2 * v[1][0] - v[0][0], 2 * v[1][1] - v[0][1]]
    elif kind == "sliver":
        v[2] = [(v[0][0] + v[1][0]) // 2, (v[0][1] + v[1][1]) // 2 + 1]
    elif kind == "horizontal":
        v[1][1] = v[0][1]
    elif kind == "vertical":
        v[1][0] = v[0][0]
    if draw(st.booleans()):  # corners on pixel samples: edges meet samples
        v = [[(x - SS // 2) // SS * SS + SS // 2, (y - SS // 2) // SS * SS + SS // 2]
             for x, y in v]
    v = [[min(max(x, LO_X), HI_X), min(max(y, LO_Y), HI_Y)] for x, y in v]
    return v, tile, draw(st.integers(0, fk.N_RANGES - 1))


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(record())
def test_box_property_on_records(rec):
    verts, tile, rng = rec
    row = torch.zeros((1, fk.REC_WORDS), dtype=I32)  # one record
    for k, (x, y) in enumerate(verts):
        row[0, k] = (x - CFG.min_coord) | ((y - CFG.min_coord) << 16)
    row[0, fk.REC_ID] = 7
    rmeta = torch.zeros((CFG.n_tiles, fk.N_RANGES, 2), dtype=I32)
    rmeta[tile, rng, 1] = 1
    check_boxes(rmeta.reshape(-1), row, row.clone(), CFG)
    # a zero-area record covers nothing
    (x0, y0), (x1, y1), (x2, y2) = verts
    if (x1 - x0) * (y2 - y0) == (y1 - y0) * (x2 - x0):
        _, _, pos = fk._range_pairs(rmeta.reshape(-1), CFG.n_tiles)
        cov = plain_coverage(torch.tensor([tile]), torch.tensor([rng]), pos,
                             row, row, CFG)
        assert not cov.any()


def test_box_pixels_counts_empty_boxes_as_zero():
    box = torch.tensor([[0, 3, 0, 1], [5, 4, 0, 7], [0, 127, 7, 6]], dtype=I32)
    assert fk.box_pixels(box).tolist() == [8, 0, 0]
    assert np.array_equal(fk.box_pixels(box[:0]).numpy(), np.zeros(0))
