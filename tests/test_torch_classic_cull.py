"""K4's cull is exact: every pixel of the frame that the plain version's
arithmetic covers for a binned (triangle, tile) record lies inside the
record's pixel box (``rec_box`` from ``binning.bin_triangles``, the boxes
``csrc/raster_classic.cu`` culls to).  Checked on the clip-heavy,
clip-overflow and pairs-overflow cases of ``test_torch_classic.py``, where
``rec_box`` also equals the JAX package's own setup coordinates put
through the pixel-AABB rule and clipped to the tile, and as a hypothesis
property over single records anywhere in the guard extent, zero-area,
sliver and axis-aligned (top-left) edges included.  A box one sample
short on its min side fails the check."""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_classic import _case, _port_geometry  # noqa: E402

from ash_renderer_tpu_torch import specmath as sm  # noqa: E402
from ash_renderer_tpu_torch.config import derive_raster_config  # noqa: E402
from ash_renderer_tpu_torch.ops import binning  # noqa: E402
from ash_renderer_tpu_torch.ops import raster_visibility as rv  # noqa: E402
from ash_renderer_tpu_torch.rtypes import TriangleSetup  # noqa: E402

torch.set_num_threads(1)

I32 = torch.int32
PIX = torch.arange(rv.N_PIX)
COL, ROW = (PIX % rv.TILE_W).to(I32), (PIX // rv.TILE_W).to(I32)
CASE_NAMES = ["clip_heavy", "clip_overflow", "pairs_overflow"]


def record_tiles(start, count):
    """(live columns, the tile of each) from tile_start / tile_count."""
    tile = torch.repeat_interleave(torch.arange(count.shape[0]), count.long())
    first = torch.cumsum(count.long(), 0) - count.long()
    pos = start.long()[tile] + (torch.arange(tile.shape[0]) - first[tile])
    return pos, tile


def plain_coverage(rec_i, pos, tile, cfg):
    """(N, 2048) bool: each record's coverage of its tile's pixels inside
    the frame, in the arithmetic of ``rasterize_visibility_plain``."""
    ss = cfg.subpixel_scale
    r = rec_i[:, pos][..., None]
    cov = torch.ones((pos.shape[0], rv.N_PIX), dtype=torch.bool)
    for i in range(3):
        e = (r[6 + i] + r[2 * i] * (COL * ss)) + r[2 * i + 1] * (ROW * ss)
        cov &= e >= 1 - ((r[13] >> i) & 1)
    tx = (tile % cfg.grid_w)[:, None] * rv.TILE_W + COL
    ty = (tile // cfg.grid_w)[:, None] * rv.TILE_H + ROW
    return cov & (tx < cfg.width) & (ty < cfg.height)


def check_boxes(rec_i, rec_box, start, count, cfg):
    """Asserts that no covered pixel of a live record lies outside its box
    and that the dead columns' boxes are 0; returns (records, covered
    record-pixels, box record-pixels)."""
    pos, tile = record_tiles(start, count)
    n_live = pos.shape[0]
    assert not rec_box[:, n_live:].any(), "a dead column has a box"
    n_cov = 0
    for c0 in range(0, n_live, rv.PLAIN_CHUNK):
        sl = slice(c0, c0 + rv.PLAIN_CHUNK)
        cov = plain_coverage(rec_i, pos[sl], tile[sl], cfg)
        b0, b1, b2, b3 = (f[:, None] for f in binning.unpack_box(rec_box[0, pos[sl]]))
        inside = (COL >= b0) & (COL <= b1) & (ROW >= b2) & (ROW <= b3)
        outside = cov & ~inside
        assert not outside.any(), (
            f"{int(outside.sum())} covered pixels outside their box, first "
            f"at record {c0 + int(outside.any(1).nonzero()[0])}")
        n_cov += int(cov.sum())
    return n_live, n_cov, int(rv.box_pixels(rec_box[0, pos]).sum())


def port_records(name):
    case, jax_out = _case(name)
    _, su, _, _ = _port_geometry(case)
    rec_i, _, rec_box, start, count, _ = binning.bin_triangles(
        su, case.cfg, case.settings.max_pairs)
    return case, jax_out[1], rec_i, rec_box, start, count


@pytest.mark.parametrize("name, box_share", [
    ("clip_heavy", 0.75), ("clip_overflow", 0.75), ("pairs_overflow", 0.5),
])
def test_box_holds_every_covered_pixel(name, box_share):
    case, _, rec_i, rec_box, start, count = port_records(name)
    n, n_cov, n_box = check_boxes(rec_i, rec_box, start, count, case.cfg)
    assert n > 50 and n_cov > 10_000
    # the cull's point: the boxes are a part of the brute-force work (these
    # scenes' triangles are large; the subdiv-8 frame's are 1-3 px)
    assert n_cov <= n_box < n * rv.N_PIX * box_share


@pytest.mark.parametrize("name", CASE_NAMES)
def test_box_is_the_jax_setups_pixel_aabb_in_the_tile(name):
    """rec_box per (tile, triangle id), from the JAX package's own snapped
    coordinates: the pixels whose sample lies in the vertex bbox, clamped
    to the frame, clipped to the tile (numpy, independent of the port)."""
    case, jsu, rec_i, rec_box, start, count = port_records(name)
    cfg = case.cfg
    ss, half = cfg.subpixel_scale, cfg.subpixel_scale // 2
    pos, tile = record_tiles(start, count)
    ids = rec_i[12, pos].numpy()
    x = np.stack([np.asarray(jsu.x0), np.asarray(jsu.x1), np.asarray(jsu.x2)])[:, ids]
    y = np.stack([np.asarray(jsu.y0), np.asarray(jsu.y1), np.asarray(jsu.y2)])[:, ids]
    px0 = tile.numpy() % cfg.grid_w * rv.TILE_W
    py0 = tile.numpy() // cfg.grid_w * rv.TILE_H
    pxmin = np.maximum((x.min(0) - half + ss - 1) // ss, 0)
    pxmax = np.minimum((x.max(0) - half) // ss, cfg.width - 1)
    pymin = np.maximum((y.min(0) - half + ss - 1) // ss, 0)
    pymax = np.minimum((y.max(0) - half) // ss, cfg.height - 1)
    col0, col1 = np.maximum(pxmin - px0, 0), np.minimum(pxmax - px0, rv.TILE_W - 1)
    row0, row1 = np.maximum(pymin - py0, 0), np.minimum(pymax - py0, rv.TILE_H - 1)
    assert (col0 <= col1).all() and (row0 <= row1).all()
    want = col0 | (col1 << 7) | (row0 << 14) | (row1 << 18)
    np.testing.assert_array_equal(rec_box[0, pos].numpy(), want)
    assert not rec_box[0, pos.shape[0]:].any()


@pytest.mark.parametrize("side", ["col", "row"])
def test_box_one_sample_short_fails(side):
    """The check has teeth: each box with its min column (row) moved in by
    one pixel misses covered pixels on the clip-heavy case."""
    case, _, rec_i, rec_box, start, count = port_records("clip_heavy")
    col0, col1, row0, row1 = binning.unpack_box(rec_box)
    if side == "col":
        col0 = torch.clamp(col0 + 1, max=rv.TILE_W - 1)
    else:
        row0 = torch.clamp(row0 + 1, max=rv.TILE_H - 1)
    n_live = int(count.sum())
    short = rec_box.clone()
    short[:, :n_live] = binning.pack_box(col0, col1, row0, row1)[:, :n_live]
    with pytest.raises(AssertionError, match="outside their box"):
        check_boxes(rec_i, short, start, count, case.cfg)


def test_box_pixels_counts_packed_boxes():
    box = binning.pack_box(torch.tensor([0, 5, 0, 127]), torch.tensor([3, 4, 127, 127]),
                           torch.tensor([0, 0, 0, 15]), torch.tensor([1, 7, 15, 15]))
    assert rv.box_pixels(box).tolist() == [8, 0, 2048, 1]
    assert rv.box_pixels(box[None, :]).shape == (1, 4)


# One triangle per example in a 200x24 frame (2x2 tiles of 16x128, the
# right and bottom ones cut by the frame), its corners anywhere in the
# guard extent, binned to every tile its pixel AABB meets.
CFG = derive_raster_config(200, 24)
SS = CFG.subpixel_scale
LO_X, HI_X = CFG.min_coord, CFG.max_coord_x
LO_Y, HI_Y = CFG.min_coord, CFG.max_coord_y
KINDS = ("general", "point", "collinear", "sliver", "horizontal", "vertical")


@st.composite
def triangle(draw):
    scale = draw(st.sampled_from([2, 12, 40, 200, 1500, 6000]))
    if draw(st.booleans()):  # around the frame
        cx = draw(st.integers(-8 * SS, (CFG.width + 8) * SS))
        cy = draw(st.integers(-4 * SS, (CFG.height + 4) * SS))
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
    return [[min(max(x, LO_X), HI_X), min(max(y, LO_Y), HI_Y)] for x, y in v]


def one_triangle_setup(verts):
    """A TriangleSetup of one valid row (either winding, any area), its
    area2 the edges' sum, so the records' E2c is the true third edge."""
    (x0, y0), (x1, y1), (x2, y2) = [[torch.tensor([c], dtype=I32) for c in p]
                                    for p in verts]
    a0, b0, _ = sm.edge_coeffs(x1, y1, x2, y2)
    area2 = sm.edge_at(a0, b0, x1, y1, x0, y0)
    zero = torch.zeros(1, dtype=I32)
    return TriangleSetup(
        valid=torch.ones(1, dtype=torch.bool), x0=x0, y0=y0, x1=x1, y1=y1,
        x2=x2, y2=y2, area2=area2, inv_area2=sm.recip_spec(area2.float()),
        zq0=zero + 100, zq1=zero + 200, zq2=zero + 300,
        iw0=zero.float(), iw1=zero.float(), iw2=zero.float(),
        v0=zero, v1=zero, v2=zero, mat=zero)


@settings(max_examples=1000, deadline=None, derandomize=True, database=None)
@given(triangle())
def test_box_property_on_records(verts):
    su = one_triangle_setup(verts)
    rec_i, _, rec_box, start, count, _ = binning.bin_triangles(su, CFG, 8)
    _, n_cov, _ = check_boxes(rec_i, rec_box, start, count, CFG)
    (x0, y0), (x1, y1), (x2, y2) = verts
    if (x1 - x0) * (y2 - y0) == (y1 - y0) * (x2 - x0):
        assert n_cov == 0, "a zero-area record covers a pixel"
