"""The classic route's binning (``ops/binning.py``) on the CPU, entry for
entry against a numpy statement of its order: the setup rows in order,
each triangle's tile rectangle row-major, the pair budget cut at
``max_pairs``, each tile's records in pair order (K12's order, and that of
``bin_triangles_plain``'s stable sort), every dead column zero.  Also the
rows-taking entry K12 launches on a card (``bin_rows``), the wrappers'
device policy and K12's entry in the build tables.

The setups are the port's plain ``geometry_device`` of
``test_torch_classic.py``'s scenes (that file holds them and
``bin_triangles`` to the JAX package)."""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_classic import CASES  # noqa: E402

from ash_renderer_tpu_torch import _build  # noqa: E402
from ash_renderer_tpu_torch.ops import binning, geometry  # noqa: E402
from ash_renderer_tpu_torch.rtypes import SETUP_COLS, TriangleSetup  # noqa: E402

torch.set_num_threads(1)

NAMES = sorted(CASES)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(the case's classic RasterConfig, its settings, the port's plain
    TriangleSetup of its frame)."""
    build, settings = CASES[name]
    case = tp.classic_case(build(), settings)
    st = tp.port_state(case)
    clip, attrs = geometry.transform_vertices(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    su, _, _ = geometry.geometry_device(clip, attrs, st.tri_v, st.tri_mat,
                                        case.cfg, case.settings.clip_budget)
    return case.cfg, case.settings, su


def _wrap(v):
    return (v + 2**31) % 2**32 - 2**31


def _edge(xa, ya, xb, yb):
    dx, dy = xb - xa, yb - ya
    return -dy, dx, int((dy == 0 and dx > 0) or dy < 0)


def numpy_bin(su, cfg, max_pairs, tile_row0=0, tile_rows=None):
    """The binning in plain Python on numpy values: (rec_i (14, P) int32,
    rec_f bits (1, P) int32, rec_box (1, P) int32, tile_start, tile_count,
    (pairs_total, pairs_overflow)), its records in pair-index order within
    each tile."""
    f = {k.name: getattr(su, k.name).numpy()
         for k in dataclasses.fields(TriangleSetup)}
    ss, half = cfg.subpixel_scale, cfg.subpixel_scale // 2
    tw, th, gw = cfg.tile_w, cfg.tile_h, cfg.grid_w
    if tile_rows is None:
        tile_rows = cfg.grid_h
    py_lo = tile_row0 * th
    py_hi = min((tile_row0 + tile_rows) * th, cfg.height) - 1
    n_tiles = tile_rows * gw
    pairs, total = [], 0  # the kept pairs in pair-index order
    for t in range(len(f["valid"])):
        if not f["valid"][t]:
            continue
        xs = [int(f[k][t]) for k in ("x0", "x1", "x2")]
        ys = [int(f[k][t]) for k in ("y0", "y1", "y2")]
        pxmin = max(0, (min(xs) - half + ss - 1) // ss)
        pxmax = min(cfg.width - 1, (max(xs) - half) // ss)
        pymin = max(py_lo, max(0, (min(ys) - half + ss - 1) // ss))
        pymax = min(py_hi, min(cfg.height - 1, (max(ys) - half) // ss))
        if pxmax < pxmin or pymax < pymin:
            continue
        for ty in range(pymin // th - tile_row0, pymax // th - tile_row0 + 1):
            for tx in range(pxmin // tw, pxmax // tw + 1):
                if total < max_pairs:
                    pairs.append((t, tx, ty, (pxmin, pxmax, pymin, pymax)))
                total += 1
    count = np.zeros(n_tiles, np.int32)
    for _, tx, ty, _ in pairs:
        count[ty * gw + tx] += 1
    start = (np.cumsum(count) - count).astype(np.int32)
    rec = np.zeros((16, max_pairs), np.int64)
    done = np.zeros(n_tiles, np.int64)
    for t, tx, ty, (pxmin, pxmax, pymin, pymax) in pairs:
        tile = ty * gw + tx
        slot = start[tile] + done[tile]
        done[tile] += 1
        x0, y0, x1, y1, x2, y2 = (int(f[k][t]) for k in
                                  ("x0", "y0", "x1", "y1", "x2", "y2"))
        a0, b0, tl0 = _edge(x1, y1, x2, y2)
        a1, b1, tl1 = _edge(x2, y2, x0, y0)
        a2, b2, tl2 = _edge(x0, y0, x1, y1)
        px0, py0 = tx * tw, (ty + tile_row0) * th
        sx, sy = px0 * ss + half, py0 * ss + half
        e0c = _wrap(a0 * (sx - x1) + b0 * (sy - y1))
        e1c = _wrap(a1 * (sx - x2) + b1 * (sy - y2))
        e2c = _wrap(int(f["area2"][t]) - e0c - e1c)
        box = (max(pxmin - px0, 0) | min(pxmax - px0, tw - 1) << 7
               | max(pymin - py0, 0) << 14 | min(pymax - py0, th - 1) << 18)
        rec[:, slot] = [a0, b0, a1, b1, a2, b2, e0c, e1c, e2c,
                        f["zq0"][t], f["zq1"][t], f["zq2"][t], t,
                        tl0 | tl1 << 1 | tl2 << 2,
                        f["inv_area2"][t:t + 1].view(np.int32)[0], box]
    rec = rec.astype(np.int32)
    return (rec[:14], rec[14:15], rec[15:], start, count,
            (total, max(total - max_pairs, 0)))


def _check(got, want):
    """``bin_triangles``' outputs against ``numpy_bin``'s, entry for entry."""
    rec_i, rec_f, rec_box, start, count, stats = got
    w_i, w_f, w_box, w_start, w_count, w_stats = want
    assert rec_i.dtype == torch.int32 and rec_f.dtype == torch.float32
    assert rec_box.dtype == start.dtype == count.dtype == torch.int32
    np.testing.assert_array_equal(start.numpy(), w_start)
    np.testing.assert_array_equal(count.numpy(), w_count)
    np.testing.assert_array_equal(rec_i.numpy(), w_i)
    np.testing.assert_array_equal(rec_f.numpy().view(np.int32), w_f)
    np.testing.assert_array_equal(rec_box.numpy(), w_box)
    assert (int(stats["pairs_total"]), int(stats["pairs_overflow"])) == w_stats
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in stats.values())


def _same_outputs(got, want):
    *arrs, stats = got
    *w_arrs, w_stats = want
    for a, b in zip(arrs, w_arrs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32))
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in w_stats.items()}


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_numpy_order(name):
    """The three scenes of ``test_torch_classic.py`` at their budgets (the
    last overflows its 96 pairs)."""
    cfg, st, su = _setup(name)
    want = numpy_bin(su, cfg, st.max_pairs)
    _check(binning.bin_triangles_plain(su, cfg, st.max_pairs), want)
    assert int(want[4].sum()) > 50
    assert (want[5][1] > 0) == (name == "pairs_overflow")


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_numpy_order_in_a_slab(name):
    """The tile-row window of rows 1 and 2: rows clamped to it, tiles
    counted from its first row, edge values at the screen's samples."""
    cfg, st, su = _setup(name)
    want = numpy_bin(su, cfg, st.max_pairs, 1, 2)
    assert want[3].shape == (2 * cfg.grid_w,) and int(want[4].sum()) > 10
    _check(binning.bin_triangles_plain(su, cfg, st.max_pairs, 1, 2), want)


def test_window_past_the_frame_bins_nothing():
    """A window wholly below the frame's last row (a padded slab's) has
    py_lo > py_hi: no pair, zero counts, every column zero."""
    cfg, st, su = _setup("clip_heavy")
    got = binning.bin_triangles_plain(su, cfg, st.max_pairs, cfg.grid_h, 2)
    want = numpy_bin(su, cfg, st.max_pairs, cfg.grid_h, 2)
    assert want[5] == (0, 0)
    _check(got, want)
    assert not got[0].any() and not got[2].any() and not got[4].any()


def test_no_valid_row_bins_nothing():
    cfg, st, su = _setup("clip_overflow")
    dead = dataclasses.replace(su, valid=torch.zeros_like(su.valid))
    got = binning.bin_triangles_plain(dead, cfg, st.max_pairs)
    _check(got, numpy_bin(dead, cfg, st.max_pairs))
    assert int(got[5]["pairs_total"]) == 0 and not got[0].any()


@pytest.mark.parametrize("max_pairs", [0, 32])
def test_empty_setup_bins_nothing(max_pairs):
    """S = 0 rows: zero pairs, zero counts, zeroed (14, P), (1, P), (1, P)
    arrays."""
    cfg, _, _ = _setup("clip_heavy")
    rows = torch.zeros((0, SETUP_COLS), dtype=torch.int32)
    valid = torch.zeros(0, dtype=torch.bool)
    su = geometry.setup_from_rows(rows, valid)
    got = binning.bin_rows(rows, valid, cfg, max_pairs)
    _check(got, numpy_bin(su, cfg, max_pairs))
    assert got[0].shape == (binning.RECORD_ROWS, max_pairs)
    assert got[3].shape == (cfg.grid_h * cfg.grid_w,)
    _same_outputs(binning.bin_triangles(su, cfg, max_pairs), got)


@pytest.mark.parametrize("keep", [1, 2])
def test_budget_cuts_a_rectangle_in_the_middle(keep):
    """A ``max_pairs`` that ends ``keep`` pairs into the first triangle
    covering three tiles or more: it keeps its first pairs in row-major
    order, and the rest and every later triangle are cut."""
    cfg, _, su = _setup("clip_heavy")
    full = numpy_bin(su, cfg, 1 << 20)
    ids = full[0][12, : int(full[4].sum())]
    rows, n = np.unique(ids, return_counts=True)
    big = rows[n >= 3]
    assert big.size, "no triangle covers three tiles"
    first = int(big[0])
    budget = int((ids < first).sum()) + keep
    want = numpy_bin(su, cfg, budget)
    assert int((want[0][12, :budget] == first).sum()) == keep
    assert want[5][1] > 0
    _check(binning.bin_triangles_plain(su, cfg, budget), want)


@pytest.mark.parametrize("window", [(0, None), (1, 2)], ids=["whole", "slab"])
@pytest.mark.parametrize("name", NAMES)
def test_rows_entry_equals_bin_triangles(name, window):
    """``bin_rows`` on the setup as one table (``geometry.setup_table``, as
    K10 writes it) equals ``bin_triangles`` on its fields."""
    cfg, st, su = _setup(name)
    got = binning.bin_rows(geometry.setup_table(su), su.valid, cfg,
                           st.max_pairs, *window)
    _same_outputs(got, binning.bin_triangles(su, cfg, st.max_pairs, *window))


def test_device_policy():
    """A device that is neither the CPU nor CUDA raises; so do arguments
    the kernel does not take, on every device."""
    cfg, st, su = _setup("clip_heavy")
    rows, valid = geometry.setup_table(su), su.valid
    with pytest.raises(ValueError, match="unsupported device"):
        binning.bin_rows(rows.to("meta"), valid.to("meta"), cfg, 32)
    meta_su = TriangleSetup(**{f.name: getattr(su, f.name).to("meta")
                               for f in dataclasses.fields(TriangleSetup)})
    with pytest.raises(ValueError, match="unsupported device"):
        binning.bin_triangles(meta_su, cfg, 32)
    for bad in (rows[:, :18].contiguous(), rows.to(torch.int64),
                rows.t().contiguous().t()):
        with pytest.raises(ValueError, match="bad rows"):
            binning.bin_rows(bad, valid, cfg, 32)
    with pytest.raises(ValueError, match="bad valid"):
        binning.bin_rows(rows, valid[1:], cfg, 32)
    with pytest.raises(ValueError, match="bad valid"):
        binning.bin_rows(rows, valid.to(torch.int32), cfg, 32)


def test_build_tables_hold_k12():
    """K12's C entry point and argument list, and the classic route's
    sources (``Renderer.warmup`` builds them)."""
    P, I = _build.ctypes.c_void_p, _build.ctypes.c_int
    assert _build.KERNELS["binning.cu"] == {
        "ash_bin_triangles": [P] * 9 + [I] * 12 + [P]}
    assert _build._ENTRY_SOURCE["ash_bin_triangles"] == "binning.cu"
    assert "binning.cu" in _build.ROUTE_SOURCES["classic"]
    assert "binning.cu" not in _build.ROUTE_SOURCES["fused"]
    assert binning.KERNEL == "K12_binning"
