"""The windowed front of the port's row-slab rendering against the JAX
package, bit for bit, on the tile-row windows of slabs (a slab renders the
tile rows [tile_row0, tile_row0 + tile_rows)): the first and a middle
slab, a last slab that runs past the screen, one of a single tile row, and
one wholly past the screen.

* ``binsort.stream_keys`` / ``stream_keys_from_aabb`` (keys) and
  ``sort_and_bounds``' bounds, on every window;
* the slab front (``pipeline.render_front(tile_row0=, tile_rows=)``):
  clip-tail keys, wide-pair expansion, ``build_range_meta`` (against the
  reference's without its last word, which is the slab's first tile row)
  and the table gathers, compared as ``test_torch_binning.py`` compares
  the whole frame's;
* ``binsort.expand_wide_pairs`` on the reference's own sorted slab.

The classic pipeline's windowed modules: ``test_torch_sharding_classic.py``;
K3 / K3F at a slab origin: ``test_torch_sharding_raster.py``."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_binning import _range_rows  # noqa: E402
from test_torch_classic import _same  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import binsort, fused_kernel  # noqa: E402

torch.set_num_threads(1)

# (tile_row0, tile_rows) on the fused cases' 16 tile rows (192x128,
# 8-row tiles): first, middle, past the screen (rows 12-17), one row, and
# wholly past it
FUSED_WINDOWS = [(0, 6), (6, 6), (12, 6), (9, 1), (16, 2)]


def wid(w):
    return f"{w[0]}+{w[1]}"


@functools.lru_cache(maxsize=None)
def _setup():
    """The graze case (clip tail and wide pairs live) with budgets sized to
    it, and the reference's transform and K1 on it."""
    case = tp.case_from(tp.graze_scene(), RendererSettings(
        width=192, height=128, clip_budget=32, wide_rows=64,
        wide_pairs=1024))
    return case, tp.jax_front(case, setup_only=True)


@functools.lru_cache(maxsize=None)
def _jax_tail():
    """The reference's clip tail on the case (its ``_clip_tail_into`` up to
    the keys, which are the window's): comb with the tail rows written in,
    the tail's setup fields and the counters."""
    from ash_renderer_tpu.ops import geometry as jgeo
    from ash_renderer_tpu.ops import tritables as jtt

    case, ref = _setup()
    p = case.ref_packed
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    t = p.tri_v.shape[0]

    @jax.jit
    def tail(tblT, tri_v, tri_mat, flags, comb):
        tail_f, (a0, a1, a2), cstats = jgeo.clip_tail_fused(
            tblT, tri_v, tri_mat, ((flags >> 1) & 1).astype(bool),
            case.ref_cfg, case.ref_settings.clip_budget)
        rows = jtt.comb_rows(tail_f, a0, a1, a2, case.ref_cfg, id_base=t)
        return comb.at[t:].set(rows), tail_f, cstats

    comb, tail_f, cstats = tail(ref["tblT"], p.tri_v, tri_mat, ref["flags"],
                                ref["comb_main"])
    return comb, tail_f, {k: int(v) for k, v in cstats.items()}


@functools.lru_cache(maxsize=None)
def _jax_slab_front(tile_row0, tile_rows):
    """The reference's slab front (its ``_slab_pipeline_fused`` up to the
    raster): the clip tail's and K1's keys for the window (from K1's packed
    extents), the windowed sort, expansion and range meta.  numpy
    outputs."""
    from ash_renderer_tpu import pipeline as jpl
    from ash_renderer_tpu.ops import binsort as jbs

    case, ref = _setup()
    cfg = case.ref_cfg
    comb, tail_f, cstats = _jax_tail()
    keys_tail = jbs.stream_keys(
        tail_f["valid"], tail_f["x0"], tail_f["y0"], tail_f["x1"],
        tail_f["y1"], tail_f["x2"], tail_f["y2"], cfg, tile_row0, tile_rows)
    keys_main = jbs.stream_keys_from_aabb(
        jnp.asarray(ref["flags"] & 1).astype(bool), jnp.asarray(ref["extx"]),
        jnp.asarray(ref["exty"]), cfg, tile_row0, tile_rows)
    keys = jnp.concatenate([keys_main, keys_tail])
    rmeta, tbl_sorted, tbl_ext, sstats = jpl.sort_expand_table(
        tp.jax_statics(case), comb, keys, tile_row0, tile_rows)
    out = {k: np.asarray(v) for k, v in dict(
        comb=comb, keys=keys, rmeta=rmeta, tbl_sorted=tbl_sorted,
        tbl_ext=tbl_ext).items()}
    out["stats"] = {**cstats, **{k: int(v) for k, v in sstats.items()}}
    return out


def _port_slab_front(tile_row0, tile_rows):
    case, _ = _setup()
    return pipeline.render_front(
        tp.port_statics(case), tp.port_state(case), tp.t(case.mm),
        tp.t(case.mvp), tile_row0=tile_row0, tile_rows=tile_rows)


@pytest.mark.parametrize("window", FUSED_WINDOWS, ids=wid)
def test_stream_keys_window(window):
    """stream_keys on random snapped coordinates over the guard extent."""
    from ash_renderer_tpu.ops import binsort as jbs

    case, _ = _setup()
    cfg = case.cfg
    rng = np.random.default_rng(window[0] * 7 + window[1])
    n = 4000
    ss = cfg.subpixel_scale
    c = np.empty((6, n), np.int32)
    c[0::2] = rng.integers(-40 * ss, (cfg.width + 40) * ss, (3, n))
    c[1::2] = rng.integers(-40 * ss, (cfg.height + 40) * ss, (3, n))
    # small triangles too, for the fine keys
    c[:, ::2] = c[0:2, ::2].repeat(3, 0) + rng.integers(-60, 60, (6, n // 2))
    valid = rng.random(n) < 0.9
    want = np.asarray(jbs.stream_keys(jnp.asarray(valid), *map(jnp.asarray, c),
                                      case.ref_cfg, *window))
    got = binsort.stream_keys(tp.t(valid), *map(tp.t, c), cfg, *window)
    _same(got.numpy(), want)
    n_tiles = window[1] * cfg.grid_w
    dead = n_tiles * binsort.KEYS_PER_TILE + 1
    assert window[0] >= cfg.grid_h or (want < dead).sum() > 100
    assert window[0] < cfg.grid_h or (want == dead).all()


@pytest.mark.parametrize("window", FUSED_WINDOWS, ids=wid)
def test_stream_keys_from_aabb_and_bounds_window(window):
    """Keys from K1's packed pixel AABBs, and the run bounds of the slab's
    sorted keys (the reference's K2 in interpret mode)."""
    from ash_renderer_tpu.ops import binsort as jbs

    case, ref = _setup()
    valid = ref["flags"] & 1
    want = np.asarray(jbs.stream_keys_from_aabb(
        jnp.asarray(valid).astype(bool), jnp.asarray(ref["extx"]),
        jnp.asarray(ref["exty"]), case.ref_cfg, *window))
    got = binsort.stream_keys_from_aabb(tp.t(valid).bool(), tp.t(ref["extx"]),
                                        tp.t(ref["exty"]), case.cfg, *window)
    _same(got.numpy(), want)
    # the whole window's keys are K1's own
    full = binsort.stream_keys_from_aabb(tp.t(valid).bool(), tp.t(ref["extx"]),
                                         tp.t(ref["exty"]), case.cfg)
    _same(full.numpy(), ref["keys_main"])

    _, want_b = jbs.sort_and_bounds(jnp.asarray(want), case.ref_cfg, window[1],
                                    interpret=True)
    _, got_b = binsort.sort_and_bounds(got, case.cfg, window[1])
    _same(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("window", FUSED_WINDOWS, ids=wid)
def test_slab_front_matches_reference(window):
    """The slab front against the reference's: the clip tail's rows, the
    counters, rmeta (the reference's last word is the slab's first tile
    row) and each range's rows per tile."""
    tile_row0, tile_rows = window
    ref = _jax_slab_front(*window)
    rs = ref["stats"]
    rmeta, tbl_sorted, tbl_ext, comb, stats = _port_slab_front(*window)
    _same(comb.numpy(), ref["comb"])
    for k in ("clip_overflow", "n_clipped", "n_wide", "wide_pairs_n",
              "wide_leftover", "live_rows"):
        assert int(stats[k]) == rs[k], k
    assert rs["wide_leftover"] == 0
    if tile_rows > 1 and tile_row0 < 12:
        assert rs["n_clipped"] > 0 and rs["wide_pairs_n"] > 0
    n_tiles = tile_rows * 2
    assert int(ref["rmeta"][-1]) == tile_row0
    ref_meta = ref["rmeta"][:-1]
    _same(rmeta.numpy(), ref_meta)
    for r in range(fused_kernel.N_RANGES):
        got = _range_rows(rmeta.numpy(), tp.table_rows(tbl_sorted, comb),
                          tp.table_rows(tbl_ext, comb), n_tiles, r)
        want = _range_rows(ref_meta, ref["tbl_sorted"], ref["tbl_ext"],
                           n_tiles, r)
        for tile in range(n_tiles):
            _same(got[tile], want[tile])


@pytest.mark.parametrize("window", FUSED_WINDOWS[1:3], ids=wid)
def test_expand_wide_pairs_window(window):
    """expand_wide_pairs on the reference's own comb, order and bounds of
    the slab: pair run starts, the new wide start, and each tile's pair
    rows as a set."""
    from ash_renderer_tpu.ops import binsort as jbs

    case, _ = _setup()
    ref = _jax_slab_front(*window)
    st = case.settings
    order, bounds = jbs.sort_and_bounds(jnp.asarray(ref["keys"]), case.ref_cfg,
                                        window[1], interpret=True)
    want = jbs.expand_wide_pairs(jnp.asarray(ref["comb"]), order, bounds,
                                 case.ref_cfg, st.wide_rows, st.wide_pairs,
                                 *window)
    w_rows, w_starts, w_ws = (np.asarray(x) for x in want)
    g_rows, g_starts, g_ws = binsort.expand_wide_pairs(
        tp.t(ref["comb"]), tp.t(order), tp.t(bounds), case.cfg, st.wide_rows,
        st.wide_pairs, *window)
    _same(g_starts.numpy(), w_starts)
    assert g_ws == int(w_ws)
    n_pairs = int(w_starts[-1])
    assert n_pairs > 0
    for a, b in zip(w_starts[:-1], w_starts[1:]):
        _same(np.sort(g_rows.numpy()[a:b]), np.sort(w_rows[a:b]))


def test_window_defaults_are_the_whole_grid():
    """The default window leaves every full-frame result unchanged: the
    explicit whole-grid window gives the same keys, bounds and front."""
    case, ref = _setup()
    cfg = case.cfg
    args = (tp.t(ref["flags"] & 1).bool(), tp.t(ref["extx"]), tp.t(ref["exty"]),
            cfg)
    _same(binsort.stream_keys_from_aabb(*args, 0, cfg.grid_h).numpy(),
          binsort.stream_keys_from_aabb(*args).numpy())
    statics, st = tp.port_statics(case), tp.port_state(case)
    whole = pipeline.render_front(statics, st, tp.t(case.mm), tp.t(case.mvp))
    win = pipeline.render_front(statics, st, tp.t(case.mm), tp.t(case.mvp),
                                tile_row0=0, tile_rows=cfg.grid_h)
    for a, b in zip(whole[:4], win[:4]):
        _same(a.numpy(), b.numpy())
    assert cfg.grid_h == 16
