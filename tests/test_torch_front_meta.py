"""The fused front's wide-pair expansion, range metadata and sorted-table
records (kernel K9's plain version, ``front_meta.front_meta_plain``,
reached through ``front_meta.front_meta`` on CPU tensors) against the JAX
package's ``binsort.expand_wide_pairs``, ``fused_kernel.build_range_meta``
and the two ``tritables.sorted_table_budgeted`` gathers of
``sort_expand_table`` under ``jax.jit`` on the CPU, bit for bit:
``pair_starts``, the counts, ``rmeta`` (the reference's without its last
word, the slab's first tile row), the first ``n_pairs`` pair rows entry
for entry, so each tile's rows in order, the live records (the
reference's rows ``[:live_end]`` and ``[:n_pairs]`` at
``tritables.REC_COLS``, then a zero word; tolerance 0) and the front's
four counters, 0-dim tensors equal to the reference's ``sstats``.

The inputs are made with numpy from a seed: snapped triangle corners
packed into comb columns 0-2, each row's index in its id column (the
records' id word is the row's index), streaming keys that put chosen rows in the
wide run (some of them dead in the window, as rows keyed from other data
can be), the stable order and its run bounds.  Cases: an empty wide run,
more wide rows than ``wide_rows``, pairs past ``wide_pairs`` (the
positional cut), a dead row inside the consumed prefix, a middle slab and
a padded last slab, and 4-row tiles.  Then ``pipeline.expand_table`` on
the CPU against the chain it ran before K9 (five host reads, whole rows
gathered), read at the records' columns.  The kernel
itself is held to the plain version on the card (``chip_smoke.py`` phase
28)."""

import dataclasses
import functools
import inspect
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import config as jconfig  # noqa: E402
from ash_renderer_tpu_torch import _build, config, pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import (binsort, clip_tail,  # noqa: E402
                                        front_meta, fused_kernel, tritables)

torch.set_num_threads(1)

WIDTH, HEIGHT = 300, 200  # 3 x 25 tiles of 8 rows, 3 x 50 of 4


@dataclasses.dataclass(frozen=True)
class FrontCase:
    name: str
    tile_h: int = 8
    window: tuple = (0, None)  # (tile_row0, tile_rows)
    n_wide: int = 40
    n_dead: int = 4  # wide-run rows dead in the window
    wide_rows: int = 64
    wide_pairs: int = 4096


CASES = [
    FrontCase("empty wide run", n_wide=0, n_dead=0),
    FrontCase("whole grid"),
    FrontCase("n_wide past wide_rows", wide_rows=16),
    FrontCase("pairs past wide_pairs", wide_pairs=60),
    FrontCase("middle slab", window=(8, 6)),
    FrontCase("padded last slab", window=(21, 7)),
    FrontCase("4-row tiles", tile_h=4),
    FrontCase("4-row tiles, slab, pairs cut", tile_h=4, window=(30, 12),
              wide_pairs=40),
]


def cfgs(tile_h: int):
    """(the port's, the JAX package's) RasterConfig of the test frame."""
    return (config.derive_raster_config(WIDTH, HEIGHT, tile_h=tile_h),
            jconfig.derive_raster_config(WIDTH, HEIGHT, tile_h=tile_h))


def make_front(case: FrontCase, seed: int = 0, n_rows: int = 500):
    """(comb, order, bounds, wide row ids, dead row ids) as numpy int32."""
    cfg = cfgs(case.tile_h)[0]
    rng = np.random.default_rng(seed)
    tile_rows, py_lo, py_hi = binsort.window_rows(cfg, *case.window)
    n_tiles = tile_rows * cfg.grid_w
    nk = n_tiles * binsort.KEYS_PER_TILE
    ss = cfg.subpixel_scale
    lo_c, hi_x, hi_y = cfg.min_coord, cfg.max_coord_x, cfg.max_coord_y
    # corners anywhere in the guard rect; wide rows spread over the window
    xs = rng.integers(lo_c, hi_x + 1, (n_rows, 3))
    ys = rng.integers(lo_c, hi_y + 1, (n_rows, 3))
    rows = rng.permutation(n_rows)
    wide = np.sort(rows[: case.n_wide])
    dead = wide[1::2][: case.n_dead]  # early in the wide run: consumed
    for r in wide:
        cx = rng.integers(0, WIDTH)
        cy = rng.integers(py_lo, max(py_lo, min(py_hi, HEIGHT - 1)) + 1)
        half = rng.integers(1, 200, 2)
        xs[r] = np.clip(rng.integers(cx - half[0], cx + half[0] + 1, 3) * ss,
                        lo_c, hi_x)
        ys[r] = np.clip(rng.integers(cy - half[1], cy + half[1] + 1, 3) * ss,
                        lo_c, hi_y)
    # dead in the window: left of the screen, or wholly above the window
    for k, r in enumerate(dead):
        if k % 2 or py_lo == 0:
            xs[r] = rng.integers(lo_c, -ss, 3)
        else:
            ys[r] = rng.integers(lo_c, py_lo * ss - ss, 3)
    off = -lo_c
    comb = rng.integers(-2**31, 2**31, (n_rows, tritables.TBL_COLS),
                        dtype=np.int64).astype(np.int32)
    comb[:, 0:3] = ((xs + off) | ((ys + off) << 16)).astype(np.int32)
    # each row's own index in its id column, as every comb table holds it
    comb[:, tritables.ID_COL] = np.arange(n_rows)
    keys = rng.integers(0, nk + 2, n_rows)
    keys[keys == nk] = nk + 1
    keys[wide] = nk
    order = np.argsort(keys, kind="stable").astype(np.int32)
    bounds = np.concatenate([
        np.searchsorted(keys[order], np.arange(nk + 2)), [n_rows]
    ]).astype(np.int32)
    return comb, order, bounds, wide, dead


def jax_front_meta(case: FrontCase, comb, order, bounds):
    """(pair_rows, pair_starts, new_ws, rmeta, tbl_sorted, tbl_ext, sstats)
    of the JAX package's expand_wide_pairs, build_range_meta and the two
    budgeted gathers of sort_expand_table under jax.jit."""
    from ash_renderer_tpu.ops import binsort as jbs
    from ash_renderer_tpu.ops import fused_kernel as jfk
    from ash_renderer_tpu.ops import tritables as jtt

    cfg = cfgs(case.tile_h)[1]
    row0, rows = case.window
    n_tiles = (cfg.grid_h if rows is None else rows) * cfg.grid_w
    nk = n_tiles * jbs.KEYS_PER_TILE

    @jax.jit
    def run(comb, order, bounds):
        pair_rows, pair_starts, new_ws = jbs.expand_wide_pairs(
            comb, order, bounds, cfg, case.wide_rows, case.wide_pairs, row0,
            rows)
        rmeta = jfk.build_range_meta(bounds, n_tiles, cfg.grid_w, row0,
                                     pair_starts=pair_starts, pair_base=0,
                                     wide_start=new_ws)
        live_end = bounds[nk + 1]
        n_pairs = pair_starts[-1]
        tbl_sorted = jtt.sorted_table_budgeted(comb, order, 256, live_end)
        tbl_ext = jtt.sorted_table_budgeted(comb, pair_rows, 256, n_pairs,
                                            fracs=(1 / 32, 1 / 4))
        sstats = {"n_wide": live_end - bounds[nk], "wide_pairs_n": n_pairs,
                  "wide_leftover": live_end - new_ws, "live_rows": live_end}
        return (pair_rows, pair_starts, new_ws, rmeta, tbl_sorted, tbl_ext,
                sstats)

    out = run(*(jnp.asarray(a) for a in (comb, order, bounds)))
    return [np.asarray(x) for x in out[:-1]] + [
        {k: int(v) for k, v in out[-1].items()}]


def port_front_meta(case: FrontCase, comb, order, bounds):
    return front_meta.front_meta(
        tp.t(comb), tp.t(order), tp.t(bounds), cfgs(case.tile_h)[0],
        case.wide_rows, case.wide_pairs, *case.window)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_front_meta_matches_jax(case):
    comb, order, bounds, wide, dead = make_front(case)
    (w_rows, w_starts, w_ws, w_meta, w_sorted, w_ext,
     w_stats) = jax_front_meta(case, comb, order, bounds)
    out = port_front_meta(case, comb, order, bounds)
    pair_rows, pair_starts, rmeta, counts, tbl_sorted, tbl_ext = (
        x.numpy() for x in out)
    cfg = cfgs(case.tile_h)[0]
    n_tiles = binsort.window_rows(cfg, *case.window)[0] * cfg.grid_w
    nk = n_tiles * binsort.KEYS_PER_TILE
    n_pairs = int(w_starts[-1])
    live_end = int(bounds[nk + 1])
    np.testing.assert_array_equal(pair_starts, w_starts)
    np.testing.assert_array_equal(
        counts, [bounds[nk], live_end, int(w_ws), n_pairs,
                 live_end - bounds[nk], live_end - int(w_ws)])
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(rmeta, w_meta[:-1])
    assert rmeta.shape == (n_tiles * fused_kernel.N_RANGES * 2,)
    # each tile's rows, in order: the consumed rows that cover it
    np.testing.assert_array_equal(pair_rows[:n_pairs], w_rows[:n_pairs])
    for a, b in zip(pair_starts[:-1], pair_starts[1:]):
        assert (np.diff(pair_rows[a:b]) > 0).all()
    # the live records, word for word
    assert tbl_sorted.shape == (live_end, tritables.REC_WORDS)
    assert tbl_ext.shape == (n_pairs, tritables.REC_WORDS)
    assert tbl_sorted.dtype == tbl_ext.dtype == np.int32
    np.testing.assert_array_equal(tbl_sorted, tp.records(w_sorted[:live_end]))
    np.testing.assert_array_equal(tbl_ext, tp.records(w_ext[:n_pairs]))
    # the front's counters: 0-dim tensors with the reference's values
    stats = front_meta.front_stats(out[3])
    assert set(stats) == set(w_stats)
    for k, v in stats.items():
        assert v.dim() == 0 and v.dtype == torch.int32, k
        assert int(v) == w_stats[k], k

    ws, we, new_ws = (int(v) for v in counts[:3])
    n_fit = new_ws - ws
    if case.n_wide == 0:
        assert ws == we and n_pairs == 0 and not pair_starts.any()
        return
    assert we - ws == case.n_wide and n_pairs > 0
    consumed = order[ws:new_ws]
    if case.wide_pairs < 100:
        assert n_fit < min(case.n_wide, case.wide_rows), "no pair cut"
    else:
        assert n_fit == min(case.n_wide, case.wide_rows)
    # a row dead in the window, consumed as a 0-pair row
    assert np.isin(dead, consumed).any()
    assert not np.isin(dead, pair_rows[:n_pairs]).any()


def expand_table_before_k9(statics, comb, order, bounds, tile_row0=0,
                           tile_rows=None):
    """``pipeline.expand_table`` as it was before kernel K9: the plain
    expansion and range meta, five host reads, whole rows gathered."""
    cfg = statics.cfg
    st = statics.settings
    n_tiles = binsort.window_rows(cfg, tile_row0, tile_rows)[0] * cfg.grid_w
    pair_rows, pair_starts, new_ws = binsort.expand_wide_pairs(
        comb, order, bounds, cfg, st.wide_rows, st.wide_pairs, tile_row0,
        tile_rows)
    rmeta = fused_kernel.build_range_meta(bounds, n_tiles, cfg.grid_w,
                                          pair_starts, new_ws)
    ws, live_end = bounds[n_tiles * binsort.KEYS_PER_TILE:][:2].tolist()
    n_pairs = int(pair_starts[-1])
    tbl_sorted = comb.index_select(0, order[:live_end])
    tbl_ext = comb.index_select(0, pair_rows[:n_pairs])
    sstats = {"n_wide": live_end - ws, "wide_pairs_n": n_pairs,
              "wide_leftover": live_end - new_ws, "live_rows": live_end}
    return rmeta, tbl_sorted, tbl_ext, sstats


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[5], CASES[7]],
                         ids=lambda c: c.name)
def test_expand_table_unchanged_on_cpu(case):
    """pipeline.expand_table on CPU tensors gives the rmeta it gave before
    K9, the rows it gathered then as records (their ``REC_COLS``, then a
    zero word), and the same counters, now 0-dim tensors."""
    comb, order, bounds, _, _ = make_front(case, seed=1)
    cfg = cfgs(case.tile_h)[0]
    statics = pipeline.FrameStatics(
        cfg=cfg, settings=config.RendererSettings(
            width=WIDTH, height=HEIGHT, wide_rows=case.wide_rows,
            wide_pairs=case.wide_pairs, fused_tile_h=case.tile_h),
        has_atlas=False, has_light=False)
    args = (statics, tp.t(comb), tp.t(order), tp.t(bounds), *case.window)
    got = pipeline.expand_table(*args)
    want = expand_table_before_k9(*args)
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), tp.records(w.numpy()))
    assert set(got[3]) == set(want[3])
    for k, v in got[3].items():
        assert v.dim() == 0 and int(v) == want[3][k], k


def test_front_meta_refuses_other_devices():
    """A tensor neither on the CPU nor on a card never reaches the plain
    version."""
    cfg = cfgs(8)[0]
    nk = cfg.n_tiles * binsort.KEYS_PER_TILE
    meta = functools.partial(torch.empty, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        front_meta.front_meta(meta((10, tritables.TBL_COLS)), meta(10),
                              meta(nk + 3), cfg, 64, 4096)


def test_a_cuda_front_reads_nothing_back():
    """What a CUDA front runs of ``pipeline.expand_table`` (the CUDA branch
    of ``front_meta.front_meta``, ``front_meta.front_stats``) reads nothing
    back to the host and gathers no table with a library call: the kernel
    writes the records, and the counters stay 0-dim device tensors."""
    fm = inspect.getsource(front_meta.front_meta)
    sources = [inspect.getsource(pipeline.expand_table),
               fm[fm.index('if dev.type != "cuda"'):],
               inspect.getsource(front_meta.front_stats)]
    for src in sources:
        for call in (".tolist(", ".item(", "index_select", ".cpu(",
                     ".numpy(", "int(counts", "int(meta"):
            assert call not in src, call


@pytest.mark.parametrize("source, wrapper", [("front_meta.cu", front_meta),
                                             ("clip_tail.cu", clip_tail)])
def test_the_kernel_is_one_cooperative_launch(source, wrapper):
    """K9 and K6 each launch one cooperative grid a call (no ``<<<``), whose
    passes two grid syncs split, and their wrappers count one launch."""
    with open(os.path.join(_build.CSRC, source)) as f:
        code = re.sub(r"//[^\n]*", "", f.read())
    assert "<<<" not in code
    assert code.count("cudaLaunchCooperativeKernel(") == 1
    assert code.count("grid.sync()") == 2
    assert wrapper.N_LAUNCHES == 1
