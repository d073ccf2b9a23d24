"""The port's front after setup -- clip tail, streaming keys, sort + run
bounds, wide-pair expansion, range metadata, table gathers -- against the
reference's stages on the same scenes.

The two sorts may order equal keys differently, so sorted positions are
never compared one by one: bounds always, rmeta where no wide budget
overflows (with an overflow, which wide rows get expanded depends on the
tie order), and table contents as per-range sets of rows."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import binsort, fused_kernel  # noqa: E402
from ash_renderer_tpu_torch.ops.tritables import ID_COL  # noqa: E402

torch.set_num_threads(1)


def _range_rows(rmeta, tbl_sorted, tbl_ext, n_tiles, r):
    """Per tile, the sorted list of rows (full 128-col rows) range r streams.
    rmeta: the port's layout (the reference's without its last word)."""
    m = rmeta.reshape(n_tiles, fused_kernel.N_RANGES, 2)
    src = tbl_ext if r == fused_kernel.EXT_RANGE else tbl_sorted
    out = []
    for tile in range(n_tiles):
        rs, re = m[tile, r]
        rows = src[rs:re]
        out.append(rows[np.argsort(rows[:, ID_COL], kind="stable")])
    return out


@pytest.mark.parametrize(
    "name", ["random", "graze", "overflow"]
)
def test_front_matches_reference(name):
    case = tp.make_case(name)
    ref = tp.jax_front(case)
    rs = ref["stats"]
    statics = tp.port_statics(case)
    st = tp.port_state(case)
    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        statics, st, tp.t(case.mm), tp.t(case.mvp)
    )
    t = st.ltT.shape[0] * 128
    # the clip tail's rows (ids T..) and every live main row
    np.testing.assert_array_equal(comb[t:].numpy(), ref["comb"][t:])
    np.testing.assert_array_equal(comb[:t].numpy(), ref["comb"][:t])

    keys = ref["keys"]
    order, bounds = binsort.sort_and_bounds(tp.t(keys), case.cfg)
    want = np.searchsorted(np.sort(keys), np.arange(bounds.shape[0] - 1))
    np.testing.assert_array_equal(bounds[:-1].numpy(), want)
    assert int(bounds[-1]) == keys.shape[0]
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(keys.shape[0]))

    for k in ("clip_overflow", "n_clipped", "n_valid", "n_fast", "n_setup",
              "n_wide", "live_rows"):
        assert int(stats[k]) == rs[k], k
    overflow = rs["wide_leftover"] > 0
    if name == "overflow":
        assert rs["clip_overflow"] > 0 and overflow
    if name == "graze":
        assert rs["n_clipped"] > 0 and rs["wide_pairs_n"] > 0 and not overflow

    n_tiles = case.cfg.n_tiles
    ranges = [0, 1, 2, 3, 6] if overflow else list(range(fused_kernel.N_RANGES))
    # the reference's last word is the first tile row of a mesh-sharded
    # slab: 0 for the whole frame, and left out of the port's layout
    assert int(ref["rmeta"][-1]) == 0
    ref_meta = ref["rmeta"][:-1]
    mp = rmeta.numpy().reshape(n_tiles, fused_kernel.N_RANGES, 2)
    mr = ref_meta.reshape(n_tiles, fused_kernel.N_RANGES, 2)
    np.testing.assert_array_equal(mp[:, ranges], mr[:, ranges])
    if not overflow:
        assert int(stats["wide_pairs_n"]) == rs["wide_pairs_n"]
    for r in ranges:
        got = _range_rows(rmeta.numpy(), tbl_sorted.numpy(), tbl_ext.numpy(),
                          n_tiles, r)
        want = _range_rows(ref_meta, ref["tbl_sorted"], ref["tbl_ext"],
                           n_tiles, r)
        for tile in range(n_tiles):
            np.testing.assert_array_equal(got[tile], want[tile])


def test_range_meta_matches_reference_builder():
    """build_range_meta on one bounds table with pair runs and a moved wide
    start, and on one with every pair run empty."""
    import jax.numpy as jnp

    from ash_renderer_tpu.ops import fused_kernel as jfk

    rng = np.random.default_rng(3)
    gw, gh = 5, 4
    n_tiles = gw * gh
    keys = np.sort(rng.integers(0, n_tiles * 12 + 2, 600).astype(np.int32))
    bounds = np.concatenate([
        np.searchsorted(keys, np.arange(n_tiles * 12 + 2)), [keys.shape[0]]
    ]).astype(np.int32)
    pair_starts = np.sort(rng.integers(0, 90, n_tiles + 1)).astype(np.int32)
    ws = int(bounds[n_tiles * 12]) + 3
    no_pairs = np.zeros(n_tiles + 1, np.int32)
    for ps, w in ((no_pairs, int(bounds[n_tiles * 12])), (pair_starts, ws)):
        got = fused_kernel.build_range_meta(
            torch.from_numpy(bounds), n_tiles, gw, torch.from_numpy(ps), w
        )
        want = np.asarray(jfk.build_range_meta(
            jnp.asarray(bounds), n_tiles, gw, pair_starts=jnp.asarray(ps),
            wide_start=jnp.asarray(w, jnp.int32),
        ))
        assert want[-1] == 0
        np.testing.assert_array_equal(got.numpy(), want[:-1])
