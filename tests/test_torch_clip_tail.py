"""The clip tail (``ops/clip_tail.clip_tail``: kernel K6 on a card, its
plain version on CPU tensors) against the JAX package's stage
(``ash_renderer_tpu/pipeline.py:_clip_tail_into``: ``clip_tail_fused``,
``comb_rows`` and ``stream_keys``) under ``jax.jit`` on the CPU, bit for
bit: the tail comb words, the tail keys and the counters.  Both take the
reference's vertex table, setup flags and main comb rows of the case.

Cases at 192x128: no clip candidate; candidates, among them a triangle
that crosses the near plane and one that crosses two guard planes; more
candidates than a small budget (overflow).  A slab's tile-row window,
4-row tiles and a budget of 17 (the one-launch kernel fans 16 budget
slots a block, so its last group is partial):
``test_torch_clip_tail_window.py`` (each JAX stage compiles
for ~10 s, so the cases are split over two files)."""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch.ops import (binsort, clip_tail, geometry,  # noqa: E402
                                        setup_kernel)

torch.set_num_threads(1)


def _near_plane_scene():
    """Random triangles spread +-8 about z = 2.5: many cross the near
    plane and the guard planes (``torch_parity.SCENES["near_plane"]``)."""
    return tp.rand_scene(2, 170, 300, 8.0, zoff=2.5)


def _settings(budget):
    return RendererSettings(width=192, height=128, clip_budget=budget)


# name -> (scene builder, settings, tile height, (tile_row0, tile_rows))
CASES = {
    "no_candidate": (tp.textured_scene, _settings(64), 8, (0, None)),
    "candidates": (_near_plane_scene, _settings(256), 8, (0, None)),
    "overflow": (_near_plane_scene, _settings(8), 8, (0, None)),
    "slab_window": (_near_plane_scene, _settings(256), 8, (6, 6)),
    "tile_h4": (_near_plane_scene, _settings(256), 4, (0, None)),
    # a budget that is no multiple of the kernel's 16 slots a block
    "budget_17": (_near_plane_scene, _settings(17), 8, (0, None)),
}
# the cases of this file; the others are test_torch_clip_tail_window.py's
WHOLE_GRID = ("no_candidate", "candidates", "overflow")


@functools.lru_cache(maxsize=None)
def _setup(name):
    build, settings, tile_h, _ = CASES[name]
    case = tp.case_from(build(), settings, tile_h=tile_h)
    return case, tp.jax_front(case, setup_only=True)


@functools.lru_cache(maxsize=None)
def _jax_tail(name):
    """The reference's stage on the case: (comb, tail keys, counters)."""
    from ash_renderer_tpu import pipeline as jpl

    case, ref = _setup(name)
    row0, rows = CASES[name][3]
    p = case.ref_packed
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    stage = jax.jit(functools.partial(jpl._clip_tail_into, tp.jax_statics(case),
                                      tile_row0=row0, tile_rows=rows))
    comb, keys, gstats = stage(ref["tblT"], p.tri_v, tri_mat, ref["flags"],
                               ref["comb_main"])
    return (np.asarray(comb), np.asarray(keys),
            {k: int(v) for k, v in gstats.items()})


def _port_tail(name):
    """The port's clip tail on the same inputs: (comb, keys, counters)."""
    case, ref = _setup(name)
    row0, rows = CASES[name][3]
    st = tp.port_state(case)
    comb = tp.t(ref["comb_main"])
    keys, counters = clip_tail.clip_tail(
        tp.t(ref["tblT"]), st.tri_v, st.tri_mat, tp.t(ref["flags"]), comb,
        case.cfg, case.settings.clip_budget, row0, rows)
    return comb, keys, counters


def check_against_the_reference(name):
    """The port's tail comb words, keys and counters equal the reference's
    on case ``name``, and the main rows stay as they were."""
    case, ref = _setup(name)
    comb, keys, counters = _port_tail(name)
    want_comb, want_keys, want_stats = _jax_tail(name)
    t = ref["flags"].shape[0]
    assert comb.shape[0] == t + case.settings.clip_budget * geometry.MAX_CLIP_TRIS
    np.testing.assert_array_equal(comb[:t].numpy(), ref["comb_main"][:t])
    np.testing.assert_array_equal(comb[t:].numpy(), want_comb[t:])
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    for k in clip_tail.COUNTERS:
        assert int(counters[k]) == want_stats[k], k


@pytest.mark.parametrize("name", WHOLE_GRID)
def test_clip_tail_matches_the_reference(name):
    check_against_the_reference(name)


def _crossings(name):
    """Per clip candidate (in triangle order): the guard planes (near, far,
    left, right, top, bottom) its corners lie on both sides of."""
    case, ref = _setup(name)
    gx, gy = setup_kernel.guard_factors(case.cfg)
    clip = ref["tblT"][:4].view(np.float32)
    tri_v = case.ref_packed.tri_v
    out = []
    for tri in np.flatnonzero((ref["flags"] >> 1) & 1):
        x, y, z, w = clip[:, tri_v[tri]]
        d = np.stack([z, w - z, gx * w + x, gx * w - x, gy * w + y,
                      gy * w - y])
        out.append({p for p in range(6)
                    if (d[p] < 0).any() and (d[p] >= 0).any()})
    return out


def has_live_fan_rows(name) -> bool:
    _, ref = _setup(name)
    return _jax_tail(name)[2]["n_valid"] > int((ref["flags"] & 1).sum())


def test_the_cases_hold_what_they_name():
    """No candidate in the first case; in the second, every candidate
    within the budget, one crossing the near plane, one crossing two guard
    planes, and live fan rows; the overflow case past its budget."""
    stats = {name: _jax_tail(name)[2] for name in WHOLE_GRID}
    assert stats["no_candidate"]["n_clipped"] == 0
    crossed = _crossings("candidates")
    assert 0 < len(crossed) <= CASES["candidates"][1].clip_budget
    assert any(0 in c for c in crossed)
    assert any(len(c - {0, 1}) >= 2 for c in crossed)
    assert has_live_fan_rows("candidates")
    assert stats["candidates"]["clip_overflow"] == 0
    assert stats["overflow"]["clip_overflow"] > 0
    assert stats["overflow"]["n_clipped"] == stats["candidates"]["n_clipped"]


def test_counters_are_0dim_int32_tensors_on_the_input_device():
    _, keys, counters = _port_tail("candidates")
    assert set(counters) == set(clip_tail.COUNTERS)
    for k, v in counters.items():
        assert isinstance(v, torch.Tensor) and v.dim() == 0, k
        assert v.dtype == torch.int32 and v.device == keys.device, k
    assert keys.dtype == torch.int32 and keys.device.type == "cpu"


def test_dead_tail_rows_of_a_frame_with_no_candidate():
    """With no candidate every tail row is dead: zeroed fields (packed
    coordinates 0 - min_coord), its own id, the dead key."""
    case, ref = _setup("no_candidate")
    comb, keys, counters = _port_tail("no_candidate")
    t = ref["flags"].shape[0]
    n = case.settings.clip_budget * geometry.MAX_CLIP_TRIS
    off = -case.cfg.min_coord
    want = np.zeros((n, comb.shape[1]), np.int32)
    want[:, 0:3] = off | (off << 16)
    want[:, 46] = t + np.arange(n)
    np.testing.assert_array_equal(comb[t:].numpy(), want)
    dead = case.cfg.n_tiles * binsort.KEYS_PER_TILE + 1
    assert (keys.numpy() == dead).all()
    assert int(counters["n_clipped"]) == int(counters["clip_overflow"]) == 0


def test_a_device_that_is_neither_cpu_nor_cuda_is_refused():
    case, ref = _setup("candidates")
    meta = torch.device("meta")
    st = tp.port_state(case)
    args = [tp.t(ref["tblT"]).to(meta), st.tri_v.to(meta),
            st.tri_mat.to(meta), tp.t(ref["flags"]).to(meta),
            tp.t(ref["comb_main"]).to(meta)]
    with pytest.raises(ValueError, match="unsupported device"):
        clip_tail.clip_tail(*args, case.cfg, case.settings.clip_budget)
