"""The fused route's vertex stage (kernel K8's plain version,
``vertex_transform.transform_vertices_T_plain``, reached through
``setup_kernel.transform_vertices_T`` on CPU tensors) against the JAX
package's ``setup_kernel.transform_vertices_T`` under ``jax.jit`` on the
CPU, bit for bit: one object and several (the ``vert_obj`` gather), NaN and
+-Inf positions, -0.0 and subnormal inputs, colour and uv bits with NaN
payloads.

The computed rows (clip, world normal, world position) are compared under
the subnormal rule of ``torch_parity``: XLA on the CPU flushes subnormal
results to zero, torch and the CUDA kernel keep them, so each subnormal is
mapped to the zero of its sign on both sides; every other bit pattern must
match.  The copied rows (colour, uv) must match bit for bit, payloads
included.  The kernel itself is held to the plain version on the card
(``chip_smoke.py`` phase 27)."""

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

from ash_renderer_tpu_torch.ops import setup_kernel, vertex_transform  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
COMPUTED_ROWS = (0, 1, 2, 3, 8, 9, 10, 13, 14, 15)  # clip, normal, world
COPIED_ROWS = (4, 5, 6, 7, 11, 12)  # colour, uv
# float32 bit patterns with NaN payloads: quiet, signalling, negative
NAN_PAYLOADS = np.array([0x7FC12345, 0x7F800001, 0xFFC0BEEF, 0x7FFFFFFF],
                        np.uint32).view(np.int32)
SUBNORMALS = np.array([1e-40, -1e-40, 1.4e-45, -2.5e-39], F32)


@functools.lru_cache(maxsize=None)
def _jax_transform():
    from ash_renderer_tpu.ops import setup_kernel as jsk

    return jax.jit(jsk.transform_vertices_T)


def make_inputs(seed: int, n_verts: int, n_obj: int, kind: str):
    """Seeded vertex arrays and (n_obj, 4, 4) model and MVP matrices.
    ``kind`` "nonfinite": NaN / +-Inf / -0.0 positions and normals, a -0.0
    matrix entry, colour and uv words carrying NaN payloads; "subnormal":
    subnormal and -0.0 positions and normals, subnormal matrix entries (the
    translation included) and subnormal colour and uv words; "finite":
    none of these.  XLA on the CPU also reads a subnormal input as zero,
    so the subnormal case keeps non-finite values out and its matrix
    entries positive, where that reading and the subnormal rule agree."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n_verts, 3)).astype(F32)
    nrm = rng.uniform(-1, 1, (n_verts, 3)).astype(F32)
    col = rng.uniform(0, 1, (n_verts, 4)).astype(F32)
    uv = rng.uniform(-3, 3, (n_verts, 2)).astype(F32)
    vobj = rng.integers(0, n_obj, n_verts).astype(np.int32)
    mm = rng.uniform(-2, 2, (n_obj, 4, 4)).astype(F32)
    mm[:, 3] = (0, 0, 0, 1)
    mvp = rng.uniform(-2, 2, (n_obj, 4, 4)).astype(F32)
    if kind == "finite":
        return pos, vobj, nrm, col, uv, mm, mvp
    idx = rng.choice(n_verts, 64, replace=False)
    if kind == "nonfinite":
        vals = np.array([np.nan, np.inf, -np.inf, -0.0], F32)
        mm[0, 1, 2] = -0.0
        words = NAN_PAYLOADS
    else:
        vals = np.array([-0.0, *SUBNORMALS], F32)
        mm[0, 0, 1] = abs(SUBNORMALS[0])
        mvp[0, 2, 3] = abs(SUBNORMALS[3])
        # world x of a -0.0 position is -0.0: ((+m * -0) + (+m * -0)) +
        # ((+m * -0) + -0)
        mm[0, 0, 0], mm[0, 0, 2], mm[0, 0, 3] = 1.5, 0.5, -0.0
        words = SUBNORMALS.view(np.int32)
    pos[idx[:32], rng.integers(0, 3, 32)] = rng.choice(vals, 32)
    nrm[idx[32:], rng.integers(0, 3, 32)] = rng.choice(vals, 32)
    pos[idx[:4]] = -0.0
    for a, w in ((col, 4), (uv, 2)):
        bits = a.view(np.int32)
        hit = rng.choice(n_verts, 40, replace=False)
        bits[hit, rng.integers(0, w, 40)] = rng.choice(words, 40)
    return pos, vobj, nrm, col, uv, mm, mvp


def check(seed: int, n_verts: int, n_obj: int, kind: str):
    args = make_inputs(seed, n_verts, n_obj, kind)
    want = np.asarray(_jax_transform()(*(jnp.asarray(a) for a in args)))
    got = setup_kernel.transform_vertices_T(*(tp.t(a) for a in args))
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, n_verts)
    got = got.numpy()
    np.testing.assert_array_equal(got[list(COPIED_ROWS)],
                                  want[list(COPIED_ROWS)])
    rows = list(COMPUTED_ROWS)
    np.testing.assert_array_equal(tp._flush(got[rows]), tp._flush(want[rows]))
    return got


@pytest.mark.parametrize("n_obj", [1, 3], ids=["one object", "three objects"])
@pytest.mark.parametrize("kind", ["finite", "nonfinite", "subnormal"])
def test_transform_matches_jax(n_obj, kind):
    got = check(20 + n_obj, 1000, n_obj, kind)
    f = got.view(np.float32)[list(COMPUTED_ROWS)]
    if kind == "nonfinite":
        assert np.isnan(f).any() and np.isinf(f).any()
    if kind == "subnormal":
        sub = (np.abs(f) < np.finfo(F32).tiny) & (f != 0)
        assert sub.any() and (np.signbit(f) & (f == 0)).any()


def test_transform_keeps_payloads_and_gathers_objects():
    """Colour and uv words keep their NaN payloads; with several objects
    each vertex takes its own object's matrices (the gather)."""
    pos, vobj, nrm, col, uv, mm, mvp = make_inputs(7, 300, 4, "nonfinite")
    got = setup_kernel.transform_vertices_T(
        *(tp.t(a) for a in (pos, vobj, nrm, col, uv, mm, mvp))).numpy()
    np.testing.assert_array_equal(got[4:8], col.view(np.int32).T)
    np.testing.assert_array_equal(got[11:13], uv.view(np.int32).T)
    assert np.isin(NAN_PAYLOADS, got[4:8]).sum() >= 3
    one = setup_kernel.transform_vertices_T(
        *(tp.t(a) for a in (pos, vobj, nrm, col, uv, mm[2:3], mvp[2:3])))
    on2 = vobj == 2
    assert 0 < on2.sum() < vobj.size
    np.testing.assert_array_equal(got[:, on2], one.numpy()[:, on2])
    assert not np.array_equal(got[:4, ~on2], one.numpy()[:4, ~on2])


def test_entry_point_is_the_wrapper():
    """The setup module's vertex stage is K8's wrapper."""
    assert setup_kernel.transform_vertices_T is \
        vertex_transform.transform_vertices_T
    assert setup_kernel.N_TBL_ROWS == vertex_transform.N_ROWS == 16


def test_transform_refuses_other_devices():
    """A tensor neither on the CPU nor on a card never reaches the plain
    version."""
    args = [torch.empty(s, dtype=d, device="meta") for s, d in (
        ((8, 3), torch.float32), ((8,), torch.int32), ((8, 3), torch.float32),
        ((8, 4), torch.float32), ((8, 2), torch.float32),
        ((1, 4, 4), torch.float32), ((1, 4, 4), torch.float32))]
    with pytest.raises(ValueError, match="unsupported device"):
        vertex_transform.transform_vertices_T(*args)
