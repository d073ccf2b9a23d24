"""``tritables.build_comb_table`` against the JAX package's, bit for bit,
in both corner branches: row gathers by vertex id, and kernel K5 at F = 12
by meshlet-local id (its plain version here; the Pallas kernel in
interpret mode on the JAX side), on the three scenes of
tests/test_setup_kernel.py (the wide one clips).  The two branches agree
wherever the table is read, and the K5 branch equals K1's comb rows on the
real rows of alive meshlets.  A comb with K5's corners 1 and 2 in their
unrewound order must fail the comparison."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import Mesh, RendererSettings, Scene, SceneObject  # noqa: E402
from ash_renderer_tpu_torch import specmath as sm  # noqa: E402
from ash_renderer_tpu_torch.ops import (geometry, meshlet_gather,  # noqa: E402
                                        setup_kernel, tritables)

torch.set_num_threads(1)

CLIP_BUDGET = 64
SCENES = [(1, 2.0), (2, 8.0), (4, 0.3)]


def _case(seed, spread):
    """tests/test_setup_kernel.py's scene at 512x256, meshlet-packed."""
    rng = np.random.default_rng(seed)
    nv, nt = 170, 300
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(np.float32)
    pos[:, 2] += 2.5
    mesh = Mesh(positions=pos,
                indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
                colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32))
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    return tp.case_from(sc, RendererSettings(width=512, height=256))


def _jax_combs(case):
    """The JAX package's (plain-branch comb, local_tri-branch comb)."""
    from ash_renderer_tpu.ops import geometry as rgeo
    from ash_renderer_tpu.ops import tritables as rtt

    p = case.ref_packed
    clip, attrs = rgeo.transform_vertices(
        jnp.asarray(p.positions), jnp.asarray(p.vert_obj),
        jnp.asarray(p.normals), jnp.asarray(p.colors), jnp.asarray(p.uvs),
        jnp.asarray(case.mm), jnp.asarray(case.mvp))
    lt = jnp.asarray(p.local_tri)
    su, attrs_full, _ = rgeo.geometry_device(
        clip, attrs, jnp.asarray(p.tri_v), jnp.asarray(p.tri_obj),
        jnp.asarray(p.obj_material), case.ref_cfg, CLIP_BUDGET,
        local_tri=lt, interpret=True)
    return tuple(np.asarray(rtt.build_comb_table(
        su, attrs_full, case.ref_cfg, local_tri=x, interpret=True))
        for x in (None, lt))


def _port_setup(case):
    """(state, TriangleSetup, combined attributes, local_tri) of the port."""
    st = tp.port_state(case)
    clip, attrs = geometry.transform_vertices(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    lt = tp.t(case.packed.local_tri)
    su, attrs_full, _ = geometry.geometry_device(
        clip, attrs, st.tri_v, st.tri_mat, case.cfg, CLIP_BUDGET, local_tri=lt)
    return st, su, attrs_full, lt


_COMBS = {}


def _combs(seed, spread):
    """(port plain, port local_tri, JAX plain, JAX local_tri, case), built
    once per scene."""
    if (seed, spread) not in _COMBS:
        case = _case(seed, spread)
        _, su, attrs_full, lt = _port_setup(case)
        plain = tritables.build_comb_table(su, attrs_full, case.cfg).numpy()
        local = tritables.build_comb_table(su, attrs_full, case.cfg,
                                           local_tri=lt).numpy()
        _COMBS[seed, spread] = (plain, local, *_jax_combs(case), case)
    return _COMBS[seed, spread]


@pytest.mark.parametrize("seed,spread", SCENES)
def test_comb_table_matches_jax(seed, spread):
    plain, local, want_plain, want_local, case = _combs(seed, spread)
    t = case.packed.tri_v.shape[0]
    assert plain.shape == (t + 7 * CLIP_BUDGET, 128)
    np.testing.assert_array_equal(plain, want_plain)
    np.testing.assert_array_equal(local, want_local)
    if spread > 4:  # the wide scene must exercise the clip tail
        assert _valid(plain)[t:].sum() > 0


def _valid(comb):
    """Valid rows: inv_area2 (col 5) is zeroed on dead rows only."""
    return comb[:, 5] != 0


def _check_branches_agree(local, plain, valid):
    """The K5 branch equals the row-gather branch on every valid row, and on
    every row in the setup and id columns; dead rows differ only in the
    attribute columns (zeroed vertex ids gather vertex 0's row there)."""
    np.testing.assert_array_equal(local[valid], plain[valid])
    np.testing.assert_array_equal(local[:, :10], plain[:, :10])
    np.testing.assert_array_equal(local[:, 46:], plain[:, 46:])


@pytest.mark.parametrize("seed,spread", SCENES)
def test_comb_branches_agree(seed, spread):
    plain, local, _, _, case = _combs(seed, spread)
    valid = _valid(plain)
    assert 3 < valid.sum() < valid.size
    _check_branches_agree(local, plain, valid)


@pytest.mark.parametrize("seed,spread", SCENES)
def test_comb_equals_k1_on_alive_meshlets(seed, spread):
    """tests/test_setup_kernel.py's rule: K1's rows equal the K5 branch's
    on the real rows of alive meshlets; dead meshlets are zero-filled."""
    _, local, _, _, case = _combs(seed, spread)
    st = tp.port_state(case)
    tblT = setup_kernel.transform_vertices_T(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    comb_k, _, flags, _, _ = setup_kernel.triangle_setup(
        tblT, st.ltT, st.matT, case.cfg)
    comb_k, flags = comb_k.numpy(), flags.numpy()
    t = comb_k.shape[0]
    alive = np.repeat((flags.reshape(-1, 128) & 3).any(1), 128)
    real = (case.packed.tri_v[:, 0] >= 0) & alive
    assert real.sum() > 3
    np.testing.assert_array_equal(comb_k[real], local[:t][real])
    assert not comb_k[~alive].any()


def test_swapped_corner_order_fails():
    """K5's corners in their unrewound order (setup corner 1 from K5's
    corner 1) give a comb that the comparison above rejects."""
    plain, local, want_plain, want_local, case = _combs(1, 2.0)
    _, su, attrs_full, lt = _port_setup(case)
    t = lt.shape[0]
    a3 = sm.bitcast_f32(meshlet_gather.gather_tri_rows(
        sm.bitcast_i32(attrs_full[:t]), lt))
    tail = [attrs_full[v[t:].long()] for v in (su.v0, su.v1, su.v2)]
    swapped = tritables.comb_rows(
        {k: getattr(su, k) for k in tritables._COMB_SETUP_FIELDS},
        torch.cat([a3[:, 0:12], tail[0]]), torch.cat([a3[:, 12:24], tail[1]]),
        torch.cat([a3[:, 24:36], tail[2]]), case.cfg).numpy()
    valid = _valid(plain)
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(swapped, want_local)
    with pytest.raises(AssertionError):
        _check_branches_agree(swapped, plain, valid)
