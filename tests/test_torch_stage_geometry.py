"""``geometry.stage_geometry_rows``, the classic frame's geometry stage
(kernel K10 with the vertex transform folded into its launch, on a card),
on the CPU: bit for bit against the JAX package's ``pipeline._stage_geometry``
(its transform and ``geometry_device`` under one jit, the Pallas corner
gather in interpret mode) on bench.py's gate scene, a clipping scene
within its clip budget, one over it, a scene of several objects and a
meshlet-packed scene; against the port's own ``transform_vertices`` +
``geometry_rows`` in each slab of a two-slab classic frame; and its
argument checks.  On CPU tensors the entry runs its plain version
(``transform_vertices_plain``, then ``geometry_device_plain``); the kernel
is held to that on the card by ``chip_smoke.py`` phase 29."""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import geometry  # noqa: E402
from ash_renderer_tpu_torch.rtypes import TriangleSetup  # noqa: E402

torch.set_num_threads(1)

# name -> (JAX-package scene builder, settings, meshlet packing)
CASES = {
    # bench.py's parity-gate scene (160 triangles over 200 vertices)
    "gate": (tp.gate_scene, RendererSettings(width=256, height=192,
                                             clip_budget=64), False),
    "clip_within_budget": (lambda: tp.rand_scene(6, 60, 50, 4.0, zoff=0.8),
                           RendererSettings(width=128, height=64,
                                            clip_budget=64), False),
    "clip_over_budget": (lambda: tp.rand_scene(2, 170, 300, 8.0, zoff=2.5),
                         RendererSettings(width=192, height=128,
                                          clip_budget=8), False),
    # five objects of one mesh: vert_obj takes five model / MVP matrices
    "several_objects": (tp._parity_multi_object,
                        RendererSettings(width=144, height=112,
                                         clip_budget=16), False),
    "meshlets": (lambda: tp.rand_scene(6, 60, 50, 4.0, zoff=0.8),
                 RendererSettings(width=128, height=64, clip_budget=64),
                 True),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    build, settings, meshlets = CASES[name]
    return tp.classic_case(build(), settings, meshlets=meshlets)


def _jax_stage(case):
    """The reference's ``_stage_geometry`` on the case: (TriangleSetup,
    attrs_full, stats)."""
    from ash_renderer_tpu import pipeline as jpipe

    p = case.ref_packed
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    return jpipe._stage_geometry(
        case.ref_cfg, case.ref_settings.clip_budget, p.positions, p.vert_obj,
        p.normals, p.colors, p.uvs, p.tri_v, p.tri_obj, p.obj_material,
        case.mm, case.mvp, local_tri=p.local_tri, interpret=True,
        tri_mat=tri_mat)


def _stage_args(case):
    st = tp.port_state(case)
    return (st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
            tp.t(case.mm), tp.t(case.mvp), st.tri_v, st.tri_mat, case.cfg,
            case.settings.clip_budget)


def _same(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("name", list(CASES))
def test_stage_geometry_rows_matches_the_reference_stage(name):
    """The setup table (against ``setup_table`` of the reference's fields),
    the valid flags, the combined attributes and the counters equal
    ``_stage_geometry``'s, bit for bit."""
    case = _case(name)
    jsu, jattrs_full, jstats = _jax_stage(case)
    lt = None if case.packed.local_tri is None else tp.t(case.packed.local_tri)
    rows, valid, attrs_full, stats = geometry.stage_geometry_rows(
        *_stage_args(case), local_tri=lt)
    want_su = TriangleSetup(**{
        f.name: tp.t(np.asarray(getattr(jsu, f.name)))
        for f in dataclasses.fields(TriangleSetup)})
    _same(rows.numpy(), geometry.setup_table(want_su).numpy())
    _same(valid.numpy(), np.asarray(jsu.valid))
    _same(attrs_full.numpy(), np.asarray(jattrs_full))
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in jstats.items()}
    assert int(valid.sum()) > 0
    if name.startswith("clip"):
        assert stats["n_clipped"] > 0
        assert (stats["clip_overflow"] > 0) == (name == "clip_over_budget")
    if name == "several_objects":
        assert case.mm.shape[0] >= 2
        assert len(np.unique(case.packed.vert_obj)) >= 2


def test_stage_geometry_rows_in_each_slab():
    """A classic frame in two row slabs calls the stage entry once a slab,
    each call equal to ``transform_vertices`` + ``geometry_rows`` on the
    same inputs, and the slabs join into the single frame."""
    from ash_renderer_tpu_torch.parallel import (make_render_mesh,
                                                 render_frame_sharded)

    case = _case("clip_within_budget")
    statics = tp.port_statics(case)
    st = tp.port_state(case)
    mm, mvp = tp.t(case.mm), tp.t(case.mvp)
    cam = tp.t(case.cam.position.astype(np.float32))
    calls, real = [], geometry.stage_geometry_rows

    def stage(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    geometry.stage_geometry_rows = stage
    try:
        mesh = make_render_mesh([torch.device("cpu")] * 2)
        frame, _ = render_frame_sharded(statics, mesh,
                                        {torch.device("cpu"): st}, mm, mvp,
                                        cam)
    finally:
        geometry.stage_geometry_rows = real
    assert len(calls) == 2
    for args, kw, (rows, valid, attrs_full, stats) in calls:
        clip, attrs = geometry.transform_vertices(*args[:7])
        w_rows, w_valid, w_attrs_full, w_stats = geometry.geometry_rows(
            clip, attrs, *args[7:], **kw)
        _same(rows.numpy(), w_rows.numpy())
        _same(valid.numpy(), w_valid.numpy())
        _same(attrs_full.numpy(), w_attrs_full.numpy())
        assert {k: int(v) for k, v in stats.items()} == {
            k: int(v) for k, v in w_stats.items()}
    whole, _ = pipeline.render_frame(statics, st, mm, mvp, cam)
    _same(frame.numpy(), whole.numpy())


def _args():
    v = 4
    return [torch.zeros((v, 3)), torch.zeros(v, dtype=torch.int32),
            torch.zeros((v, 3)), torch.zeros((v, 4)), torch.zeros((v, 2)),
            torch.eye(4)[None].contiguous(), torch.eye(4)[None].contiguous(),
            torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32)]


@pytest.mark.parametrize("bad", [
    "meta", "positions_f64", "vert_obj_i64", "mats_none", "tri_v_i64",
    "tri_mat_2d", "local_tri", "no_vertices"])
def test_stage_geometry_rows_checks(bad):
    """``stage_geometry_rows`` raises on a device that is neither the CPU
    nor CUDA, on a bad dtype or shape of any of its tensors and on a scene
    without vertices."""
    from ash_renderer_tpu_torch.config import derive_raster_config

    cfg = derive_raster_config(64, 32, tile_h=16)
    args, lt, match = _args(), None, "stage_geometry_rows"
    if bad == "meta":
        args, match = [a.to("meta") for a in args], "unsupported device"
    elif bad == "local_tri":
        lt = torch.zeros((3, 3), dtype=torch.int32)
    elif bad == "no_vertices":
        args = [a[:0] for a in args[:5]] + args[5:]
        match = "no vertices"
    else:
        i, x = {"positions_f64": (0, args[0].double()),
                "vert_obj_i64": (1, args[1].long()),
                "mats_none": (5, torch.zeros((0, 4, 4))),
                "tri_v_i64": (7, args[7].long()),
                "tri_mat_2d": (8, torch.zeros((2, 1), dtype=torch.int32))
                }[bad]
        args[i] = x
    with pytest.raises(ValueError, match=match):
        geometry.stage_geometry_rows(*args, cfg, 4, local_tri=lt)
