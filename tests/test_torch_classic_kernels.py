"""The classic route's glue wrappers on the CPU, bit for bit against the JAX
package: ``geometry.transform_vertices`` (kernel K8C on a card) and
``geometry.geometry_device`` (kernel K10: every TriangleSetup field, the
combined attributes and the counters, which are 0-dim int32 tensors on the
frame's device) on a scene with nothing clipped, a clipping scene whose
candidates overflow the budget, a textured, lit scene with three
materials, a 2x SSAA scene and the meshlet-packed ``local_tri`` path; and
the wrappers' argument checks.  ``shade.shade_pack_classic`` (kernel K11)
is ``test_torch_classic_kernels_shade.py``'s.  On CPU tensors each wrapper
runs its plain version; the kernels are held to those on the card by
``chip_smoke.py`` phase 29."""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from golden_scenes import multi_material, ssaa_srgb  # noqa: E402
from test_torch_classic import _jax_geometry, _same  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch.ops import geometry, shade  # noqa: E402
from ash_renderer_tpu_torch.rtypes import (  # noqa: E402
    SETUP_COLS, SETUP_F32_FIELDS, SETUP_ROW_FIELDS)

torch.set_num_threads(1)


def _with_budget(build, budget):
    def make():
        scene, settings = build()
        return scene, dataclasses.replace(settings, clip_budget=budget)
    return make


# name -> (JAX-package scene and settings, meshlet packing)
CASES = {
    # a cloud like bench.py's parity-gate scene, further away: nothing clips
    "no_clip": (lambda: (tp.rand_scene(5, 200, 160, 2.0, zoff=8.0),
                         RendererSettings(width=256, height=192,
                                          clip_budget=16)), False),
    "clip_overflow": (lambda: (tp.rand_scene(2, 170, 300, 8.0, zoff=2.5),
                               RendererSettings(width=192, height=128,
                                                clip_budget=8)), False),
    "textured_lit": (_with_budget(multi_material, 16), False),
    "ssaa2": (_with_budget(ssaa_srgb, 16), False),
    "local_tri": (lambda: (tp.rand_scene(6, 60, 50, 4.0, zoff=0.8),
                           RendererSettings(width=128, height=64,
                                            clip_budget=64)), True),
}


@functools.lru_cache(maxsize=None)
def classic_kernel_case(name):
    """(case, the JAX package's ((clip, attrs), su, attrs_full, stats),
    the port's (clip, attrs), su, attrs_full, stats)."""
    build, meshlets = CASES[name]
    case = tp.classic_case(*build(), meshlets=meshlets)
    st = tp.port_state(case)
    lt = None if case.packed.local_tri is None else tp.t(case.packed.local_tri)
    clip, attrs = geometry.transform_vertices(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    su, attrs_full, stats = geometry.geometry_device(
        clip, attrs, st.tri_v, st.tri_mat, case.cfg,
        case.settings.clip_budget, local_tri=lt)
    return case, _jax_geometry(case), ((clip, attrs), su, attrs_full, stats)


@pytest.mark.parametrize("name", list(CASES))
def test_transform_vertices_matches(name):
    """The transform's clip (V, 4) and attribute (V, 12) rows equal the
    reference's bit for bit."""
    _, ((jclip, jattrs), _, _, _), ((clip, attrs), _, _, _) = (
        classic_kernel_case(name))
    _same(clip.numpy(), np.asarray(jclip))
    _same(attrs.numpy(), np.asarray(jattrs))


@pytest.mark.parametrize("name", list(CASES))
def test_geometry_device_fields_and_counters(name):
    """Every TriangleSetup field, the combined attributes (V + 9 *
    clip_budget rows) and the counters equal the reference's; each case
    exercises what its name says."""
    case, (_, jsu, jattrs_full, jstats), (_, su, attrs_full, stats) = (
        classic_kernel_case(name))
    for f in dataclasses.fields(su):
        _same(getattr(su, f.name).numpy(), np.asarray(getattr(jsu, f.name)))
    _same(attrs_full.numpy(), np.asarray(jattrs_full))
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in jstats.items()}
    b = case.settings.clip_budget
    assert stats["n_setup"] == case.packed.tri_v.shape[0] + 7 * b
    assert int(stats["n_valid"]) > 10
    clipped, over = int(stats["n_clipped"]), int(stats["clip_overflow"])
    if name == "no_clip":
        assert clipped == 0 and int(stats["n_fast"]) > 100
    elif name == "clip_overflow":
        assert clipped > b and over == clipped - b
    elif name == "local_tri":
        assert case.packed.local_tri is not None and 0 < clipped <= b
    else:
        assert over == 0


@pytest.mark.parametrize("name", ["no_clip", "clip_overflow"])
def test_geometry_device_counters_are_device_scalars(name):
    """The counters are 0-dim int32 tensors on the frame's device (a card
    reads them after the frame, with no host read inside it); n_setup is
    the host-known row count."""
    _, _, (_, su, _, stats) = classic_kernel_case(name)
    for k in geometry.COUNTERS:
        v = stats[k]
        assert torch.is_tensor(v) and v.dim() == 0, k
        assert v.dtype == torch.int32 and v.device == su.x0.device, k
    assert isinstance(stats["n_setup"], int)


@pytest.mark.parametrize("name", ["clip_overflow", "local_tri"])
def test_geometry_rows_is_the_setup_table(name):
    """``geometry_rows``, which the classic frame calls, gives the setup as
    one (S, SETUP_COLS) int32 table: ``setup_table`` of the fields
    ``geometry_device`` gives (``rtypes.SETUP_ROW_FIELDS``, floats as
    bits, the last two words zero), their ``valid`` beside it, and the
    same combined attributes and counters."""
    case, _, ((clip, attrs), su, attrs_full, stats) = (
        classic_kernel_case(name))
    st = tp.port_state(case)
    lt = None if case.packed.local_tri is None else tp.t(case.packed.local_tri)
    rows, valid, attrs_full_r, stats_r = geometry.geometry_rows(
        clip, attrs, st.tri_v, st.tri_mat, case.cfg,
        case.settings.clip_budget, local_tri=lt)
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    assert rows.shape == (stats["n_setup"], SETUP_COLS)
    _same(rows.numpy(), geometry.setup_table(su).numpy())
    assert not rows[:, len(SETUP_ROW_FIELDS):].any()
    _same(valid.numpy(), su.valid.numpy())
    _same(attrs_full_r.numpy(), attrs_full.numpy())
    assert {k: int(v) for k, v in stats_r.items()} == {
        k: int(v) for k, v in stats.items()}


def _transform_args():
    v = 4
    return [torch.zeros((v, 3)), torch.zeros(v, dtype=torch.int32),
            torch.zeros((v, 3)), torch.zeros((v, 4)), torch.zeros((v, 2)),
            torch.eye(4)[None].contiguous(), torch.eye(4)[None].contiguous()]


def _geometry_args():
    return [torch.zeros((4, 4)), torch.zeros((4, 12)),
            torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32)]


def _bad(args, i, x):
    args = list(args)
    args[i] = x
    return args


@pytest.mark.parametrize("bad", [
    "meta", "positions_f64", "vert_obj_i64", "colors_3", "mats_none"])
def test_transform_vertices_checks(bad):
    """On a device that is neither the CPU nor CUDA, and on a bad dtype or
    shape, ``transform_vertices`` raises (the CUDA kernel takes only what
    ``check_transform_args`` allows)."""
    args = _transform_args()
    if bad == "meta":
        args, match = [a.to("meta") for a in args], "unsupported device"
    else:
        i, x = {"positions_f64": (0, args[0].double()),
                "vert_obj_i64": (1, args[1].long()),
                "colors_3": (3, torch.zeros((4, 3))),
                "mats_none": (5, torch.zeros((0, 4, 4)))}[bad]
        args, match = _bad(args, i, x), "transform_vertices"
    with pytest.raises(ValueError, match=match):
        geometry.transform_vertices(*args)


@pytest.mark.parametrize("bad", [
    "meta", "clip_f64", "attrs_11", "tri_v_i64", "tri_mat_2d", "local_tri"])
def test_geometry_device_checks(bad):
    """``geometry_device`` raises on a device that is neither the CPU nor
    CUDA and on a bad dtype or shape of any of its tensors."""
    from ash_renderer_tpu_torch.config import derive_raster_config

    cfg = derive_raster_config(64, 32, tile_h=16)
    args, lt = _geometry_args(), None
    if bad == "meta":
        args, match = [a.to("meta") for a in args], "unsupported device"
    elif bad == "local_tri":
        lt, match = torch.zeros((3, 3), dtype=torch.int32), "local_tri"
    else:
        i, x = {"clip_f64": (0, args[0].double()),
                "attrs_11": (1, torch.zeros((4, 11))),
                "tri_v_i64": (2, args[2].long()),
                "tri_mat_2d": (3, torch.zeros((2, 1), dtype=torch.int32))
                }[bad]
        args, match = _bad(args, i, x), "geometry_device: bad"
    with pytest.raises(ValueError, match=match):
        geometry.geometry_device(*args, cfg, 4, local_tri=lt)


@pytest.mark.parametrize("bad", [
    "meta", "vis_f32", "rows_19", "rows_i64", "attrs_11", "consts_short",
    "width", "supersample"])
def test_shade_pack_classic_checks(bad):
    """``shade_pack_classic`` raises on a device that is neither the CPU
    nor CUDA and on a bad dtype or shape: the visibility buffer, the setup
    table, the attribute table, the shade constants (their count is the
    shade mode's), a width other than the frame's, rows that do not
    resolve at the supersample."""
    from ash_renderer_tpu_torch.config import derive_raster_config

    cfg = derive_raster_config(64, 32, tile_h=16)
    mode = (1, 0, True, False, False)
    n_consts = shade.shade_consts_layout(mode)["_total"]
    rows = torch.zeros((3, SETUP_COLS), dtype=torch.int32)
    vis = torch.full((32, 64), -1, dtype=torch.int32)
    attrs = torch.zeros((4, 12))
    consts = torch.zeros(n_consts, dtype=torch.int32)
    ss = 1
    if bad == "meta":
        vis, rows, attrs, consts = (x.to("meta")
                                    for x in (vis, rows, attrs, consts))
    elif bad == "rows_19":
        rows = rows[:, :19].contiguous()
    elif bad == "rows_i64":
        rows = rows.long()
    elif bad == "vis_f32":
        vis = vis.float()
    elif bad == "attrs_11":
        attrs = torch.zeros((4, 11))
    elif bad == "consts_short":
        consts = consts[:-1]
    elif bad == "width":
        vis = vis[:, :48]
    else:
        ss = 3
    with pytest.raises(ValueError, match="unsupported device" if bad == "meta"
                       else "shade_pack_classic"):
        shade.shade_pack_classic(vis, rows, attrs, mode, consts, cfg=cfg,
                                 supersample=ss)


def test_setup_rows_are_the_fields():
    """``setup_from_rows``: each TriangleSetup field is its column of the
    (S, SETUP_COLS) table K10 writes (``rtypes.SETUP_ROW_FIELDS``, floats
    as bits), a view of it, and ``valid`` is the bool array beside it;
    ``setup_table`` of those fields is the table with its two last words
    zeroed."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (5, SETUP_COLS),
                                         dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.integers(0, 2, 5).astype(bool))
    su = geometry.setup_from_rows(rows, valid)
    assert su.valid is valid
    names = [f.name for f in dataclasses.fields(su)]
    assert sorted(SETUP_ROW_FIELDS) == sorted(set(names) - {"valid"})
    for i, k in enumerate(SETUP_ROW_FIELDS):
        got = getattr(su, k)
        assert got.dtype == (torch.float32 if k in SETUP_F32_FIELDS
                             else torch.int32), k
        assert got.data_ptr() == rows[:, i].data_ptr(), k
        _same(got.contiguous().view(torch.int32).numpy(), rows[:, i].numpy())
    n = len(SETUP_ROW_FIELDS)
    packed = geometry.setup_table(su)
    _same(packed[:, :n].numpy(), rows[:, :n].numpy())
    assert not packed[:, n:].any()


@pytest.mark.parametrize("name", ["clip_overflow", "textured_lit"])
def test_setup_rows_feed_binning_and_shading(name):
    """The TriangleSetup made of the columns of the classic frame's setup
    table (``geometry_rows``, as K10 returns it on a card) gives
    ``binning.bin_triangles`` and ``tritables.build_comb_table`` the same
    outputs as the plain version's own fields, and ``shade_pack_classic``
    on the table equals ``shade`` + ``resolve_and_pack`` on those
    fields."""
    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import binning, raster_visibility
    from ash_renderer_tpu_torch.ops import tritables

    case, _, (_, su, attrs_full, _) = classic_kernel_case(name)
    rows = geometry.setup_table(su)
    su_rows = geometry.setup_from_rows(rows, su.valid.clone())
    assert not su_rows.x0.is_contiguous()
    cfg, st = case.cfg, case.settings
    state = tp.port_state(case)
    statics = tp.port_statics(case)
    atlas = state.atlas if statics.has_atlas else None
    light = state.light if statics.has_light else None
    mode = pipeline.surface_mode(statics, state.materials, atlas, light)
    consts = shade.pack_shade_consts(
        mode, state.materials, atlas, light,
        torch.from_numpy(case.cam.position.astype(np.float32)))
    sh_kw = dict(atlas=atlas, light=light, cfg=cfg,
                 clear_color=st.clear_color)
    outs = []
    for s in (su, su_rows):
        rec = binning.bin_triangles(s, cfg, st.max_pairs)
        _, vis_t = raster_visibility.rasterize_visibility(*rec[:2], *rec[3:5],
                                                          cfg)
        rgba8 = shade.resolve_and_pack(
            shade.shade(vis_t, s, attrs_full, mode, consts, **sh_kw),
            st.supersample, st.srgb_output)
        comb = tritables.build_comb_table(s, attrs_full, cfg)
        outs.append((*rec[:5], vis_t, rgba8, comb))
    rgba8_rows = shade.shade_pack_classic(
        outs[1][5], rows, attrs_full, mode, consts, **sh_kw,
        supersample=st.supersample, srgb=st.srgb_output)
    for got, want in zip(outs[1] + (rgba8_rows,), outs[0] + (outs[0][6],)):
        _same(got.numpy(), want.numpy())
    assert int((outs[0][5] >= 0).sum()) > 300
