"""The classic pipeline's modules on the CPU, bit for bit against the JAX
package: the vertex transform, ``geometry_device`` (plain and meshlet
corner gathers), K5's plain version against the Pallas
``gather_tri_rows`` (interpret mode), ``bin_triangles``, K4's plain version
against the Pallas ``rasterize_visibility`` on the JAX package's own
records, and ``shade``."""

import dataclasses
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

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import (binning, geometry,  # noqa: E402
                                        meshlet_gather, raster_visibility,
                                        shade)

torch.set_num_threads(1)

# name -> (JAX-package scene, settings): one clip-heavy (every candidate
# fits clip_budget), one whose candidates overflow it, and a random scene
# whose pairs overflow a small max_pairs
CASES = {
    "clip_heavy": (lambda: tp.rand_scene(6, 60, 50, 4.0, zoff=0.8),
                   RendererSettings(width=128, height=64, clip_budget=64)),
    "clip_overflow": (lambda: tp.rand_scene(2, 170, 300, 8.0, zoff=2.5),
                      RendererSettings(width=192, height=128, clip_budget=8)),
    "pairs_overflow": (lambda: tp.rand_scene(13, 150, 220, 2.0),
                       RendererSettings(width=192, height=128, clip_budget=32,
                                        max_pairs=96)),
}


@functools.lru_cache(maxsize=None)
def _case(name, meshlets=False):
    build, settings = CASES[name]
    case = tp.classic_case(build(), settings, meshlets=meshlets)
    return case, _jax_geometry(case)


def _jax_packed(case):
    p = case.ref_packed
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    return p, tri_mat


@functools.partial(jax.jit, static_argnames=("cfg", "clip_budget"))
def _jax_geometry_jit(positions, vert_obj, normals, colors, uvs, mm, mvp,
                      tri_v, tri_obj, obj_material, tri_mat, local_tri, cfg,
                      clip_budget):
    from ash_renderer_tpu.ops import geometry as jgeo

    clip, attrs = jgeo.transform_vertices(positions, vert_obj, normals,
                                          colors, uvs, mm, mvp)
    return (clip, attrs), *jgeo.geometry_device(
        clip, attrs, tri_v, tri_obj, obj_material, cfg, clip_budget,
        local_tri=local_tri, interpret=True, tri_mat=tri_mat)


def _jax_geometry(case):
    """The reference's transform + geometry_device on the case (one jit:
    it compiles faster than the same ops dispatched one by one)."""
    p, tri_mat = _jax_packed(case)
    return _jax_geometry_jit(
        p.positions, p.vert_obj, p.normals, p.colors, p.uvs, case.mm,
        case.mvp, p.tri_v, p.tri_obj, p.obj_material, tri_mat, p.local_tri,
        cfg=case.ref_cfg, clip_budget=case.ref_settings.clip_budget)


def _jax_bin(jsu, cfg, max_pairs):
    from ash_renderer_tpu.ops import binning as jbin

    return jax.jit(jbin.bin_triangles, static_argnums=(1, 2))(jsu, cfg,
                                                             max_pairs)


def _port_geometry(case):
    st = tp.port_state(case)
    lt = None if case.packed.local_tri is None else tp.t(case.packed.local_tri)
    clip, attrs = geometry.transform_vertices(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    su, attrs_full, stats = geometry.geometry_device(
        clip, attrs, st.tri_v, st.tri_mat, case.cfg,
        case.settings.clip_budget, local_tri=lt)
    return (clip, attrs), su, attrs_full, stats


def _su_to_port(su):
    from ash_renderer_tpu_torch.rtypes import TriangleSetup

    return TriangleSetup(**{f.name: tp.t(getattr(su, f.name))
                            for f in dataclasses.fields(TriangleSetup)})


def _same(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("meshlets", [False, True], ids=["plain", "meshlets"])
@pytest.mark.parametrize("name", ["clip_heavy", "clip_overflow"])
def test_geometry_device_matches(name, meshlets):
    """transform_vertices and geometry_device: every TriangleSetup field,
    the combined attributes and the stats equal the reference's."""
    case, ((jclip, jattrs), jsu, jattrs_full, jstats) = _case(name, meshlets)
    (clip, attrs), su, attrs_full, stats = _port_geometry(case)
    _same(clip.numpy(), jclip)
    _same(attrs.numpy(), jattrs)
    for f in dataclasses.fields(su):
        got, want = getattr(su, f.name).numpy(), np.asarray(getattr(jsu, f.name))
        assert got.shape == want.shape, f.name
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=f.name)
    _same(attrs_full.numpy(), jattrs_full)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in jstats.items()}
    assert stats["n_clipped"] > 0 and int(su.valid.sum()) > 10
    if name == "clip_overflow":
        assert stats["clip_overflow"] > 0


@pytest.mark.parametrize("nf", [8, 12])
def test_gather_tri_rows_plain_matches(nf):
    """K5's plain version against the Pallas kernel (interpret mode) on
    random int32 tables, with local ids outside [0, 128) in the F = 12
    case: those rows are 0."""
    from ash_renderer_tpu.ops import meshlet_gather as jmg

    rng = np.random.default_rng(nf)
    m = 3
    tbl = rng.integers(-2**31, 2**31, (m * 128, nf), dtype=np.int64).astype(np.int32)
    local = rng.integers(0, 128, (m * 128, 3)).astype(np.int32)
    if nf == 12:
        local[::7, 1] = 128
        local[::11, 2] = -1
    want = np.asarray(jmg.gather_tri_rows(jnp.asarray(tbl), jnp.asarray(local),
                                          interpret=True))
    got = meshlet_gather.gather_tri_rows(tp.t(tbl), tp.t(local)).numpy()
    _same(got, want)
    assert (got[::7, nf : 2 * nf] == 0).all() == (nf == 12)


def test_gather_tri_rows_checks_shapes():
    tbl = torch.zeros((256, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        meshlet_gather.gather_tri_rows(tbl, torch.zeros((128, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        meshlet_gather.gather_tri_rows(torch.zeros((256, 33), dtype=torch.int32),
                                       torch.zeros((256, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        meshlet_gather.gather_tri_rows(tbl.to("meta"),
                                       torch.zeros((256, 3), dtype=torch.int32,
                                                   device="meta"))


def _binning_pair(case, jsu):
    max_pairs = case.settings.max_pairs
    want = _jax_bin(jsu, case.ref_cfg, max_pairs)
    got = binning.bin_triangles(_su_to_port(jsu), case.cfg, max_pairs)
    return jsu, got, want


@pytest.mark.parametrize("name", ["clip_heavy", "clip_overflow",
                                  "pairs_overflow"])
def test_bin_triangles_matches(name):
    """tile_start, tile_count and the stats exactly; each tile's records as
    a set (sorted by triangle id: the two sorts order equal tiles
    differently); the dead columns past the live pairs all zero."""
    case, (_, jsu, _, _) = _case(name)
    _, (rec_i, rec_f, start, count, stats), want = _binning_pair(case, jsu)
    w_rec_i, w_rec_f, w_start, w_count, w_stats = (
        np.asarray(x) if not isinstance(x, dict) else x for x in want)
    p = case.settings.max_pairs
    _same(start.numpy(), w_start)
    _same(count.numpy(), w_count)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in w_stats.items()}
    assert rec_i.shape == (14, p) and rec_f.shape == (1, p)
    # the reference's rows 14-15 are zero padding, which the port drops
    assert not w_rec_i[14:].any()
    w_rec_i, w_rec_f = w_rec_i[:14, :p], w_rec_f[:, :p]
    got_i, got_f = rec_i.numpy(), rec_f.numpy()
    n_live = int(count.sum())
    for s, c in zip(start.numpy(), count.numpy()):
        cols = slice(s, s + c)
        og, ow = np.argsort(got_i[12, cols]), np.argsort(w_rec_i[12, cols])
        _same(got_i[:, cols][:, og], w_rec_i[:, cols][:, ow])
        _same(got_f[:, cols][:, og], w_rec_f[:, cols][:, ow])
    assert not got_i[:, n_live:].any() and not w_rec_i[:, n_live:].any()
    _same(got_f[:, n_live:], w_rec_f[:, n_live:])
    assert n_live > 50
    if name == "pairs_overflow":
        assert int(stats["pairs_overflow"]) > 0 and n_live == p


@pytest.mark.parametrize("name", ["clip_heavy", "clip_overflow",
                                  "pairs_overflow"])
def test_rasterize_visibility_plain_matches(name):
    """K4's plain version against the Pallas kernel (interpret mode) on
    the JAX package's own records (their 14 record rows, with the DMA
    padding columns)."""
    from ash_renderer_tpu.ops import raster_pallas

    case, (_, jsu, _, _) = _case(name)
    rec_i, rec_f, start, count, _ = _jax_bin(jsu, case.ref_cfg,
                                             case.settings.max_pairs)
    want_d, want_t = raster_pallas.rasterize_visibility(
        rec_i, rec_f, start, count, case.ref_cfg, interpret=True)
    got_d, got_t = raster_visibility.rasterize_visibility(
        tp.t(np.asarray(rec_i)[:binning.RECORD_ROWS]), tp.t(rec_f),
        tp.t(start), tp.t(count), case.cfg)
    _same(got_t.numpy(), want_t)
    _same(got_d.numpy(), want_d)
    assert int((got_t >= 0).sum()) > 300


def test_rasterize_visibility_checks():
    from ash_renderer_tpu_torch.config import derive_raster_config

    cfg8 = derive_raster_config(128, 64, tile_h=8)
    z = torch.zeros((binning.RECORD_ROWS, 4), dtype=torch.int32)
    args = (z, torch.zeros((1, 4)), torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="16x128"):
        raster_visibility.rasterize_visibility(*args, cfg8)
    cfg = derive_raster_config(128, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        raster_visibility.rasterize_visibility(
            *(a.to("meta") for a in args[:2]), *args[2:], cfg)
    d, t = raster_visibility.rasterize_visibility(
        *args[:2], torch.zeros(4, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), cfg)
    assert (d == 65535).all() and (t == -1).all() and d.shape == (64, 128)


def test_shade_matches():
    """shade on a lit, textured, multi-material scene (tests/golden_scenes
    multi_material) against the reference's shade.shade(jnp, ...), from the
    same setup, attributes and visibility."""
    from golden_scenes import multi_material

    from ash_renderer_tpu.ops import raster_pallas
    from ash_renderer_tpu.ops import shade as jshade

    ref_scene, settings = multi_material()  # nothing to clip
    case = tp.classic_case(ref_scene, dataclasses.replace(settings,
                                                          clip_budget=16))
    _, jsu, jattrs, _ = _jax_geometry(case)
    rec = _jax_bin(jsu, case.ref_cfg, case.settings.max_pairs)
    _, vis_t = raster_pallas.rasterize_visibility(*rec[:4], case.ref_cfg,
                                                  interpret=True)
    mats, atlas, light = tp.jax_shading(case)
    cam_pos = case.cam.position.astype(np.float32)
    want = np.asarray(jax.jit(
        functools.partial(jshade.shade, jnp, cfg=case.ref_cfg,
                          clear_color=settings.clear_color)
    )(vis_t, jsu, jattrs, materials=mats, atlas=atlas, light=light,
      camera_pos=jnp.asarray(cam_pos)))

    st = tp.port_state(case)
    statics = pipeline.FrameStatics(cfg=case.cfg, settings=case.settings,
                                    has_atlas=True, has_light=True)
    mode = pipeline.surface_mode(statics, st.materials, st.atlas, st.light)
    assert mode == (3, 2, True, True, True)
    consts = shade.pack_shade_consts(mode, st.materials, st.atlas, st.light,
                                     torch.from_numpy(cam_pos))
    got = shade.shade(tp.t(vis_t), _su_to_port(jsu), tp.t(jattrs), mode,
                      consts, atlas=st.atlas, light=st.light, cfg=case.cfg,
                      clear_color=settings.clear_color).numpy()
    valid = np.asarray(vis_t) >= 0
    assert valid.sum() > 5000
    _same(got[valid], want[valid])
    # background pixels: the clear colour on both
    _same(got[~valid], want[~valid])
    tex = np.isin(np.asarray(jsu.mat)[np.clip(np.asarray(vis_t), 0, None)], [0, 2])
    assert (tex & valid).sum() > 1000  # textured materials reached
