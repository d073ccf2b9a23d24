"""The port's row-slab rendering on the CPU (``parallel/sharding.py``; the
plain versions of the kernels): each slab is a mesh entry, and a mesh that
repeats the CPU renders N slabs on one device, as the card's run emulates
them on one H100.  Every sharded frame must equal the port's
single-device frame byte for byte:

* both pipelines at 2, 3 and 8 slabs, grids that the slab count does not
  divide (padded slabs, some wholly past the screen) included;
* the reference's concentrated-slab budget case (every slab gets the whole
  pair budget) and dense population case (the worst slab's wide, pair and
  clip counters live);
* ``Renderer(n_devices=)`` and ``Renderer(mesh=)``, with no front cache;
* the errors: a supersampling factor that does not divide a slab's rows, a
  mesh that mixes device types, more CUDA devices than exist.

The JAX package's sharded frames: ``test_torch_sharding_jax.py``."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import Mesh, RendererSettings, Scene, SceneObject  # noqa: E402
from ash_renderer_tpu_torch import parallel, pipeline  # noqa: E402
from ash_renderer_tpu_torch.renderer import (Renderer, frame_statics,  # noqa: E402
                                             resolve_mesh)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _case(name, pipe, **kw):
    """The parity case ``name`` with its settings for pipeline ``pipe``
    (fused: meshlet packing and 8-row tiles; classic: plain packing and
    16-row tiles)."""
    build, settings = tp.SCENES[name]
    settings = dataclasses.replace(settings, pipeline=pipe, **kw)
    if pipe == "classic":
        return tp.classic_case(build(), settings)
    return tp.case_from(build(), settings)


def _inputs(case):
    statics = frame_statics(case.settings, case.packed.tri_v.shape[0],
                            case.scene.atlas is not None,
                            case.scene.light is not None)
    assert statics.cfg == case.cfg
    cam = torch.from_numpy(case.cam.position.astype(np.float32))
    return statics, tp.port_state(case), tp.t(case.mm), tp.t(case.mvp), cam


def _single(case):
    statics, state, mm, mvp, cam = _inputs(case)
    if case.settings.pipeline == "classic":
        rgba8, aux = pipeline.render_frame(statics, state, mm, mvp, cam)
    else:
        rgba8, aux = pipeline.render_frame_fused_staged(statics, state, mm,
                                                        mvp, cam)
    return rgba8.numpy(), aux


def _sharded(case, n):
    statics, state, mm, mvp, cam = _inputs(case)
    mesh = parallel.make_render_mesh([CPU] * n)
    fn = (parallel.render_frame_sharded if case.settings.pipeline == "classic"
          else parallel.render_frame_sharded_fused)
    rgba8, stats = fn(statics, mesh, {CPU: state}, mm, mvp, cam)
    return rgba8.numpy(), {k: int(v) for k, v in stats.items()}


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("name, pipe", [
    ("random", "fused"),  # phase F (K3F's plain version)
    ("textured", "fused"),  # phase E (K3's)
    ("graze", "fused"),  # clip tail and wide pairs
    ("random", "classic"),  # 8 tile rows: 3 slabs do not divide them
    ("near_plane", "classic"),
])
def test_sharded_equals_single_device(name, pipe, n):
    case = _case(name, pipe)
    want, aux = _single(case)
    got, stats = _sharded(case, n)
    assert int((aux["vis_tri"] >= 0).sum()) > 500
    assert got.shape == want.shape == (case.cfg.height, case.cfg.width, 4)
    np.testing.assert_array_equal(got, want)
    if pipe == "classic":
        assert stats == {"pairs_overflow": 0}
    else:
        assert stats["clip_overflow"] == int(aux["clip_overflow"]) == 0
        assert stats["n_clipped"] == int(aux["n_clipped"])


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("pipe, height", [("fused", 40), ("classic", 48)])
def test_indivisible_grid_pads(pipe, height, n):
    """5 (fused) or 3 (classic) tile rows: the last slabs run past the
    screen, and with 8 slabs some lie wholly past it; they render the
    clear colour and are cropped."""
    case = _case("random", pipe, width=128, height=height)
    assert case.cfg.grid_h in (3, 5)
    want, _ = _single(case)
    got, _ = _sharded(case, n)
    np.testing.assert_array_equal(got, want)


def test_supersampled_slabs():
    """2x SSAA and the sRGB pack: each slab resolves its own rows."""
    case = _case("ssaa_srgb", "fused")
    want, _ = _single(case)
    for n in (2, 3):
        got, _ = _sharded(case, n)
        np.testing.assert_array_equal(got, want)


def test_concentrated_slab_budget():
    """The reference's case: all geometry in one thin band of rows, a pair
    budget the whole frame fits but a budget / 8 would not.  Every slab
    gets the whole budget, so the sharded frame drops nothing."""
    rng = np.random.default_rng(11)
    nv, nt = 240, 700
    pos = rng.uniform(-2, 2, (nv, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-1.35, -1.05, nv).astype(np.float32)
    pos[:, 2] += 3.0
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=pos, indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32)))))
    case = tp.classic_case(sc, RendererSettings(
        width=128, height=512, clip_budget=128, max_pairs=1 << 12,
        pipeline="classic"))
    want, aux = _single(case)
    assert int(aux["pairs_overflow"]) == 0
    assert int(aux["pairs_total"]) > case.settings.max_pairs // 8
    got, stats = _sharded(case, 8)
    assert stats["pairs_overflow"] == 0
    np.testing.assert_array_equal(got, want)


def test_dense_population_counters():
    """The reference's dense case: a sphere just past the near plane, 4
    slabs.  The worst slab's wide rows, wide pairs and clipped triangles
    are live, within budget, and the frame equals the single device's."""
    case = tp.case_from(tp.graze_scene(), RendererSettings(
        width=128, height=256, clip_budget=512, pipeline="fused",
        wide_rows=1 << 10, wide_pairs=1 << 13))
    want, aux = _single(case)
    got, cnt = _sharded(case, 4)
    assert cnt["n_wide"] > 0 and cnt["wide_pairs_n"] > 0, cnt
    assert cnt["n_clipped"] > 0, cnt
    assert cnt["wide_leftover"] == 0 and cnt["clip_overflow"] == 0, cnt
    assert int((aux["vis_tri"] >= 0).sum()) > 2000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pipe", ["fused", "classic"])
def test_renderer_slabs(pipe):
    """Renderer(n_devices=) and Renderer(mesh=) on the CPU: the single
    device's frame, one scene upload, no front cache."""
    case = _case("random", pipe)
    single = Renderer(case.scene, case.settings, device="cpu")
    want = single.read_frame(single.render_frame(case.cam)[0])
    r_n = Renderer(case.scene, dataclasses.replace(case.settings, n_devices=3),
                   device="cpu")
    r_mesh = Renderer(case.scene, case.settings,
                      mesh=parallel.make_render_mesh(["cpu", "cpu"]))
    for r, n in ((r_n, 3), (r_mesh, 2)):
        assert r.mesh == (CPU,) * n and list(r.states) == [CPU]
        assert r._front_cache is None and r.device == CPU
        got, aux = r.render_frame(case.cam)
        np.testing.assert_array_equal(r.read_frame(got), want)
        assert int(aux["pairs_overflow" if pipe == "classic"
                       else "clip_overflow"]) == 0
    # a resize keeps the mesh; the frame still equals the single device's
    r_n.resize(128, 40 if pipe == "fused" else 48)
    single.resize(128, 40 if pipe == "fused" else 48)
    np.testing.assert_array_equal(
        r_n.read_frame(r_n.render_frame(case.cam)[0]),
        single.read_frame(single.render_frame(case.cam)[0]))


def test_supersample_must_divide_slab_rows():
    """rows_per * tile_h % supersample: 15 tile rows of 8 over 2 slabs are
    slabs of 64 rows, which 3x supersampling does not divide."""
    case = _case("random", "fused", width=40, height=40, supersample=3)
    assert case.cfg.grid_h == 15
    statics = _inputs(case)[0]
    assert parallel.slab_rows(statics, 5) == 3  # 24 rows a slab
    with pytest.raises(ValueError, match="supersample"):
        _sharded(case, 2)
    r = Renderer(case.scene, dataclasses.replace(case.settings, n_devices=2),
                 device="cpu")
    with pytest.raises(ValueError, match="supersample"):
        r.render_frame(case.cam)


def test_mesh_errors():
    with pytest.raises(ValueError, match="more than one type"):
        parallel.make_render_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="no devices"):
        parallel.make_render_mesh([])
    case = _case("random", "fused")
    with pytest.raises(ValueError, match="more than one type"):
        Renderer(case.scene, case.settings, mesh=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="first device"):
        Renderer(case.scene, case.settings, device="meta", mesh=[CPU])
    with pytest.raises(TypeError):
        Renderer(case.scene, case.settings)
    # a state missing for a device of the mesh
    statics, state, mm, mvp, cam = _inputs(case)
    with pytest.raises(ValueError, match="no scene state"):
        parallel.render_frame_sharded_fused(statics, (CPU, CPU), {}, mm, mvp,
                                            cam)
    # the fused slabs take a meshlet-packed state
    plain = tp.port_state(_case("random", "classic"))
    with pytest.raises(ValueError, match="meshlet-packed"):
        parallel.render_frame_sharded_fused(statics, (CPU,), {CPU: plain}, mm,
                                            mvp, cam)
    assert state.ltT is not None


def test_n_devices_beyond_the_cards_raises():
    """n_devices on a CUDA device takes cuda:0 .. n-1 and raises when fewer
    cards exist; it never shrinks the mesh or moves to the CPU."""
    st = RendererSettings(n_devices=torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        resolve_mesh(st, torch.device("cuda"))
    assert resolve_mesh(st, CPU) == (CPU,) * st.n_devices
    assert resolve_mesh(RendererSettings(), CPU) is None
    assert resolve_mesh(st, CPU, mesh=["cpu"]) == (CPU,)
