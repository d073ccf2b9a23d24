"""The "auto" rules of the port's facade (``renderer.auto_route``) on the
CPU: the rule's table for a CPU and a CUDA device (a device object, no
card), the CPU Renderer's routes as before, re-entry with resolved
settings (``update_settings``, ``resize``, ``update_mesh``), and both
fused routes a card's "auto" can take ("on", the CUDA branch's, and
"off") rendered here with their knobs named: the five pinned golden
scenes and the reference CLI scene at 320x240, each equal to its PNG
golden."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ash_renderer_tpu_torch import benchmarks, pipeline
from ash_renderer_tpu_torch.camera import Camera
from ash_renderer_tpu_torch.config import RendererSettings
from ash_renderer_tpu_torch.ops import fused_kernel
from ash_renderer_tpu_torch.renderer import (
    AUTO_FUSED_TRIS, CUDA_AUTO_FUSED_TRIS, CUDA_SURFACE_SHADE, Renderer,
    auto_route)
from ash_renderer_tpu_torch.scene import Material, Mesh, Scene, SceneObject

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)
AUTO = RendererSettings(width=64, height=32)


def _edges(floor):
    """Triangle counts on both sides of a threshold (none below 0)."""
    return [n for n in (0, 1, 2, floor - 1, floor, floor + 1,
                        1_310_720) if n >= 0]


@pytest.mark.parametrize("n_tris", _edges(AUTO_FUSED_TRIS))
def test_cpu_branch_is_the_references_rule(n_tris):
    """CPU: fused from 4096 triangles, else classic; the shade knob stays
    "auto" (``shade_mode_for`` gives it the reference's meaning)."""
    got = auto_route(AUTO, CPU, n_tris)
    assert got.pipeline == ("fused" if n_tris >= AUTO_FUSED_TRIS
                            else "classic")
    assert got.fused_surface_shade == "auto"
    assert dataclasses.replace(got, pipeline="auto") == AUTO


@pytest.mark.parametrize("n_tris", _edges(CUDA_AUTO_FUSED_TRIS))
def test_cuda_branch_resolves_both_knobs(n_tris):
    """CUDA: fused from ``CUDA_AUTO_FUSED_TRIS``, else classic; the shade
    knob ``CUDA_SURFACE_SHADE`` ("on")."""
    assert CUDA_SURFACE_SHADE in ("on", "off")
    for dev in (CUDA, torch.device("cuda"), "cuda:1"):
        got = auto_route(AUTO, dev, n_tris)
        assert got.pipeline == ("fused" if n_tris >= CUDA_AUTO_FUSED_TRIS
                                else "classic")
        assert got.fused_surface_shade == CUDA_SURFACE_SHADE
        assert dataclasses.replace(got, pipeline="auto",
                                   fused_surface_shade="auto") == AUTO


@pytest.mark.parametrize("dev", [CPU, CUDA])
@pytest.mark.parametrize("pipe", ["fused", "classic"])
@pytest.mark.parametrize("shade", ["on", "off"])
def test_explicit_knobs_are_honoured(dev, pipe, shade):
    """Named knobs pass through on both devices, whatever the scene; a
    resolved setting resolves to itself (re-entry keeps the route)."""
    st = dataclasses.replace(AUTO, pipeline=pipe, fused_surface_shade=shade)
    for n_tris in (2, 319, 320, 4095, 4096, 1_310_720):
        assert auto_route(st, dev, n_tris) == st
    resolved = auto_route(AUTO, dev, 2)
    assert auto_route(resolved, dev, 1_310_720) == resolved
    # a named pipeline with the shade knob left to the rule, and back
    half = dataclasses.replace(AUTO, pipeline=pipe)
    assert auto_route(half, dev, 1_310_720).pipeline == pipe
    half = dataclasses.replace(AUTO, fused_surface_shade=shade)
    assert auto_route(half, dev, 2).fused_surface_shade == shade


def _scene(n_tris, n_materials=1, textured=False, seed=3):
    rng = np.random.default_rng(seed)
    mesh = Mesh(positions=rng.uniform(-1, 1, (64, 3)).astype(np.float32),
                indices=rng.integers(0, 64, (n_tris, 3)).astype(np.int32),
                uvs=rng.uniform(0, 1, (64, 2)).astype(np.float32))
    sc = Scene(materials=[Material(texture_id=0 if textured else -1)
                          for _ in range(n_materials)])
    if textured:
        from ash_renderer_tpu_torch.textures import TextureAtlas, checkerboard

        sc.atlas = TextureAtlas.build([checkerboard(16)])
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    return sc


@pytest.mark.parametrize("n_materials", [1, fused_kernel.MAX_SHADE_M,
                                         fused_kernel.MAX_SHADE_M + 1])
@pytest.mark.parametrize("textured", [False, True])
def test_cuda_route_keeps_the_table_caps(n_materials, textured):
    """The CUDA branch's resolved shade knob still sends a scene over
    ``MAX_SHADE_M`` materials to phase E; within the caps it shades in the
    kernel, textured or not, exactly when the resolved knob is "on".
    The statics are built on the CPU from the CUDA branch's settings."""
    sc = _scene(64, n_materials, textured)
    st = auto_route(dataclasses.replace(AUTO, pipeline="fused"), CUDA, 64)
    r = Renderer(sc, st, device="cpu")
    assert r.settings == st
    s = r.state
    mode = pipeline.shade_mode_for(r.statics, s.materials, s.atlas, s.light)
    within = n_materials <= fused_kernel.MAX_SHADE_M
    assert (mode is not None) == (within and st.fused_surface_shade == "on")


@pytest.mark.parametrize("n_tris,n_obj,want", [
    (2, 1, "classic"), (4095, 1, "classic"), (4096, 1, "fused"),
    (2048, 2, "classic"), (5000, 1, "fused")])
def test_cpu_renderer_resolves_as_before(n_tris, n_obj, want):
    """The CPU Renderer's "auto": the reference's rule, counted over the
    meshes, with the shade knob untouched."""
    sc = _scene(n_tris)
    for _ in range(n_obj - 1):
        sc.add_object(SceneObject(mesh=0))
    r = Renderer(sc, AUTO, device="cpu")
    assert r.settings.pipeline == want
    assert r.settings.fused_surface_shade == "auto"
    assert r.settings == dataclasses.replace(AUTO, pipeline=want)


def test_update_settings_resize_and_update_mesh_keep_the_route():
    """``resize`` keeps the resolved route; ``update_mesh`` re-enters the
    settings-dependent tier with the settings already resolved, so a mesh
    edit across the threshold keeps the route; ``update_settings`` with
    "auto" resolves anew, and with named knobs takes them."""
    r = Renderer(_scene(100), AUTO, device="cpu")
    assert r.settings.pipeline == "classic"
    r.resize(48, 24)
    assert (r.settings.pipeline, r.cfg.tile_h) == ("classic", 16)
    assert (r.settings.width, r.settings.height) == (48, 24)
    big = _scene(AUTO_FUSED_TRIS + 10, seed=4).meshes[0]
    r.update_mesh(0, big)
    assert r.settings.pipeline == "classic" and r.packed.local_tri is None
    r.update_settings(AUTO)
    assert r.settings.pipeline == "fused" and r.packed.local_tri is not None
    assert r.settings.fused_surface_shade == "auto"
    r.resize(64, 32)
    assert (r.settings.pipeline, r.cfg.tile_h) == ("fused", 8)
    assert r._front_cache is not None
    named = auto_route(AUTO, CUDA, 100)
    r.update_settings(named)
    assert r.settings == named
    frame = r.read_frame(r.render_frame(Camera())[0])
    assert frame.shape == (32, 64, 4)


def _png(name):
    from PIL import Image

    return np.asarray(Image.open(os.path.join(ROOT, "tests", "golden", name)))


def _route_frame(scene, settings, route):
    """The frame of ``route`` ("fused on" or "fused off", the routes
    chip_smoke.py phase 22 times on a card) rendered on the CPU with its
    knobs named (the CPU honours them).  Returns (frame, settings)."""
    pipe, shade = route.split()
    st = dataclasses.replace(settings, pipeline=pipe,
                             fused_surface_shade=shade)
    r = Renderer(scene, st, device="cpu")
    assert r.settings == st
    return r.read_frame(r.render_frame(Camera())[0]), st


ROUTES = ["fused on", "fused off"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(benchmarks.GOLDEN_SCENES))
def test_golden_scene_on_the_cuda_routes(name, route):
    """Each pinned golden scene on both fused routes a card's "auto" can
    take equals its PNG golden and pinned sha256."""
    import hashlib

    frame, _ = _route_frame(*benchmarks.GOLDEN_SCENES[name](), route)
    png = ("reference_320x240.png" if name == "reference"
           else f"golden_{name}.png")
    np.testing.assert_array_equal(frame, _png(png))
    assert (hashlib.sha256(frame.tobytes()).hexdigest()
            == benchmarks.GOLDEN_SHA[name])


@pytest.mark.parametrize("route", ROUTES)
def test_reference_cli_scene_on_the_cuda_routes(route):
    """``app.main reference --size 320x240``'s scene and settings (the
    reference config resized, as the CLI does) on both fused routes equal
    tests/golden/reference_320x240.png."""
    scene, settings, _ = benchmarks.ALL_CONFIGS["reference"]()
    frame, _ = _route_frame(
        scene, dataclasses.replace(settings, width=320, height=240), route)
    np.testing.assert_array_equal(frame, _png("reference_320x240.png"))
