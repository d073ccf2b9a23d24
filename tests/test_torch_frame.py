"""The port's whole slice on the CPU: Renderer frames against the numpy
oracle and the stored subdiv-5 headline golden, the front cache across
static -> moved -> static, the Renderer's device policy and frame ring, and
that the package never imports jax."""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch.camera import Camera  # noqa: E402
from ash_renderer_tpu_torch.config import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle(case, cam=None):
    """The numpy oracle's frame of the case's JAX-package scene."""
    from ash_renderer_tpu.oracle import render_oracle

    cam = cam or case.ref_cam
    st = case.ref_settings
    mats, atlas, light = tp.jax_shading(case)
    return render_oracle(
        case.ref_packed, case.mm, cam.view_matrix(),
        cam.projection_matrix(st.render_width / st.render_height), st,
        materials=mats, atlas=atlas, light=light,
        camera_pos=cam.position.astype(np.float32), cfg=case.ref_cfg,
    )


@pytest.mark.parametrize(
    "name", ["random", "graze", "overflow", "textured", "ssaa_srgb"]
)
def test_frame_matches_oracle(name):
    case = tp.make_case(name)
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    rgba8, aux = r.render_frame(case.cam)
    o = _oracle(case)
    assert int((o["vis_tri"] >= 0).sum()) > 300
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), o["vis_tri"])
    np.testing.assert_array_equal(aux["vis_d16"].numpy(), o["vis_d16"])
    np.testing.assert_array_equal(r.read_frame(rgba8), o["rgba8"])
    if name == "overflow":
        assert aux["clip_overflow"] > 0 and aux["wide_leftover"] > 0


def test_headline_subdiv5_matches_golden():
    """config4 at subdiv 5 (20,480 triangles, 1920x1080): the frame's
    sha256 equals the golden the numpy oracle left in docs/golden/."""
    from ash_renderer_tpu_torch.benchmarks import config4_million_tri

    scene, settings, cams = config4_million_tri(5)
    r = Renderer(scene, settings, device="cpu")
    rgba8, aux = r.render_frame(cams[0])
    with open(os.path.join(ROOT, "docs", "golden",
                           "headline_config4_s5.json")) as f:
        golden = json.load(f)
    assert int((aux["vis_tri"] >= 0).sum()) == golden["covered_px"]
    digest = hashlib.sha256(r.read_frame(rgba8).tobytes()).hexdigest()
    assert digest == golden["sha256"]


def test_front_cache_static_moved_static():
    case = tp.make_case("textured")
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    moved = Camera(position=np.array([0.3, -0.1, 0.4], np.float32),
                   theta=0.05)
    a = r.read_frame(r.render_frame(case.cam)[0])
    key_a = r._front_cache.key
    front_a = r._front_cache.value
    b = r.read_frame(r.render_frame(moved)[0])
    assert r._front_cache.key != key_a
    c = r.read_frame(r.render_frame(case.cam)[0])
    assert r._front_cache.key == key_a
    assert r._front_cache.value is not front_a  # recomputed after the miss
    d = r.read_frame(r.render_frame(case.cam)[0])
    np.testing.assert_array_equal(c, a)
    np.testing.assert_array_equal(d, a)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(b, _oracle(case, moved)["rgba8"])
    import dataclasses

    uncached = Renderer(case.scene, dataclasses.replace(
        tp.fused(case.settings), front_coherence=False), device="cpu")
    assert uncached._front_cache is None
    np.testing.assert_array_equal(
        uncached.read_frame(uncached.render_frame(case.cam)[0]), a
    )


def test_stage_hook_order_and_cache():
    """render_frame reports each stage as it is issued, in pipeline order;
    a front-cache hit reports only the stages after the front."""
    case = tp.make_case("random")
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    seen = []
    a = r.read_frame(r.render_frame(case.cam, on_stage=seen.append)[0])
    assert seen == ["mvp_upload", "transform", "setup_K1", "clip_tail",
                    "sort_bounds_K2", "expand_meta_gather", "raster_K3",
                    "shade_pack"]
    seen.clear()
    b = r.read_frame(r.render_frame(case.cam, on_stage=seen.append)[0])
    assert seen == ["mvp_upload", "raster_K3", "shade_pack"]
    np.testing.assert_array_equal(a, b)


def test_renderer_device_and_pipeline_policy():
    """The reference's routing: "auto" takes the classic pipeline under
    4096 triangles (counted over the meshes, not the objects) and the fused
    one from 4096; an explicit pipeline is honoured."""
    import dataclasses

    from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject

    case = tp.make_case("random")  # 220 triangles
    with pytest.raises(TypeError):
        Renderer(case.scene, case.settings)  # no device: never picked here
    with pytest.raises(ValueError, match="unknown pipeline"):
        Renderer(case.scene, dataclasses.replace(case.settings,
                                                 pipeline="staged"),
                 device="cpu")
    r = Renderer(case.scene, case.settings, device=torch.device("cpu"))
    assert case.settings.pipeline == "auto"
    assert r.settings.pipeline == "classic"
    assert r.packed.local_tri is None and r.state.ltT is None
    assert r.cfg.tile_h == 16 and r._front_cache is None
    # the classic pair budget, capped by the triangle count
    assert r.statics.settings.max_pairs == 1 << 14
    assert r.state.positions.device.type == "cpu"
    for name in ("fused", "classic"):
        r = Renderer(case.scene, dataclasses.replace(case.settings,
                                                     pipeline=name),
                     device="cpu")
        assert r.settings.pipeline == name
        assert (r.packed.local_tri is not None) == (name == "fused")
    with pytest.raises(ValueError, match="8-row"):
        Renderer(case.scene, dataclasses.replace(
            tp.fused(case.settings), fused_tile_h=4), device="cpu")
    # the 16-row classic tiles do not read fused_tile_h
    Renderer(case.scene, dataclasses.replace(case.settings, fused_tile_h=4),
             device="cpu")

    rng = np.random.default_rng(3)

    def scene_of(n_tris, n_objects=1):
        mesh = Mesh(positions=rng.uniform(-1, 1, (64, 3)).astype(np.float32),
                    indices=rng.integers(0, 64, (n_tris, 3)).astype(np.int32))
        sc = Scene()
        m = sc.add_mesh(mesh)
        for _ in range(n_objects):
            sc.add_object(SceneObject(mesh=m))
        return sc

    settings = RendererSettings(width=64, height=32)
    for n_tris, n_obj, want in ((4095, 1, "classic"), (4096, 1, "fused"),
                                (2048, 2, "classic")):
        r = Renderer(scene_of(n_tris, n_obj), settings, device="cpu")
        assert r.settings.pipeline == want, (n_tris, n_obj)


def test_draw_frame_ring():
    case = tp.make_case("random")
    r = Renderer(case.scene, RendererSettings(width=96, height=64,
                                              frames_in_flight=2,
                                              pipeline="fused"),
                 device="cpu")
    got = []
    presented = [r.draw_frame(case.cam, on_present=got.append)
                 for _ in range(3)]
    assert presented[0] is None and presented[1] is None
    assert presented[2].shape == (64, 96, 4) and presented[2].dtype == np.uint8
    rest = r.finish()
    assert len(rest) == 2 and len(got) == 3
    assert r.stats.n_frames == 3
    assert r.stats.summary()["frames"] == 3


def test_write_png_roundtrip(tmp_path):
    from PIL import Image

    from ash_renderer_tpu_torch.present import write_png

    frame = np.random.default_rng(0).integers(0, 256, (24, 40, 4),
                                              dtype=np.uint8)
    path = str(tmp_path / "frame.png")
    write_png(path, frame)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), frame)


def test_port_never_imports_jax():
    """In a fresh interpreter where importing jax or the JAX package
    raises, every module of the port imports and a tiny scene renders on
    the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "ash_renderer_tpu"):
                    raise ImportError(f"{name} is blocked in this process")
                return None

        sys.meta_path.insert(0, NoJax())
        import numpy as np
        import torch
        import ash_renderer_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from ash_renderer_tpu_torch.benchmarks import config4_million_tri
        from ash_renderer_tpu_torch.config import RendererSettings
        from ash_renderer_tpu_torch.renderer import Renderer
        scene, _, cams = config4_million_tri(1)
        frames = []
        for pipeline in ("fused", "auto"):  # 80 triangles: auto is classic
            r = Renderer(scene, RendererSettings(width=64, height=64,
                                                 pipeline=pipeline),
                         device="cpu")
            frames.append(r.read_frame(r.render_frame(cams[0])[0]))
        assert r.settings.pipeline == "classic"
        assert frames[0].shape == (64, 64, 4) and int(frames[0][..., 0].max()) > 0
        assert (frames[0] == frames[1]).all()
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "ash_renderer_tpu")]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
