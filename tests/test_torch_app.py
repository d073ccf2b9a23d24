"""The port's app shell (``App``, ``render_to_images``, ``main``), camera
controller and scene serialization against the JAX package's, on the CPU,
and the app's device policy: it renders on the CUDA card unless told
otherwise and raises without one."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import camera as ref_camera  # noqa: E402
from ash_renderer_tpu import scene as ref_scene  # noqa: E402
from ash_renderer_tpu import serialization as ref_ser  # noqa: E402
from ash_renderer_tpu import textures as ref_textures  # noqa: E402
from ash_renderer_tpu.app import App as RefApp  # noqa: E402
from ash_renderer_tpu.app import InputEvent as RefInputEvent  # noqa: E402
from ash_renderer_tpu.config import RendererSettings as RefSettings  # noqa: E402
from ash_renderer_tpu.models import cube as ref_cube  # noqa: E402
from ash_renderer_tpu.present import FrameCollector as RefCollector  # noqa: E402
from ash_renderer_tpu_torch import app, camera, models, serialization  # noqa: E402
from ash_renderer_tpu_torch.config import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch.debugging import numpy_pack  # noqa: E402
from ash_renderer_tpu_torch.oracle import render_oracle  # noqa: E402
from ash_renderer_tpu_torch.present import FrameCollector  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402
from ash_renderer_tpu_torch.scene import (  # noqa: E402
    Mesh, reference_two_triangle_scene, scene_from_reference)

torch.set_num_threads(1)
SETTINGS = dict(width=64, height=48, clip_budget=64)
# a scripted input sequence: every key, both mouse axes, key combinations
EVENTS = [dict(forward=True), dict(mouse_dx=3.0),
          dict(left=True, mouse_dy=-2.0), dict(backward=True, right=True),
          dict(forward=True, left=True, mouse_dx=-7.5, mouse_dy=1.25),
          dict(right=True)]

needs_no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="checks the refusal without CUDA")


_same, _same_scene = tp.same_bits, tp.same_scene


def _same_camera(got, want):
    _same(got.position, want.position)
    _same(got.up, want.up)
    assert (got.phi, got.theta, got.fovy, got.znear, got.zfar) == (
        want.phi, want.theta, want.fovy, want.znear, want.zfar)


def oracle_frame(renderer, cam):
    """The port's numpy oracle frame of ``renderer``'s scene at ``cam``."""
    st, s = renderer.settings, renderer.state
    return render_oracle(
        renderer.packed, renderer.scene.model_matrices(), cam.view_matrix(),
        cam.projection_matrix(st.render_width / st.render_height), st,
        materials=numpy_pack(s.materials),
        atlas=None if s.atlas is None else numpy_pack(s.atlas),
        light=None if s.light is None else numpy_pack(s.light),
        camera_pos=cam.position.astype(np.float32), cfg=renderer.cfg,
    )["rgba8"]


# ---------------------------------------------------------------------------
# camera control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speed,sens", [(0.01, 0.01), (0.37, 0.003)])
def test_camera_controller_matches_reference(speed, sens):
    """CameraController over the scripted sequence leaves the Camera bit-
    equal to the reference's after every update."""
    c, rc = camera.Camera(), ref_camera.Camera()
    ctl = camera.CameraController(speed=speed, mouse_sens=sens)
    rctl = ref_camera.CameraController(speed=speed, mouse_sens=sens)
    for ev in EVENTS * 3:
        for k, kc in ((ctl, camera), (rctl, ref_camera)):
            k.forward_pressed = ev.get("forward", False)
            k.backward_pressed = ev.get("backward", False)
            k.left_pressed = ev.get("left", False)
            k.right_pressed = ev.get("right", False)
            k.process_mouse(ev.get("mouse_dx", 0.0), ev.get("mouse_dy", 0.0))
        ctl.update_camera(c)
        rctl.update_camera(rc)
        _same_camera(c, rc)
        assert (ctl.mouse_delta_x, ctl.mouse_delta_y) == (0.0, 0.0)
    _same(c.view_matrix(), rc.view_matrix())


# ---------------------------------------------------------------------------
# the app on the CPU
# ---------------------------------------------------------------------------

def test_app_frames_match_jax_app_and_oracle():
    """App.step on the reference scene at 64x48: every presented frame
    equals the JAX App's byte for byte (the same scripted input) and the
    port's oracle at the controller's camera; the cameras stay bit-equal."""
    ref = RefApp(ref_scene.reference_two_triangle_scene(),
                 RefSettings(**SETTINGS), warmup=False)
    port = app.App(reference_two_triangle_scene(), RendererSettings(**SETTINGS),
                   device="cpu")
    rc, pc = RefCollector(), FrameCollector()
    cams = []
    for ev in EVENTS:
        ref.step(RefInputEvent(**ev), on_present=rc)
        port.step(app.InputEvent(**ev), on_present=pc)
        _same_camera(port.camera, ref.camera)
        cams.append(dataclasses.replace(port.camera,
                                        position=port.camera.position.copy()))
    ref.renderer.finish()
    port.renderer.finish()
    assert len(pc.frames) == len(rc.frames) == len(EVENTS)
    for got, want, cam in zip(pc.frames, rc.frames, cams):
        _same(got, want)
        _same(got, oracle_frame(port.renderer, cam))
    assert len({f.tobytes() for f in pc.frames}) > 1  # the input moved it


def test_app_run_counts_frames():
    a = app.App(reference_two_triangle_scene(), RendererSettings(**SETTINGS),
                device="cpu")
    stats = a.run(4, [app.InputEvent(forward=True)] * 3
                  + [app.InputEvent(mouse_dx=5.0)])
    assert stats.n_frames == 4
    assert a.camera.position[2] == pytest.approx(0.03, abs=1e-6)
    assert a.camera.theta == pytest.approx(0.05)


def test_app_self_recovering_resize():
    """A resize event under a running loop recovers inside draw_frame (no
    renderer.resize() call): the next frame has the new size and equals a
    fresh Renderer's frame at that size."""
    st = RendererSettings(**SETTINGS, frames_in_flight=1)
    a = app.App(reference_two_triangle_scene(), st, device="cpu")
    coll = FrameCollector()
    a.step(on_present=coll)
    a.request_resize(96, 72)
    a.step(on_present=coll)
    a.renderer.finish()
    assert (a.renderer.settings.width, a.renderer.settings.height) == (96, 72)
    assert [f.shape for f in coll.frames] == [(48, 64, 4), (72, 96, 4)]
    fresh = Renderer(reference_two_triangle_scene(),
                     dataclasses.replace(st, width=96, height=72), device="cpu")
    _same(coll.frames[1], fresh.read_frame(fresh.render_frame(a.camera)[0]))


def test_update_mesh_equals_fresh_renderer():
    """update_mesh re-uploads the geometry: the next frame equals a fresh
    Renderer's on the edited scene."""
    st = RendererSettings(**SETTINGS)
    r = Renderer(reference_two_triangle_scene(), st, device="cpu")
    cam = camera.Camera()
    before = r.read_frame(r.render_frame(cam)[0])
    m = r.scene.meshes[0]
    edited = Mesh(positions=m.positions * np.float32(0.6), indices=m.indices,
                  colors=m.colors[:, [2, 0, 1, 3]])
    r.update_mesh(0, edited)
    after = r.read_frame(r.render_frame(cam)[0])
    scene = reference_two_triangle_scene()
    scene.meshes[0] = edited
    fresh = Renderer(scene, st, device="cpu")
    _same(after, fresh.read_frame(fresh.render_frame(cam)[0]))
    assert not np.array_equal(after, before)


def _decode_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_render_to_images(tmp_path):
    """render_to_images writes numbered PNGs that decode to the frames the
    extra sink collected."""
    extra = FrameCollector()
    paths = app.render_to_images(
        reference_two_triangle_scene(), RendererSettings(**SETTINGS),
        [camera.Camera(), camera.Camera(theta=0.3)], str(tmp_path / "out"),
        extra_present=extra, device="cpu")
    assert [os.path.basename(p) for p in paths] == ["frame_0000.png",
                                                    "frame_0001.png"]
    for p, f in zip(paths, extra.frames):
        _same(_decode_png(p), f)
    assert not np.array_equal(extra.frames[0], extra.frames[1])


def test_main_on_the_cpu(tmp_path, capsys):
    """main(..., --device cpu) renders a config and an OBJ file to PNGs and
    prints the reference's summary line; the reference config's frame
    equals the port's oracle."""
    out = str(tmp_path / "frames")
    paths = app.main(["reference", "--size", "64x48", "--frames", "2",
                      "--out", out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]
    assert "rendered 2 frame(s) at 64x48" in capsys.readouterr().out
    r = Renderer(reference_two_triangle_scene(),
                 RendererSettings(width=64, height=48), device="cpu")
    _same(_decode_png(paths[0]), oracle_frame(r, camera.Camera()))

    from ash_renderer_tpu_torch.models.obj import save_obj

    obj_path = str(tmp_path / "cube.obj")
    save_obj(obj_path, models.cube(1.0))
    out2 = str(tmp_path / "obj_frames")
    app.main([obj_path, "--size", "48x32", "--out", out2, "--device", "cpu"])
    img = _decode_png(os.path.join(out2, "frame_0000.png"))
    assert img.shape == (32, 48, 4) and img[..., :3].any()


@needs_no_cuda
def test_main_without_a_card_raises_and_writes_nothing(tmp_path):
    """Without --device, main renders on the card; with no CUDA it raises
    before any work and writes no frame (never a CPU fallback)."""
    out = str(tmp_path / "frames")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["reference", "--size", "64x48", "--out", out])
    assert not os.path.exists(out)


@needs_no_cuda
def test_app_and_render_to_images_default_to_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.App(reference_two_triangle_scene())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.render_to_images(reference_two_triangle_scene(),
                             RendererSettings(**SETTINGS), [camera.Camera()],
                             str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def _ref_scene():
    """The reference test's scene, with a second material and object."""
    sc = ref_scene.Scene(
        materials=[ref_scene.Material(base_color=(0.5, 0.6, 0.7, 1.0),
                                      texture_id=0, specular=0.3,
                                      shininess=16),
                   ref_scene.Material(base_color=(0.9, 0.2, 0.1, 1.0))],
        light=ref_scene.DirectionalLight(direction=(0.1, -0.9, 0.3),
                                         ambient=0.2),
    )
    sc.atlas = ref_textures.TextureAtlas.build(
        [ref_textures.checkerboard(16), ref_textures.checkerboard(8, 2)])
    m = sc.add_mesh(ref_cube())
    sc.add_object(ref_scene.SceneObject(mesh=m))
    sc.add_object(ref_scene.SceneObject(
        mesh=m, material=1, model=np.array(
            [[1, 0, 0, 0.5], [0, 1, 0, 0], [0, 0, 1, 3.0], [0, 0, 0, 1]],
            np.float32)))
    return sc


CAMS = [dict(), dict(theta=1.0, phi=1.2, position=np.array(
    [0.1, -0.2, -1.5], np.float32))]


def _npz_arrays(path):
    with np.load(path) as d:
        return {k: np.array(d[k]) for k in d.files}


def _same_loaded(got, got_cams, want, want_cams):
    _same_scene(got, want)
    assert len(got_cams) == len(want_cams)
    for c, w in zip(got_cams, want_cams):
        _same_camera(c, w)


def test_serialization_roundtrip_and_file_matches_reference(tmp_path):
    """save_scene -> load_scene gives the scene back, the file holds the
    same arrays as the reference's file of the same scene, and the loaded
    scene renders the same oracle frame."""
    ref = _ref_scene()
    port = scene_from_reference(ref)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    serialization.save_scene(a, port, [camera.Camera(**c) for c in CAMS])
    ref_ser.save_scene(b, ref, [ref_camera.Camera(**c) for c in CAMS])
    fa, fb = _npz_arrays(a), _npz_arrays(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        _same(fa[k], fb[k])
    back, cams = serialization.load_scene(a)
    _same_scene(back, port)
    # the file keeps the angles as float32, as the reference's does
    _same_loaded(back, cams, *ref_ser.load_scene(b))
    st = RendererSettings(width=48, height=32, clip_budget=32)
    frames = [oracle_frame(Renderer(sc, st, device="cpu"), cams[1])
              for sc in (port, back)]
    _same(frames[0], frames[1])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_serialization_cross_loads(tmp_path, direction):
    """A file saved by either package loads in the other into equal
    arrays."""
    ref = _ref_scene()
    path = str(tmp_path / "scene.npz")
    if direction == "jax_to_port":
        ref_ser.save_scene(path, ref, [ref_camera.Camera(**c) for c in CAMS])
        got, got_cams = serialization.load_scene(path)
        want, want_cams = ref_ser.load_scene(path)
    else:
        serialization.save_scene(path, scene_from_reference(ref),
                                 [camera.Camera(**c) for c in CAMS])
        want, want_cams = serialization.load_scene(path)
        got, got_cams = ref_ser.load_scene(path)
    _same_loaded(got, got_cams, want, want_cams)
    _same_scene(got, ref)


def test_serialization_without_atlas_light_or_cameras(tmp_path):
    sc = reference_two_triangle_scene()
    path = str(tmp_path / "bare.npz")
    serialization.save_scene(path, sc)
    back, cams = serialization.load_scene(path)
    assert cams == [] and back.light is None and back.atlas is None
    ref_back, _ = ref_ser.load_scene(path)
    _same_scene(back, ref_back)
    _same(back.meshes[0].positions, sc.meshes[0].positions)


# ---------------------------------------------------------------------------
# warm-up
# ---------------------------------------------------------------------------

def test_app_takes_the_references_warmup_argument():
    import inspect

    ref = inspect.signature(RefApp.__init__).parameters
    port = inspect.signature(app.App.__init__).parameters
    assert list(port)[: len(ref)] == list(ref)
    assert port["warmup"].default is ref["warmup"].default is True
    assert port["warmup"].kind == ref["warmup"].kind


@pytest.mark.parametrize("how", ["keyword_true", "keyword_false",
                                 "positional_false", "default"])
def test_app_never_warms_a_cpu_renderer(how, monkeypatch):
    """warmup=True and warmup=False are both accepted (by keyword or in the
    reference's position); a CPU renderer is never warmed up, as the
    reference warms up on the TPU only."""
    def refuse(self, *a, **kw):
        raise AssertionError("App warmed up a CPU renderer")

    monkeypatch.setattr(Renderer, "warmup", refuse)
    args = (reference_two_triangle_scene(), RendererSettings(**SETTINGS))
    a = {
        "keyword_true": lambda: app.App(*args, warmup=True, device="cpu"),
        "keyword_false": lambda: app.App(*args, warmup=False, device="cpu"),
        "positional_false": lambda: app.App(*args, None, 0.01, 0.01, False,
                                            device="cpu"),
        "default": lambda: app.App(*args, device="cpu"),
    }[how]()
    assert a.renderer.device == torch.device("cpu")
    assert a.run(1).n_frames == 1


def test_app_warms_a_card_renderer_only_when_asked(monkeypatch):
    """On a CUDA device App calls Renderer.warmup unless warmup=False (the
    renderer is built on the CPU here and named CUDA, so nothing runs)."""
    real_init = Renderer.__init__

    def on_a_card(self, *a, **kw):
        real_init(self, *a, **dict(kw, device="cpu"))
        self.device = torch.device("cuda", 0)

    calls = []
    monkeypatch.setattr(app, "require_device", torch.device)
    monkeypatch.setattr(Renderer, "__init__", on_a_card)
    monkeypatch.setattr(Renderer, "warmup", lambda self: calls.append(self))
    args = (reference_two_triangle_scene(), RendererSettings(**SETTINGS))
    a = app.App(*args)
    assert calls == [a.renderer]
    app.App(*args, warmup=False)
    assert calls == [a.renderer]
