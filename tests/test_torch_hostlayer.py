"""The port's own host layer (mathx, camera, config, scene, the native
meshlet builder, profiling, PNG writing) against the JAX package's, bit for
bit, and the port's isolation: no module of it imports jax or the JAX
package."""

import ast
import dataclasses
import os
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import camera as ref_camera  # noqa: E402
from ash_renderer_tpu import config as ref_config  # noqa: E402
from ash_renderer_tpu import mathx as ref_mathx  # noqa: E402
from ash_renderer_tpu import scene as ref_scene  # noqa: E402
from ash_renderer_tpu_torch import camera, config, mathx, scene  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKED_FIELDS = ("positions", "colors", "normals", "uvs", "vert_obj", "tri_v",
                 "tri_obj", "local_tri", "obj_material")


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _multi_object():
    """Three objects over two meshes, three materials, one textured."""
    from ash_renderer_tpu.models import cube, icosphere

    sc = ref_scene.Scene(materials=[
        ref_scene.Material(), ref_scene.Material(base_color=(0.2, 0.9, 0.4, 1)),
        ref_scene.Material(texture_id=0, specular=0.3, shininess=8)])
    a = sc.add_mesh(icosphere(2, 0.7))
    b = sc.add_mesh(cube(0.9))
    for i, (m, mat) in enumerate(((a, 0), (b, 1), (a, 2))):
        sc.add_object(ref_scene.SceneObject(
            mesh=m, material=mat, model=ref_mathx.compose(
                ref_mathx.translation([i - 1.0, 0.2 * i, 3.0 + 0.3 * i]),
                ref_mathx.rotation_y(0.4 * i))))
    return sc


def _icosphere4():
    from ash_renderer_tpu.models import icosphere

    sc = ref_scene.Scene()
    sc.add_object(ref_scene.SceneObject(mesh=sc.add_mesh(icosphere(4))))
    return sc


SCENES = {
    "random": lambda: tp.rand_scene(13, 150, 220, 2.0),
    "random_dense": lambda: tp.rand_scene(5, 40, 900, 1.0),
    "icosphere4": _icosphere4,
    "multi_object": _multi_object,
}


@pytest.fixture
def python_meshlets(monkeypatch):
    """Packs with the Python meshlet loop, as where no host C++ compiler is
    found."""
    monkeypatch.setattr(scene.native_mod, "available", lambda: False)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_matches_reference(name, python_meshlets):
    """Scene.pack, meshlet and plain layouts, through the pure-Python
    meshlet builder: every array equal to the JAX package's."""
    ref = SCENES[name]()
    port = scene.scene_from_reference(ref)
    for meshlets in (True, False):
        want = ref.pack(meshlets=meshlets)
        got = port.pack(meshlets=meshlets)
        for k in PACKED_FIELDS:
            if getattr(want, k) is None:
                assert getattr(got, k) is None, k
            else:
                _same(getattr(got, k), getattr(want, k))
        for k in ("num_vertices", "num_triangles", "has_normals", "n_meshlets"):
            assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("name", ["random_dense", "icosphere4", "multi_object"])
def test_native_meshlets_match_python(name):
    """The port's C++ meshlet builder (csrc/meshlets.cpp, built here with
    the host compiler) gives the Python loop's arrays."""
    port = scene.scene_from_reference(SCENES[name]())
    assert scene.native_mod.available()
    fast = port.pack(meshlets=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene.native_mod, "available", lambda: False)
        slow = port.pack(meshlets=True)
    for k in PACKED_FIELDS:
        _same(getattr(fast, k), getattr(slow, k))


def test_scene_from_reference_carries_everything():
    from ash_renderer_tpu.textures import TextureAtlas, checkerboard

    ref = _multi_object()
    ref.light = ref_scene.DirectionalLight(direction=(0.2, -0.6, 0.75),
                                           ambient=0.3)
    ref.atlas = TextureAtlas.build([checkerboard(32)])
    port = scene.scene_from_reference(ref)
    assert isinstance(port, scene.Scene)
    assert [dataclasses.asdict(m) for m in port.materials] == [
        dataclasses.asdict(m) for m in ref.materials]
    assert dataclasses.asdict(port.light) == dataclasses.asdict(ref.light)
    for f in dataclasses.fields(port.atlas):
        _same(getattr(port.atlas, f.name), getattr(ref.atlas, f.name))
    _same(port.model_matrices(), ref.model_matrices())
    assert [(o.mesh, o.material) for o in port.objects] == [
        (o.mesh, o.material) for o in ref.objects]
    for pm, rm in zip(port.meshes, ref.meshes):
        for k in ("positions", "indices", "colors", "normals", "uvs"):
            _same(getattr(pm, k), getattr(rm, k))
    assert port.meshes[0].positions is not ref.meshes[0].positions


POSES = [
    dict(),
    dict(position=np.array([0.3, -0.2, 0.5], np.float32), theta=0.4),
    dict(position=np.array([1.02, 0.0, 1.5], np.float32), phi=1.2,
         theta=-0.7),
    dict(position=np.array([-2.0, 1.0, -3.0], np.float32), fovy=0.9,
         znear=0.1, zfar=50.0),
]


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_camera_matrices_match(pose):
    kw = POSES[pose]
    ref, port = ref_camera.Camera(**kw), camera.Camera(**kw)
    _same(port.forward(), ref.forward())
    _same(port.view_matrix(), ref.view_matrix())
    for aspect in (800 / 600, 1920 / 1080, 1.0):
        _same(port.projection_matrix(aspect), ref.projection_matrix(aspect))


def test_orbit_path_matches():
    for kw in (dict(), dict(radius=2.0, center=[0.0, 0.0, 2.0]),
               dict(radius=5.0, height=-1.5)):
        ref = ref_camera.orbit_path(8, **kw)
        port = camera.orbit_path(8, **kw)
        assert len(port) == len(ref) == 8
        for a, b in zip(port, ref):
            _same(a.position, b.position)
            assert (a.phi, a.theta) == (b.phi, b.theta)
            _same(a.view_matrix(), b.view_matrix())


def test_mathx_matches():
    eye, target = np.array([1.0, 2.0, -3.0]), np.array([0.2, -0.1, 4.0])
    up = np.array([0.0, -1.0, 0.0])
    _same(mathx.look_at_rh(eye, target, up), ref_mathx.look_at_rh(eye, target, up))
    _same(mathx.perspective(1.7, 45.0, 0.01, 100.0),
          ref_mathx.perspective(1.7, 45.0, 0.01, 100.0))
    for fn in ("rotation_x", "rotation_y", "rotation_z"):
        _same(getattr(mathx, fn)(0.37), getattr(ref_mathx, fn)(0.37))
    _same(mathx.scaling([1.0, 2.0, 0.5]), ref_mathx.scaling([1.0, 2.0, 0.5]))
    _same(mathx.translation([1, -2, 3]), ref_mathx.translation([1, -2, 3]))
    args = (mathx.translation([0, 0, 2.0]), mathx.rotation_y(0.6),
            mathx.rotation_x(0.3), mathx.scaling(1.5))
    _same(mathx.compose(*args), ref_mathx.compose(*args))
    _same(mathx.normalize([3.0, 4.0, 12.0]), ref_mathx.normalize([3.0, 4.0, 12.0]))


@pytest.mark.parametrize("size", [(800, 600), (1920, 1080), (192, 128),
                                  (150, 64)])
def test_raster_config_matches(size):
    w, h = size
    for tile_h in (8, 16):
        got = config.derive_raster_config(w, h, tile_h=tile_h)
        want = ref_config.derive_raster_config(w, h, tile_h=tile_h)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for k in ("subpixel_scale", "grid_h", "grid_w", "n_tiles", "min_coord",
                  "max_coord_x", "max_coord_y"):
            assert getattr(got, k) == getattr(want, k), k


def test_settings_match():
    assert dataclasses.asdict(config.RendererSettings()) == dataclasses.asdict(
        ref_config.RendererSettings())
    kw = dict(width=320, height=200, supersample=2, fused_surface_shade="on",
              front_coherence=False, clip_budget=64)
    port, ref = config.RendererSettings(**kw), ref_config.RendererSettings(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.render_width, port.render_height) == (
        ref.render_width, ref.render_height)


def test_frame_stats_summary():
    from ash_renderer_tpu_torch.profiling import FrameStats

    st = FrameStats(window=3)
    for i in range(5):
        st.record_dispatch(0.001 * (i + 1))
        st.record_frame(0.01, {"n_valid": torch.tensor(7 + i), "other": 1})
    out = st.summary()
    assert out["frames"] == 5 and out["n_valid"] == 11
    assert out["avg_dispatch_ms"] == pytest.approx(4.0)
    assert out["fps_host_loop"] == pytest.approx(100.0)
    assert "other" not in out


def test_write_png_is_a_plain_png(tmp_path):
    """The stdlib writer: signature, IHDR for 8-bit RGBA, one IDAT whose
    rows all use filter 0, and the pixels back (PIL reads it too)."""
    from PIL import Image

    from ash_renderer_tpu_torch.present import write_png

    frame = np.random.default_rng(1).integers(0, 256, (7, 5, 4), np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, frame)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data[12:16] == b"IHDR" and data[16:29] == (
        (5).to_bytes(4, "big") + (7).to_bytes(4, "big") + bytes([8, 6, 0, 0, 0]))
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8)
    raw = raw.reshape(7, 1 + 5 * 4)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(7, 5, 4), frame)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), frame)


def _imports(path):
    """Every module name a file imports (absolute, or resolved against the
    port package for relative imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.append(node.module or "")
            else:
                names.append("ash_renderer_tpu_torch")  # inside the package
    return names


def _port_files():
    pkg = os.path.join(ROOT, "ash_renderer_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    return files + [os.path.join(ROOT, "chip_smoke.py"),
                    os.path.join(ROOT, "experiments", "torch_profile_frame.py")]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """AST scan of every module of the port, chip_smoke.py and the frame
    profiler: no import of jax, jaxlib or ash_renderer_tpu (or a submodule)."""
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ash_renderer_tpu"):
                bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad
    # and nothing runs the JAX package's native build
    for path in files:
        with open(path) as f:
            assert "ash_renderer_tpu/native" not in f.read(), path
