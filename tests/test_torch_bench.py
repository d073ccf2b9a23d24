"""``bench_torch.py`` (the port's counterpart of ``bench.py``) and
``Renderer.warmup`` on the CPU at small sizes: the parity gate against the
port's oracle, the headline hash gate on the stored golden frames (and
config5's oracle branch without the reference's texture asset), the
fly-by path against ``bench.py``'s, whole runs in a process where jax is
blocked and in this one, and the refusal to run without a card."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from ash_renderer_tpu_torch import _build, benchmarks, camera  # noqa: E402
from ash_renderer_tpu_torch import pipeline as pl  # noqa: E402
from ash_renderer_tpu_torch.config import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402
from ash_renderer_tpu_torch.textures import checkerboard  # noqa: E402

torch.set_num_threads(1)
GOLDEN = os.path.join(ROOT, "docs", "golden")
KEYS = ("metric", "value", "unit", "vs_baseline")
CONFIG4_KEYS = ("moving_camera_fps", "orbit_camera_fps", "static_uncached_fps")


def golden_frame(name):
    return np.load(os.path.join(GOLDEN, name))["rgba8"]


# ---------------------------------------------------------------------------
# parity gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["classic", "fused"])
def test_parity_gate_is_exact_on_the_cpu(pipeline, capsys):
    assert bench_torch.parity_gate(pipeline, device="cpu") is True
    assert (f"parity gate (256x192, 160 tris, {pipeline}): EXACT"
            in capsys.readouterr().err)


@pytest.mark.parametrize("pipeline,fn", [("classic", "render_frame"),
                                         ("fused", "render_frame_fused")])
def test_parity_gate_fails_on_one_changed_pixel(pipeline, fn, monkeypatch,
                                                capsys):
    real = getattr(pl, fn)

    def one_pixel_off(*args, **kw):
        rgba8, aux = real(*args, **kw)
        rgba8 = rgba8.clone()
        rgba8[100, 128, 0] ^= 1
        return rgba8, aux

    monkeypatch.setattr(pl, fn, one_pixel_off)
    assert bench_torch.parity_gate(pipeline, device="cpu") is False
    assert "MISMATCH" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# headline hash gate
# ---------------------------------------------------------------------------

HEADLINES = [("headline_config4_s5_rgba8.npz", 5, "config4_million_tri"),
             ("headline_config4_rgba8.npz", 8, "config4_million_tri"),
             ("headline_terrain_rgba8.npz", 8, "config4_terrain")]


@pytest.mark.parametrize("npz,subdiv,config", HEADLINES)
def test_hash_gate_passes_the_stored_frames(npz, subdiv, config, capsys):
    frame = golden_frame(npz)
    assert bench_torch.headline_hash_gate(torch.from_numpy(frame), subdiv,
                                          config) is True
    assert "headline hash gate (1920x1080" in capsys.readouterr().err


@pytest.mark.parametrize("npz,subdiv,config", HEADLINES[:2])
def test_hash_gate_fails_one_flipped_pixel(npz, subdiv, config, capsys):
    frame = golden_frame(npz).copy()
    frame[540, 960, 1] ^= 0x80
    assert bench_torch.headline_hash_gate(frame, subdiv, config) is False
    err = capsys.readouterr().err
    assert "MISMATCH" in err
    assert "differing pixels: 1 / 2073600" in err


def test_hash_gate_without_a_golden_is_none(capsys):
    frame = np.zeros((8, 8, 4), np.uint8)
    assert bench_torch.headline_hash_gate(frame, 6, "config4_million_tri") is None
    assert "no golden for subdiv=6, skipped" in capsys.readouterr().err


@pytest.mark.parametrize("same", [True, False])
def test_config5_without_the_asset_is_held_to_the_oracle(same, monkeypatch,
                                                         capsys):
    """With no texture asset the stored config5 golden does not apply: the
    gate says so and decides by ``oracle_frame`` (stubbed here)."""
    monkeypatch.delenv(benchmarks.REFERENCE_TEXTURE_ENV, raising=False)
    stub = np.arange(600 * 800 * 4, dtype=np.uint32).astype(np.uint8)
    stub = stub.reshape(600, 800, 4)
    want = stub.copy()
    if not same:
        want[7, 9, 3] ^= 1
    calls = []

    def oracle(config):
        calls.append(config)
        return want

    monkeypatch.setattr(bench_torch, "oracle_frame", oracle)
    assert bench_torch.headline_hash_gate(stub, 8, "config5_flythrough") is same
    assert calls == ["config5_flythrough"]
    err = capsys.readouterr().err
    assert "headline hash gate: headline_config5.json skipped" in err
    verdict = "EXACT" if same else "MISMATCH"
    assert f"headline oracle gate (800x600, 34048 tris): {verdict}" in err
    if not same:
        assert "differing pixels: 1 / 480000" in err


def _write_png(path, side_h, side_w):
    from PIL import Image

    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (side_h, side_w, 4), np.uint8)).save(
        path)
    return path


def test_config5_with_the_asset_uses_its_golden(tmp_path, monkeypatch):
    monkeypatch.setenv(benchmarks.REFERENCE_TEXTURE_ENV,
                       _write_png(str(tmp_path / "t.png"), 64, 64))

    def no_oracle(config):
        raise AssertionError("the oracle branch ran with the asset present")

    monkeypatch.setattr(bench_torch, "oracle_frame", no_oracle)
    frame = golden_frame("headline_config5_rgba8.npz")
    assert bench_torch.headline_hash_gate(frame, 8, "config5_flythrough") is True


@pytest.mark.parametrize("case", ["unset", "missing", "not_square",
                                  "not_pow2", "not_an_image", "asset"])
def test_reference_texture_found_is_the_textures_own_test(case, tmp_path,
                                                          monkeypatch):
    env = benchmarks.REFERENCE_TEXTURE_ENV
    path = str(tmp_path / "t.png")
    if case == "unset":
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, path)
    if case == "not_an_image":
        (tmp_path / "t.png").write_bytes(b"not a png")
    elif case in ("not_square", "not_pow2", "asset"):
        _write_png(path, *{"not_square": (32, 64), "not_pow2": (48, 48),
                           "asset": (32, 32)}[case])
    found = benchmarks.reference_texture_found()
    assert found is (case == "asset")
    used_asset = not np.array_equal(benchmarks._reference_texture(),
                                    checkerboard(512))
    assert found is used_asset


def test_oracle_frame_equals_the_renderers_frame():
    scene, settings, cams = benchmarks.ALL_CONFIGS["reference"]()
    r = Renderer(scene, settings, device="cpu")
    frame = r.read_frame(r.render_frame(cams[0])[0])
    np.testing.assert_array_equal(bench_torch.oracle_frame("reference"), frame)


# ---------------------------------------------------------------------------
# fly-by path
# ---------------------------------------------------------------------------

def test_flyby_path_is_bench_pys():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench", os.path.join(ROOT, "bench.py"))
    ref = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):  # bench.py sets a jax cache variable
        spec.loader.exec_module(ref)
    got, want = bench_torch.flyby_path(24), ref.flyby_path(24)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert g.position.dtype == w.position.dtype
        np.testing.assert_array_equal(g.position, w.position)
        np.testing.assert_array_equal(g.view_matrix(), w.view_matrix())
        np.testing.assert_array_equal(g.projection_matrix(16 / 9),
                                      w.projection_matrix(16 / 9))


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

# the finder of tests/test_torch_frame.py::test_port_never_imports_jax
_NO_JAX = textwrap.dedent("""
    import runpy, sys

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ash_renderer_tpu"):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, NoJax())
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ash_renderer_tpu")]
""")


def run_bench(*args, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    env.pop("PYTHONPATH", None)  # the script puts the repo on sys.path
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX, os.path.join(ROOT, "bench_torch.py"),
         *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cpu_run_without_jax_prints_one_json_line():
    out = run_bench("--device", "cpu", "--config", "reference", "--frames", "2")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert sorted(res) == sorted(KEYS)
    assert res["metric"] == "frames/sec at 800x600 on reference (2 tris)"
    assert res["value"] > 0 and res["unit"] == "fps"
    assert res["vs_baseline"] == round(res["value"] / 60.0, 4)
    assert "parity gate (256x192, 160 tris, classic): EXACT" in out.stderr
    assert "device: cpu" in out.stderr


def test_without_device_it_refuses_to_run_with_no_card():
    out = run_bench("--frames", "1", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


def small_config4(monkeypatch):
    real = benchmarks.config4_million_tri

    def small(subdiv=8):
        scene, settings, cams = real(subdiv)
        return scene, RendererSettings(width=256, height=192), cams

    monkeypatch.setattr(benchmarks, "config4_million_tri", small)
    return small


def test_config4_run_walks_the_motion_branches(monkeypatch, capsys):
    """config4 (subdiv 3, 256x192, fused) through the fly-by, the orbit, the
    uncached control and the post-motion re-gate; the gate (stubbed, since
    no golden exists at this size) sees the first frame and the post-motion
    frame, which must be byte-equal."""
    small_config4(monkeypatch)
    seen = []

    def gate(rgba8, subdiv, config):
        seen.append((bench_torch.host(rgba8).copy(), subdiv, config))
        return True

    monkeypatch.setattr(bench_torch, "headline_hash_gate", gate)
    res = bench_torch.main(["--device", "cpu", "--subdiv", "3", "--pipeline",
                            "fused", "--frames", "1"])
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1]) == res
    assert sorted(res) == sorted(KEYS + CONFIG4_KEYS)
    assert "[" not in res["metric"]
    assert res["metric"] == "frames/sec at 256x192 on config4_million_tri (1280 tris)"
    assert all(res[k] > 0 for k in ("value",) + CONFIG4_KEYS)
    for line in ("parity gate (256x192, 160 tris, fused): EXACT",
                 "front cache hit: the warm-up frame's camera",
                 "moving camera (fly-by)", "frames with clips",
                 "moving camera (orbit, coverage-constant)",
                 "static pose, front cache disabled",
                 "post-motion static re-gate: EXACT"):
        assert line in err
    assert [(s, c) for _, s, c in seen] == [(3, "config4_million_tri")] * 2
    np.testing.assert_array_equal(seen[0][0], seen[1][0])
    assert seen[0][0].shape == (192, 256, 4) and seen[0][0][..., 0].max() > 0


def tiny_config4(width=64, height=48, **kw):
    scene, _, cams = benchmarks.config4_million_tri(2)
    return scene, RendererSettings(width=width, height=height, **kw), cams


@pytest.mark.parametrize("parity", ["fails", "raises"])
def test_failed_gates_flag_the_metric(parity, monkeypatch, capsys):
    """A parity gate that fails or raises, and a hash gate that fails, each
    flag ``metric``; terrain's gate is reached with its scene made tiny."""
    def gate(pipeline, device):
        if parity == "raises":
            raise RuntimeError("no frame")
        return False

    monkeypatch.setattr(bench_torch, "parity_gate", gate)
    monkeypatch.setattr(bench_torch, "headline_hash_gate", lambda *a: False)
    monkeypatch.setitem(benchmarks.ALL_CONFIGS, "config4_terrain",
                        lambda: tiny_config4(pipeline="fused"))
    res = bench_torch.main(["--device", "cpu", "--config", "config4_terrain",
                            "--frames", "1"])
    assert res["metric"] == ("frames/sec at 64x48 on config4_terrain (320 "
                             "tris) [PARITY GATE FAILED] [HEADLINE HASH "
                             "MISMATCH]")
    assert sorted(res) == sorted(KEYS)
    err = capsys.readouterr().err
    assert ("parity gate error: RuntimeError('no frame')" in err) is (
        parity == "raises")


def test_sweep_runs_every_config_and_reports_the_headline(monkeypatch,
                                                          capsys):
    configs = {
        "reference": lambda: tiny_config4(),  # 320 triangles: auto -> classic
        "config4_million_tri": lambda: tiny_config4(96, 64, pipeline="fused"),
    }
    monkeypatch.setattr(benchmarks, "ALL_CONFIGS", configs)
    res = bench_torch.main(["--device", "cpu", "--sweep", "--frames", "2"])
    out, err = capsys.readouterr()
    assert out.splitlines() == [json.dumps(res)]
    assert res["metric"] == ("frames/sec at 96x64 on config4_million_tri "
                             "(320 tris) [sweep]")
    assert res["value"] > 0
    assert "reference" in err and "[classic] warmup   0.0s" in err
    assert "[fused] warmup" in err


# ---------------------------------------------------------------------------
# Renderer.warmup
# ---------------------------------------------------------------------------

def test_warmup_signature_is_the_references():
    import inspect

    from ash_renderer_tpu.renderer import Renderer as RefRenderer

    assert (str(inspect.signature(Renderer.warmup))
            == str(inspect.signature(RefRenderer.warmup)))


def _refuse_builds(monkeypatch):
    """Make building or loading a kernel library raise (the host libraries,
    the meshlet builder's, stay allowed)."""
    real_build, real_load = _build.build, _build.load

    def build(sources=tuple(_build.KERNELS), **kw):
        assert not set(sources) & set(_build.KERNELS), sources
        return real_build(sources, **kw)

    def load(source):
        assert source not in _build.KERNELS, source
        return real_load(source)

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "load", load)


@pytest.mark.parametrize("pipeline", ["fused", "classic"])
def test_warmup_on_the_cpu_builds_nothing_and_keeps_the_bits(
        pipeline, monkeypatch, capsys):
    """A CPU renderer's warm-up renders one frame at ``Camera()`` and
    builds nothing; the frames after it (the warm-up camera's, served from
    the front cache on "fused", and a moved one) equal a fresh renderer's
    byte for byte."""
    _refuse_builds(monkeypatch)
    cams = [camera.Camera(),
            camera.orbit_path(8, radius=2.0, center=[0.0, 0.0, 2.0])[3]]
    frames = []
    for warm in (True, False):
        r = Renderer(*tiny_config4(pipeline=pipeline)[:2], device="cpu")
        if warm:
            dt = r.warmup(verbose=True)
            assert isinstance(dt, float) and dt >= 0
        frames.append([r.read_frame(r.render_frame(c)[0]) for c in cams])
    assert "warmup: real frame done" in capsys.readouterr().err
    for got, want in zip(*frames):
        np.testing.assert_array_equal(got, want)
    assert frames[0][0][..., 0].max() > 0


def test_warmup_without_execute_renders_nothing(monkeypatch):
    _refuse_builds(monkeypatch)
    r = Renderer(*tiny_config4()[:2], device="cpu")

    def no_frame(*a, **kw):
        raise AssertionError("warmup(execute=False) rendered a frame")

    monkeypatch.setattr(r, "render_frame", no_frame)
    assert r.warmup(execute=False) >= 0


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("pipeline,sources", [
    ("fused", _build.ROUTE_SOURCES["fused"]),
    ("classic", _build.ROUTE_SOURCES["classic"]),
])
def test_warmup_on_a_card_builds_the_routes_libraries(pipeline, sources,
                                                      parallel, monkeypatch):
    """On a CUDA device the route's sources are built in one call (all
    nvcc processes together) or one call each, then loaded.  The device is
    named CUDA here without a card; ``execute=False`` launches nothing."""
    r = Renderer(*tiny_config4(pipeline=pipeline)[:2], device="cpu")
    r.device = torch.device("cuda", 0)
    calls = []
    monkeypatch.setattr(_build, "build", lambda s: calls.append(("build", s)))
    monkeypatch.setattr(_build, "load", lambda s: calls.append(("load", s)))
    r.warmup(parallel=parallel, execute=False)
    builds = ([("build", sources)] if parallel
              else [("build", (s,)) for s in sources])
    assert calls == builds + [("load", s) for s in sources]
    assert set(sources) <= set(_build.KERNELS)


@pytest.mark.parametrize("config", ["reference", "config2_multi_mesh"])
def test_warmup_builds_the_cuda_auto_routes_libraries(config, monkeypatch):
    """A small scene's settings resolved by the CUDA branch of the auto
    rule (``renderer.auto_route``, called here without a card): warm-up
    builds and loads the sources of the route it resolved to
    (``_build.ROUTE_SOURCES``: the fused route's seven, K7's with them, or
    the classic route's K10, with the transform folded in, K12, K4 and
    K11)."""
    from ash_renderer_tpu_torch.renderer import auto_route

    scene, settings, _ = benchmarks.ALL_CONFIGS[config]()
    settings = dataclasses.replace(settings, width=64, height=48)
    st = auto_route(settings, torch.device("cuda", 0),
                    sum(m.num_triangles for m in scene.meshes))
    r = Renderer(scene, st, device="cpu")
    assert r.settings == st
    r.device = torch.device("cuda", 0)
    calls = []
    monkeypatch.setattr(_build, "build", lambda s: calls.append(("build", s)))
    monkeypatch.setattr(_build, "load", lambda s: calls.append(("load", s)))
    r.warmup(execute=False)
    sources = _build.ROUTE_SOURCES[st.pipeline]
    assert calls == [("build", sources)] + [("load", s) for s in sources]
    assert st.fused_surface_shade == "on"


# each route's wrappers (module of ``ash_renderer_tpu_torch.ops``,
# function) and the kernel each launches, as ``chip_smoke.route_kernels``
# requires them of a frame; the Renderer packs the classic route plainly,
# so K5 is not among them
ROUTE_WRAPPERS = {
    "classic": {("geometry", "stage_geometry_rows"): "K10",
                ("binning", "bin_rows"): "K12",
                ("raster_visibility", "rasterize_visibility"): "K4",
                ("shade", "shade_pack_classic"): "K11"},
    "fused": {("vertex_transform", "transform_vertices_T"): "K8",
              ("setup_kernel", "triangle_setup"): "K1",
              ("clip_tail", "clip_tail"): "K6",
              ("bincount", "sorted_run_bounds"): "K2",
              ("front_meta", "front_meta"): "K9",
              ("fused_kernel", "rasterize_distribute"): "K3",
              ("shade_pack", "shade_pack"): "K7"},
}


def _launches_of(module, fn_name):
    """(kernel name or None, entry point) of each ``_build.launch`` call in
    ``module``'s function ``fn_name``; a kernel name given by a module
    constant is resolved, one computed by a call is None."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    out = []
    for c in ast.walk(fn):
        if (isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr == "launch"
                and getattr(c.func.value, "id", None) == "_build"):
            name = c.args[0]
            out.append((getattr(module, name.id)
                        if isinstance(name, ast.Name) else None,
                        c.args[1].value))
    return out


@pytest.mark.parametrize("route", sorted(ROUTE_WRAPPERS))
def test_route_sources_hold_the_routes_kernels(route):
    """``_build.ROUTE_SOURCES[route]``, which ``Renderer.warmup`` builds,
    is the set of sources of the entry points the route's wrappers launch
    (``_build._ENTRY_SOURCE``), each wrapper's kernel name the one the
    route's frame counts (K3 and K3F at both tile heights for K3's
    wrapper); on the classic route ``pipeline.render_frame``
    calls each of them."""
    import importlib
    import inspect

    from ash_renderer_tpu_torch.ops import fused_kernel as fk

    sources = set()
    for (mod, fn), kernel in ROUTE_WRAPPERS[route].items():
        module = importlib.import_module(f"ash_renderer_tpu_torch.ops.{mod}")
        launches = _launches_of(module, fn)
        assert launches, f"{mod}.{fn} launches nothing"
        for name, entry in launches:
            names = ({fk.kernel_name(th, f) for th in fk.TILE_HEIGHTS
                      for f in (False, True)} if name is None else {name})
            # K3's entry is K3 or K3F by its shade flag
            assert all(n.split("_")[0] in (kernel, kernel + "F")
                       for n in names), (fn, names)
            sources.add(_build._ENTRY_SOURCE[entry])
    assert sources == set(_build.ROUTE_SOURCES[route])
    if route == "classic":
        body = inspect.getsource(pl.render_frame)
        for mod, fn in ROUTE_WRAPPERS[route]:
            assert f"{mod}.{fn}(" in body, fn
