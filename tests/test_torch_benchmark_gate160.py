"""The benchmark's classic-route cell, ``gate160-orbit``, on the CPU: its
scene is bench.py's parity-gate scene as ``bench_torch.parity_gate``
builds it, array for array, at the app's default size; "auto" sends it
to the classic route on a card (and on the CPU); its orbit keeps every
vertex in frame; its stored
frames are the port's oracle's; a run of its path holds every gated frame
to the oracle bit for bit, reports the classic route's stages and K4 and
nothing of the fused route's, and fails on a flipped byte."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_torch  # noqa: E402
from torch_bench_small import (CLASSIC_METRICS, FOLDED_STAGES,  # noqa: E402,F401
                               FUSED_ONLY, last_line, no_foreign)
from ash_renderer_tpu_torch import pipeline, renderer  # noqa: E402
from ash_renderer_tpu_torch.camera import Camera  # noqa: E402
from ash_renderer_tpu_torch.config import RendererSettings  # noqa: E402
from benchmark import cells, golden, run, scenes  # noqa: E402

CELL = "gate160-orbit"


def in_frame(packed, model_mats, cam, aspect: float) -> float:
    """The share of ``packed``'s vertices (padding rows left out) that
    camera ``cam`` sees inside its view volume: clip w > 0 and every
    normalized coordinate within [-1, 1]."""
    view, proj = cam.view_matrix(), cam.projection_matrix(aspect)
    n = packed.num_vertices
    mvp = (proj @ view @ np.asarray(model_mats, np.float32)).astype(np.float64)
    obj = packed.vert_obj[:n]
    p = np.concatenate([packed.positions[:n], np.ones((n, 1))], axis=1)
    inside = 0
    for o in np.unique(obj):
        clip = p[obj == o] @ mvp[o].T
        w = clip[:, 3:]
        inside += int(np.sum((w[:, 0] > 0)
                             & np.all(np.abs(clip[:, :3]) <= w, axis=1)))
    return inside / n


def test_the_scene_is_the_parity_gates(monkeypatch):
    """``scenes.gate160``'s positions, indices and colours are the ones
    ``bench_torch.parity_gate`` draws, array for array, at its pose; its
    size is the app's default (``RendererSettings()``, 800x600), where the
    gate renders 256x192; the gate itself passes on the CPU."""
    seen = {}
    real_mesh, real_settings = bench_torch.Mesh, bench_torch.RendererSettings

    def mesh(**kw):
        seen["mesh"] = kw
        return real_mesh(**kw)

    def settings(**kw):
        seen["settings"] = kw
        return real_settings(**kw)

    monkeypatch.setattr(bench_torch, "Mesh", mesh)
    monkeypatch.setattr(bench_torch, "RendererSettings", settings)
    assert bench_torch.parity_gate("classic", device="cpu")
    scene, st, cams = scenes.gate160()
    (m,) = scene.meshes
    for name in ("positions", "indices", "colors"):
        want = seen["mesh"][name]
        got = getattr(m, name)
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert (seen["settings"]["width"], seen["settings"]["height"]) == (
        256, 192)
    assert (st.width, st.height, st.supersample) == (
        RendererSettings().width, RendererSettings().height, 1) == (800, 600, 1)
    assert st.pipeline == "auto"
    assert len(scene.objects) == 1 and scene.atlas is None
    assert scene.light is None and len(scene.materials) == 1
    assert cells.camera_key(cams[0]) == cells.camera_key(Camera())
    assert m.num_triangles == scenes.GATE_TRIS


@pytest.mark.parametrize("n_tris, route", [
    (scenes.GATE_TRIS, "classic"),
    (renderer.CUDA_AUTO_FUSED_TRIS - 1, "classic"),
    (renderer.CUDA_AUTO_FUSED_TRIS, "fused"),
])
def test_auto_routes_the_gate_scene_to_classic_on_a_card(n_tris, route):
    """``renderer.auto_route`` is a function of the device's name: on a
    "cuda" device 160 triangles take the classic route, 320 the fused
    one; on the CPU the gate scene is classic too (``golden.py`` renders
    the stored frames on that route)."""
    st = scenes.gate160()[1]
    assert renderer.auto_route(st, "cuda", n_tris).pipeline == route
    assert renderer.auto_route(st, "cpu", scenes.GATE_TRIS).pipeline == (
        "classic")


def test_cells_load_reads_the_seven_cells():
    got = cells.load()
    assert len(got) == 7
    assert list(got)[-1] == CELL
    assert got[CELL].chips == 1 and got[CELL].slabs == 1
    scene, st, static = cells.scene_of(got[CELL])
    assert sum(m.num_triangles for m in scene.meshes) == scenes.GATE_TRIS


@pytest.mark.parametrize("seed", range(3))
def test_the_orbit_keeps_the_cloud_in_frame(seed):
    """At radius 6 the camera stays outside the cloud's box (its farthest
    corner 2 sqrt 3 from the center) and sees every vertex on every frame
    of the 240-frame path, whatever the start angle."""
    cell = cells.load()[CELL]
    scene, st, _ = cells.scene_of(cell)
    packed = scene.pack()
    mm = scene.model_matrices()
    corner = np.abs(packed.positions[:packed.num_vertices]
                    - np.asarray(cell.path["center"], np.float32)).max(0)
    assert np.linalg.norm(corner) < cell.path["radius"]
    aspect = st.render_width / st.render_height
    shares = [in_frame(packed, mm, cam, aspect)
              for cam in cells.path_of(cell, cells.FRAMES, seed)]
    assert min(shares) == 1.0


def test_the_stored_frames_are_the_oracles(monkeypatch):
    """Every frame of ``benchmark/golden/gate160-orbit.json``, the static
    pose among them, is the port's oracle's at its camera."""
    monkeypatch.setattr(golden, "_RENDERERS", {})
    cell = cells.load()[CELL]
    stored = run.load_golden(cell)
    static = cells.scene_of(cell)[2]
    assert stored["static"]["camera"] == cells.camera_key(static)
    assert stored["static"]["sha256"] == golden.oracle_sha(cell.config, static)
    for n, entries in stored["frames"].items():
        cams = cells.path_of(cell, int(n), stored["seed"])
        for e in entries:
            assert e["sha256"] == golden.oracle_sha(cell.config,
                                                    cams[e["frame"]]), e


def test_a_run_is_bit_equal_to_the_oracle(no_foreign, capsys):
    """A 24-frame run on the CPU (the plain versions) takes the classic
    route, holds its static pose to the stored frame and both path frames
    to the stored frames and to the oracle, and reports the classic
    route's stages (stage and host ms) and K4, nothing fused-only."""
    assert run.main(["--cell", CELL, "--device", "cpu", "--frames",
                     "24"]) == 0
    out = capsys.readouterr().out
    assert "; route classic, " in out and "front cache off" in out
    assert out.count("gate static pose") == 2
    assert "(benchmark/golden/gate160-orbit.json (static))" in out
    assert out.count("stored frame EXACT; the port's numpy oracle EXACT") == 2
    last = last_line(out)
    assert last["correct"] is True and last["gated_frames"] == 4
    m = last["metrics"]
    assert set(m) == set(CLASSIC_METRICS)
    assert not FUSED_ONLY & set(m)
    for s in run.CLASSIC_STAGES:
        if s in FOLDED_STAGES:
            assert (m[f"stage_ms.{s}"] == m[f"stage_host_ms.{s}"]
                    == "not reached"), s
        else:
            assert m[f"stage_ms.{s}"] > 0 and m[f"stage_host_ms.{s}"] > 0, s
    assert m["K4_ms"] == "not measured"


def test_a_flipped_byte_fails_the_run(no_foreign, monkeypatch, capsys):
    """The oracle gate is live: one byte off in the quarter frame of the
    classic route fails that gate and the run."""
    cell = cells.load()[CELL]
    gated = cells.path_of(cell, 12, cells.DEFAULT_SEED)[3]
    real = pipeline.render_frame

    def one_byte_off(statics, state, mm, mvp, cam_pos, **kw):
        rgba8, aux = real(statics, state, mm, mvp, cam_pos, **kw)
        if np.array_equal(cam_pos.numpy(), gated.position):
            rgba8 = rgba8.clone()
            rgba8[100, 120, 2] ^= 1
        return rgba8, aux

    monkeypatch.setattr(pipeline, "render_frame", one_byte_off)
    monkeypatch.setattr(renderer, "render_frame", one_byte_off)
    assert run.main(["--cell", CELL, "--device", "cpu", "--frames", "12",
                     "--no-trace"]) == 1
    out = capsys.readouterr().out
    assert "gate frame 3 (quarter): FAILED" in out
    assert "the port's numpy oracle MISMATCH (1 px)" in out
    assert "gate frame 9 (three quarters): EXACT" in out
    assert last_line(out)["failed_frames"] == 1
