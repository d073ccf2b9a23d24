"""The port's benchmark (``benchmark/``) on the CPU at small sizes: every
cell's run prints every metric with its unit and holds its gated frames
exact, the seeded camera paths, the stored frames of the default seed
(``benchmark/golden``) against the paths, ``BENCHMARK.json`` as the one
source of the cells (a cell added there runs with no code changed), the
walk at the App camera's speed, the spread's bound rule, the refusal to
run without a card and an import scan (no jax, nothing of the JAX
package).  The gates' failure paths and the
golden-making procedure are in ``test_torch_benchmark_gates.py``."""

import ast
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_bench_small import (ARGS, CLASSIC_METRICS,  # noqa: E402,F401
                               FOLDED_METRICS, METRICS, no_foreign, small,
                               last_line as _last)
from benchmark import cells, readings, run, spread  # noqa: E402

CELLS = cells.load()
# the cells the card renders on the classic route ("auto" under
# renderer.CUDA_AUTO_FUSED_TRIS triangles; test_torch_benchmark_gate160.py)
CLASSIC_CELLS = {"gate160-orbit"}
with open(cells.BENCHMARK_JSON) as _f:
    DECLARED = {m["name"]: m for m in json.load(_f)["metrics"]}


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_run_prints_every_metric_and_holds_its_gates(cell, small, capsys):
    assert run.main(["--cell", cell, *ARGS]) == 0
    out = capsys.readouterr().out
    classic = "; route classic, " in out
    assert classic == (cell in CLASSIC_CELLS)
    for name, unit in (CLASSIC_METRICS if classic else METRICS).items():
        line = next((ln for ln in out.splitlines()
                     if ln.startswith(f"{name} = ")), None)
        assert line is not None, name
        assert line.split(" = ", 1)[1].split("  (")[0].endswith(unit), line
    assert "fps = " in out
    last = _last(out)
    assert last["correct"] is True and last["failed_frames"] == 0
    assert last["gated_frames"] == 4  # static twice, two path frames
    assert last["metrics"]["gated_frames_exact"] == 4
    assert last["metrics"]["frame_ms_p50"] > 0
    if CELLS[cell].slabs == 1 and not classic:
        assert "front_cache_hit_share" in last["metrics"]
    if cell == "config4-static-cached":
        assert last["metrics"]["front_cache_hit_share"] == 1.0
    if cell == "terrain-walk":
        assert "(first clipped): EXACT" in out
    assert len(last["slow_frames"]) == 5
    assert out.count("slow frame ") == 5
    # every metric of the last line is declared, and each declared metric
    # reads a number exactly in the cells its list names (a reading the
    # machine hides prints "not shown"); device-only ones by name (the
    # CPU's K3 stands for the card's K3F)
    k3 = "K3F" if "K3F_ms" in last["metrics"] else "K3"
    got = {k.replace(f"{k3}_", "K3F_", 1) if k.startswith(f"{k3}_") else k: v
           for k, v in last["metrics"].items()}
    assert set(got) <= set(DECLARED), sorted(set(got) - set(DECLARED))
    for name, m in DECLARED.items():
        if m.get("device_only"):
            assert name in got or cell not in m["workloads"], name
            continue
        v = got.get(name)
        if cell in CLASSIC_CELLS and name in FOLDED_METRICS:
            assert v == "not reached", (name, v)
            continue
        reads = _is_number(v) or v == readings.NOT_SHOWN
        assert reads == (cell in m["workloads"]), (name, v)


def test_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--cell", "config4-orbit"])


@pytest.mark.parametrize("cell", sorted(c.name for c in CELLS.values()
                                        if c.path["kind"] != "static"))
def test_cameras_come_from_the_seed(cell):
    c = CELLS[cell]
    keys = [[cells.camera_key(cam) for cam in cells.path_of(c, 24, seed)]
            for seed in (0, 0, 1)]
    assert keys[0] == keys[1]
    assert keys[0] != keys[2]
    assert len({tuple(k) for k in keys[0]}) == 24  # every frame moves
    # frame 10 i of 240 is frame i of 24
    long = cells.path_of(c, 240, 0)
    assert [cells.camera_key(long[10 * i]) for i in range(24)] == keys[0]


def test_gated_frames():
    flyby = CELLS["config4-flyby"]
    cams = cells.path_of(flyby, 240, 0)
    gates = cells.gated_frames(flyby, cams, None)
    i = next(k for k, why in gates.items() if why == "closest approach")
    assert abs(float(cams[i].position[2]) - 2.0) <= 6.0 / 240 / 2 + 1e-6
    walk = CELLS["terrain-walk"]
    cams = cells.path_of(walk, 24, 0)
    assert cells.gated_frames(walk, cams, [0, 0, 0, 5] + [1] * 20) == {
        12: "half", 3: "first clipped"}
    assert cells.gated_frames(walk, cams, [0] * 24)[None] == "first clipped"


@pytest.mark.parametrize("name", sorted({c.golden for c in CELLS.values()
                                         if c.golden}))
def test_stored_frames_match_the_paths(name):
    """Each stored frame's camera is its path's frame for the default
    seed, at 240 and 24 frames, for every cell that names the file."""
    with open(os.path.join(ROOT, name)) as f:
        doc = json.load(f)
    users = [c for c in CELLS.values() if c.golden == name]
    assert doc["cell"] == users[0].name
    assert len({(c.config, json.dumps(c.path), c.gates) for c in users}) == 1
    cell = users[0]
    assert doc["seed"] == cells.DEFAULT_SEED
    assert sorted(doc["frames"]) == ["24", "240"]
    for n, entries in doc["frames"].items():
        cams = cells.path_of(cell, int(n), doc["seed"])
        whys = cells.gated_frames(cell, cams, [1] * int(n)).values()
        assert sorted(e["why"] for e in entries) == sorted(whys)
        for e in entries:
            assert e["camera"] == cells.camera_key(cams[e["frame"]])
            assert len(e["sha256"]) == 64


def test_benchmark_json_names_the_cells():
    """BENCHMARK.json names the seven cells once each, every one on one
    chip, config4-orbit-8slabs-1chip alone in row slabs (8 on one card,
    on config4-orbit's path, gates and stored frames), gate160-orbit on
    the gate scene with its static pose stored beside its path frames,
    every end-to-end metric with a bound, and every file a cell names
    exists."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = [w["name"] for w in bench["workloads"]]
    assert sorted(names) == sorted(CELLS) == sorted(
        ["config4-static-cached", "config4-orbit", "config4-flyby",
         "terrain-walk", "config5-flythrough", "config4-orbit-8slabs-1chip",
         "gate160-orbit"])
    gate = CELLS["gate160-orbit"]
    assert (gate.config, gate.path, gate.gates) == (
        "gate160", {"kind": "orbit", "radius": 6.0,
                    "center": [0.0, 0.0, 3.5], "height": 0.0},
        ("quarter", "three quarters"))
    assert gate.static_golden == gate.golden == (
        "benchmark/golden/gate160-orbit.json")
    assert len(set(names)) == len(names)
    assert all(c.chips == 1 for c in CELLS.values())
    assert {c.name: c.slabs for c in CELLS.values() if c.slabs != 1} == {
        "config4-orbit-8slabs-1chip": 8}
    slab, orbit = CELLS["config4-orbit-8slabs-1chip"], CELLS["config4-orbit"]
    assert (slab.config, slab.path, slab.gates, slab.static_golden,
            slab.golden) == (orbit.config, orbit.path, orbit.gates,
                             orbit.static_golden, orbit.golden)
    end_to_end = [m["name"] for m in bench["metrics"] if m["end_to_end"]]
    assert end_to_end == ["frame_ms_p50", "frame_ms_p95"]
    for w in bench["workloads"]:
        for m in end_to_end:
            assert w["bounds"][m] > 0
    for c in CELLS.values():
        for rel in filter(None, (c.static_golden, c.golden)):
            assert os.path.exists(os.path.join(ROOT, rel)), rel
    assert bench["seed"] == cells.DEFAULT_SEED


@pytest.mark.parametrize("slabs", [2, 3])
def test_a_cell_added_to_the_json_runs(slabs, small, tmp_path, monkeypatch,
                                       capsys):
    """A workload added to BENCHMARK.json (here: the orbit in another
    number of row slabs on one chip than the 8-slab cell's) runs with no
    code changed, and holds its gates."""
    with open(cells.BENCHMARK_JSON) as f:
        bench = json.load(f)
    orbit = next(w for w in bench["workloads"] if w["name"] == "config4-orbit")
    name = f"config4-orbit-{slabs}slabs-1chip"
    bench["workloads"].append({**orbit, "name": name, "slabs": slabs})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    monkeypatch.setattr(cells, "BENCHMARK_JSON", str(path))
    assert run.main(["--cell", name, *ARGS]) == 0
    out = capsys.readouterr().out
    assert f"{slabs} slab(s) on cpu" in out
    assert _last(out)["gated_frames"] == 4


def test_a_cell_named_twice_is_refused(tmp_path):
    with open(cells.BENCHMARK_JSON) as f:
        bench = json.load(f)
    bench["workloads"].append(bench["workloads"][0])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="named twice"):
        cells.load(str(path))


def test_the_walk_moves_at_the_app_cameras_speed():
    """The walk moves as far a frame as the App's CameraController does
    an update (``App(speed=)``'s default) over the 240 timed frames."""
    import inspect

    from ash_renderer_tpu_torch.app import App

    speed = inspect.signature(App).parameters["speed"].default
    cams = cells.path_of(CELLS["terrain-walk"], cells.FRAMES, 0)
    steps = [float(np.linalg.norm(b.position - a.position))
             for a, b in zip(cams, cams[1:])]
    assert np.allclose(steps, speed, rtol=1e-3)


@pytest.mark.parametrize("planted, refused", [
    ("jax", True), ("jaxlib.xla_client", True), ("flax", True),
    ("ash_renderer_tpu.renderer", True), ("ash_renderer_tpu_torch_extra", False),
])
def test_a_run_is_refused_when_the_process_holds_jax(
        planted, refused, no_foreign, monkeypatch, capsys):
    """Once the run is over, a module of JAX or of the JAX package in the
    process (here a planted stand-in) refuses it: ``correct`` false, the
    modules named, exit 1, whatever its gates; the port's own names do
    not."""
    def fake_run(cell, seed, device, frames, trace):
        rep = run.Report(cell, seed, frames, torch.device(device))
        rep.gate("static pose before the path", True)
        monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
        return rep

    monkeypatch.setattr(run, "run", fake_run)
    assert run.main(["--cell", "config4-orbit", *ARGS]) == (
        1 if refused else 0)
    out = capsys.readouterr().out
    last = _last(out)
    assert last["correct"] is (not refused)
    assert last["refused"] == ([f"the process holds modules of JAX or of the "
                                f"JAX package: {planted}"] if refused else [])
    assert ("refused: " in out) is refused


def _aa_call(tmp_path, tag, values, metric="frame_ms_p50",
             frames=cells.FRAMES):
    """A call's JSON as ``spread.py`` writes it: the runs alternate A, B."""
    sides = ["AB"[k % 2] for k in range(len(values))]
    (tmp_path / f"{tag}.json").write_text(json.dumps({
        "tag": tag, "frames": frames,
        "table": {f"x {metric}": spread.aa_row(values, sides)}}))


def test_the_bound_covers_the_spread_within_and_across_calls(
        tmp_path, monkeypatch, capsys):
    """The A/A rule: the bound is the larger of 2 x the widest gap between
    the medians of sides A and B of any call and 2 x the widest quartile
    distance of any call, each a share of its call's median."""
    monkeypatch.setattr(spread, "OUT_DIR", str(tmp_path))
    flat = [10.0] * 10
    _aa_call(tmp_path, "a", flat)
    _aa_call(tmp_path, "b", flat)
    # the gap term, on rows whose gap exceeds their quartile distance: 2 x
    # the widest gap (3%), beyond 2 x the widest quartile distance (2%)
    rows = [{"gap_share": 0.03, "quartile_share": 0.01},
            {"gap_share": 0.02, "quartile_share": 0.005}]
    assert spread.bound_of(rows) == (0.06, "A/A gap")
    # side A (runs 0, 2, ...) 10, side B 11: a gap of 1 over the call's
    # median 10.5, the quartiles 10 and 11 as wide: both terms 19.05%
    _aa_call(tmp_path, "gap", [10.0, 11.0] * 5)
    row = json.loads((tmp_path / "gap.json").read_text())["table"][
        "x frame_ms_p50"]
    assert (row["median_a"], row["median_b"], row["median"]) == (
        10.0, 11.0, 10.5)
    assert row["gap_share"] == row["quartile_share"] == 1 / 10.5
    assert spread.combine(["a", "b", "gap"]) == {
        "x": {"frame_ms_p50": math.ceil(2 * 100 / 10.5) / 100}}
    # the quartile floor: both sides alike (a zero gap), but the runs
    # spread: Q1 9, Q3 11 of median 10, so 2 x 20%
    _aa_call(tmp_path, "spread", [9.0, 9.0, 9.0, 9.0, 10.0, 10.0, 11.0, 11.0,
                                  11.0, 11.0])
    row = json.loads((tmp_path / "spread.json").read_text())["table"][
        "x frame_ms_p50"]
    assert row["gap_share"] == 0.0
    assert (row["q1"], row["q3"]) == (9.0, 11.0)
    assert spread.combine(["a", "b", "spread"]) == {"x": {"frame_ms_p50": 0.4}}
    assert spread.bound_of([row]) == (0.4, "quartiles")
    out = capsys.readouterr().out
    assert "| x | frame_ms_p50 |" in out
    assert "(A/A gap) |" in out and "(quartiles) |" in out
    # the widest of each term over the calls
    assert spread.combine(["gap", "spread", "a"]) == {
        "x": {"frame_ms_p50": 0.4}}
    with pytest.raises(SystemExit):
        spread.main(["--combine", "a", "b"])  # fewer than 3 calls


def test_a_longer_window_sets_no_bound(tmp_path, monkeypatch):
    """A call run with another path length than the benchmark's
    (``spread.py --frames``) is refused by ``--combine``: the bounds hold
    the benchmark's own window."""
    monkeypatch.setattr(spread, "OUT_DIR", str(tmp_path))
    for tag in ("a", "b"):
        _aa_call(tmp_path, tag, [10.0] * 10)
    _aa_call(tmp_path, "long", [10.0] * 10, frames=10 * cells.FRAMES)
    with pytest.raises(SystemExit, match="long: 2400 frames a run"):
        spread.combine(["a", "b", "long"])
    _aa_call(tmp_path, "c", [10.0] * 10)
    assert spread.combine(["a", "b", "c"]) == {"x": {"frame_ms_p50": 0.0}}


@pytest.mark.parametrize("seed", range(3))
def test_an_aa_gap_stays_within_its_quartile_distance(seed):
    """With the runs split alternately into equal sides, each side's
    median lies between the call's quartiles (the medians of its lower
    and upper halves), so the gap term never exceeds the quartile term
    of the same call: the bound is at least 2 x the runs' spread."""
    rng = np.random.default_rng(seed)
    for n in (4, 6, 10):
        for _ in range(200):
            v = list(rng.lognormal(0.0, 0.3, n))
            row = spread.aa_row(v, ["AB"[k % 2] for k in range(n)])
            assert row["gap_share"] <= row["quartile_share"] + 1e-12


@pytest.mark.parametrize("values, q", [
    ([1.0, 2.0, 3.0, 4.0], (1.5, 3.5)),
    ([1.0, 2.0, 3.0, 4.0, 5.0], (1.5, 4.5)),
    (list(map(float, range(10))), (2.0, 7.0)),
])
def test_quartiles_are_the_medians_of_the_halves(values, q):
    assert spread.quartiles(values) == q
    assert spread.quartiles(values[::-1]) == q


@pytest.mark.parametrize("b_tree", [None, "parent"])
def test_the_aa_call_alternates_sides_in_turns(b_tree, tmp_path, monkeypatch,
                                               capsys):
    """``spread.py`` runs each cell 2 k times with the benchmark's own
    arguments, the cells in turns, run k of a cell on side "AB"[k % 2],
    and writes each cell's A/A row, what its runs waited on and every
    run; with ``--b-tree`` side B runs that checkout's ``run.py``, its
    kernels built there first."""
    from ash_renderer_tpu_torch import _build

    calls, built = [], []

    class Done:
        def __init__(self, stdout):
            self.stdout, self.stderr, self.returncode = stdout, "", 0

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return Done("NVIDIA H100 80GB HBM3, 700.00 W\n")
        if cmd[1] == "-c":
            built.append(kw["cwd"])
            return Done("")
        cell = cmd[cmd.index("--cell") + 1]
        calls.append((cell, "--no-trace" in cmd, len(cmd), cmd[1]))
        k = sum(1 for c in calls if c[0] == cell) - 1
        m = {name: 10.0 + k % 2 for name in spread.METRICS}
        m.update({name: float(k) for name in spread.READINGS})
        return Done("log\n" + json.dumps({
            "correct": True, "gated_frames": 4, "metrics": m,
            "slow_frames": [{"frame": 3, "ms": 20.0, "run_delay_ms": 0.5,
                             "gc_ms": 1.0, "gc": [1, 0, 0], "allocs": 0,
                             "first_clipped": k == 0}]}))

    monkeypatch.setattr(spread, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(spread.subprocess, "run", fake_run)
    monkeypatch.setattr(_build, "build", lambda *a, **k: None)
    tree = str(tmp_path / "parent")
    assert spread.main(["--cells", "config4-orbit", "terrain-walk",
                        "--per-side", "2", "--tag", "t"]
                       + (["--b-tree", tree] if b_tree else [])) == 0
    assert [c[0] for c in calls] == ["config4-orbit", "terrain-walk"] * 4
    side_b = os.path.join(tree if b_tree else ROOT, "benchmark", "run.py")
    assert [c[3] for c in calls] == [os.path.join(
        ROOT, "benchmark", "run.py")] * 2 + [side_b] * 2 + [
        c[3] for c in calls[:4]]
    assert built == ([tree] if b_tree else [])
    assert [c[1] for c in calls] == [False] * 2 + [True] * 6  # --traced 1
    assert {c[2] for c in calls if not c[1]} == {4}  # run.py --cell NAME
    doc = json.loads((tmp_path / "t.json").read_text())
    row = doc["table"]["config4-orbit frame_ms_p50"]
    assert row["sides"] == ["A", "B", "A", "B"]
    assert (row["median_a"], row["median_b"]) == (10.0, 11.0)
    waits = doc["waits"]["terrain-walk"]
    assert waits["slow_frames"]["with_collection"] == 4
    assert waits["slow_frames"]["first_clipped"] == 1
    assert waits["r"]["frame_ms_p50"]["run_delay_ms"] == pytest.approx(
        spread.correlation([0, 1, 2, 3], [10, 11, 10, 11]))
    assert "follows" in capsys.readouterr().out


def test_declared_metrics_name_their_layer_and_cells():
    """Every metric of BENCHMARK.json has a unit, a direction, its layer and
    the cells it reads a number in; only frame_ms_p50 / p95 are
    end-to-end; K1 is not listed for the static cell (the front cache
    hits), the raster layer's bound share is listed for exactly the
    one-card cells without slabs (slabs: not measured), and K3F's own
    bound share is gone (it counted the planes, one implementation's
    intermediate)."""
    for name, m in DECLARED.items():
        assert m["unit"] and m["layer"] and m["what"], name
        assert m["better"] in ("lower", "higher", "neither"), name
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), name
        assert m["end_to_end"] == (name in spread.BOUNDED), name
    assert "config4-static-cached" not in DECLARED["K1_ms"]["workloads"]
    assert "config4-static-cached" not in DECLARED["K1_bound_share"][
        "workloads"]
    assert DECLARED["raster_shade_bound_share"]["workloads"] == [
        c.name for c in CELLS.values() if c.chips == 1 and c.slabs == 1
        and c.name not in CLASSIC_CELLS]
    assert DECLARED["raster_shade_bound_share"]["unit"] == "of the bound"
    assert DECLARED["raster_shade_bound_share"]["better"] == "higher"
    assert "K3F_bound_share" not in DECLARED
    for s in run.STAGES + run.CLASSIC_STAGES:
        assert f"stage_ms.{s}" in DECLARED
    # each stage's host ms beside its stage ms, in the same cells
    stages = [n for n in DECLARED if n.startswith("stage_ms.")]
    assert sorted(n for n in DECLARED if n.startswith("stage_host_ms.")) == (
        sorted(n.replace("stage_ms.", "stage_host_ms.") for n in stages))
    for n in stages:
        host = DECLARED[n.replace("stage_ms.", "stage_host_ms.")]
        assert host["workloads"] == DECLARED[n]["workloads"], n
        assert host["layer"] == DECLARED[n]["layer"], n
    # the classic cell reads K4 and the classic stages, nothing fused-only
    for name in ("K4_ms", "stage_ms.geometry", "stage_ms.binning",
                 "stage_ms.raster_K4"):
        assert DECLARED[name]["workloads"] == sorted(CLASSIC_CELLS), name
    for name in ("K1_ms", "K1_bound_share", "K3F_ms", "front_cache_hit_share",
                 "n_clipped_median", "stage_ms.setup_K1",
                 "stage_ms.raster_K3"):
        assert not CLASSIC_CELLS & set(DECLARED[name]["workloads"]), name
    for name in ("launches_per_frame", "idle_share", "K1_ms", "K3F_ms",
                 "trace_window_ms_per_frame",
                 "clipped_frame_share", "front_cache_hit_share",
                 "first_use_ms_max", "run_delay_ms", "cpu_throttled_ms",
                 "gc_ms", "device_allocs", "card_sm_mhz_before",
                 "card_clock_reasons_after"):
        assert name in DECLARED, name


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                bad += [f"{fn}: {m}" for m in mods
                        if m.split(".")[0] in ("jax", "jaxlib",
                                               "ash_renderer_tpu")]
    assert not bad, bad
