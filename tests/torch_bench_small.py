"""Shared set-up of the benchmark's CPU tests: every cell's scene cut
small, on the route the card takes (fused; the gate scene, which is not
cut, classic), the static poses held to the port's oracle."""

import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ash_renderer_tpu_torch import benchmarks, renderer  # noqa: E402
from benchmark import cells, golden, run, scenes  # noqa: E402

torch.set_num_threads(1)
LOAD_GOLDEN = run.load_golden
FRAMES = 12
ARGS = ["--device", "cpu", "--frames", str(FRAMES)]
# every metric a run on the fused route prints, with its unit (on the CPU
# the device metrics print "not measured")
METRICS = {
    "setup_s": "s", "peak_device_mib": "MiB", "host_issue_us": "us per launch",
    "host_issue_us_after": "us per launch", "frame_ms_p50": "ms",
    "frame_ms_p95": "ms", "frame_ms_max": "ms",
    "n_clipped_median": "per frame", "live_rows_median": "per frame",
    "n_wide_median": "per frame", "wide_pairs_n_median": "per frame",
    "clipped_frame_share": "of frames", "gated_frames_exact": "frames",
    **{f"stage_ms.{s}": "ms" for s in run.STAGES},
    **{f"stage_host_ms.{s}": "ms" for s in run.STAGES},
    "launches_per_frame": "", "idle_share": "",
    "trace_window_ms_per_frame": "", "K1_ms": "", "K3_ms": "",
    "K1_bound_share": "", "raster_shade_bound_share": "",
    # what the loop waited on (benchmark/readings.py)
    "first_use_ms_max": "ms", "run_delay_ms": "ms",
    "involuntary_switches": "switches", "cpu_throttled_ms": "ms",
    "cpu_throttled_periods": "periods", "cpu_steal_ms": "ms",
    "gc_collections": "collections", "gc_ms": "ms", "device_allocs": "",
    "device_frees": "", "alloc_retries": "",
    **{f"card_{k}_{side}": "" for side in ("before", "after")
       for k in ("sm_mhz", "mem_mhz", "power_w", "temp_c", "clock_reasons")},
}
# the fused route's own: the front's counters and cache, K1, K3 / K3F and
# the raster layer's bound share, the front's stages
FUSED_ONLY = {"n_clipped_median", "live_rows_median", "n_wide_median",
              "wide_pairs_n_median", "clipped_frame_share", "K1_ms", "K3_ms",
              "K1_bound_share", "raster_shade_bound_share"} | {
    f"{kind}.{s}" for kind in ("stage_ms", "stage_host_ms")
    for s in set(run.STAGES) - set(run.CLASSIC_STAGES)}
# every metric a run on the classic route prints
# the classic stages a frame no longer reports: K10 transforms the
# vertices inside its own launch (the "geometry" stage), so
# pipeline.render_frame calls no on_stage("transform") and the benchmark
# prints these "not reached" until a benchmark change takes them off the
# classic cell
FOLDED_STAGES = ("transform",)
FOLDED_METRICS = {f"{kind}.{s}" for kind in ("stage_ms", "stage_host_ms")
                  for s in FOLDED_STAGES}
CLASSIC_METRICS = {
    **{k: v for k, v in METRICS.items() if k not in FUSED_ONLY},
    **{f"{kind}.{s}": "ms" for kind in ("stage_ms", "stage_host_ms")
       for s in run.CLASSIC_STAGES},
    "K4_ms": ""}


def _small(build, **kw):
    def small(*_args, **_kw):
        scene, st, cams = build(**kw)
        return scene, dataclasses.replace(st, width=64, height=48), cams
    return small


def hide_foreign(monkeypatch) -> None:
    """The process as the benchmark's own: no module of JAX or of the JAX
    package in ``sys.modules`` (the tests' conftest loads JAX, and a run
    that finds it is refused), all put back after the test."""
    for name in run.foreign_modules():
        monkeypatch.delitem(sys.modules, name)


@pytest.fixture
def no_foreign(monkeypatch):
    hide_foreign(monkeypatch)


@pytest.fixture
def small(monkeypatch):
    """Every configuration of the cells cut to a few hundred triangles at
    64x48 (config4 subdiv 2, terrain n = 12, config5's own scene), on the
    fused route the card takes ("auto" takes it from 161 triangles here:
    the cut scenes have 288 and more), and the gate scene (160 triangles
    at 800x600, not cut: it is its source's, and small) on the classic
    route the card takes; the static poses held to the port's oracle;
    nothing of JAX in the process."""
    for name, build, kw in (
            ("config4_million_tri", benchmarks.config4_million_tri,
             dict(subdiv=2)),
            ("config4_terrain", benchmarks.config4_terrain, dict(n=12)),
            ("config5_flythrough", benchmarks.config5_flythrough, {})):
        monkeypatch.setitem(benchmarks.ALL_CONFIGS, name, _small(build, **kw))
    hide_foreign(monkeypatch)
    monkeypatch.setattr(renderer, "AUTO_FUSED_TRIS", scenes.GATE_TRIS + 1)
    monkeypatch.setattr(golden, "_RENDERERS", {})
    statics = {}

    def static_golden(cell, stored):
        if cell.config not in statics:
            statics[cell.config] = golden.oracle_sha(
                cell.config, cells.scene_of(cell)[2])
        return statics[cell.config], "the port's oracle"

    monkeypatch.setattr(run, "static_golden", static_golden)
    monkeypatch.setattr(run, "load_golden", lambda cell: {})


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
