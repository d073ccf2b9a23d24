"""The port's debug and profiling layer on the CPU: ``validate_frame``
gives the JAX package's findings on the same inputs (tensors on the port's
side, numpy on the reference's), ``compare_with_oracle`` on a CPU
``Renderer`` is pixel-exact on the classic and both fused routes and
reports one flipped pixel as an ERROR, and ``profiling.Timer`` and
``profiling.trace`` work on the CPU."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch import debugging, profiling  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)


def _vis(bad=0):
    vt = np.full((6, 8), -1, np.int32)
    vt[1:3, 2:6] = 4
    vt[0, :bad] = 99
    vt[5, :bad] = -7
    return vt


# name -> (aux, rgba8)
VALIDATE_CASES = {
    "clean": ({"clip_overflow": 0, "pairs_overflow": 0, "vis_tri": _vis(),
               "n_setup": 10}, np.zeros((6, 8, 4), np.uint8)),
    "overflow": ({"clip_overflow": 3, "pairs_overflow": 12, "vis_tri": _vis(),
                  "n_setup": 10}, None),
    "tri_id_range": ({"vis_tri": _vis(bad=3), "n_setup": 10}, None),
    "nan_frame": ({"clip_overflow": 0}, np.array(
        [[[0.5, np.nan, 0.0, 1.0], [0.1, 0.2, np.inf, 1.0]]], np.float32)),
    "everything": ({"clip_overflow": 1, "pairs_overflow": 2,
                    "vis_tri": _vis(bad=2), "n_setup": 5},
                   np.full((2, 2, 4), np.nan, np.float32)),
}


@pytest.mark.parametrize("name", sorted(VALIDATE_CASES))
def test_validate_frame_matches_jax(name):
    from ash_renderer_tpu.utils import debugging as ref

    aux, rgba8 = VALIDATE_CASES[name]
    want = [str(f) for f in ref.validate_frame(aux, rgba8)]
    taux = {k: torch.tensor(v) for k, v in aux.items()}
    seen = []
    m = debugging.DebugMessenger(min_severity="INFO", sink=seen.append)
    got = debugging.validate_frame(
        taux, None if rgba8 is None else torch.from_numpy(rgba8), m)
    assert [str(f) for f in got] == want
    assert seen == want and [str(f) for f in m.findings] == want
    assert (want == ["[INFO][ok] frame clean"]) == (name == "clean")


def test_messenger_filters_by_severity():
    seen = []
    m = debugging.DebugMessenger(sink=seen.append)
    debugging.validate_frame(*VALIDATE_CASES["overflow"], messenger=m)
    debugging.validate_frame(*VALIDATE_CASES["clean"], messenger=m)
    assert len(m.findings) == 3 and len(seen) == 2
    assert all(s.startswith("[WARNING]") for s in seen)


@pytest.mark.parametrize("name,pipeline", [("gate", "classic"),
                                           ("gate", "fused"),
                                           ("textured", "fused")])
def test_compare_with_oracle_on_a_cpu_renderer(name, pipeline, monkeypatch):
    """pixel-exact on each route; one pixel flipped after the readback is
    an ERROR that counts it."""
    import dataclasses

    build, settings = tp.FALLBACK_SCENES[name]
    case = tp.case_from(build(), settings)
    r = Renderer(case.scene, dataclasses.replace(case.settings,
                                                 pipeline=pipeline),
                 device="cpu")
    assert r.settings.pipeline == pipeline
    got = debugging.compare_with_oracle(r, case.cam)
    assert [str(f) for f in got] == ["[INFO][oracle] pixel-exact match"]

    read = r.read_frame

    def flipped(rgba8):
        f = read(rgba8).copy()
        f[3, 5, 1] ^= 0x80
        return f

    monkeypatch.setattr(r, "read_frame", flipped)
    got = debugging.compare_with_oracle(r, case.cam)
    assert len(got) == 1 and got[0].severity == "ERROR"
    assert got[0].message.startswith("1 pixels differ") and "=128)" in got[0].message


def test_timer_sums_scopes_on_the_host():
    t = profiling.Timer()
    for _ in range(2):
        with t.scope("a"):
            torch.ones(64, 64).sum()
    with t.scope("b"):
        pass
    assert set(t.times) == {"a", "b"} and t.times["a"] > 0


def test_timer_records_a_scope_that_raises():
    t = profiling.Timer(device="cpu")
    with pytest.raises(KeyError):
        with t.scope("x"):
            raise KeyError("x")
    assert "x" in t.times


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "sub" / "frame.json"
    with profiling.trace(str(path)) as prof:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
