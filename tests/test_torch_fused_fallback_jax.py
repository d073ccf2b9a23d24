"""The port's non-meshlet fused fallback (``pipeline.render_frame_fused``
on a plain-packed scene) against the JAX package's
``render_frame_fused_jit`` without ``local_tri`` (its non-meshlet branch,
Pallas kernels in interpret mode), bit for bit: RGBA8, vis_tri, vis_d16,
the counters and the aux keys, on bench.py's parity-gate scene (the
phase F route, K3F).  The textured scene (phase E, K3) and the clipping
one are in ``test_torch_fused_fallback_jax_textured.py`` and
``..._jax_clip.py``: each JAX frame compiles for ~15 s."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


def check_fallback_against_jax(name):
    case = tp.fallback_case(name)
    got, aux = tp.port_fallback_frame(case)
    want, jaux = tp.jax_fallback_frame(case)
    assert int((jaux["vis_tri"] >= 0).sum()) > 500
    assert sorted(aux) == sorted(jaux)
    np.testing.assert_array_equal(aux["vis_tri"], jaux["vis_tri"])
    np.testing.assert_array_equal(aux["vis_d16"], jaux["vis_d16"])
    np.testing.assert_array_equal(got, want)
    for k in sorted(aux):
        if k not in ("vis_tri", "vis_d16"):
            assert int(aux[k]) == int(jaux[k]), k
    return aux


def test_gate_fallback_frame_matches_jax():
    check_fallback_against_jax("gate")
