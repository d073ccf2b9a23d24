"""The port's non-meshlet fused fallback (``pipeline.render_frame_fused``)
on the CPU (plain versions of K2, K3 and K3F): its frames equal the port's
numpy oracle on bench.py's parity-gate scene (phase F), a textured scene
(phase E) and a scene that clips; it refuses a meshlet-packed scene.  The
JAX package's frames are compared in ``test_torch_fused_fallback_jax*.py``."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name,phase_f", [("gate", True), ("textured", False),
                                          ("near_plane", True)])
def test_fallback_frame_equals_port_oracle(name, phase_f):
    case = tp.fallback_case(name)
    st = tp.port_state(case)
    statics = tp.port_statics(case)
    atlas = st.atlas if statics.has_atlas else None
    light = st.light if statics.has_light else None
    smode = pipeline.shade_mode_for(statics, st.materials, atlas, light)
    assert (smode is not None) == phase_f
    got, aux = tp.port_fallback_frame(case)
    o = tp.port_oracle_frame(case)
    assert int((o["vis_tri"] >= 0).sum()) > 500
    np.testing.assert_array_equal(aux["vis_tri"], o["vis_tri"])
    np.testing.assert_array_equal(aux["vis_d16"], o["vis_d16"])
    np.testing.assert_array_equal(got, o["rgba8"])
    t_rows = case.packed.tri_v.shape[0]
    assert int(aux["n_setup"]) == t_rows + 7 * case.settings.clip_budget
    assert int(aux["n_valid"]) == int(o["setup"].valid.sum())


def test_fallback_refuses_a_meshlet_packed_scene():
    build, settings = tp.FALLBACK_SCENES["gate"]
    case = tp.case_from(build(), settings, meshlets=True)
    with pytest.raises(ValueError, match="plain-packed"):
        pipeline.render_frame_fused(
            tp.port_statics(case), tp.port_state(case), tp.t(case.mm),
            tp.t(case.mvp), torch.from_numpy(case.cam.position))
