"""The slice as a whole on the CPU: the port's Renderer frames on the
phase F route (the raster kernel's plain version with a shade mode, then
``shade.combine_from_prelight``) against the JAX package's fused frame
(``render_frame_fused_jit``, Pallas in interpret mode), the numpy oracle and
a stored golden, bit for bit."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch.ops import fused_kernel  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_frame(case):
    from ash_renderer_tpu.pipeline import render_frame_fused_jit

    p = case.ref_packed
    mats, atlas, light = tp.jax_shading(case)
    rgba8, aux = render_frame_fused_jit(
        tp.jax_statics(case),
        jnp.asarray(p.positions), jnp.asarray(p.vert_obj),
        jnp.asarray(p.normals), jnp.asarray(p.colors), jnp.asarray(p.uvs),
        jnp.asarray(p.tri_v), jnp.asarray(p.tri_obj),
        jnp.asarray(p.obj_material), jnp.asarray(case.mm),
        jnp.asarray(case.mvp),
        jnp.asarray(case.ref_cam.position.astype(np.float32)),
        mats, atlas, light, jnp.asarray(p.local_tri),
    )
    return np.asarray(rgba8), np.asarray(aux["vis_tri"])


def _oracle_frame(case):
    from ash_renderer_tpu.oracle import render_oracle

    st = case.ref_settings
    mats, atlas, light = tp.jax_shading(case)
    return render_oracle(
        case.ref_packed, case.mm, case.view, case.proj, st, materials=mats,
        atlas=atlas, light=light,
        camera_pos=case.ref_cam.position.astype(np.float32), cfg=case.ref_cfg,
    )["rgba8"]


@pytest.fixture
def phase_f_calls(monkeypatch):
    """Counts the plain phase F's calls (the CPU stands in for K3F)."""
    calls = []
    real = fused_kernel.phase_f_plain

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(fused_kernel, "phase_f_plain", spy)
    return calls


@pytest.mark.parametrize("name", ["config3", "textured_on", "huge_uv_on"])
def test_frame_on_phase_f_route(name, phase_f_calls):
    """The port's Renderer frame, routed through phase F, equals the JAX
    package's fused frame and (below 2**31 texels) the numpy oracle's."""
    case = tp.make_case(name)
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    rgba8, aux = r.render_frame(case.cam)
    got = r.read_frame(rgba8)
    assert len(phase_f_calls) == 1, "phase F did not run"
    want, want_vis = _jax_frame(case)
    assert int((want_vis >= 0).sum()) > 300
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), want_vis)
    np.testing.assert_array_equal(got, want)
    if name != "huge_uv_on":  # the oracle's numpy cast differs there
        np.testing.assert_array_equal(got, _oracle_frame(case))
    # the phase E route gives the same frame
    off = Renderer(case.scene, dataclasses.replace(
        tp.fused(case.settings), fused_surface_shade="off"), device="cpu")
    np.testing.assert_array_equal(off.read_frame(off.render_frame(case.cam)[0]),
                                  got)
    assert len(phase_f_calls) == 1


def test_blinn_phong_golden_on_phase_f_route(phase_f_calls):
    """tests/golden_scenes.blinn_phong_specular, carried across: the "auto"
    route takes phase F and the frame equals the stored golden PNG."""
    from PIL import Image

    from golden_scenes import blinn_phong_specular

    ref_scene, settings = blinn_phong_specular()
    case = tp.case_from(ref_scene, settings)
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    got = r.read_frame(r.render_frame(case.cam)[0])
    assert phase_f_calls == [(1, 0, True, False, True)]
    want = np.asarray(Image.open(os.path.join(
        ROOT, "tests", "golden", "golden_blinn_phong_specular.png")))
    np.testing.assert_array_equal(got, want)
