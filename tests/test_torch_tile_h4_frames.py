"""The fused route's frame on 4-row tiles (``fused_tile_h=4``): a
``Renderer(fused_tile_h=4, device="cpu")`` frame against the JAX
package's fused frame at the same tile height (Pallas kernels in
interpret mode) and its numpy oracle, bit for bit."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_sharding_jax import _ref_args  # noqa: E402
from test_torch_tile_h4 import TH, case4  # noqa: E402

from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)


def test_renderer_tile_h4_frame_matches_jax_and_oracle():
    """The Renderer on 4-row tiles against the JAX package's fused frame
    (``render_frame_fused_jit`` at ``tile_h=4``) and its numpy oracle, on
    the textured, lit, specular scene."""
    from ash_renderer_tpu.oracle import render_oracle
    from ash_renderer_tpu.pipeline import render_frame_fused_jit

    case = case4("textured")
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    assert r.cfg.tile_h == TH and r.cfg == case.cfg
    got, aux = r.render_frame(case.cam)
    got = r.read_frame(got)
    p = case.ref_packed
    mats, atlas, light = tp.jax_shading(case)
    want, jaux = render_frame_fused_jit(
        tp.jax_statics(case),
        *_ref_args(case), mats, atlas, light, jnp.asarray(p.local_tri))
    o = render_oracle(
        p, case.mm, case.view, case.proj, case.ref_settings, materials=mats,
        atlas=atlas, light=light,
        camera_pos=case.ref_cam.position.astype(np.float32), cfg=case.ref_cfg)
    assert int((o["vis_tri"] >= 0).sum()) > 500
    np.testing.assert_array_equal(aux["vis_tri"].numpy(),
                                  np.asarray(jaux["vis_tri"]))
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), o["vis_tri"])
    np.testing.assert_array_equal(aux["vis_d16"].numpy(), o["vis_d16"])
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, o["rgba8"])
    for k in ("n_valid", "n_clipped", "n_fast", "n_wide", "live_rows"):
        assert int(aux[k]) == int(jaux[k]), k
