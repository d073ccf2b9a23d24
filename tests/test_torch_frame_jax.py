"""The port's Renderer frame against the JAX package's fused frame
(render_frame_fused_jit, Pallas kernels in interpret mode) on the textured,
lit, specular scene that exercises the headline's whole shading chain."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)


def test_frame_matches_jax_fused_frame():
    from ash_renderer_tpu.pipeline import render_frame_fused_jit

    case = tp.make_case("textured")
    p = case.ref_packed
    r = Renderer(case.scene, tp.fused(case.settings), device="cpu")
    got, aux = r.render_frame(case.cam)
    mats, atlas, light = tp.jax_shading(case)
    want, jaux = render_frame_fused_jit(
        tp.jax_statics(case),
        jnp.asarray(p.positions), jnp.asarray(p.vert_obj),
        jnp.asarray(p.normals), jnp.asarray(p.colors), jnp.asarray(p.uvs),
        jnp.asarray(p.tri_v), jnp.asarray(p.tri_obj),
        jnp.asarray(p.obj_material), jnp.asarray(case.mm),
        jnp.asarray(case.mvp), jnp.asarray(case.cam.position.astype(np.float32)),
        mats, atlas, light, jnp.asarray(p.local_tri),
    )
    assert int((np.asarray(jaux["vis_tri"]) >= 0).sum()) > 500
    np.testing.assert_array_equal(aux["vis_tri"].numpy(),
                                  np.asarray(jaux["vis_tri"]))
    np.testing.assert_array_equal(r.read_frame(got), np.asarray(want))
    for k in ("n_valid", "n_clipped", "n_fast", "n_wide", "live_rows"):
        assert int(aux[k]) == int(jaux[k]), k
