"""config2 (3,500 triangles over 3 meshes, 12 objects) at 200x150 on the
route the port's "auto" takes on a CUDA device (``renderer.auto_route``),
rendered on the CPU with the resolved knobs named, against the JAX
package's frame of the same route (Pallas in interpret mode), bit for bit.
Its own file: the JAX frame compiles for ~20-35 s on one core."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch.renderer import Renderer, auto_route  # noqa: E402

torch.set_num_threads(1)


def _jax_frame(case):
    """The JAX package's frame of the case's route: ``render_frame_fused_jit``
    (meshlet-packed) or ``render_frame_jit`` (classic)."""
    from ash_renderer_tpu.pipeline import render_frame_fused_jit, render_frame_jit

    p = case.ref_packed
    mats, atlas, light = tp.jax_shading(case)
    args = [tp.jax_statics(case),
            *(jnp.asarray(a) for a in (p.positions, p.vert_obj, p.normals,
                                       p.colors, p.uvs, p.tri_v, p.tri_obj,
                                       p.obj_material, case.mm, case.mvp)),
            jnp.asarray(case.ref_cam.position.astype(np.float32)),
            mats, atlas, light]
    if case.settings.pipeline == "fused":
        rgba8, aux = render_frame_fused_jit(*args, jnp.asarray(p.local_tri))
    else:
        rgba8, aux = render_frame_jit(*args)
    return np.asarray(rgba8), np.asarray(aux["vis_tri"])


def test_config2_on_the_cuda_route_matches_jax():
    from ash_renderer_tpu.benchmarks import config2_multi_mesh

    ref_scene, ref_settings, _ = config2_multi_mesh()
    n_tris = sum(m.num_triangles for m in ref_scene.meshes)
    assert n_tris == 3500
    small = tp.port_settings(dataclasses.replace(ref_settings, width=200,
                                                 height=150))
    st = auto_route(small, torch.device("cuda", 0), n_tris)
    ref_st = dataclasses.replace(
        ref_settings, width=200, height=150, pipeline=st.pipeline,
        fused_surface_shade=st.fused_surface_shade)
    if st.pipeline == "fused":
        case = tp.case_from(ref_scene, ref_st)
    else:
        case = tp.classic_case(ref_scene, ref_st)
    r = Renderer(case.scene, st, device="cpu")
    assert r.settings == st == case.settings
    rgba8, aux = r.render_frame(case.cam)
    want, want_vis = _jax_frame(case)
    assert len(np.unique(want_vis[want_vis >= 0])) > 500
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), want_vis)
    np.testing.assert_array_equal(r.read_frame(rgba8), want)
