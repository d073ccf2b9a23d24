"""The port's fused row-slab frame against the JAX package's, byte for
byte, at 2 slabs: ``parallel.render_frame_sharded_fused`` on a mesh that
repeats the CPU against the reference's ``render_frame_sharded_fused``
under ``shard_map`` on two of the eight virtual CPU devices of
``tests/conftest.py`` (Pallas kernels in interpret mode), on
``tests/test_sharding.py``'s fused scene at a height that pads (5 tile
rows over 2 slabs), with live clipping and the worst slab's counters
equal."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_sharding_jax import _port_frame, _ref_args  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import parallel  # noqa: E402

torch.set_num_threads(1)


def test_fused_slabs_match_reference():
    from ash_renderer_tpu.ops import setup_kernel
    from ash_renderer_tpu.parallel import (make_render_mesh,
                                           render_frame_sharded_fused)

    case = tp.case_from(tp.rand_scene(9, 140, 200, 2.0), RendererSettings(
        width=128, height=40, clip_budget=128, pipeline="fused"))
    assert case.cfg.grid_h == 5
    p = case.ref_packed
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    ltT, matT = setup_kernel.prep_static(p.local_tri, tri_mat,
                                         p.tri_v[:, 0] >= 0)
    mats, atlas, light = tp.jax_shading(case)
    mesh = make_render_mesh(jax.devices()[:2])
    want, wstats = jax.jit(
        lambda *a: render_frame_sharded_fused(tp.jax_statics(case), mesh, *a)
    )(*_ref_args(case), mats, atlas, light, jnp.asarray(tri_mat),
      jnp.asarray(ltT), jnp.asarray(matT))
    got, stats = _port_frame(case, parallel.render_frame_sharded_fused)
    want = np.asarray(want)
    assert int((want[..., :3] != 0).any(-1).sum()) > 500
    assert stats == {k: int(v) for k, v in wstats.items()}
    assert stats["n_clipped"] > 0
    np.testing.assert_array_equal(got, want)
