"""The port's row-slab frames against the JAX package's multi-chip frames,
byte for byte, at 2 slabs: ``parallel.render_frame_sharded`` (classic;
the fused pipeline's is ``test_torch_sharding_jax_fused.py``) on a mesh
that repeats the CPU, against the reference's ``render_frame_sharded``
under ``shard_map`` on two of the eight virtual CPU devices of
``tests/conftest.py`` (Pallas kernels in interpret mode), on
``tests/test_sharding.py``'s scene."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import parallel  # noqa: E402
from ash_renderer_tpu_torch.renderer import frame_statics  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _ref_args(case):
    p = case.ref_packed
    return (
        jnp.asarray(p.positions), jnp.asarray(p.vert_obj),
        jnp.asarray(p.normals), jnp.asarray(p.colors), jnp.asarray(p.uvs),
        jnp.asarray(p.tri_v), jnp.asarray(p.tri_obj),
        jnp.asarray(p.obj_material), jnp.asarray(case.mm),
        jnp.asarray(case.mvp),
        jnp.asarray(case.ref_cam.position.astype(np.float32)),
    )


def _port_frame(case, fn):
    statics = frame_statics(case.settings, case.packed.tri_v.shape[0],
                            case.scene.atlas is not None,
                            case.scene.light is not None)
    rgba8, stats = fn(statics, parallel.make_render_mesh([CPU, CPU]),
                      {CPU: tp.port_state(case)}, tp.t(case.mm),
                      tp.t(case.mvp),
                      torch.from_numpy(case.cam.position.astype(np.float32)))
    return rgba8.numpy(), {k: int(v) for k, v in stats.items()}


def test_classic_slabs_match_reference():
    from ash_renderer_tpu.parallel import (make_render_mesh,
                                           render_frame_sharded)

    case = tp.classic_case(tp.rand_scene(3, 90, 70, 2.0), RendererSettings(
        width=128, height=128, clip_budget=128, max_pairs=1 << 14,
        pipeline="classic"))
    mats, atlas, light = tp.jax_shading(case)
    mesh = make_render_mesh(jax.devices()[:2])
    want, wstats = jax.jit(
        lambda *a: render_frame_sharded(tp.jax_statics(case), mesh, *a)
    )(*_ref_args(case), mats, atlas, light, None)
    got, stats = _port_frame(case, parallel.render_frame_sharded)
    want = np.asarray(want)
    assert int((want[..., :3] != 0).any(-1).sum()) > 500
    assert stats == {"pairs_overflow": int(wstats["pairs_overflow"])} == {
        "pairs_overflow": 0}
    np.testing.assert_array_equal(got, want)
