"""A fused frame in 2 row slabs on 4-row tiles (``fused_tile_h=4``):
``parallel.render_frame_sharded_fused`` on a mesh that repeats the CPU
against the reference's ``render_frame_sharded_fused`` under
``shard_map`` on two of the eight virtual CPU devices of
``tests/conftest.py`` (Pallas kernels in interpret mode), byte for byte,
as ``test_torch_sharding_jax_fused.py`` does at 8 rows, and against the
port's single-device frame and its frame in 4 slabs."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_sharding_jax import _port_frame, _ref_args  # noqa: E402
from test_torch_tile_h4 import TH  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import parallel  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)


def test_fused_slabs_4_rows_match_reference():
    """2 slabs of 5 tile rows of 4 (the last padded past the 36 rows)
    against the reference's ``render_frame_sharded_fused`` under
    ``shard_map`` on two virtual CPU devices, and against the port's
    single-device frame and its frame in 4 slabs."""
    from ash_renderer_tpu.ops import setup_kernel as jsetup
    from ash_renderer_tpu.parallel import (make_render_mesh,
                                           render_frame_sharded_fused)

    case = tp.case_from(tp.rand_scene(9, 140, 200, 2.0), RendererSettings(
        width=128, height=36, clip_budget=128, pipeline="fused",
        fused_tile_h=TH), tile_h=TH)
    assert case.cfg.grid_h == 9
    p = case.ref_packed
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    ltT, matT = jsetup.prep_static(p.local_tri, tri_mat, p.tri_v[:, 0] >= 0)
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
    np.testing.assert_array_equal(got, want)
    r = Renderer(case.scene, case.settings, device="cpu")
    assert r.cfg.tile_h == TH
    np.testing.assert_array_equal(got, r.read_frame(r.render_frame(case.cam)[0]))
    # 4 slabs of 3 tile rows: the last lies wholly past the screen
    r4 = Renderer(case.scene, case.settings,
                  mesh=parallel.make_render_mesh(["cpu"] * 4))
    assert parallel.slab_rows(r4.statics, 4) == 3
    np.testing.assert_array_equal(got, r4.read_frame(r4.render_frame(case.cam)[0]))
