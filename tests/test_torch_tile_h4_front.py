"""The fused route's front on 4-row tiles (``fused_tile_h=4``) against
the JAX package's stages at the same tile height, bit for bit: the keys
(K1's and the clip tail's), the run bounds and the range metadata."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_tile_h4 import case4, front  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import binsort, geometry, setup_kernel  # noqa: E402

torch.set_num_threads(1)


def test_front_keys_bounds_rmeta_4_rows():
    """Keys (K1's and the clip tail's), run bounds and range metadata of the
    grazing scene at 4-row tiles: twice the tiles, so twice the key bins."""
    case = case4("graze")
    ref = tp.jax_front(case)
    assert ref["stats"]["wide_leftover"] == 0 and ref["stats"]["n_clipped"] > 0
    statics, st = tp.port_statics(case), tp.port_state(case)
    tblT = setup_kernel.transform_vertices_T(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    comb, keys_main, flags, _, _ = setup_kernel.triangle_setup(
        tblT, st.ltT, st.matT, case.cfg,
        tail_rows=case.settings.clip_budget * geometry.MAX_CLIP_TRIS)
    np.testing.assert_array_equal(keys_main.numpy(), ref["keys_main"])
    _, keys_tail, _ = pipeline._clip_tail_into(statics, tblT, st.tri_v,
                                               st.tri_mat, flags, comb)
    np.testing.assert_array_equal(keys_tail.numpy(), ref["keys_tail"])
    keys = ref["keys"]
    _, bounds = binsort.sort_and_bounds(tp.t(keys), case.cfg)
    n_bins = case.cfg.n_tiles * binsort.KEYS_PER_TILE + 2
    assert bounds.shape[0] == n_bins + 1
    np.testing.assert_array_equal(
        bounds[:-1].numpy(), np.searchsorted(np.sort(keys), np.arange(n_bins)))
    rmeta, tbl_sorted, tbl_ext, _, _ = front(case)
    np.testing.assert_array_equal(rmeta.numpy(), ref["rmeta"][:-1])
    assert int(ref["rmeta"][-1]) == 0
