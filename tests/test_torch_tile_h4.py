"""K3 and K3F on 4-row tiles (``fused_tile_h=4``): their plain versions
against the reference's Pallas raster/distribute kernel (interpret mode)
on a 4-row config, on the port's front of the same scene (which
``test_torch_tile_h4_front.py`` holds to the reference's), bit for bit:

* K3 on the random scene and the grazing scene (clip fans and wide
  pairs), planes compared as in ``test_torch_raster.py``;
* K3F in one untextured shade mode (config3's scene, whose small
  triangles stream own-fine runs) and one textured, planes compared with
  ``torch_parity.compare_f_planes``.

The frames at 4 rows are ``test_torch_tile_h4_frames.py`` and
``test_torch_tile_h4_slabs.py``."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_raster import jax_rmeta  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel  # noqa: E402

torch.set_num_threads(1)
TH = 4


def case4(name):
    """The parity case ``name`` on 4-row fused tiles."""
    build, settings = tp.SCENES[name]
    return tp.case_from(build(), dataclasses.replace(
        settings, fused_tile_h=TH), tile_h=TH)


def front(case):
    """The port's front of the case: (rmeta, tbl_sorted, tbl_ext, comb,
    stats)."""
    return pipeline.render_front(tp.port_statics(case), tp.port_state(case),
                                 tp.t(case.mm), tp.t(case.mvp))


def padded(rec, comb):
    """The port's records as the table the reference's kernel reads: the
    comb rows they stand for, then 256 rows, since its DMA windows read up
    to 256 rows past the end."""
    return jnp.asarray(np.concatenate(
        [tp.table_rows(rec, comb), np.zeros((256, comb.shape[1]), np.int32)]))


@pytest.mark.parametrize("name", ["random", "graze"])
def test_k3_plain_matches_reference_kernel_4_rows(name):
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case = case4(name)
    assert case.cfg.tile_h == TH and case.ref_cfg.tile_h == TH
    rmeta, tbl_sorted, tbl_ext, comb, stats = front(case)
    if name == "graze":
        assert stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0

    want_d, want_t, want_p = (np.asarray(a) for a in jfk.rasterize_distribute(
        jax_rmeta(rmeta), padded(tbl_sorted, comb), padded(tbl_ext, comb),
        case.ref_cfg, interpret=True,
    ))
    vis_d, vis_t, planes = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, case.cfg
    )
    planes = planes.numpy()
    assert planes.shape == (case.cfg.n_tiles, fused_kernel.OUT_COLS,
                            TH * fused_kernel.TILE_W) == want_p.shape
    assert int((want_t >= 0).sum()) > 500
    np.testing.assert_array_equal(vis_t.numpy(), want_t)
    np.testing.assert_array_equal(vis_d.numpy(), want_d)
    valid = want_p[:, fused_kernel.VIS_ROW, :] >= 0
    for row in range(fused_kernel.VIS_ROW - 1):
        np.testing.assert_array_equal(planes[:, row][valid],
                                      want_p[:, row][valid], err_msg=str(row))
    np.testing.assert_array_equal(planes[:, 16:], want_p[:, 16:])


@pytest.mark.parametrize("name,mode", [
    ("config3", (1, 0, True, False, True)),  # untextured, lit
    ("textured_on", (1, 1, True, True, True)),
])
def test_k3f_plain_matches_reference_kernel_4_rows(name, mode):
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case = case4(name)
    rmeta, tbl_sorted, tbl_ext, comb, _ = front(case)
    smode, consts, ref_kw = tp.shade_inputs(case)
    assert smode == mode
    if name == "config3":  # small triangles: own-fine runs at 4 rows too
        m = rmeta.reshape(-1, fused_kernel.N_RANGES, 2)
        assert int((m[:, fused_kernel.FINE_RANGE, 1]
                    - m[:, fused_kernel.FINE_RANGE, 0]).sum()) > 100
    want = jfk.rasterize_distribute(
        jax_rmeta(rmeta), padded(tbl_sorted, comb), padded(tbl_ext, comb), case.ref_cfg,
        interpret=True, **ref_kw)
    got = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, case.cfg, smode, consts)
    assert got[2].shape[2] == TH * fused_kernel.TILE_W
    planes, valid = tp.compare_f_planes(got, want)
    assert valid.sum() > 300
    assert (planes[:, fused_kernel.F_LIT][valid] != 0).any()
    assert (planes[:, fused_kernel.F_TEXMASK][valid] != 0).any() == smode[3]
