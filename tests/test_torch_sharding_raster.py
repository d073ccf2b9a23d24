"""K3's plain version (``rasterize_distribute``) at a slab's row origin
against the reference's Pallas raster/distribute kernel with
``tile_rows`` (interpret mode; its range meta ends in the slab's first tile
row), on the slab tables of ``test_torch_sharding_modules.py``'s graze
case: a middle slab and a last slab that runs past the screen with phase E
(K3), and the middle slab with phase F (K3F).  Visibility bit for bit (a
slab's vis keeps all its rows), planes bit for bit on covered pixels and
in the material / id / pad rows everywhere."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_classic import _same  # noqa: E402
from test_torch_sharding_modules import _port_slab_front, _setup, wid  # noqa: E402

from ash_renderer_tpu_torch.ops import fused_kernel  # noqa: E402

torch.set_num_threads(1)


def _jax_tables(rmeta, tbl_sorted, tbl_ext, comb, tile_row0):
    """The slab's tables in the reference's layout: the range meta ends in
    the slab's first tile row, the records become the comb rows they stand
    for, and the DMA windows read up to 256 rows past each table."""
    def padded(x):
        return jnp.asarray(np.concatenate(
            [tp.table_rows(x, comb), np.zeros((256, comb.shape[1]), np.int32)]))

    return (jnp.asarray(np.append(rmeta.numpy(), np.int32(tile_row0))),
            padded(tbl_sorted), padded(tbl_ext))


@pytest.mark.parametrize("window", [(6, 6), (12, 6)], ids=wid)
def test_k3_plain_at_slab_origin(window):
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case, _ = _setup()
    tile_row0, tile_rows = window
    rmeta, tbl_sorted, tbl_ext, comb, stats = _port_slab_front(*window)
    assert stats["n_clipped"] > 0 and stats["live_rows"] > 0
    want_d, want_t, want_p = (np.asarray(a) for a in jfk.rasterize_distribute(
        *_jax_tables(rmeta, tbl_sorted, tbl_ext, comb, tile_row0), case.ref_cfg,
        interpret=True, tile_rows=tile_rows))
    vis_d, vis_t, planes = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, case.cfg, tile_row0=tile_row0,
        tile_rows=tile_rows)
    assert vis_t.shape == (tile_rows * 8, case.cfg.width)
    _same(vis_t.numpy(), want_t)
    _same(vis_d.numpy(), want_d)
    planes = planes.numpy()
    valid = want_p[:, fused_kernel.VIS_ROW, :] >= 0
    assert valid.sum() > 300
    # rows past the screen stay background
    past = max(0, (tile_row0 + tile_rows) * 8 - case.cfg.height)
    assert past == 0 or (want_t[tile_rows * 8 - past:] == -1).all()
    for row in range(16):
        _same(planes[:, row][valid], want_p[:, row][valid])
    _same(planes[:, 16:], want_p[:, 16:])


def test_k3f_plain_at_slab_origin():
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case, _ = _setup()
    tile_row0, tile_rows = 6, 6
    rmeta, tbl_sorted, tbl_ext, comb, _ = _port_slab_front(tile_row0,
                                                           tile_rows)
    smode, consts, ref_kw = tp.shade_inputs(case)
    assert smode == (1, 0, True, False, False)
    want = jfk.rasterize_distribute(
        *_jax_tables(rmeta, tbl_sorted, tbl_ext, comb, tile_row0), case.ref_cfg,
        interpret=True, tile_rows=tile_rows, **ref_kw)
    got = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, case.cfg, smode, consts,
        tile_row0=tile_row0, tile_rows=tile_rows)
    _, valid = tp.compare_f_planes(got, want)
    assert valid.sum() > 300
