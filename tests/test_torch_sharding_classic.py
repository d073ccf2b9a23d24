"""The classic pipeline's windowed modules against the JAX package, bit for
bit, on the tile-row windows of slabs of a clip-heavy random scene
(192x128, 16-row tiles, 8 tile rows): the first and a middle slab, a last
slab that runs past the screen, one of a single tile row, and one wholly
past the screen.

* ``binning.bin_triangles(su, cfg, max_pairs, tile_row0, tile_rows)``,
  compared as ``test_torch_classic.py::test_bin_triangles_matches``
  compares the whole grid's;
* K4's plain version over the slab's records
  (``rasterize_visibility(tile_rows=)``) against the reference's Pallas
  kernel with ``tile_rows`` (interpret mode), then ``shade.shade(
  py_offset=)`` of the slab's vis against the reference's."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_classic import _jax_geometry, _same, _su_to_port  # noqa: E402
from test_torch_sharding_modules import wid  # noqa: E402

from ash_renderer_tpu import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import (binning, raster_visibility,  # noqa: E402
                                        shade)

torch.set_num_threads(1)

CLASSIC_WINDOWS = [(0, 3), (3, 3), (6, 3), (4, 1), (8, 1)]


def _jax_bin_window(jsu, cfg, max_pairs, tile_row0, tile_rows):
    from ash_renderer_tpu.ops import binning as jbin

    return jax.jit(jbin.bin_triangles, static_argnums=(1, 2, 3, 4))(
        jsu, cfg, max_pairs, tile_row0, tile_rows)


@functools.lru_cache(maxsize=None)
def _classic_case():
    case = tp.classic_case(tp.rand_scene(6, 60, 50, 4.0, zoff=0.8),
                           RendererSettings(width=192, height=128,
                                            clip_budget=64))
    return case, _jax_geometry(case)


@pytest.mark.parametrize("window", CLASSIC_WINDOWS, ids=wid)
def test_bin_triangles_window(window):
    """Windowed binning: tile_start, tile_count and the stats exactly, each
    tile's records as a set; the dead columns zero."""
    case, (_, jsu, _, _) = _classic_case()
    p = case.settings.max_pairs
    want = _jax_bin_window(jsu, case.ref_cfg, p, *window)
    rec_i, rec_f, rec_box, start, count, stats = binning.bin_triangles(
        _su_to_port(jsu), case.cfg, p, *window)
    w_rec_i, w_rec_f, w_start, w_count, w_stats = (
        np.asarray(x) if not isinstance(x, dict) else x for x in want)
    n_tiles = window[1] * case.cfg.grid_w
    assert start.shape == (n_tiles,)
    _same(start.numpy(), w_start)
    _same(count.numpy(), w_count)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in w_stats.items()}
    w_rec_i, w_rec_f = w_rec_i[:14, :p], w_rec_f[:, :p]
    got_i, got_f = rec_i.numpy(), rec_f.numpy()
    for s, c in zip(start.numpy(), count.numpy()):
        cols = slice(s, s + c)
        og, ow = np.argsort(got_i[12, cols]), np.argsort(w_rec_i[12, cols])
        _same(got_i[:, cols][:, og], w_rec_i[:, cols][:, ow])
        _same(got_f[:, cols][:, og], w_rec_f[:, cols][:, ow])
    n_live = int(count.sum())
    assert not got_i[:, n_live:].any()
    assert (n_live > 20) == (window[0] < case.cfg.grid_h)
    # every live record's box lies in its tile
    col0, col1, row0, row1 = binning.unpack_box(rec_box[0, :n_live])
    assert bool((col0 <= col1).all() and (row0 <= row1).all())


@pytest.mark.parametrize("window", [(3, 3), (6, 3)], ids=wid)
def test_slab_raster_and_shade(window):
    """K4's plain version over the slab's records against the reference's
    Pallas kernel with ``tile_rows`` (interpret mode), then
    ``shade(py_offset=)`` of the slab's vis against the reference's."""
    from ash_renderer_tpu.ops import raster_pallas
    from ash_renderer_tpu.ops import shade as jshade

    case, (_, jsu, jattrs, _) = _classic_case()
    tile_row0, tile_rows = window
    rec = _jax_bin_window(jsu, case.ref_cfg, case.settings.max_pairs, *window)
    want_d, want_t = raster_pallas.rasterize_visibility(
        *rec[:4], case.ref_cfg, interpret=True, tile_rows=tile_rows)
    got_d, got_t = raster_visibility.rasterize_visibility(
        tp.t(np.asarray(rec[0])[:14]), tp.t(rec[1]), tp.t(rec[2]),
        tp.t(rec[3]), case.cfg, tile_rows=tile_rows)
    assert got_t.shape == (tile_rows * 16, case.cfg.width)
    _same(got_t.numpy(), np.asarray(want_t))
    _same(got_d.numpy(), np.asarray(want_d))
    assert int((got_t >= 0).sum()) > 300

    mats, atlas, light = tp.jax_shading(case)
    cam_pos = case.cam.position.astype(np.float32)
    py_offset = tile_row0 * case.cfg.tile_h
    want = np.asarray(jax.jit(
        functools.partial(jshade.shade, jnp, cfg=case.ref_cfg,
                          clear_color=case.settings.clear_color,
                          py_offset=py_offset)
    )(want_t, jsu, jattrs, materials=mats, camera_pos=jnp.asarray(cam_pos)))
    st = tp.port_state(case)
    statics = tp.port_statics(case)
    mode = pipeline.surface_mode(statics, st.materials, None, None)
    consts = shade.pack_shade_consts(mode, st.materials, None, None,
                                     torch.from_numpy(cam_pos))
    got = shade.shade(got_t, _su_to_port(jsu), tp.t(jattrs), mode, consts,
                      cfg=case.cfg, clear_color=case.settings.clear_color,
                      py_offset=py_offset).numpy()
    _same(got, want)
