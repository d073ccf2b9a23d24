"""The classic route's shade + pack wrapper ``shade.shade_pack_classic``
(kernel K11 on a card) on the CPU, bit for bit against the JAX package's
``shade.shade`` followed by ``resolve_and_pack``, from the JAX package's
visibility buffer (its binning and its Pallas raster in interpret mode)
and the port's own setup table and attributes (``geometry_device``'s
fields as ``geometry.setup_table`` lays them out, which
``test_torch_classic_kernels.py`` holds to the reference's): the scenes
of ``test_torch_classic_kernels.CASES`` (nothing clipped, clipping over
the budget, textured and lit with three materials, 2x SSAA with sRGB, the
``local_tri`` path) and two row slabs of the clipping scene at their
screen-row offset."""

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
from test_torch_classic import _same  # noqa: E402
from test_torch_classic_kernels import CASES, classic_kernel_case  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import geometry, shade  # noqa: E402

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("cfg", "max_pairs", "tile_row0",
                                             "tile_rows"))
def _jax_vis(jsu, cfg, max_pairs, tile_row0, tile_rows):
    from ash_renderer_tpu.ops import binning as jbin
    from ash_renderer_tpu.ops import raster_pallas

    rec = jbin.bin_triangles(jsu, cfg, max_pairs, tile_row0, tile_rows)
    return raster_pallas.rasterize_visibility(
        *rec[:4], cfg, interpret=True, tile_rows=tile_rows)[1]


@functools.partial(jax.jit, static_argnames=("cfg", "clear_color",
                                             "py_offset", "supersample",
                                             "srgb"))
def _jax_shade_pack(vis_t, jsu, jattrs, materials, atlas, light, camera_pos,
                    cfg, clear_color, py_offset, supersample, srgb):
    from ash_renderer_tpu.ops import shade as jshade

    rgba = jshade.shade(jnp, vis_t, jsu, jattrs, materials=materials,
                        atlas=atlas, light=light, camera_pos=camera_pos,
                        cfg=cfg, clear_color=clear_color, py_offset=py_offset)
    return jshade.resolve_and_pack(jnp, rgba, supersample, srgb)


def _check(name, tile_row0=0, tile_rows=None):
    """K11's plain version on the case's frame (or the slab of
    ``tile_rows`` tile rows from ``tile_row0``) against the reference."""
    case, (_, jsu, jattrs_full, _), (_, su, attrs_full, _) = (
        classic_kernel_case(name))
    st, rst = case.settings, case.ref_settings
    vis_t = np.array(_jax_vis(jsu, case.ref_cfg, rst.max_pairs, tile_row0,
                              tile_rows))
    if tile_rows is None:
        vis_t = vis_t[: case.cfg.height, : case.cfg.width]
    else:
        vis_t = vis_t[:, : case.cfg.width]
    mats, atlas, light = tp.jax_shading(case)
    cam_pos = case.cam.position.astype(np.float32)
    py_offset = tile_row0 * case.cfg.tile_h
    want = np.asarray(_jax_shade_pack(
        jnp.asarray(vis_t), jsu, jattrs_full, mats, atlas, light,
        jnp.asarray(cam_pos), cfg=case.ref_cfg,
        clear_color=tuple(rst.clear_color), py_offset=py_offset,
        supersample=rst.supersample, srgb=rst.srgb_output))

    state = tp.port_state(case)
    statics = tp.port_statics(case)
    p_atlas = state.atlas if statics.has_atlas else None
    p_light = state.light if statics.has_light else None
    mode = pipeline.surface_mode(statics, state.materials, p_atlas, p_light)
    consts = shade.pack_shade_consts(mode, state.materials, p_atlas, p_light,
                                     torch.from_numpy(cam_pos))
    got = shade.shade_pack_classic(
        torch.from_numpy(vis_t), geometry.setup_table(su), attrs_full, mode,
        consts, atlas=p_atlas, light=p_light, cfg=case.cfg,
        clear_color=st.clear_color,
        supersample=st.supersample, srgb=st.srgb_output,
        py_offset=py_offset).numpy()
    _same(got, want)
    ss = st.supersample
    assert got.shape == (vis_t.shape[0] // ss, vis_t.shape[1] // ss, 4)
    return mode, vis_t, got


@pytest.mark.parametrize("name", list(CASES))
def test_shade_pack_classic_matches(name):
    """The RGBA8 frame equals the reference's byte for byte; each case
    reaches what its name says."""
    case = classic_kernel_case(name)[0]
    mode, vis_t, got = _check(name)
    assert int((vis_t >= 0).sum()) > 300 and got[..., :3].max() > 0
    if name == "textured_lit":
        assert mode == (3, 2, True, True, True)
    elif name == "ssaa2":
        st = case.settings
        assert st.supersample == 2 and st.srgb_output and mode[3] and mode[4]
    else:
        assert mode[3:] == (False, False)


@pytest.mark.parametrize("window", [(1, 2), (3, 2)],
                         ids=lambda w: f"rows{w[0]}+{w[1]}")
def test_shade_pack_classic_slab_offset(window):
    """Two middle row slabs of the clipping scene (192x128, 8 tile rows):
    K11's plain version shades each slab's visibility at its screen-row
    offset (``py_offset`` = tile_row0 * 16) as the reference does."""
    _, vis_t, got = _check("clip_overflow", *window)
    assert vis_t.shape[0] == window[1] * 16 and int((vis_t >= 0).sum()) > 100
