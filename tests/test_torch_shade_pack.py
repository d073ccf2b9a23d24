"""Shade + pack (``ops/shade_pack.shade_pack``: kernel K7 on a card, its
plain version on CPU tensors) against the phase F branch of the JAX
package's ``_shade_from_planes`` under ``jax.jit`` on the CPU, bit for
bit (RGBA8).

Both take the same int32 planes, made with numpy from a seed: covered
samples hold phase F values (colours past [0, 1] for the clamps, lit and
texmask words other than 0 and 1, taps inside and outside the quad
table), background samples random words (NaN and Inf patterns among
them), and some tile rows are empty.  The port's side goes through
``pipeline._shade_from_planes``, which must call the plain version on
CPU tensors.  The tables are two random 32x32 textures, two materials
and a light of a colour other than white."""

import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import RendererSettings, derive_raster_config  # noqa: E402
from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.config import \
    derive_raster_config as port_raster_config  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from ash_renderer_tpu_torch.ops import shade_pack  # noqa: E402

torch.set_num_threads(1)

SIZE = dict(width=200, height=120)  # 1.56 tiles wide: the width is cropped
TEXTURED_LIT = (2, 2, True, True, True)  # (M, T, has_m, has_a, has_l)
# name -> (settings fields, tile height, shade mode, planes kind, first
# tile row of a slab of SLAB_ROWS tile rows (None: the whole frame))
CASES = {
    "textured_lit": (SIZE, 8, TEXTURED_LIT, "phase_f", None),
    "lit_no_atlas": (SIZE, 8, (2, 0, True, False, True), "phase_f", None),
    "unlit": (SIZE, 8, (2, 2, True, True, False), "phase_f", None),
    "no_materials": (SIZE, 8, (0, 0, False, False, True), "phase_f", None),
    "clear_color": (dict(SIZE, clear_color=(0.25, 0.5, 0.75, 0.3)), 8,
                    TEXTURED_LIT, "phase_f", None),
    "tap_outside": (SIZE, 8, TEXTURED_LIT, "taps_outside", None),
    "ssaa_srgb": (dict(width=96, height=60, supersample=2, srgb_output=True),
                  8, TEXTURED_LIT, "phase_f", None),
    "tile_h4": (SIZE, 4, TEXTURED_LIT, "phase_f", None),
    "slab": (SIZE, 8, TEXTURED_LIT, "phase_f", 3),
    "non_finite": (SIZE, 8, TEXTURED_LIT, "non_finite", None),
}
SLAB_ROWS = 5
LIGHT_COLOR = (0.9, 0.7, 0.5)


@functools.lru_cache(maxsize=None)
def _tables():
    """(JAX materials, atlas, light; the port's atlas and light) of two
    random textures, two materials and a coloured light."""
    from ash_renderer_tpu.rtypes import LightPack, MaterialsPack
    from ash_renderer_tpu.textures import TextureAtlas

    from ash_renderer_tpu_torch import rtypes, textures

    rng = np.random.default_rng(19)
    images = [rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
              for _ in range(2)]
    atlas = TextureAtlas.build(images)
    mats = MaterialsPack(
        base_color=np.ones((2, 4), np.float32),
        tex_id=np.array([0, 1], np.int32),
        specular=np.array([0.5, 0.2], np.float32),
        shininess=np.array([32, 8], np.int32))
    light = LightPack(direction=np.array([0.4, -0.6, 0.7], np.float32),
                      color=np.array(LIGHT_COLOR, np.float32),
                      ambient=np.float32(0.2))
    port_atlas = textures.TextureAtlas(**{
        f.name: tp.t(getattr(atlas, f.name))
        for f in dataclasses.fields(TextureAtlas)})
    port_light = rtypes.LightPack(direction=tp.t(light.direction),
                                  color=tp.t(light.color),
                                  ambient=tp.t(light.ambient))
    return mats, atlas, light, port_atlas, port_light


def _planes(seed, n_tiles, gw, npix, kind, n_quads):
    """(n_tiles, 24, npix) int32 planes: phase F values on covered samples
    (``kind`` "taps_outside": every tap outside [0, n_quads); "non_finite":
    NaN, +-Inf and -0.0 among rows 0-7), random words elsewhere; the first
    tile row and every fourth sample of the last are empty."""
    rng = np.random.default_rng(seed)
    shape = (n_tiles, npix)
    planes = rng.integers(-2 ** 31, 2 ** 31, (n_tiles, fk.OUT_COLS, npix),
                          dtype=np.int64).astype(np.int32)

    def f(lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    rows = {fk.F_P + k: f(-0.25, 1.25) for k in range(4)}
    rows.update({fk.F_DIFF + k: f(0.0, 1.3) for k in range(3)})
    rows[fk.F_SPEC] = f(0.0, 0.9)
    if kind == "non_finite":
        special = np.array([np.nan, np.inf, -np.inf, -0.0], np.float32)
        for r in range(fk.F_SPEC + 1):
            hit = rng.random(shape) < 0.08
            rows[r] = np.where(hit, rng.choice(special, shape), rows[r])
    rows = {r: v.view(np.int32) for r, v in rows.items()}
    rows[fk.F_LIT] = rng.choice(np.array([0, 1, 1, 1, 3], np.int32), shape)
    if kind == "taps_outside":
        below = rng.integers(-2 ** 31, 0, shape)
        above = rng.integers(n_quads, 2 ** 31, shape)
        rows[fk.F_TAP] = np.where(rng.random(shape) < 0.5, below,
                                  above).astype(np.int32)
    else:
        rows[fk.F_TAP] = rng.integers(-40, n_quads + 40, shape,
                                      dtype=np.int32)
    rows[fk.F_FU] = f(0.0, 1.0).view(np.int32)
    rows[fk.F_FV] = f(0.0, 1.0).view(np.int32)
    rows[fk.F_TEXMASK] = rng.choice(np.array([0, 1, 1, 1, -2], np.int32),
                                    shape)
    valid = rng.random(shape) < 0.75
    valid[:gw] = False
    valid[-gw:, ::4] = False
    for r, v in rows.items():
        planes[:, r] = np.where(valid, v, planes[:, r])
    planes[:, fk.F_TEXMASK + 1 : fk.VIS_ROW] = 0
    planes[:, fk.VIS_ROW] = np.where(
        valid, rng.integers(0, 1 << 20, shape, dtype=np.int32), -1)
    return planes


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port statics, JAX statics, planes, shade mode, first slab row)."""
    from ash_renderer_tpu.pipeline import FrameStatics as JaxStatics

    fields, tile_h, mode, kind, row0 = CASES[name]
    settings = RendererSettings(fused_surface_shade="on", **fields)
    w, h = settings.render_width, settings.render_height
    cfg = derive_raster_config(w, h, tile_h=tile_h)
    _, _, has_m, has_a, has_l = mode
    statics = pipeline.FrameStatics(
        cfg=port_raster_config(w, h, tile_h=tile_h),
        settings=tp.port_settings(settings), has_atlas=has_a,
        has_light=has_l)
    jstatics = JaxStatics(cfg=cfg, settings=settings, has_materials=has_m,
                          has_atlas=has_a, has_light=has_l, interpret=True)
    gh = cfg.grid_h if row0 is None else SLAB_ROWS
    n_quads = _tables()[1].quads.shape[0]
    planes = _planes(sum(map(ord, name)), gh * cfg.grid_w, cfg.grid_w,
                     tile_h * fk.TILE_W, kind, n_quads)
    return statics, jstatics, planes, mode, row0


def _jax_frame(name):
    """The JAX package's phase F shade + pack of the case's planes."""
    from ash_renderer_tpu import pipeline as jpl

    _, jstatics, planes, mode, row0 = _case(name)
    mats, atlas, light, _, _ = _tables()
    _, _, has_m, has_a, has_l = mode
    mats = mats if has_m else None
    atlas = atlas if has_a else None
    light = light if has_l else None
    assert jpl.shade_mode_for(jstatics, mats, atlas, light) == mode
    stage = jax.jit(functools.partial(
        jpl._shade_from_planes, jstatics, tile_row0=row0 or 0))
    cam = np.zeros(3, np.float32)
    return np.asarray(stage(planes, cam, mats, atlas, light))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain version's calls."""
    calls = []
    real = shade_pack.shade_pack_plain

    def spy(*args, **kw):
        calls.append(args[0].device)
        return real(*args, **kw)

    monkeypatch.setattr(shade_pack, "shade_pack_plain", spy)
    return calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_shade_pack_matches_the_reference(name, plain_calls):
    """The port's shade + pack of the planes (through
    ``pipeline._shade_from_planes``, which takes the plain version on CPU
    tensors) equals the JAX package's RGBA8 frame."""
    statics, _, planes, mode, row0 = _case(name)
    _, _, _, atlas, light = _tables()
    got = pipeline._shade_from_planes(
        statics, tp.t(planes), mode, None, True, atlas, light,
        full_frame=row0 is None)
    assert plain_calls == [torch.device("cpu")]
    want = _jax_frame(name)
    st, cfg = statics.settings, statics.cfg
    rows = cfg.height if row0 is None else SLAB_ROWS * cfg.tile_h
    assert want.shape == (rows // st.supersample,
                          cfg.width // st.supersample, 4)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # the frame is neither all clear nor all one colour
    assert len(np.unique(want.reshape(-1, 4), axis=0)) > 100


def test_a_device_that_is_neither_cpu_nor_cuda_is_refused():
    statics, _, planes, mode, _ = _case("textured_lit")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        shade_pack.shade_pack(
            tp.t(planes).to(meta), statics.cfg, 1, False, (0, 0, 0, 1))
