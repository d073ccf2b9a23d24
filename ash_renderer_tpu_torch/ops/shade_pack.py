"""Shade + pack: the raster kernel's phase F planes -> the RGBA8 frame.

Kernel K7.  ``shade_pack`` launches ``csrc/shade_pack.cu`` on CUDA
tensors and runs ``shade_pack_plain`` on CPU tensors: the torch chain
``shade.combine_from_prelight`` (quad gather + bilinear lerp, texture
modulation, lighting combine, clear), the tile-to-image relayout
(``tile_image``) and ``shade.resolve_and_pack`` (SSAA box, sRGB LUT,
RGBA8 pack), bit-equal to the phase F branch of the JAX package's
``_shade_from_planes``.

It replaces no Pallas kernel.  The reference computes this stage as XLA
glue after the fused kernel (``ash_renderer_tpu/pipeline.py:147-295``,
phase F branch ``:239-258``), which XLA fuses; in eager torch the same
chain is 20-30 launches and ~10 full-frame temporaries of 8-33 MB each.

What bounds it on the card: bytes.  Each render sample's winner id and,
where it is covered, the plane rows its shading needs (and a 16-byte
quad where it is textured) are read once, and 4 bytes a pixel written;
at the 1080p headline that is ~0.02 ms at 3.35 TB/s.  The kernel runs
one thread per output pixel, its samples' plane columns read straight
into registers, a background sample reading its winner id alone
(``csrc/shade_pack.cu``).

The phase E route (K3 then ``shade.surface_prelight``) keeps the plain
chain: ``pipeline._shade_from_planes`` lays its RGBA out with
``pack_tiles``.  The classic route's shade + pack is kernel K11
(``shade.shade_pack_classic``), a second entry of the same source that
shares K7's combine, SSAA box and pack.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import specmath as sm
from . import fused_kernel as fk
from . import shade

KERNEL = "K7_shade_pack"


def frame_rows(cfg, n_tiles: int, full_frame: bool = True) -> int:
    """The render rows the frame of ``n_tiles`` tiles keeps: the render
    height for a whole frame, every row of its tile rows for a slab."""
    return cfg.height if full_frame else n_tiles // cfg.grid_w * cfg.tile_h


def tile_image(x, cfg, full_frame: bool = True):
    """(n_tiles, tile_h * 128, ...) tile-flat pixels -> (rows, width, ...)
    image of their n_tiles / grid_w tile rows, cropped to the width and
    ``frame_rows``."""
    th, tw, gw = cfg.tile_h, fk.TILE_W, cfg.grid_w
    gh = x.shape[0] // gw
    rest = x.shape[2:]
    img = (x.reshape(gh, gw, th, tw, *rest).transpose(1, 2)
           .reshape(gh * th, gw * tw, *rest))
    return img[: frame_rows(cfg, x.shape[0], full_frame), : cfg.width]


def pack_tiles(rgba, cfg, supersample: int, srgb: bool,
               full_frame: bool = True):
    """(n_tiles, tile_h * 128, 4) f32 tile-flat RGBA -> the RGBA8 frame
    (``tile_image``, then ``shade.resolve_and_pack``; at supersample 1 the
    pack runs first and the relayout moves 4 bytes a pixel)."""
    if supersample == 1:
        return tile_image(shade.resolve_and_pack(rgba, 1, srgb), cfg,
                          full_frame)
    return shade.resolve_and_pack(tile_image(rgba, cfg, full_frame),
                                  supersample, srgb)


def shade_pack(planes, cfg, supersample: int, srgb: bool, clear_color,
               atlas=None, light=None, has_materials: bool = True,
               full_frame: bool = True):
    """Shade + pack the phase F planes ((n_tiles, 24, tile_h * 128)
    int32, the raster kernel's with a shade mode) into the RGBA8 frame
    (rows / supersample, width / supersample, 4) uint8; ``rows`` is
    ``frame_rows``.  ``atlas`` / ``light``: None where the shade mode has
    no texture / lighting stage; ``has_materials``: the mode's (without
    materials there is no specular term).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    dev = planes.device
    if dev.type == "cpu":
        return shade_pack_plain(planes, cfg, supersample, srgb, clear_color,
                                atlas, light, has_materials, full_frame)
    if dev.type != "cuda":
        raise ValueError(f"shade_pack: unsupported device {dev}")
    fk.check_tiles(cfg)
    npix = cfg.tile_h * fk.TILE_W
    n_tiles = planes.shape[0] if planes.dim() == 3 else 0
    if (planes.dtype != torch.int32 or planes.dim() != 3
            or tuple(planes.shape[1:]) != (fk.OUT_COLS, npix)
            or n_tiles == 0 or n_tiles % cfg.grid_w
            or not planes.is_contiguous()):
        raise ValueError(f"shade_pack: bad planes {planes.dtype} "
                         f"{tuple(planes.shape)}")
    rows = frame_rows(cfg, n_tiles, full_frame)
    ss = supersample
    if ss < 1 or rows % ss or cfg.width % ss:
        raise ValueError(f"shade_pack: {rows}x{cfg.width} render pixels "
                         f"do not resolve at supersample {ss}")
    quads = lcol = lut = None
    if atlas is not None:
        quads = atlas.quads
        if (quads.device != dev or quads.dtype != torch.int32
                or quads.dim() != 2 or quads.shape[1] != 4
                or quads.shape[0] == 0 or not quads.is_contiguous()
                or quads.data_ptr() % 16):
            raise ValueError(f"shade_pack: bad quads {quads.dtype} "
                             f"{tuple(quads.shape)} on {quads.device}")
    if light is not None:
        lcol = light.color
        if (lcol.device != dev or lcol.dtype != torch.float32
                or tuple(lcol.shape) != (3,) or not lcol.is_contiguous()):
            raise ValueError(f"shade_pack: bad light colour {lcol.dtype} "
                             f"{tuple(lcol.shape)} on {lcol.device}")
    if srgb:
        lut = shade.srgb_lut(dev)
    out = torch.empty((rows // ss, cfg.width // ss, 4), dtype=torch.uint8,
                      device=dev)
    clear = [float(v) for v in np.asarray(clear_color, dtype=np.float32)]
    _build.launch(
        KERNEL, "ash_shade_pack", dev, planes.data_ptr(),
        None if quads is None else quads.data_ptr(),
        0 if quads is None else quads.shape[0],
        None if lcol is None else lcol.data_ptr(),
        None if lut is None else lut.data_ptr(), out.data_ptr(),
        cfg.grid_w, cfg.tile_h, rows // ss, cfg.width // ss, ss,
        sm._f32(1.0 / (ss * ss)), int(has_materials), *clear,
    )
    return out


def shade_pack_plain(planes, cfg, supersample: int, srgb: bool, clear_color,
                     atlas=None, light=None, has_materials: bool = True,
                     full_frame: bool = True):
    """shade_pack in torch ops (any device): ``combine_planes``, then
    ``pack_tiles``."""
    rgba = combine_planes(planes, clear_color, atlas, light, has_materials)
    return pack_tiles(rgba, cfg, supersample, srgb, full_frame)


def combine_planes(planes, clear_color, atlas=None, light=None,
                   has_materials: bool = True):
    """``shade.combine_from_prelight`` on the phase F planes' rows:
    (n_tiles, tile_h * 128, 4) f32 tile-flat RGBA."""
    pf = planes.view(torch.float32)
    return shade.combine_from_prelight(
        planes[:, fk.VIS_ROW] >= 0, pf[:, fk.F_P : fk.F_P + 4],
        pf[:, fk.F_DIFF : fk.F_DIFF + 3], pf[:, fk.F_SPEC],
        planes[:, fk.F_LIT], planes[:, fk.F_TAP], pf[:, fk.F_FU],
        pf[:, fk.F_FV], planes[:, fk.F_TEXMASK], atlas=atlas, light=light,
        has_materials=has_materials, clear_color=clear_color,
    )
