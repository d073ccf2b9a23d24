"""Deferred shading in torch ops (counterpart of the fused path's subset of
``ash_renderer_tpu/ops/shade.py``): the interpolation half the raster
kernel's phase E runs, the surface half (material, mip selection, bilinear
texture tap, Blinn-Phong, clear) and the resolve + RGBA8 pack.

Every op is a single IEEE float32 mul/add/sub, a select, an integer op or a
table gather, in the spec's association, so results equal the reference's
bit for bit on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import specmath as sm
from ..specmath import _f32
from ..textures import MAX_LEVELS

F32 = torch.float32
I32 = torch.int32


def _take(arr, idx):
    """Clipped gather along axis 0: arr[clip(idx, 0, n - 1)]."""
    n = arr.shape[0]
    flat = torch.clamp(idx, 0, n - 1).reshape(-1).long()
    return arr.index_select(0, flat).reshape(idx.shape + arr.shape[1:])


def _edges_at_pixels(g, px, py, cfg):
    """The three int32 edge values at pixel centres, and the edges' A
    coefficients."""
    sx, sy = sm.pixel_sample_coords(px, py, cfg.subpixel_scale)
    x0, y0 = g["x0"], g["y0"]
    x1, y1 = g["x1"], g["y1"]
    x2, y2 = g["x2"], g["y2"]
    a0, b0, _ = sm.edge_coeffs(x1, y1, x2, y2)
    a1, b1, _ = sm.edge_coeffs(x2, y2, x0, y0)
    a2, b2, _ = sm.edge_coeffs(x0, y0, x1, y1)
    e0 = sm.edge_at(a0, b0, x1, y1, sx, sy)
    e1 = sm.edge_at(a1, b1, x2, y2, sx, sy)
    e2 = sm.edge_at(a2, b2, x0, y0, sx, sy)
    return (e0, e1, e2), (a0, a1, a2)


def interp_fields_stacked(g, A0, A1, A2, px, py, cfg):
    """Perspective-correct interpolation of the 12 attribute channels,
    stacked on axis -2 of A0/A1/A2 ((..., 12, N) per corner; g's fields and
    px/py are (..., N)), plus the raw uv screen derivatives the mip selector
    scales by the level size.  Returns (attr (..., 12, N), (durx, dvrx,
    dury, dvry) each (..., N))."""
    (e0, e1, e2), (a0c, a1c, a2c) = _edges_at_pixels(g, px, py, cfg)
    l0, l1, l2 = sm.bary_weights(e0, e1, e2, g["inv_area2"])
    m0, m1, m2 = sm.persp_weights(l0, l1, l2, g["iw0"], g["iw1"], g["iw2"])
    attr = sm.dot3(
        m0[..., None, :], A0, m1[..., None, :], A1, m2[..., None, :], A2
    )

    scale = float(cfg.subpixel_scale)
    x0, y0 = g["x0"], g["y0"]
    x1, y1 = g["x1"], g["y1"]
    x2, y2 = g["x2"], g["y2"]
    b0 = x2 - x1
    b1 = x0 - x2
    b2 = x1 - x0
    inv_area = g["inv_area2"]
    dp = []
    for (ea, eb), iw in (
        ((a0c, b0), g["iw0"]),
        ((a1c, b1), g["iw1"]),
        ((a2c, b2), g["iw2"]),
    ):
        gx = ea.to(F32) * scale * inv_area * iw
        gy = eb.to(F32) * scale * inv_area * iw
        dp.append((gx, gy))
    p0 = e0.to(F32) * inv_area * g["iw0"]
    p1 = e1.to(F32) * inv_area * g["iw1"]
    p2 = e2.to(F32) * inv_area * g["iw2"]
    s = (p0 + p1) + p2
    inv_s = sm.recip_spec(s)
    u0, v0c = A0[..., 7, :], A0[..., 8, :]
    u1, v1c = A1[..., 7, :], A1[..., 8, :]
    u2, v2c = A2[..., 7, :], A2[..., 8, :]
    u, v = attr[..., 7, :], attr[..., 8, :]

    def raws(axis):
        dsx = sm.dot3(dp[0][axis], 1.0, dp[1][axis], 1.0, dp[2][axis], 1.0)
        dux = sm.dot3(dp[0][axis], u0, dp[1][axis], u1, dp[2][axis], u2)
        dvx = sm.dot3(dp[0][axis], v0c, dp[1][axis], v1c, dp[2][axis], v2c)
        return (dux - u * dsx) * inv_s, (dvx - v * dsx) * inv_s

    durx, dvrx = raws(0)
    dury, dvry = raws(1)
    return attr, (durx, dvrx, dury, dvry)


def _normalize3(v):
    """Vector normalize via the spec rsqrt; zero-safe.  Returns (v / |v|,
    |v|^2)."""
    n2 = sm.dot3(v[..., 0], v[..., 0], v[..., 1], v[..., 1], v[..., 2], v[..., 2])
    inv = sm.rsqrt_spec(torch.clamp(n2, min=_f32(1e-30)))
    return v * inv[..., None], n2


def _mip_from_raws(duv, atlas, tex_id):
    """Nearest mip level from the raw uv derivatives: floor(log2 of the
    larger texel footprint), from exponent bits."""
    durx, dvrx, dury, dvry = duv
    tex_c = torch.clamp(tex_id, 0, atlas.level_w.shape[0] - 1)
    bw = _take(atlas.level_w[:, 0], tex_c).to(F32)
    bh = _take(atlas.level_h[:, 0], tex_c).to(F32)
    nl = _take(atlas.n_levels, tex_c)

    def footprint2(dur, dvr):
        du = dur * bw
        dv = dvr * bh
        return du * du + dv * dv

    rho2 = torch.maximum(footprint2(durx, dvrx), footprint2(dury, dvry))
    rho2 = torch.clamp(rho2, min=_f32(1e-20))
    level = sm.float_exponent(rho2) >> 1
    hi = torch.clamp(nl - 1, min=0)
    return torch.minimum(torch.clamp(level, min=0), hi).to(I32)


def sample_texture(atlas, tex_id, u, v, level):
    """Wrap-addressed bilinear tap at an explicit mip level; one quad-table
    row gather fetches the 2x2 footprint."""
    tex_c = torch.clamp(tex_id, 0, atlas.level_offset.shape[0] - 1)
    flat = tex_c * MAX_LEVELS + level
    off = _take(atlas.level_offset.reshape(-1), flat)
    w = _take(atlas.level_w.reshape(-1), flat)
    h = _take(atlas.level_h.reshape(-1), flat)
    # background pixels carry NaN uv (masked later): zero them before the
    # float -> int casts
    u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    ut = u * w.to(F32) - 0.5
    vt = v * h.to(F32) - 0.5
    iu0 = torch.floor(ut).to(I32)
    iv0 = torch.floor(vt).to(I32)
    fu = ut - iu0.to(F32)
    fv = vt - iv0.to(F32)
    tap = off + torch.remainder(iv0, h) * w + torch.remainder(iu0, w)
    quad = _take(atlas.quads, tap)  # (..., 4) packed texels
    k = _f32(1.0 / 255.0)

    def unpack(t32):
        return torch.stack(
            [((t32 >> s) & 255).to(F32) * k for s in (0, 8, 16, 24)], dim=-1
        )

    c00 = unpack(quad[..., 0])
    c10 = unpack(quad[..., 1])
    c01 = unpack(quad[..., 2])
    c11 = unpack(quad[..., 3])
    top = sm.lerp(c00, c10, fu[..., None])
    bot = sm.lerp(c01, c11, fu[..., None])
    return sm.lerp(top, bot, fv[..., None])


def shade_surface(valid, attr, mat_id, duv, materials=None, atlas=None,
                  light=None, camera_pos=None, clear_color=(0.0, 0.0, 0.0, 1.0)):
    """The surface half of shading from interpolated values: material
    modulation, mip selection + texture tap, Blinn-Phong, background clear.
    attr: list of 12 channel tensors; duv: (durx, dvrx, dury, dvry).
    Returns (..., 4) f32 RGBA."""
    color = torch.stack(attr[0:4], dim=-1)
    normal = torch.stack(attr[4:7], dim=-1)
    u, v = attr[7], attr[8]
    wpos = torch.stack(attr[9:12], dim=-1)

    rgba = color
    if materials is not None:
        mat = torch.clamp(mat_id, 0, materials.base_color.shape[0] - 1)
        rgba = rgba * _take(materials.base_color, mat)
        if atlas is not None:
            tex_id = _take(materials.tex_id, mat)
            level = _mip_from_raws(duv, atlas, tex_id)
            texel = sample_texture(atlas, tex_id, u, v, level)
            rgba = torch.where((tex_id >= 0)[..., None], rgba * texel, rgba)

    if light is not None:
        n, n2 = _normalize3(normal)
        lit = n2 > _f32(1e-12)  # vertices without normals stay unlit
        ldir, _ = _normalize3(light.direction.expand(normal.shape))
        ndotl = torch.clamp(
            -sm.dot3(
                n[..., 0], ldir[..., 0], n[..., 1], ldir[..., 1], n[..., 2],
                ldir[..., 2],
            ),
            min=0.0,
        )
        diffuse = light.ambient + ndotl[..., None] * light.color
        rgb = rgba[..., :3] * diffuse
        if materials is not None and camera_pos is not None:
            spec_k = _take(materials.specular, mat)
            shin = _take(materials.shininess, mat)
            vdir, _ = _normalize3(camera_pos - wpos)
            hv, _ = _normalize3(vdir - ldir)
            ndoth = torch.clamp(
                sm.dot3(
                    n[..., 0], hv[..., 0], n[..., 1], hv[..., 1], n[..., 2],
                    hv[..., 2],
                ),
                min=0.0,
            )
            spec = sm.powi(ndoth, shin, 8) * spec_k
            rgb = rgb + spec[..., None] * light.color
        rgba = torch.cat(
            [torch.where(lit[..., None], rgb, rgba[..., :3]), rgba[..., 3:4]],
            dim=-1,
        )

    clear = torch.tensor(
        np.asarray(clear_color, dtype=np.float32), device=rgba.device
    )
    return torch.where(valid[..., None], rgba, clear)


def resolve_and_pack(rgba, supersample: int, srgb: bool):
    """Box-resolve the supersampled (H*s, W*s, 4) image (ordered sum over
    the s*s footprint, then * 1/s^2) and pack to RGBA8, optionally through
    the sRGB LUT."""
    if supersample > 1:
        h, w = rgba.shape[0] // supersample, rgba.shape[1] // supersample
        r = rgba.reshape(h, supersample, w, supersample, 4)
        acc = None
        for i in range(supersample):
            for j in range(supersample):
                term = r[:, i, :, j, :]
                acc = term if acc is None else acc + term
        rgba = acc * _f32(1.0 / (supersample * supersample))
    if srgb:
        lut = torch.from_numpy(sm.srgb_encode_lut()).to(rgba.device)
        idx = torch.round(torch.clamp(rgba[..., :3], 0.0, 1.0) * 4095.0).long()
        rgba = torch.cat([lut[idx], rgba[..., 3:4]], dim=-1)
    return sm.pack_unorm8(rgba)
