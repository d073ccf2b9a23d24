"""Deferred shading in numpy: the oracle's copy of
``ash_renderer_tpu/ops/shade.py`` with the array namespace fixed to numpy.

A second implementation of the port's torch shade stage
(``ash_renderer_tpu_torch/ops/shade.py``), not a wrapper of it: the same
spec formulas (``specmath_np``), written over numpy arrays.  Its texture
tap casts float to int32 as numpy does (an out-of-range value is
undefined there), as the JAX package's own oracle does; the device side
saturates (``specmath.f32_to_i32_sat``), so the two part only where u * w
or v * h reaches 2**31.

Stages: the visibility buffer's winner rows are gathered per pixel
(``shade``), interpolated (``interp_fields``), shaded (``shade_surface``:
material, mip level + bilinear tap, Blinn-Phong, background clear) and
resolved + packed to RGBA8 (``resolve_and_pack``).  ``combine_from_prelight``
is the post-tap half of ``shade_surface`` over phase F's planes.
"""

from __future__ import annotations

import numpy as np

from ..textures import MAX_LEVELS
from . import specmath_np as sm

F32 = np.float32
I32 = np.int32


def _take(arr, idx):
    """Row gather along axis 0 with the index clipped to the table."""
    arr = np.asarray(arr)
    return arr[np.clip(idx, 0, arr.shape[0] - 1)]


def _edges_at_pixels(su_g, px, py, cfg):
    """The three int32 edge values at pixel centres for the per-pixel setup
    ``su_g`` (dict of arrays), and the edges' A coefficients."""
    sx, sy = sm.pixel_sample_coords(px, py, cfg.subpixel_scale)
    x0, y0 = su_g["x0"], su_g["y0"]
    x1, y1 = su_g["x1"], su_g["y1"]
    x2, y2 = su_g["x2"], su_g["y2"]
    a0, b0, _ = sm.edge_coeffs(x1, y1, x2, y2)
    a1, b1, _ = sm.edge_coeffs(x2, y2, x0, y0)
    a2, b2, _ = sm.edge_coeffs(x0, y0, x1, y1)
    e0 = sm.edge_at(a0, b0, x1, y1, sx, sy)
    e1 = sm.edge_at(a1, b1, x2, y2, sx, sy)
    e2 = sm.edge_at(a2, b2, x0, y0, sx, sy)
    return (e0, e1, e2), (a0, a1, a2)


def _normalize3(v):
    """Zero-safe normalize through the spec's rsqrt; returns (v / |v|,
    |v|^2)."""
    n2 = sm.dot3(v[..., 0], v[..., 0], v[..., 1], v[..., 1], v[..., 2], v[..., 2])
    inv = sm.rsqrt_spec(np.maximum(n2, F32(1e-30)))
    return v * inv[..., None], n2


def _unpack(t32, ch):
    """Channel ``ch`` of packed RGBA8 int32 texels as f32 in [0, 1]."""
    return ((t32 >> (8 * ch)) & 255).astype(F32) * F32(1.0 / 255.0)


def sample_texture(atlas, tex_id, u, v, level):
    """Wrap-addressed bilinear tap at an explicit mip level; pixels with a
    negative tex_id still tap (clamped) and are masked by the caller."""
    tex_c = np.clip(tex_id, 0, atlas.level_offset.shape[0] - 1)
    flat = tex_c * MAX_LEVELS + level
    off = _take(atlas.level_offset.reshape(-1), flat)
    w = _take(atlas.level_w.reshape(-1), flat)
    h = _take(atlas.level_h.reshape(-1), flat)

    # background pixels carry NaN uv (masked later): zero them first
    u = np.where(np.isfinite(u), u, F32(0.0))
    v = np.where(np.isfinite(v), v, F32(0.0))
    ut = u * w.astype(F32) - F32(0.5)
    vt = v * h.astype(F32) - F32(0.5)
    iu0 = np.floor(ut).astype(I32)
    iv0 = np.floor(vt).astype(I32)
    fu = ut - iu0.astype(F32)
    fv = vt - iv0.astype(F32)
    iu0w = np.mod(iu0, w)
    iv0w = np.mod(iv0, h)

    # one row of the quad table holds the 2x2 footprint [texel, right,
    # down, down-right], wrap-addressed
    quad = _take(atlas.quads, off + iv0w * w + iu0w)  # (..., 4) i32

    def texel(k):
        return np.stack([_unpack(quad[..., k], ch) for ch in range(4)], axis=-1)

    top = sm.lerp(texel(0), texel(1), fu[..., None])
    bot = sm.lerp(texel(2), texel(3), fu[..., None])
    return sm.lerp(top, bot, fv[..., None])


def interp_fields(g, a0, a1, a2, px, py, cfg):
    """Per-pixel edge functions, perspective-correct weights, the 12
    interpolated attribute channels and the raw uv screen derivatives the
    mip selector takes.  a0/a1/a2: each corner's attributes as lists of 12
    per-channel arrays.  Returns (attr list of 12, (durx, dvrx, dury,
    dvry))."""
    (e0, e1, e2), (a0c, a1c, a2c) = _edges_at_pixels(g, px, py, cfg)
    l0, l1, l2 = sm.bary_weights(e0, e1, e2, g["inv_area2"])
    m0, m1, m2 = sm.persp_weights(l0, l1, l2, g["iw0"], g["iw1"], g["iw2"])
    attr = [sm.dot3(m0, a0[ch], m1, a1[ch], m2, a2[ch]) for ch in range(12)]

    # mip derivative raws, cut at _mip_level's "* bw"
    scale = F32(cfg.subpixel_scale)
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
        gx = ea.astype(F32) * scale * inv_area * iw
        gy = eb.astype(F32) * scale * inv_area * iw
        dp.append((gx, gy))
    p0 = e0.astype(F32) * inv_area * g["iw0"]
    p1 = e1.astype(F32) * inv_area * g["iw1"]
    p2 = e2.astype(F32) * inv_area * g["iw2"]
    s = (p0 + p1) + p2
    inv_s = sm.recip_spec(s)
    u0, v0c = a0[7], a0[8]
    u1, v1c = a1[7], a1[8]
    u2, v2c = a2[7], a2[8]
    u, v = attr[7], attr[8]

    def raws(axis):
        dsx = sm.dot3(dp[0][axis], F32(1.0), dp[1][axis], F32(1.0),
                      dp[2][axis], F32(1.0))
        dux = sm.dot3(dp[0][axis], u0, dp[1][axis], u1, dp[2][axis], u2)
        dvx = sm.dot3(dp[0][axis], v0c, dp[1][axis], v1c, dp[2][axis], v2c)
        return (dux - u * dsx) * inv_s, (dvx - v * dsx) * inv_s

    durx, dvrx = raws(0)
    dury, dvry = raws(1)
    return attr, (durx, dvrx, dury, dvry)


_PACK_FIELDS = "x0 y0 x1 y1 x2 y2 inv_area2 iw0 iw1 iw2 v0 v1 v2 mat".split()
_PACK_FLOAT = {"inv_area2", "iw0", "iw1", "iw2"}


def pack_setup_table(su):
    """(S, 16) int32 shading fields of a TriangleSetup (floats bitcast, two
    zero columns)."""
    cols = []
    for k in _PACK_FIELDS:
        v = np.asarray(getattr(su, k))
        cols.append(sm.bitcast_i32(v) if k in _PACK_FLOAT else v)
    cols += [np.zeros_like(cols[0])] * 2
    return np.stack(cols, axis=1)


def shade(vis_tri, su, attrs, materials=None, atlas=None, light=None,
          camera_pos=None, cfg=None, clear_color=(0.0, 0.0, 0.0, 1.0),
          py_offset: int = 0):
    """Shade the visibility buffer into an f32 RGBA image (render
    resolution).  su: TriangleSetup of numpy arrays; attrs: (VA, 12)
    combined attribute table.  py_offset: the global pixel row of
    vis_tri's first row."""
    valid = vis_tri >= 0
    t = np.clip(vis_tri, 0, su.x0.shape[0] - 1)
    packed = _take(pack_setup_table(su), t)  # (H, W, 16)
    g = {}
    for i, k in enumerate(_PACK_FIELDS):
        v = packed[..., i]
        g[k] = sm.bitcast_f32(v) if k in _PACK_FLOAT else v
    a_v0 = _take(attrs, g["v0"])  # (H, W, 12)
    a_v1 = _take(attrs, g["v1"])
    a_v2 = _take(attrs, g["v2"])
    return shade_gathered(
        valid, g, a_v0, a_v1, a_v2, materials=materials, atlas=atlas,
        light=light, camera_pos=camera_pos, cfg=cfg, clear_color=clear_color,
        py_offset=py_offset,
    )


def shade_gathered(valid, g, a_v0, a_v1, a_v2, materials=None, atlas=None,
                   light=None, camera_pos=None, cfg=None,
                   clear_color=(0.0, 0.0, 0.0, 1.0), py_offset: int = 0,
                   px=None, py=None):
    """The per-pixel shading math given each pixel's winner setup ``g``
    (x0..y2, inv_area2, iw0-2, mat) and its three corner attribute rows.
    px/py: per-element pixel coordinates; default the (H, W) raster
    order."""
    h, w = valid.shape
    if px is None:
        px = _iota2(h, w, 1)
    if py is None:
        py = _iota2(h, w, 0) + py_offset
    a0 = [a_v0[..., ch] for ch in range(12)]
    a1 = [a_v1[..., ch] for ch in range(12)]
    a2 = [a_v2[..., ch] for ch in range(12)]
    attr, duv = interp_fields(g, a0, a1, a2, px, py, cfg)
    return shade_surface(
        valid, attr, g["mat"], duv, materials=materials, atlas=atlas,
        light=light, camera_pos=camera_pos, clear_color=clear_color,
    )


def shade_surface(valid, attr, mat_id, duv, materials=None, atlas=None,
                  light=None, camera_pos=None,
                  clear_color=(0.0, 0.0, 0.0, 1.0)):
    """The surface half of shading from interpolated values: material
    modulation, mip level + texture tap, Blinn-Phong, background clear.
    attr: list of 12 channels; duv: (durx, dvrx, dury, dvry)."""
    color = np.stack(attr[0:4], axis=-1)
    normal = np.stack(attr[4:7], axis=-1)
    u, v = attr[7], attr[8]
    wpos = np.stack(attr[9:12], axis=-1)

    rgba = color
    if materials is not None:
        mat = np.clip(mat_id, 0, materials.base_color.shape[0] - 1)
        rgba = rgba * _take(materials.base_color, mat)
        if atlas is not None:
            tex_id = _take(materials.tex_id, mat)
            level = _mip_from_raws(duv, atlas, tex_id)
            texel = sample_texture(atlas, tex_id, u, v, level)
            rgba = np.where((tex_id >= 0)[..., None], rgba * texel, rgba)

    if light is not None:
        n, n2 = _normalize3(normal)
        lit = n2 > F32(1e-12)  # vertices without normals stay unlit
        ldir, _ = _normalize3(np.broadcast_to(light.direction, normal.shape))
        ndotl = np.maximum(F32(0.0), -sm.dot3(
            n[..., 0], ldir[..., 0], n[..., 1], ldir[..., 1], n[..., 2],
            ldir[..., 2]))
        diffuse = light.ambient + ndotl[..., None] * light.color
        rgb = rgba[..., :3] * diffuse
        if materials is not None and camera_pos is not None:
            spec_k = _take(materials.specular, mat)
            shin = _take(materials.shininess, mat)
            vdir, _ = _normalize3(camera_pos - wpos)
            hv, _ = _normalize3(vdir - ldir)
            ndoth = np.maximum(F32(0.0), sm.dot3(
                n[..., 0], hv[..., 0], n[..., 1], hv[..., 1], n[..., 2],
                hv[..., 2]))
            spec = sm.powi(ndoth, shin, 8) * spec_k
            rgb = rgb + spec[..., None] * light.color
        rgba = np.concatenate(
            [np.where(lit[..., None], rgb, rgba[..., :3]), rgba[..., 3:4]],
            axis=-1,
        )

    clear = np.asarray(clear_color, dtype=F32)
    return np.where(valid[..., None], rgba, clear)


def combine_from_prelight(valid, p_ch, diffuse_ch, spec, lit, tap, fu, fv,
                          texmask, atlas=None, light=None,
                          has_materials=True,
                          clear_color=(0.0, 0.0, 0.0, 1.0)):
    """The post-tap half of shade_surface over phase F's planes: quad
    gather + bilinear lerp, texture modulation, lighting combine,
    background clear.  p_ch: 4 channel arrays (colour * base); diffuse_ch:
    3; spec, lit, tap, fu, fv, texmask per pixel.  atlas None = no texture
    stage; light None = no lighting stage."""
    if atlas is not None:
        quad = _take(atlas.quads, tap)
        tex_on = texmask != 0
        new_p = []
        for ch in range(4):
            top = sm.lerp(_unpack(quad[..., 0], ch), _unpack(quad[..., 1], ch), fu)
            bot = sm.lerp(_unpack(quad[..., 2], ch), _unpack(quad[..., 3], ch), fu)
            texel = sm.lerp(top, bot, fv)
            new_p.append(np.where(tex_on, p_ch[ch] * texel, p_ch[ch]))
        p_ch = new_p
    if light is not None:
        lit_on = lit != 0
        rgb = [p_ch[i] * diffuse_ch[i] for i in range(3)]
        if has_materials:
            rgb = [rgb[i] + spec * light.color[i] for i in range(3)]
        p_ch = [np.where(lit_on, rgb[i], p_ch[i]) for i in range(3)] + [p_ch[3]]
    rgba = np.stack(p_ch, axis=-1)
    clear = np.asarray(clear_color, dtype=F32)
    return np.where(valid[..., None], rgba, clear)


def _texture_base(atlas, tex_id):
    """(base width, base height as f32, level count) of each pixel's
    texture."""
    tex_c = np.clip(tex_id, 0, atlas.level_w.shape[0] - 1)
    bw = _take(atlas.level_w[:, 0], tex_c).astype(F32)
    bh = _take(atlas.level_h[:, 0], tex_c).astype(F32)
    return bw, bh, _take(atlas.n_levels, tex_c)


def _level_of(rho2, nl):
    """floor(log2(sqrt(max footprint^2))) from exponent bits, clamped to
    the texture's levels."""
    rho2 = np.maximum(rho2, F32(1e-20))
    level = sm.float_exponent(rho2) >> 1
    return np.clip(level, 0, np.maximum(nl - 1, 0)).astype(I32)


def _mip_from_raws(duv, atlas, tex_id):
    """Nearest mip level from interp_fields' raw uv screen derivatives (du
    = durx * base width)."""
    durx, dvrx, dury, dvry = duv
    bw, bh, nl = _texture_base(atlas, tex_id)

    def footprint2(dur, dvr):
        du = dur * bw
        dv = dvr * bh
        return du * du + dv * dv

    return _level_of(np.maximum(footprint2(durx, dvrx), footprint2(dury, dvry)),
                     nl)


def _iota2(h, w, axis):
    if axis == 1:
        return np.broadcast_to(np.arange(w, dtype=I32)[None, :], (h, w))
    return np.broadcast_to(np.arange(h, dtype=I32)[:, None], (h, w))


def _mip_level(g, edges, mus, a_v0, a_v1, a_v2, atlas, tex_id, cfg):
    """Nearest mip level from the analytic screen-space uv derivatives
    (plane identity: du/dpx = (sum dp_i u_i - u * sum dp_i) / S), taken in
    one chain; ``_mip_from_raws`` takes the same chain cut at the base
    width."""
    e0, e1, e2 = edges
    m0, m1, m2 = mus
    scale = F32(cfg.subpixel_scale)
    x0, y0 = g["x0"], g["y0"]
    x1, y1 = g["x1"], g["y1"]
    x2, y2 = g["x2"], g["y2"]
    a0, b0, _ = sm.edge_coeffs(x1, y1, x2, y2)
    a1, b1, _ = sm.edge_coeffs(x2, y2, x0, y0)
    a2, b2, _ = sm.edge_coeffs(x0, y0, x1, y1)
    inv_area = g["inv_area2"]
    dp = []
    for (ea, eb), iw in (
        ((a0, b0), g["iw0"]),
        ((a1, b1), g["iw1"]),
        ((a2, b2), g["iw2"]),
    ):
        gx = ea.astype(F32) * scale * inv_area * iw
        gy = eb.astype(F32) * scale * inv_area * iw
        dp.append((gx, gy))
    p0 = e0.astype(F32) * inv_area * g["iw0"]
    p1 = e1.astype(F32) * inv_area * g["iw1"]
    p2 = e2.astype(F32) * inv_area * g["iw2"]
    s = (p0 + p1) + p2
    inv_s = sm.recip_spec(s)
    u0, v0c = a_v0[..., 7], a_v0[..., 8]
    u1, v1c = a_v1[..., 7], a_v1[..., 8]
    u2, v2c = a_v2[..., 7], a_v2[..., 8]
    u = sm.dot3(m0, u0, m1, u1, m2, u2)
    v = sm.dot3(m0, v0c, m1, v1c, m2, v2c)
    bw, bh, nl = _texture_base(atlas, tex_id)

    def footprint2(axis):
        dsx = sm.dot3(dp[0][axis], F32(1.0), dp[1][axis], F32(1.0),
                      dp[2][axis], F32(1.0))
        dux = sm.dot3(dp[0][axis], u0, dp[1][axis], u1, dp[2][axis], u2)
        dvx = sm.dot3(dp[0][axis], v0c, dp[1][axis], v1c, dp[2][axis], v2c)
        du = (dux - u * dsx) * inv_s * bw
        dv = (dvx - v * dsx) * inv_s * bh
        return du * du + dv * dv

    return _level_of(np.maximum(footprint2(0), footprint2(1)), nl)


def resolve_and_pack(rgba, supersample: int, srgb: bool):
    """Box-resolve the supersampled image (ordered accumulation over the
    ss x ss footprint, then * 1/ss^2) and pack to RGBA8, through the sRGB
    table if asked."""
    if supersample > 1:
        h, w = rgba.shape[0] // supersample, rgba.shape[1] // supersample
        r = rgba.reshape(h, supersample, w, supersample, 4)
        acc = None
        for i in range(supersample):
            for j in range(supersample):
                term = r[:, i, :, j, :]
                acc = term if acc is None else acc + term
        rgba = acc * F32(1.0 / (supersample * supersample))
    if srgb:
        lut = sm.srgb_encode_lut()
        idx = np.round(
            np.clip(rgba[..., :3], F32(0.0), F32(1.0)) * F32(4095.0)
        ).astype(I32)
        rgba = np.concatenate([lut[idx], rgba[..., 3:4]], axis=-1)
    return sm.pack_unorm8(rgba)
