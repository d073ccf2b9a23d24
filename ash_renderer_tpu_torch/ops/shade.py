"""Deferred shading in torch ops (counterpart of
``ash_renderer_tpu/ops/shade.py``): the interpolation half the raster
kernel's phase E runs, the surface half up to the texture tap
(``surface_prelight``, which the raster kernel's phase F runs on the card),
the rest (``combine_from_prelight``: texture tap, lighting combine, clear),
the classic pipeline's per-pixel winner gather (``shade``) and the resolve
+ RGBA8 pack.

Every op is a single IEEE float32 mul/add/sub, a select, an integer op or a
table gather, in the spec's association, so results equal the reference's
bit for bit on any device.

Kernel K11 (``shade_pack_classic``, ``csrc/shade_pack.cu``): the classic
route's frame path, ``shade`` then ``resolve_and_pack``, in one launch
from the visibility buffer, K10's setup rows and the combined attribute
table to the RGBA8 frame; its plain version is ``shade_pack_classic_plain``.
It replaces no Pallas kernel: the reference computes the stage as XLA glue
under one jit (``_stage_shade``, ``ash_renderer_tpu/pipeline.py:698``),
which XLA fuses, where eager torch pays hundreds of launches and as many
full-frame temporaries.  Bound by bytes: the winner ids, the visible
triangles' 14 shading words of the setup table and their corner rows, 4
bytes a pixel written.
``diffrender`` keeps ``shade`` on autograd: K11 serves the frame path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .. import specmath as sm
from ..rtypes import (SETUP_COLS, SETUP_F32_FIELDS, SETUP_ROW_FIELDS,
                      SETUP_SHADE_COLS)
from ..specmath import _f32
from ..textures import MAX_LEVELS

F32 = torch.float32
I32 = torch.int32
KERNEL = "K11_shade_pack_classic"


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


def shade_consts_layout(shade_mode):
    """Offsets of the shade constants in ``pack_shade_consts``' tensor, in
    the reference's order (``fused_kernel.py:shade_consts_layout``).
    shade_mode = (M, T, has_materials, has_atlas, has_light)."""
    m, t, has_m, has_a, has_l = shade_mode
    off = {}
    pos = 0

    def add(name, n):
        nonlocal pos
        off[name] = pos
        pos += n

    if has_m:
        add("base", m * 4)
        add("texid", m)
        add("spec", m)
        add("shin", m)
    if has_a:
        add("loff", t * MAX_LEVELS)
        add("lw", t * MAX_LEVELS)
        add("lh", t * MAX_LEVELS)
        add("nlev", t)
    if has_l:
        add("ldir", 3)
        add("lcol", 3)
        add("amb", 1)
    add("cam", 3)
    off["_total"] = pos
    return off


def pack_shade_consts(shade_mode, materials, atlas, light, camera_pos):
    """The shading tables (materials, mip levels, light, camera position) as
    one (n,) int32 tensor on camera_pos's device, floats as their bits, laid
    out by ``shade_consts_layout``: ``pack_shade_consts_f32``'s words.
    Device ops only, so a new camera position per frame costs no host
    sync."""
    return sm.bitcast_i32(pack_shade_consts_f32(
        shade_mode, materials, atlas, light, camera_pos).detach())


def pack_shade_consts_f32(shade_mode, materials, atlas, light, camera_pos):
    """The words of ``pack_shade_consts`` as a float32 tensor, built with
    ``torch.cat`` of the float fields themselves, so autograd reaches the
    material, light and camera tables through it (``diffrender``); the
    integer fields hold their int32 bits viewed as floats."""
    _, _, has_m, has_a, has_l = shade_mode

    def f(x):
        return x.to(F32).reshape(-1)

    def ib(x):
        return sm.bitcast_f32(x.to(I32).reshape(-1))

    parts = []
    if has_m:
        parts += [f(materials.base_color), ib(materials.tex_id),
                  f(materials.specular), ib(materials.shininess)]
    if has_a:
        parts += [ib(atlas.level_offset), ib(atlas.level_w),
                  ib(atlas.level_h), ib(atlas.n_levels)]
    if has_l:
        parts += [f(light.direction), f(light.color), f(light.ambient)]
    parts.append(f(camera_pos))
    return torch.cat(parts)


def tex_address(off, w, h, u, v):
    """The addressing half of a wrap-addressed bilinear tap on the level at
    quad-table offset ``off`` of ``w`` x ``h`` texels: (the 2x2 quad's row
    index, fu, fv)."""
    # background pixels carry NaN uv (masked later): zero them before the
    # float -> int casts, which saturate as XLA's do
    u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    ut = u * w.to(F32) - 0.5
    vt = v * h.to(F32) - 0.5
    iu0 = sm.f32_to_i32_sat(torch.floor(ut))
    iv0 = sm.f32_to_i32_sat(torch.floor(vt))
    fu = ut - iu0.to(F32)
    fv = vt - iv0.to(F32)
    tap = off + torch.remainder(iv0, h) * w + torch.remainder(iu0, w)
    return tap, fu, fv


_TEXEL_SHIFTS = (0, 8, 16, 24)


@functools.lru_cache(maxsize=None)
def _device_constant(device, values, dtype):
    """``torch.tensor(values, dtype)`` on ``device``, made at first use and
    kept, so a frame uploads no host constant (callers only read it)."""
    return torch.tensor(values, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def srgb_lut(device):
    """``specmath.srgb_encode_lut()`` on ``device``, built once a device
    (callers only read it)."""
    return torch.from_numpy(sm.srgb_encode_lut()).to(device)


def bilinear(quads, tap, fu, fv):
    """The tap half: one quad-table row gather fetches the 2x2 footprint
    (c00, c10, c01, c11, RGBA8 each), then two lerps along u and one along
    v.  Returns (..., 4) f32 RGBA."""
    quad = _take(quads, tap)  # (..., 4) packed texels
    shifts = _device_constant(quad.device, _TEXEL_SHIFTS, I32)
    # (..., corner, channel)
    c = ((quad[..., :, None] >> shifts) & 255).to(F32) * _f32(1.0 / 255.0)
    top = sm.lerp(c[..., 0, :], c[..., 1, :], fu[..., None])
    bot = sm.lerp(c[..., 2, :], c[..., 3, :], fu[..., None])
    return sm.lerp(top, bot, fv[..., None])


def sample_texture(atlas, tex_id, u, v, level):
    """Wrap-addressed bilinear tap of texture ``tex_id`` at an explicit mip
    level.  Returns (..., 4) f32 RGBA."""
    tex_c = torch.clamp(tex_id, 0, atlas.level_offset.shape[0] - 1)
    flat = tex_c * MAX_LEVELS + level
    off = _take(atlas.level_offset.reshape(-1), flat)
    w = _take(atlas.level_w.reshape(-1), flat)
    h = _take(atlas.level_h.reshape(-1), flat)
    return bilinear(atlas.quads, *tex_address(off, w, h, u, v))


def surface_prelight(attr, duv, mat_row, shade_mode, consts, cf=None):
    """The surface half of shading up to the texture tap, from the
    interpolated attributes (..., 12, N), the raw uv derivatives and the
    winner's material row: material base modulation, mip level, tap
    address, Blinn-Phong diffuse and specular, lit mask.  The reference's
    ``_phase_f`` (``fused_kernel.py:128-270``) op for op: the raster
    kernel's phase F computes the same on the card, and the phase E route
    runs it here on the planes.  Its select trees over the tables in
    ``consts`` (``pack_shade_consts``) become indexed loads on the same
    clamped indices.

    ``cf``: the same words as floats; by default ``bitcast_f32(consts)``,
    which carries no autograd graph, while ``pack_shade_consts_f32``'s
    tensor (equal bits) lets gradients reach the float tables.

    Returns (p (..., 4, N) colour * base, diffuse (..., 3, N), spec, lit,
    tap, fu, fv, texmask), the arguments of ``combine_from_prelight``."""
    m_n, t_n, has_m, has_a, has_l = shade_mode
    lay = shade_consts_layout(shade_mode)
    ci = consts  # int words
    if cf is None:
        cf = sm.bitcast_f32(consts)  # the same words as floats
    nx, ny, nz = attr[..., 4, :], attr[..., 5, :], attr[..., 6, :]
    u, v = attr[..., 7, :], attr[..., 8, :]
    wx, wy, wz = attr[..., 9, :], attr[..., 10, :], attr[..., 11, :]
    zf = torch.zeros_like(u)
    zi = torch.zeros_like(mat_row)
    p = attr[..., 0:4, :]
    tap, fu, fv, texmask = zi, zf, zf, zi
    diffuse = torch.zeros_like(attr[..., 4:7, :])
    spec, lit = zf, zi

    if has_m:
        mat = torch.clamp(mat_row, 0, m_n - 1).long()
        ch = torch.arange(4, device=mat.device)[:, None]
        p = p * cf[lay["base"] + 4 * mat[..., None, :] + ch]
        if has_a:
            durx, dvrx, dury, dvry = duv
            tex_id = ci[lay["texid"] + mat]
            # the mip level: floor(log2 of the larger texel footprint), from
            # exponent bits
            tex_c = torch.clamp(tex_id, 0, t_n - 1).long()
            bw = ci[lay["lw"] + tex_c * MAX_LEVELS].to(F32)
            bh = ci[lay["lh"] + tex_c * MAX_LEVELS].to(F32)
            nl = ci[lay["nlev"] + tex_c]

            def footprint2(dur, dvr):
                du = dur * bw
                dv = dvr * bh
                return du * du + dv * dv

            rho2 = torch.maximum(footprint2(durx, dvrx),
                                 footprint2(dury, dvry))
            rho2 = torch.clamp(rho2, min=_f32(1e-20))
            level = torch.minimum(
                torch.clamp(sm.float_exponent(rho2) >> 1, min=0),
                torch.clamp(nl - 1, min=0),
            )
            flat = tex_c * MAX_LEVELS + level
            tap, fu, fv = tex_address(ci[lay["loff"] + flat],
                                      ci[lay["lw"] + flat],
                                      ci[lay["lh"] + flat], u, v)
            texmask = (tex_id >= 0).to(I32)

    if has_l:
        n2 = sm.dot3(nx, nx, ny, ny, nz, nz)
        invn = sm.rsqrt_spec(torch.clamp(n2, min=_f32(1e-30)))
        nhx, nhy, nhz = nx * invn, ny * invn, nz * invn
        lit = (n2 > _f32(1e-12)).to(I32)  # vertices without normals stay unlit
        ld0 = [cf[lay["ldir"] + i] for i in range(3)]
        d2 = sm.dot3(ld0[0], ld0[0], ld0[1], ld0[1], ld0[2], ld0[2])
        invd = sm.rsqrt_spec(torch.clamp(d2, min=_f32(1e-30)))
        ldx, ldy, ldz = ld0[0] * invd, ld0[1] * invd, ld0[2] * invd
        ndotl = torch.clamp(-sm.dot3(nhx, ldx, nhy, ldy, nhz, ldz), min=0.0)
        lcol = cf[lay["lcol"] : lay["lcol"] + 3][:, None]
        diffuse = cf[lay["amb"]] + ndotl[..., None, :] * lcol
        if has_m:
            sk = cf[lay["spec"] + mat]
            sh = ci[lay["shin"] + mat]
            vx = cf[lay["cam"]] - wx
            vy = cf[lay["cam"] + 1] - wy
            vz = cf[lay["cam"] + 2] - wz
            v2 = sm.dot3(vx, vx, vy, vy, vz, vz)
            invv = sm.rsqrt_spec(torch.clamp(v2, min=_f32(1e-30)))
            vhx, vhy, vhz = vx * invv, vy * invv, vz * invv
            hx, hy, hz = vhx - ldx, vhy - ldy, vhz - ldz
            h2 = sm.dot3(hx, hx, hy, hy, hz, hz)
            invh = sm.rsqrt_spec(torch.clamp(h2, min=_f32(1e-30)))
            hhx, hhy, hhz = hx * invh, hy * invh, hz * invh
            ndoth = torch.clamp(sm.dot3(nhx, hhx, nhy, hhy, nhz, hhz), min=0.0)
            spec = sm.powi(ndoth, sh, 8) * sk

    return p, diffuse, spec, lit, tap, fu, fv, texmask


def combine_from_prelight(valid, p, diffuse, spec, lit, tap, fu, fv, texmask,
                          atlas=None, light=None, has_materials=True,
                          clear_color=(0.0, 0.0, 0.0, 1.0)):
    """The rest of shading after ``surface_prelight`` (or the raster
    kernel's phase F planes, which hold the same values): quad gather +
    bilinear lerp, texture modulation, lighting combine, background clear.
    p: (..., 4, N) colour * base; diffuse: (..., 3, N); the others (..., N).
    atlas None = no texture stage; light None = no lighting stage.  Returns
    (..., N, 4) f32 RGBA."""
    if atlas is not None:
        texel = bilinear(atlas.quads, tap, fu, fv).movedim(-1, -2)
        p = torch.where((texmask != 0)[..., None, :], p * texel, p)
    if light is not None:
        rgb = p[..., :3, :] * diffuse
        if has_materials:
            rgb = rgb + spec[..., None, :] * light.color[:, None]
        p = torch.cat([torch.where((lit != 0)[..., None, :], rgb, p[..., :3, :]),
                       p[..., 3:, :]], dim=-2)
    clear = _device_constant(
        p.device, tuple(np.asarray(clear_color, dtype=np.float32).tolist()),
        F32)
    return torch.where(valid[..., None], p.movedim(-2, -1), clear)


# the first SETUP_SHADE_COLS columns of the setup table (rtypes)
_PACK_FIELDS = SETUP_ROW_FIELDS[:SETUP_SHADE_COLS]


def pack_setup_table(su):
    """(S, 14) int32 per-triangle shading fields of a TriangleSetup (floats
    as their bits), the setup table's first columns
    (``rtypes.SETUP_ROW_FIELDS``): one row gather per pixel fetches all
    of them."""
    return torch.stack([sm.bitcast_i32(getattr(su, k)) if k in SETUP_F32_FIELDS
                        else getattr(su, k) for k in _PACK_FIELDS], dim=1)


def shade(vis_tri, su, attrs, shade_mode, consts, atlas=None, light=None,
          cfg=None, clear_color=(0.0, 0.0, 0.0, 1.0), cf=None, specular=True,
          py_offset: int = 0):
    """Shade the classic pipeline's visibility buffer into (H, W, 4) f32
    RGBA at render resolution: each pixel gathers its winner's setup row
    (``pack_setup_table``) and its three corner rows of the combined
    attribute table ``attrs`` (VA, 12), then ``shade_gathered``.
    ``shade_mode`` and ``consts``: the scene's ``pipeline.surface_mode``
    and ``pack_shade_consts``; ``cf`` and ``specular``: see
    ``shade_gathered``; ``py_offset``: the screen row of ``vis_tri``'s
    first row (a slab's, ``parallel/sharding.py``)."""
    return _shade_table(vis_tri, pack_setup_table(su), attrs, shade_mode,
                        consts, atlas=atlas, light=light, cfg=cfg,
                        clear_color=clear_color, cf=cf, specular=specular,
                        py_offset=py_offset)


def _shade_table(vis_tri, table, attrs, shade_mode, consts, atlas=None,
                 light=None, cfg=None, clear_color=(0.0, 0.0, 0.0, 1.0),
                 cf=None, specular=True, py_offset: int = 0):
    """``shade`` from a setup table whose first columns are
    ``pack_setup_table``'s."""
    valid = vis_tri >= 0
    packed = _take(table[:, :SETUP_SHADE_COLS], vis_tri)  # (H, W, 14)
    g = {k: sm.bitcast_f32(packed[..., i]) if k in SETUP_F32_FIELDS
         else packed[..., i] for i, k in enumerate(_PACK_FIELDS)}
    corners = [_take(attrs, g[k]).movedim(-1, -2) for k in ("v0", "v1", "v2")]
    return shade_gathered(valid, g, *corners, shade_mode, consts, atlas=atlas,
                          light=light, cfg=cfg, clear_color=clear_color,
                          cf=cf, specular=specular, py_offset=py_offset)


def shade_gathered(valid, g, a0, a1, a2, shade_mode, consts, atlas=None,
                   light=None, cfg=None, clear_color=(0.0, 0.0, 0.0, 1.0),
                   cf=None, specular=True, py_offset: int = 0):
    """Shading from already fetched winner data: ``g`` the per-pixel setup
    fields (H, W) and the corner attributes a0-a2 (H, 12, W), pixel (x, y)
    at [y, x].  The reference's ``interp_fields`` + ``shade_surface`` are
    here ``interp_fields_stacked``, ``surface_prelight`` and
    ``combine_from_prelight``, the definition the fused route uses.
    ``cf``: the float words of ``consts`` (``surface_prelight``);
    ``specular=False`` leaves out the specular term, as the reference's
    ``shade_surface`` does when it is given no camera position.
    ``py_offset``: the screen row of the first row.  Returns (H, W, 4) f32
    RGBA."""
    h, w = valid.shape
    dev = valid.device
    px = torch.arange(w, dtype=I32, device=dev).expand(h, w)
    py = (torch.arange(h, dtype=I32, device=dev)[:, None]
          + py_offset).expand(h, w)
    attr, duv = interp_fields_stacked(g, a0, a1, a2, px, py, cfg)
    pre = surface_prelight(attr, duv, g["mat"], shade_mode, consts, cf=cf)
    return combine_from_prelight(
        valid, *pre, atlas=atlas if shade_mode[3] else None,
        light=light if shade_mode[4] else None,
        has_materials=shade_mode[2] and specular, clear_color=clear_color,
    )


def box_resolve(rgba, supersample: int):
    """Box-resolve the supersampled (H*s, W*s, 4) image: ordered sum over
    the s*s footprint (i outer, j inner, from sample (0, 0)), then *
    1/s^2; the image itself at supersample 1."""
    if supersample == 1:
        return rgba
    h, w = rgba.shape[0] // supersample, rgba.shape[1] // supersample
    r = rgba.reshape(h, supersample, w, supersample, 4)
    acc = None
    for i in range(supersample):
        for j in range(supersample):
            term = r[:, i, :, j, :]
            acc = term if acc is None else acc + term
    return acc * _f32(1.0 / (supersample * supersample))


def resolve_and_pack(rgba, supersample: int, srgb: bool):
    """``box_resolve`` and pack to RGBA8, optionally through the sRGB
    LUT."""
    rgba = box_resolve(rgba, supersample)
    if srgb:
        lut = srgb_lut(rgba.device)
        idx = torch.round(torch.clamp(rgba[..., :3], 0.0, 1.0) * 4095.0).long()
        rgba = torch.cat([lut[idx], rgba[..., 3:4]], dim=-1)
    return sm.pack_unorm8(rgba)


def shade_pack_classic(vis_tri, rows, attrs, shade_mode, consts,
                       atlas=None, light=None, cfg=None,
                       clear_color=(0.0, 0.0, 0.0, 1.0),
                       supersample: int = 1, srgb: bool = False,
                       py_offset: int = 0):
    """The classic frame's shade + pack: ``shade`` (arguments as there,
    the setup as ``rows``, the (S, SETUP_COLS) int32 table
    ``geometry.geometry_rows`` returns) then ``resolve_and_pack`` at
    ``supersample`` with ``srgb``: the RGBA8 frame (height / supersample,
    width / supersample, 4) uint8 of the (height, width) visibility
    buffer.  Raises ``ValueError`` on arguments the kernel does not take.
    CPU tensors take the plain version; CUDA tensors launch kernel K11."""
    dev = vis_tri.device
    m_n, t_n, has_m, has_a, has_l = shade_mode
    n_consts = shade_consts_layout(shade_mode)["_total"]
    quads = atlas.quads if has_a else None
    lcol = light.color if has_l else None
    for name, x, dtype, cols in (
            ("vis_tri", vis_tri, I32, (cfg.width,)),
            ("setup rows", rows, I32, (SETUP_COLS,)),
            ("attrs", attrs, F32, (12,)), ("consts", consts, I32, ()),
            ("quads", quads, I32, (4,)), ("light colour", lcol, F32, ())):
        if x is None:
            continue
        shape = (n_consts if name == "consts" else 3 if name == "light colour"
                 else x.shape[0], *cols)
        # vis_tri may be a crop of the raster's padded rows: its row pitch
        # is the kernel's argument
        dense = (x.stride(-1) == 1 if name == "vis_tri"
                 else x.is_contiguous())
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not dense or 0 in shape):
            raise ValueError(f"shade_pack_classic: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    h, w = vis_tri.shape
    ss = supersample
    if ss < 1 or h % ss or w % ss:
        raise ValueError(f"shade_pack_classic: {h}x{w} render pixels do not "
                         f"resolve at supersample {ss}")
    if dev.type == "cpu":
        return shade_pack_classic_plain(
            vis_tri, rows, attrs, shade_mode, consts, atlas, light, cfg,
            clear_color, supersample, srgb, py_offset)
    if dev.type != "cuda":
        raise ValueError(f"shade_pack_classic: unsupported device {dev}")
    for name, x in (("setup rows", rows), ("attrs", attrs), ("quads", quads)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"shade_pack_classic: {name} is not 16-byte "
                             "aligned")
    lut = srgb_lut(dev) if srgb else None
    out = torch.empty((h // ss, w // ss, 4), dtype=torch.uint8, device=dev)
    clear = [float(v) for v in np.asarray(clear_color, dtype=np.float32)]
    _build.launch(
        KERNEL, "ash_shade_pack_classic", dev, vis_tri.data_ptr(),
        rows.data_ptr(), attrs.data_ptr(), consts.data_ptr(), n_consts,
        m_n, t_n, int(has_m), int(has_a), int(has_l),
        None if quads is None else quads.data_ptr(),
        0 if quads is None else quads.shape[0],
        None if lcol is None else lcol.data_ptr(),
        None if lut is None else lut.data_ptr(), out.data_ptr(),
        rows.shape[0], attrs.shape[0], vis_tri.stride(0), h // ss, w // ss,
        ss, cfg.subpixel_scale, py_offset, sm._f32(1.0 / (ss * ss)), *clear,
    )
    return out


def shade_pack_classic_plain(vis_tri, rows, attrs, shade_mode, consts,
                             atlas=None, light=None, cfg=None,
                             clear_color=(0.0, 0.0, 0.0, 1.0),
                             supersample: int = 1, srgb: bool = False,
                             py_offset: int = 0):
    """shade_pack_classic in torch ops (any device): ``shade`` from the
    setup table, then ``resolve_and_pack``."""
    rgba = _shade_table(vis_tri, rows, attrs, shade_mode, consts,
                        atlas=atlas, light=light, cfg=cfg,
                        clear_color=clear_color, py_offset=py_offset)
    return resolve_and_pack(rgba, supersample, srgb)
