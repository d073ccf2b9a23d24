"""The exact rasterization semantics in torch: the counterpart of
``ash_renderer_tpu/specmath.py``, formula for formula.

Every function uses only operations whose float32 / int32 results are
identical IEEE-754 on the CPU, on the card and in numpy: one op per mul, add
or sub (never ``addcmul``, ``lerp``, ``matmul`` or a float ``sum``), integer
arithmetic, comparisons and int<->float conversions.  No hardware division,
square root or transcendental: ``recip_spec``, ``rsqrt_spec`` and ``powi``
are the spec's own.  ``csrc/specmath.cuh`` carries the same functions as
``__device__`` code for the kernels.

Rounding is ``torch.round`` (round half to even, like ``numpy.round``);
integer ``//`` and ``%`` floor like numpy's.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32

DEPTH_MAX = 65535  # D16_UNORM clear value (depth cleared to 1.0)
BG_TRI = -1  # background triangle id; any fragment (id >= 0) beats it on ties
FLT_MIN_NORMAL = float(np.float32(1.1754944e-38))


def _f32(v: float) -> float:
    """A Python float holding exactly the float32 value of ``v`` (torch
    scalars in float32 ops are rounded to float32 anyway; this keeps the
    constant's bits explicit)."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# Bitcasts
# ---------------------------------------------------------------------------

def bitcast_i32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(I32)


def bitcast_f32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(F32)


_I32_MAX = 2147483647
_I32_MIN = -2147483648
_F32_BELOW_2_31 = 2147483520.0  # the largest float32 below 2**31


def f32_to_i32_sat(x):
    """float32 -> int32 as XLA's convert (and CUDA's ``cvt.rzi.s32.f32``)
    gives it: truncation toward zero, NaN -> 0, x >= 2**31 -> 2147483647,
    x < -2**31 -> -2147483648.  torch's own CPU cast turns every
    out-of-range value into -2147483648 instead."""
    inside = torch.clamp(x, _I32_MIN, _F32_BELOW_2_31)
    inside = torch.where(torch.isnan(x), torch.zeros_like(x), inside)
    return torch.where(x >= 2147483648.0, _I32_MAX, inside.to(I32))


# ---------------------------------------------------------------------------
# Orientation, edges, fill rule
# ---------------------------------------------------------------------------

def shoelace2(x0, y0, x1, y1, x2, y2):
    """Twice the signed shoelace area of snapped int32 coords (y-down);
    negative means front-facing."""
    return (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)


def edge_coeffs(xa, ya, xb, yb):
    """Directed edge a->b: (A, B, is_top_left) with E(p) = A*(px - xa) +
    B*(py - ya), interior positive; top-left accepts E == 0."""
    dx = xb - xa
    dy = yb - ya
    top = (dy == 0) & (dx > 0)
    left = dy < 0
    return -dy, dx, top | left


def edge_at(a, b, xa, ya, px, py):
    """E = A*(px - xa) + B*(py - ya) in int32 (modular, like the spec)."""
    return a * (px - xa) + b * (py - ya)


def pixel_sample_coords(px, py, subpixel_scale: int):
    half = subpixel_scale // 2
    return px * subpixel_scale + half, py * subpixel_scale + half


def depth_key_better(d_new, idx_new, d_old, idx_old):
    """LESS_OR_EQUAL with later draws winning ties: the minimum of
    (d16, -draw_index) wins."""
    return (d_new < d_old) | ((d_new == d_old) & (idx_new > idx_old))


# ---------------------------------------------------------------------------
# Vertex transform, snapping, depth
# ---------------------------------------------------------------------------

def apply_mat4_point(m, x, y, z):
    """Row-major 4x4 times (x, y, z, 1) with the fixed association
    ((m0*x + m1*y) + (m2*z + m3)) per output component."""

    def row(r):
        return (m[..., r, 0] * x + m[..., r, 1] * y) + (
            m[..., r, 2] * z + m[..., r, 3]
        )

    return row(0), row(1), row(2), row(3)


def apply_mat3_vec(m, x, y, z):
    """Direction by the upper 3x3: (m0*x + m1*y) + m2*z."""

    def row(r):
        return (m[..., r, 0] * x + m[..., r, 1] * y) + m[..., r, 2] * z

    return row(0), row(1), row(2)


def snap_coord(ndc, size_px: int, subpixel_scale: int, min_c: int,
               max_c: int):
    """round(ndc * half + half), clamped to the guard rect, as int32; half is
    the exact float32 constant size_px * subpixel_scale / 2."""
    half = _f32(np.float32(size_px * subpixel_scale) * np.float32(0.5))
    s = ndc * half + half
    return torch.clamp(torch.round(s), min_c, max_c).to(I32)


def quantize_depth(z_ndc):
    """Per-vertex D16 depth: round(z_ndc * 65535), clamped."""
    return torch.clamp(torch.round(z_ndc * float(DEPTH_MAX)), 0, DEPTH_MAX).to(
        I32
    )


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def dot3(w0, a0, w1, a1, w2, a2):
    """(w0*a0 + w1*a1) + w2*a2, in that association."""
    return (w0 * a0 + w1 * a1) + w2 * a2


def bary_weights(e0, e1, e2, inv_area2):
    return e0.to(F32) * inv_area2, e1.to(F32) * inv_area2, e2.to(F32) * inv_area2


def interp_depth16(e0, e1, e2, inv_area2, zq0, zq1, zq2):
    """(sum e_i * z_i) * inv_area2, rounded and clamped to D16."""
    num = dot3(
        e0.to(F32), zq0.to(F32), e1.to(F32), zq1.to(F32), e2.to(F32),
        zq2.to(F32),
    )
    return torch.clamp(torch.round(num * inv_area2), 0, DEPTH_MAX).to(I32)


def persp_weights(l0, l1, l2, iw0, iw1, iw2):
    """Perspective-correct weights from screen barycentrics and 1/w."""
    p0 = l0 * iw0
    p1 = l1 * iw1
    p2 = l2 * iw2
    s = (p0 + p1) + p2
    inv = recip_spec(s)
    return p0 * inv, p1 * inv, p2 * inv


def lerp(a, b, t):
    """The spec's linear interpolation: a + (b - a) * t."""
    return a + (b - a) * t


# ---------------------------------------------------------------------------
# Output packing
# ---------------------------------------------------------------------------

def srgb_encode_lut() -> np.ndarray:
    """4096-entry sRGB encode LUT over linear [0, 1] (float64 host math,
    stored as float32: the same table as the reference's)."""
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float64)
    y = np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)
    return y.astype(np.float32)


def pack_unorm8(c):
    """f32 [0, 1] -> uint8: round(clamp(c) * 255)."""
    return torch.round(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Deterministic reciprocal / rsqrt / power
# ---------------------------------------------------------------------------

_SIGN = -2147483648


def recip_spec(x):
    """Deterministic ~2-ulp reciprocal: bit-trick seed + 3 Newton steps."""
    bits = bitcast_i32(x)
    sign = bits & _SIGN
    mag = bits & 0x7FFFFFFF
    r = bitcast_f32(0x7EF311C3 - mag)
    ax = bitcast_f32(mag)
    for _ in range(3):
        r = r * (2.0 - ax * r)
    return bitcast_f32(bitcast_i32(r) ^ sign)


def div_spec(a, b):
    """The spec's division: a * recip_spec(b)."""
    return a * recip_spec(b)


def rsqrt_spec(x):
    """Deterministic ~2-ulp reciprocal square root of positive x."""
    bits = bitcast_i32(x)
    r = bitcast_f32(0x5F375A86 - (bits >> 1))
    for _ in range(3):
        r = r * (1.5 - 0.5 * x * r * r)
    return r


def float_exponent(x):
    """floor(log2(|x|)) for normalized positive x, from the exponent bits."""
    return ((bitcast_i32(x) >> 23) & 0xFF) - 127


def flush_subnormal(v):
    """Subnormals map to exactly 0 (the spec's definition)."""
    return torch.where(torch.abs(v) < FLT_MIN_NORMAL, torch.zeros_like(v), v)


def powi(x, e, max_bits: int):
    """x ** e for x in [0, 1], integer e < 2**max_bits, by square and
    multiply with a fixed op sequence; underflow flushed to 0."""
    result = torch.ones_like(x)
    base = x
    for bit in range(max_bits):
        take = (e >> bit) & 1
        result = torch.where(take == 1, result * base, result)
        if bit + 1 < max_bits:
            base = base * base
    return flush_subnormal(result)
