"""The rasterization spec's formulas in numpy: the oracle's copy of
``ash_renderer_tpu/specmath.py`` with the array namespace fixed to numpy.

Every function uses only operations whose float32 / int32 results are
exact IEEE: add, sub, mul, comparisons, integer arithmetic, int <-> float
conversions and bit reinterpretation.  Division and rsqrt are the spec's
own (a bit-trick seed and three Newton steps), powers are
square-and-multiply.  The device side follows the same formulas in torch
(``ash_renderer_tpu_torch/specmath.py``) and CUDA (``csrc/specmath.cuh``);
the oracle does not use either.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
I32 = np.int32

DEPTH_MAX = 65535  # D16_UNORM clear value (depth cleared to 1.0)
BG_TRI = -1  # background triangle id; any fragment (id >= 0) beats it on ties
FLT_MIN_NORMAL = F32(1.1754944e-38)


# ---------------------------------------------------------------------------
# Orientation, edge functions, fill rule
# ---------------------------------------------------------------------------

def shoelace2(x0, y0, x1, y1, x2, y2):
    """Twice the signed shoelace area of snapped int32 coords (y-down);
    negative is front-facing."""
    return (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)


def edge_coeffs(xa, ya, xb, yb):
    """Directed edge a->b: (A, B, is_top_left) with E(p) = A*(px - xa) +
    B*(py - ya), A = -(yb - ya), B = xb - xa; top-left = (dy == 0 and dx >
    0) or dy < 0."""
    dx = xb - xa
    dy = yb - ya
    return -dy, dx, ((dy == 0) & (dx > 0)) | (dy < 0)


def fill_bias(is_top_left):
    """0 for top-left edges, -1 otherwise: coverage is E + bias >= 0."""
    return np.where(is_top_left, I32(0), I32(-1))


def edge_at(a, b, xa, ya, px, py):
    """E = A*(px - xa) + B*(py - ya) at sample points (int32)."""
    return a * (px - xa) + b * (py - ya)


def pixel_sample_coords(px, py, subpixel_scale):
    """Snapped coordinates of the centre of pixel (px, py)."""
    half = subpixel_scale // 2
    return px * subpixel_scale + half, py * subpixel_scale + half


def depth_key_better(d_new, idx_new, d_old, idx_old):
    """The fragment minimizing (d16, -draw_index) wins."""
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
    """The upper 3x3 times a direction: (m0*x + m1*y) + m2*z."""

    def row(r):
        return (m[..., r, 0] * x + m[..., r, 1] * y) + m[..., r, 2] * z

    return row(0), row(1), row(2)


def snap_coord(ndc, size_px, subpixel_scale, min_c, max_c):
    """NDC -> snapped int32 subpixel coordinate, clamped to the guard rect:
    round(ndc * half + half), half = size_px * subpixel_scale / 2."""
    half = F32(F32(size_px * subpixel_scale) * F32(0.5))
    s = ndc * half + half
    return np.clip(np.round(s), min_c, max_c).astype(I32)


def quantize_depth(z_ndc):
    """Per-vertex D16 depth: round(z_ndc * 65535), clamped."""
    return np.clip(np.round(z_ndc * F32(DEPTH_MAX)), 0, DEPTH_MAX).astype(I32)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def dot3(w0, a0, w1, a1, w2, a2):
    """(w0*a0 + w1*a1) + w2*a2."""
    return (w0 * a0 + w1 * a1) + w2 * a2


def bary_weights(e0, e1, e2, inv_area2):
    """Screen-space barycentric weights from int32 edge values."""
    return (
        e0.astype(F32) * inv_area2,
        e1.astype(F32) * inv_area2,
        e2.astype(F32) * inv_area2,
    )


def interp_depth16(e0, e1, e2, inv_area2, zq0, zq1, zq2):
    """(sum e_i * z_i) * inv_area2, rounded and clamped to D16."""
    num = dot3(
        e0.astype(F32), zq0.astype(F32),
        e1.astype(F32), zq1.astype(F32),
        e2.astype(F32), zq2.astype(F32),
    )
    return np.clip(np.round(num * inv_area2), 0, DEPTH_MAX).astype(I32)


def persp_weights(l0, l1, l2, iw0, iw1, iw2):
    """Perspective-correct weights from screen barycentrics and 1/w."""
    p0 = l0 * iw0
    p1 = l1 * iw1
    p2 = l2 * iw2
    s = (p0 + p1) + p2
    inv = recip_spec(s)
    return p0 * inv, p1 * inv, p2 * inv


def lerp(a, b, t):
    """a + (b - a) * t."""
    return a + (b - a) * t


# ---------------------------------------------------------------------------
# Output packing
# ---------------------------------------------------------------------------

def srgb_encode_lut() -> np.ndarray:
    """4096-entry sRGB encode table over linear [0, 1]."""
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float64)
    y = np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)
    return y.astype(F32)


def pack_unorm8(c):
    """f32 [0, 1] -> uint8: round(clamp(c) * 255)."""
    return np.round(np.clip(c, F32(0.0), F32(1.0)) * F32(255.0)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Bitcasts, division, rsqrt, powers
# ---------------------------------------------------------------------------

def bitcast_i32(x):
    a = np.ascontiguousarray(np.asarray(x, dtype=F32))
    return a.view(np.int32).reshape(np.shape(x))


def bitcast_f32(x):
    a = np.ascontiguousarray(np.asarray(x, dtype=I32))
    return a.view(F32).reshape(np.shape(x))


def recip_spec(x):
    """The spec's reciprocal of finite nonzero x (any sign): a bit-trick
    seed and three Newton steps.  Near-zero or huge inputs overflow to inf
    (callers sanitize); numpy's warnings for those are silenced."""
    with np.errstate(over="ignore", invalid="ignore"):
        bits = bitcast_i32(x)
        sign = bits & I32(-2147483648)
        mag = bits & I32(0x7FFFFFFF)
        r = bitcast_f32(I32(0x7EF311C3) - mag)
        ax = bitcast_f32(mag)
        for _ in range(3):
            r = r * (F32(2.0) - ax * r)
        return bitcast_f32(bitcast_i32(r) ^ sign)


def div_spec(a, b):
    """a * recip_spec(b)."""
    return a * recip_spec(b)


def rsqrt_spec(x):
    """The spec's reciprocal square root of positive x."""
    bits = bitcast_i32(x)
    r = bitcast_f32(I32(0x5F375A86) - (bits >> 1))
    for _ in range(3):
        r = r * (F32(1.5) - F32(0.5) * x * r * r)
    return r


def float_exponent(x):
    """floor(log2(|x|)) of a normal positive f32 from its exponent bits."""
    bits = np.ascontiguousarray(np.asarray(x, dtype=F32)).view(np.int32)
    return ((bits >> 23) & 0xFF) - 127


def flush_subnormal(v):
    """Magnitudes under FLT_MIN_NORMAL -> 0."""
    return np.where(np.abs(v) < FLT_MIN_NORMAL, F32(0.0), v)


def powi(x, e, max_bits):
    """x ** e for x in [0, 1] and integer e < 2**max_bits by
    square-and-multiply, the result's subnormals flushed to 0."""
    result = np.ones_like(x)
    base = x
    for bit in range(max_bits):
        take = (e >> bit) & 1
        result = np.where(take == 1, result * base, result)
        if bit + 1 < max_bits:
            base = base * base
    return flush_subnormal(result)
