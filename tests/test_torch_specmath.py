"""The port's specmath (torch) against the reference spec (numpy), bit for
bit, on inputs that include +-0, subnormals, inf and NaN."""

import numpy as np
import pytest
import torch

from ash_renderer_tpu import specmath as ref
from ash_renderer_tpu_torch import specmath as sm

torch.set_num_threads(1)

F32 = np.float32
SPECIAL = np.array(
    [0.0, -0.0, 1e-40, -1e-40, 1e-45, np.inf, -np.inf, np.nan, 1.0, -1.0,
     3.4028235e38, -3.4028235e38, 1.1754944e-38, 0.5, 65535.0],
    dtype=F32,
)


def _floats(seed, n=4000, special=True):
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(-100.0, 88.0, n)).astype(F32)
    x = np.where(rng.random(n) < 0.5, -mag, mag).astype(F32)
    return np.concatenate([x, SPECIAL]) if special else x


def _unit(seed, n=4000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, n).astype(F32)
    return np.concatenate([x, np.array([0.0, -0.0, 1e-40, -1e-40, 0.5, -0.5,
                                        1.0, -1.0], F32)])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == F32 else a


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_recip_spec(seed):
    x = _floats(seed)
    _same(sm.recip_spec(t(x)), ref.recip_spec(x, np))


@pytest.mark.parametrize("seed", [2, 3])
def test_rsqrt_and_div_spec(seed):
    x = np.abs(_floats(seed))
    with np.errstate(over="ignore", invalid="ignore"):
        want = ref.rsqrt_spec(x, np)
    _same(sm.rsqrt_spec(t(x)), want)
    y = _floats(seed + 10)
    with np.errstate(over="ignore", invalid="ignore"):
        want_d = ref.div_spec(y, x, np)
    _same(sm.div_spec(t(y), t(x)), want_d)


def test_bitcasts_exponent_and_flush():
    x = _floats(4)
    _same(sm.bitcast_i32(t(x)), x.view(np.int32))
    _same(sm.bitcast_f32(t(x.view(np.int32))), x)
    pos = np.abs(x[np.isfinite(x) & (x != 0)])
    _same(sm.float_exponent(t(pos)), ref.float_exponent(pos, np))
    _same(sm.flush_subnormal(t(x)), ref.flush_subnormal(x, np))


@pytest.mark.parametrize("max_bits", [1, 8])
def test_powi(max_bits):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(0, 1, 3000).astype(F32),
                        np.array([0.0, -0.0, 1e-40, 1.0, 0.999999], F32)])
    e = rng.integers(0, 1 << max_bits, x.shape[0]).astype(np.int32)
    _same(sm.powi(t(x), t(e), max_bits), ref.powi(x, e, max_bits, np))


@pytest.mark.parametrize("size,ss,lo,hi", [(1920, 16, -512, 31232),
                                           (192, 16, -512, 3584)])
def test_snap_and_quantize(size, ss, lo, hi):
    x = np.concatenate([_unit(6) * F32(2.5), np.array(
        [F32(0.5) / F32(size * ss), -F32(0.5) / F32(size * ss)], F32)])
    _same(sm.snap_coord(t(x), size, ss, lo, hi),
          ref.snap_coord(x, size, ss, lo, hi, np))
    _same(sm.quantize_depth(t(x)), ref.quantize_depth(x, np))


def test_interp_depth_and_weights():
    rng = np.random.default_rng(7)
    n = 4000
    e = [rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32) for _ in range(3)]
    z = [rng.integers(0, 65536, n).astype(np.int32) for _ in range(3)]
    inv = (F32(1.0) / rng.uniform(1, 1 << 22, n)).astype(F32)
    _same(sm.interp_depth16(*map(t, e), t(inv), *map(t, z)),
          ref.interp_depth16(*e, inv, *z, np))
    lam = [_unit(8 + k) for k in range(3)]
    iw = [np.abs(_unit(11 + k)) for k in range(3)]
    with np.errstate(all="ignore"):
        want = ref.persp_weights(*lam, *iw, np)
    for g, w in zip(sm.persp_weights(*map(t, lam), *map(t, iw)), want):
        _same(g, w)
    bw = sm.bary_weights(*map(t, e), t(inv))
    for g, w in zip(bw, ref.bary_weights(*e, inv, np)):
        _same(g, w)
    a = [_floats(20 + k, special=False) for k in range(6)]
    with np.errstate(all="ignore"):
        _same(sm.dot3(*map(t, a)), ref.dot3(*a))
        _same(sm.lerp(*map(t, a[:3])), ref.lerp(*a[:3]))


def test_edges_fill_rule_and_depth_key():
    rng = np.random.default_rng(9)
    n = 5000
    c = [rng.integers(-512, 31232, n).astype(np.int32) for _ in range(6)]
    c[2][:100] = c[0][:100]  # dx == 0 edges
    c[3][100:200] = c[1][100:200]  # dy == 0 edges
    for g, w in zip(sm.edge_coeffs(*map(t, c[:4])), ref.edge_coeffs(*c[:4])):
        _same(g, w)
    a, b, _ = ref.edge_coeffs(*c[:4])
    _same(sm.edge_at(t(a), t(b), t(c[0]), t(c[1]), t(c[4]), t(c[5])),
          ref.edge_at(a, b, c[0], c[1], c[4], c[5]))
    _same(sm.shoelace2(*map(t, c)), ref.shoelace2(*c))
    d = [rng.integers(0, 4, n).astype(np.int32) for _ in range(4)]
    _same(sm.depth_key_better(*map(t, d)), ref.depth_key_better(*d))
    px, py = rng.integers(0, 1920, n), rng.integers(0, 1080, n)
    for g, w in zip(sm.pixel_sample_coords(t(px), t(py), 16),
                    ref.pixel_sample_coords(px, py, 16)):
        _same(g, w)


def test_transform_chains():
    rng = np.random.default_rng(10)
    m = rng.uniform(-3, 3, (4, 4)).astype(F32)
    xyz = [rng.uniform(-2, 2, 3000).astype(F32) for _ in range(3)]
    for g, w in zip(sm.apply_mat4_point(t(m), *map(t, xyz)),
                    ref.apply_mat4_point(m, *xyz)):
        _same(g, w)
    for g, w in zip(sm.apply_mat3_vec(t(m), *map(t, xyz)),
                    ref.apply_mat3_vec(m, *xyz)):
        _same(g, w)


def test_pack_unorm8_and_srgb_lut():
    x = np.concatenate([_unit(12), np.array(
        [0.5 / 255, 1.5 / 255, 254.5 / 255, 2.0, -3.0], F32)])
    _same(sm.pack_unorm8(t(x)), ref.pack_unorm8(x, np))
    _same(sm.srgb_encode_lut(), ref.srgb_encode_lut())
