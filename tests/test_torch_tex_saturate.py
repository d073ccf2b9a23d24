"""Texture addressing past 2**31 texels: the float -> int32 casts of the
tap address saturate as XLA's convert does (NaN -> 0, >= 2**31 ->
2147483647, < -2**31 -> -2147483648), where torch's own CPU cast gives
-2147483648 for every out-of-range value.  Checked bit for bit against the
JAX package in ``shade.sample_texture`` and in phase F's plain version."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch.ops import fused_kernel, shade  # noqa: E402

torch.set_num_threads(1)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_saturating_cast_matches_xla():
    from ash_renderer_tpu_torch import specmath as sm

    x = np.array([0.5, -0.5, 123.9, -123.9, 2147483520.0, 2147483648.0,
                  3e9, -2147483648.0, -2147483904.0, -3e9, 5.12e9, np.inf,
                  -np.inf, np.nan, 1e7, -1e7], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = sm.f32_to_i32_sat(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # torch's own cast is what the port had: it differs past 2**31
    assert (torch.from_numpy(x).to(torch.int32).numpy() != want).any()


def test_sample_texture_saturates_like_jax():
    """u, v up to +-1e7 on a 512x512 level: |u * w| reaches 5.12e9, past
    2**31; the port's tap equals the JAX package's (xp=jnp) bit for bit."""
    from ash_renderer_tpu.ops import shade as ref_shade
    from ash_renderer_tpu.textures import TextureAtlas, checkerboard
    from ash_renderer_tpu_torch.textures import TextureAtlas as PortAtlas

    ref_atlas = TextureAtlas.build([checkerboard(512)])
    atlas = PortAtlas(**{f.name: torch.from_numpy(
        np.asarray(getattr(ref_atlas, f.name)))
        for f in dataclasses.fields(PortAtlas)})
    probes = np.array([1e7, -1e7, 5e6, -3e6, 0.3, -0.7, 4.2e6, 0.0],
                      np.float32)
    u, v = (a.reshape(-1) for a in np.meshgrid(probes, probes[::-1]))
    n = u.shape[0]
    tex_id = np.zeros(n, np.int32)
    level = np.zeros(n, np.int32)
    want = np.asarray(ref_shade.sample_texture(
        jnp, ref_atlas, jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(level)))
    got = shade.sample_texture(atlas, torch.from_numpy(tex_id),
                               torch.from_numpy(u), torch.from_numpy(v),
                               torch.from_numpy(level))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert (np.abs(u) * 512 >= 2.0 ** 31).sum() >= 16


def test_k3f_saturates_like_reference_kernel():
    """Phase F at uvs past 2**31 texels: the tap address, fu and fv equal
    the reference kernel's (XLA's saturating cast), not torch's INT_MIN."""
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case = tp.make_case("huge_uv_on")
    ref = tp.jax_front(case)
    smode, consts, ref_kw = tp.shade_inputs(case)
    assert smode == (1, 1, True, True, True)
    args = (tp.t(ref["rmeta"][:-1]), tp.t(ref["tbl_sorted"]),
            tp.t(ref["tbl_ext"]), tp.t(ref["comb"]), case.cfg)
    want = jfk.rasterize_distribute(
        jnp.asarray(ref["rmeta"]), jnp.asarray(ref["tbl_sorted"]),
        jnp.asarray(ref["tbl_ext"]), case.ref_cfg, interpret=True, **ref_kw)
    planes, valid = tp.compare_f_planes(
        fused_kernel.rasterize_distribute(*args, smode, consts), want)
    assert valid.sum() > 300
    # the phase E planes of the same pixels: u = 3e9 texels and more
    u = fused_kernel.rasterize_distribute(*args)[2][:, 7].numpy()
    assert (np.abs(u.view(np.float32)[valid]) >= 2.0 ** 31).all()
    fu = planes[:, fused_kernel.F_FU].view(np.float32)[valid]
    assert np.isfinite(fu).all()
