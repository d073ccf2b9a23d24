"""Phase F (kernel K3F's plain version) and the shade-mode route, against
the JAX package, bit for bit:

* ``rasterize_distribute_plain(..., shade_mode)`` against the reference's
  Pallas raster kernel with the same shade mode (interpret mode), on the
  same range metadata and tables, in four shade modes (out-of-range uvs:
  tests/test_torch_tex_saturate.py);
* the shade-mode routing and the constants packing.

Planes are compared under the validity mask (row 17 >= 0) in rows 0-12,
and everywhere in the zero, id and pad rows: background pixels shade the
NaN attributes of empty fields.  Float rows are compared after mapping each
subnormal to the zero of its sign (``torch_parity.compare_f_planes``): XLA
on the CPU flushes subnormal results of products such as
``powi(...) * specular`` to zero, while torch and the CUDA kernels (built
without ``-ftz``) keep them, as numpy's oracle does.
The frames (tests/test_torch_phase_f_frames.py) are compared bit for bit."""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel, shade  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# case -> the shade mode (M, T, has_materials, has_atlas, has_light)
K3F_MODES = {
    "config3": (1, 0, True, False, True),  # untextured, lit: config3's
    "textured_on": (1, 1, True, True, True),
    "two_textures_on": (2, 2, True, True, True),
    "random": (1, 0, True, False, False),  # no light
}


@pytest.mark.parametrize("name", sorted(K3F_MODES))
def test_k3f_plain_matches_reference_kernel(name):
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case = tp.make_case(name)
    ref = tp.jax_front(case)
    smode, consts, ref_kw = tp.shade_inputs(case)
    assert smode == K3F_MODES[name]
    want = jfk.rasterize_distribute(
        jnp.asarray(ref["rmeta"]), jnp.asarray(ref["tbl_sorted"]),
        jnp.asarray(ref["tbl_ext"]), case.ref_cfg, interpret=True, **ref_kw)
    # the port's range meta has no slab word (the reference's last)
    got = fused_kernel.rasterize_distribute(
        tp.t(ref["rmeta"][:-1]), tp.t(tp.records(ref["tbl_sorted"])),
        tp.t(tp.records(ref["tbl_ext"])), tp.t(ref["comb"]), case.cfg, smode,
        consts)
    planes, valid = tp.compare_f_planes(got, want)
    assert valid.sum() > 300
    lit = planes[:, fused_kernel.F_LIT][valid]
    texmask = planes[:, fused_kernel.F_TEXMASK][valid]
    assert (lit != 0).any() == smode[4]
    assert (texmask != 0).any() == smode[3]


def _mats(m):
    return types.SimpleNamespace(base_color=np.zeros((m, 4), np.float32))


def _atlas(t):
    return types.SimpleNamespace(level_offset=np.zeros((t, 13), np.int32))


def test_shade_mode_for_matches_reference():
    from ash_renderer_tpu.pipeline import shade_mode_for as ref_mode_for

    for knob in ("off", "auto", "on"):
        for m in (1, 16, 17):
            for t in (None, 1, 2, 3):
                for has_light in (False, True):
                    statics = types.SimpleNamespace(
                        settings=types.SimpleNamespace(
                            fused_surface_shade=knob),
                        has_materials=True, has_atlas=t is not None,
                        has_light=has_light)
                    args = (statics, _mats(m),
                            None if t is None else _atlas(t),
                            object() if has_light else None)
                    assert pipeline.shade_mode_for(*args) == ref_mode_for(
                        *args), (knob, m, t, has_light)


def test_shade_consts_pack_the_tables():
    case = tp.make_case("two_textures_on")
    st = tp.port_state(case)
    smode = (2, 2, True, True, True)
    cam = torch.tensor([0.5, -1.0, 2.0])
    c = shade.pack_shade_consts(smode, st.materials, st.atlas, st.light, cam)
    lay = shade.shade_consts_layout(smode)
    assert c.dtype == torch.int32 and c.shape == (lay["_total"],)
    assert lay["_total"] == 2 * 7 + 2 * (3 * 13 + 1) + 7 + 3
    f = c.view(torch.float32)
    np.testing.assert_array_equal(f[lay["base"]:lay["base"] + 8].numpy(),
                                  st.materials.base_color.reshape(-1).numpy())
    np.testing.assert_array_equal(c[lay["lh"]:lay["lh"] + 26].numpy(),
                                  st.atlas.level_h.reshape(-1).numpy())
    np.testing.assert_array_equal(f[lay["cam"]:].numpy(), cam.numpy())
    assert float(f[lay["amb"]]) == float(st.light.ambient)


def test_k3f_wrapper_takes_the_kernel_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    case = tp.make_case("random")
    meta = torch.empty(case.cfg.n_tiles * 14, dtype=torch.int32,
                       device="meta")
    tbl = torch.empty((8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_kernel.rasterize_distribute(
            meta, tbl, tbl, tbl, case.cfg, (1, 0, True, False, False),
            torch.empty(10, dtype=torch.int32, device="meta"))
