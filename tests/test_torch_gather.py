"""K5 (``meshlet_gather.gather_tri_rows``) on CPU tensors against the JAX
package's ``gather_tri_rows`` (the Pallas kernel in interpret mode), bit
for bit, at the widths and id patterns ``chip_smoke.py`` holds the CUDA
kernel to (``chip_smoke.k5_edge_inputs``: random int32 tables with NaN
and Inf bit patterns, local ids that mix -1, 128, INT_MIN, INT_MAX and
padding rows).  Then the checks the CUDA path applies to its arguments,
called on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ash_renderer_tpu.ops import meshlet_gather as jmg
from ash_renderer_tpu_torch.ops import meshlet_gather

torch.set_num_threads(1)

SPECIAL_WORDS = np.array(cs.K5_SPECIAL_WORDS, np.uint32).view(np.int32)


def edge_inputs(nf: int, n_m: int, seed: int):
    """``chip_smoke.k5_edge_inputs`` on the CPU: (tbl (n_m*128, nf),
    local_tri (n_m*128, 3)) int32 tensors, one table word in 8 a NaN /
    Inf / -0.0 pattern, one id in 5 outside [0, 128), padding rows."""
    return cs.k5_edge_inputs(nf, n_m, np.random.default_rng(seed), "cpu")


@pytest.mark.parametrize("n_m", [1, 2, 3])
@pytest.mark.parametrize("nf", cs.K5_EDGE_COLS)
def test_gather_matches_pallas(nf, n_m):
    tbl, ids = (x.numpy() for x in edge_inputs(nf, n_m, seed=100 * nf + n_m))
    want = np.asarray(jmg.gather_tri_rows(jnp.asarray(tbl), jnp.asarray(ids),
                                          interpret=True))
    got = meshlet_gather.gather_tri_rows(torch.from_numpy(tbl),
                                         torch.from_numpy(ids)).numpy()
    assert got.dtype == np.int32 and got.shape == (n_m * 128, 3 * nf)
    np.testing.assert_array_equal(got, want)
    # every bad id gave a zero row; the NaN / Inf words came through
    t, k = np.nonzero((ids < 0) | (ids >= 128))
    assert t.size and not got.reshape(-1, 3, nf)[t, k].any()
    assert np.isin(got, SPECIAL_WORDS).any()


def _args(nf=8, n_m=2):
    return edge_inputs(nf, n_m, seed=1)


def _off16(x):
    """A view of ``x``'s values that starts 4 bytes past a 16-byte
    boundary (CPU tensors are allocated 64-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def test_kernel_args_accepts_fresh_tensors_and_prefix_views():
    tbl, ids = _args()
    meshlet_gather.check_kernel_args(tbl, ids)
    # the reference's build_comb_table passes a prefix view of attrs
    big = torch.cat([tbl, torch.zeros((7, 8), dtype=torch.int32)])
    meshlet_gather.check_kernel_args(big[: tbl.shape[0]], ids)


@pytest.mark.parametrize("bad", [
    "tbl_rows", "ids_rows", "ids_cols", "too_wide", "tbl_int64",
    "ids_float", "tbl_strided", "ids_strided", "tbl_off16", "ids_off16",
])
def test_kernel_args_refuses(bad):
    tbl, ids = _args()
    args = {
        "tbl_rows": (tbl[:128], ids),
        "ids_rows": (tbl, ids[:200]),
        "ids_cols": (tbl, ids[:, :2]),
        "too_wide": (torch.zeros((256, 33), dtype=torch.int32), ids),
        "tbl_int64": (tbl.long(), ids),
        "ids_float": (tbl, ids.float()),
        "tbl_strided": (torch.cat([tbl, tbl], 1)[:, ::2], ids),
        "ids_strided": (tbl, ids.t().contiguous().t()),
        "tbl_off16": (_off16(tbl), ids),
        "ids_off16": (tbl, _off16(ids)),
    }[bad]
    with pytest.raises(ValueError, match="16-byte" if "off16" in bad else None):
        meshlet_gather.check_kernel_args(*args)


def test_cpu_tensors_take_the_plain_version_whatever_their_alignment():
    """Alignment binds the kernel only: a misaligned CPU view gives the
    plain version's rows."""
    tbl, ids = _args(nf=12, n_m=1)
    want = meshlet_gather.gather_tri_rows_plain(tbl, ids)
    got = meshlet_gather.gather_tri_rows(_off16(tbl), _off16(ids))
    assert torch.equal(got, want)
