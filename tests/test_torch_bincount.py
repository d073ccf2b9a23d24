"""K2's plain version (sorted_run_bounds) against the reference's Pallas
counting kernel (interpret mode) and numpy's searchsorted, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_renderer_tpu.ops.bincount import sorted_run_bounds as jax_bounds
from ash_renderer_tpu_torch.ops import bincount

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,s,nbins", [
    (0, 1_000, 130),       # single block, sparse bins
    (1, 5_000, 34),        # dense bins, long constant runs
    (2, 4_096, 2_050),     # exact block multiple
    (3, 17, 3_000),        # tiny input, huge bin space
    (4, 9_000, 9_000),     # bins ~ keys
    (5, 1, 5),             # one key
])
def test_run_bounds_match_reference(seed, s, nbins):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, nbins, s).astype(np.int32))
    if seed == 1:
        keys[: s // 2] = 7
        keys = np.sort(keys)
    got = bincount.sorted_run_bounds(torch.from_numpy(keys), nbins)
    assert got.dtype == torch.int32 and got.shape == (nbins,)
    want = np.searchsorted(keys, np.arange(nbins), side="left")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_bounds(jnp.asarray(keys), nbins,
                                           interpret=True))
    )


def test_run_bounds_dead_tail():
    """Keys ending in the dead key (the last bin): every bin above the
    largest live key points at the dead run; the bins past it at S."""
    keys = np.array([0, 0, 3, 3, 3, 9, 9], np.int32)
    got = bincount.sorted_run_bounds(torch.from_numpy(keys), 12).numpy()
    np.testing.assert_array_equal(got, [0, 2, 2, 2, 5, 5, 5, 5, 5, 5, 7, 7])


def test_run_bounds_wrapper_takes_the_kernel_off_the_cpu():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bincount.sorted_run_bounds(keys, 8)
