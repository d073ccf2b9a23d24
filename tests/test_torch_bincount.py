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
    # the CUDA kernel's edges (csrc/bincount.cu): 8 keys per thread, 32
    # threads per warp (256 keys), 256 threads per block (2048 keys)
    (6, 7, 40),            # chunk - 1
    (7, 8, 40),            # chunk
    (8, 9, 40),            # chunk + 1
    (9, 255, 300),         # 32 chunks - 1
    (10, 257, 300),        # 32 chunks + 1
    (11, 2_047, 700),      # a block's keys - 1
    (12, 2_049, 700),      # a block's keys + 1
    (13, 0, 50),           # no keys: every bin 0 (numpy only)
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
    if s:
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


def test_run_bounds_wants_aligned_keys():
    """The kernel reads the keys 16 bytes at a time: the wrapper's check
    refuses a view that starts off a 16-byte boundary and any layout but
    contiguous 1-D int32 (the CPU path itself takes any keys)."""
    keys = torch.arange(64, dtype=torch.int32)
    bincount.check_keys(keys)
    bincount.check_keys(keys[4:])
    for bad in (keys[1:], keys[2:], keys[3:]):
        with pytest.raises(ValueError, match="16-byte"):
            bincount.check_keys(bad)
    for bad in (keys.long(), keys.reshape(8, 8), keys[::2]):
        with pytest.raises(ValueError, match="contiguous 1-D int32"):
            bincount.check_keys(bad)
