"""Run bounds of a sorted key stream: kernel K2.

``sorted_run_bounds`` launches ``csrc/bincount.cu`` on a CUDA tensor and
runs ``sorted_run_bounds_plain`` (``torch.searchsorted``) on a CPU tensor.
It replaces the Pallas kernel ``ash_renderer_tpu/ops/bincount.py:_kernel``
(via ``sorted_run_bounds``), whose per-block ownership windows and
byte-plane transpose matmuls exist for the TPU's sequential grid and
matrix unit.  After the sort the keys ascend, so no search is needed: the
thread of sorted position i writes ``bounds[v] = i`` for every bin v in
(key[i-1], key[i]], and the thread past the end writes S into the bins
above the largest key.

What bounds it on the card: one read of the S keys and one write of the
bins (~5 MB at the headline, S ~ 1.34M, 24,302 bins); it is launch-latency
sized.
"""

from __future__ import annotations

import torch

from .. import _build

KERNEL = "K2_run_bounds"


def sorted_run_bounds(key_sorted, n_bins: int):
    """bounds[v] = first i with key_sorted[i] >= v, for v in [0, n_bins);
    key_sorted ascending int32 with values in [0, n_bins).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    dev = key_sorted.device
    if dev.type == "cpu":
        return sorted_run_bounds_plain(key_sorted, n_bins)
    if dev.type != "cuda":
        raise ValueError(f"sorted_run_bounds: unsupported device {dev}")
    if (key_sorted.dtype != torch.int32 or key_sorted.dim() != 1
            or not key_sorted.is_contiguous()):
        raise ValueError("sorted_run_bounds: want contiguous 1-D int32 keys")
    bounds = torch.empty(n_bins, dtype=torch.int32, device=dev)
    _build.launch(
        KERNEL, "ash_run_bounds", dev,
        key_sorted.data_ptr(), bounds.data_ptr(), key_sorted.shape[0], n_bins,
    )
    return bounds


def sorted_run_bounds_plain(key_sorted, n_bins: int):
    """sorted_run_bounds in torch ops (any device)."""
    v = torch.arange(n_bins, dtype=torch.int32, device=key_sorted.device)
    return torch.searchsorted(key_sorted, v, right=False).to(torch.int32)
