"""Meshlet-local corner gather: kernel K5.

``gather_tri_rows`` launches ``csrc/gather.cu`` on CUDA tensors and runs
``gather_tri_rows_plain`` (an indexed gather) on CPU tensors.  It replaces
the Pallas kernel ``ash_renderer_tpu/ops/meshlet_gather.py:_rows_kernel``
(via ``gather_tri_rows``), whose one-hot int8 matmuls and byte-plane
reassembly exist because the TPU's general gather runs on its scalar path:
here one thread writes one output word with a plain load.

What bounds it on the card: memory, T x 3F words read and written once
(1.31M triangles x 24 words: 126 MB each way at the headline).
"""

from __future__ import annotations

import torch

from .. import _build
from ..scene import MESHLET_TRIS, MESHLET_VERTS

KERNEL = "K5_gather_rows"
MAX_COLS = 32


def _check(tbl, local_tri):
    v, nf = tbl.shape
    t = local_tri.shape[0]
    if (nf > MAX_COLS or t % MESHLET_TRIS or v != (t // MESHLET_TRIS) * MESHLET_VERTS
            or local_tri.shape != (t, 3)):
        raise ValueError(
            f"gather_tri_rows: want tbl (n_meshlets * {MESHLET_VERTS}, F <= "
            f"{MAX_COLS}) and local_tri (n_meshlets * {MESHLET_TRIS}, 3), got "
            f"{tuple(tbl.shape)} and {tuple(local_tri.shape)}"
        )


def gather_tri_rows(tbl, local_tri):
    """Corner rows by meshlet-local index: tbl (V, F) int32 with V =
    n_meshlets * 128 and F <= 32, local_tri (T, 3) int32 with T = V.
    Returns (T, 3F) int32: corner k of triangle t at columns [kF, (k+1)F)
    is tbl[(t // 128) * 128 + local_tri[t, k]], bit for bit, and 0 where
    the local id is outside [0, 128).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check(tbl, local_tri)
    dev = tbl.device
    if dev.type == "cpu":
        return gather_tri_rows_plain(tbl, local_tri)
    if dev.type != "cuda":
        raise ValueError(f"gather_tri_rows: unsupported device {dev}")
    for name, x in (("tbl", tbl), ("local_tri", local_tri)):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"gather_tri_rows: bad {name} {x.dtype} on {x.device}")
    t, nf = local_tri.shape[0], tbl.shape[1]
    out = torch.empty((t, 3 * nf), dtype=torch.int32, device=dev)
    _build.launch(KERNEL, "ash_gather_tri_rows", dev, tbl.data_ptr(),
                  local_tri.data_ptr(), out.data_ptr(), t, nf)
    return out


def gather_tri_rows_plain(tbl, local_tri):
    """gather_tri_rows in torch ops (any device)."""
    _check(tbl, local_tri)
    t, nf = local_tri.shape[0], tbl.shape[1]
    base = (torch.arange(t, device=tbl.device) // MESHLET_TRIS * MESHLET_VERTS)[:, None]
    loc = local_tri.long()
    ok = (loc >= 0) & (loc < MESHLET_VERTS)
    rows = tbl[base + loc.clamp(0, MESHLET_VERTS - 1)]  # (T, 3, F)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=tbl.dtype,
                                                        device=tbl.device))
    return rows.reshape(t, 3 * nf)
