"""Meshlet-local corner gather: kernel K5.

``gather_tri_rows`` launches ``csrc/gather.cu`` on CUDA tensors and runs
``gather_tri_rows_plain`` (an indexed gather) on CPU tensors.  It replaces
the Pallas kernel ``ash_renderer_tpu/ops/meshlet_gather.py:_rows_kernel``
(via ``gather_tri_rows``), whose one-hot int8 matmuls and byte-plane
reassembly exist because the TPU's general gather runs on its scalar path.
Here a meshlet is one tile in and one tile out: persistent blocks bring
each meshlet's table slab and ids into shared memory with bulk copies,
assemble its (128, 3F) output tile there, and write it with one bulk copy.

What bounds it on the card: memory, the (V, F) table and (T, 3) ids read
once and T x 3F words written once (184 MB at the headline, F = 8).  The
bulk copies need ``tbl`` and ``local_tri`` to start 16-byte aligned;
``check_kernel_args`` raises on a view that does not.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..scene import MESHLET_TRIS, MESHLET_VERTS

KERNEL = "K5_gather_rows"
SOURCE = "gather.cu"
MAX_COLS = 32
CORNER_COLS = 8  # the classic setup's corner rows (geometry.VTX_COLS)


def launch_name(nf: int) -> str:
    """The launch count K5 adds to at width F = ``nf``: ``KERNEL`` at the
    classic setup's corner width, ``KERNEL_F<nf>`` at any other (F = 12:
    ``tritables.build_comb_table``'s attribute corners)."""
    return KERNEL if nf == CORNER_COLS else f"{KERNEL}_F{nf}"


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


def check_kernel_args(tbl, local_tri) -> None:
    """Raise ValueError unless ``tbl`` and ``local_tri`` are what the kernel
    reads: the shapes ``gather_tri_rows`` takes, int32, contiguous, on one
    device, each starting 16-byte aligned."""
    _check(tbl, local_tri)
    for name, x in (("tbl", tbl), ("local_tri", local_tri)):
        if x.device != tbl.device or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"gather_tri_rows: want contiguous int32 {name} on "
                             f"{tbl.device}, got {x.dtype} on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"gather_tri_rows: {name} must start 16-byte aligned")


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
    check_kernel_args(tbl, local_tri)
    t, nf = local_tri.shape[0], tbl.shape[1]
    out = torch.empty((t, 3 * nf), dtype=torch.int32, device=dev)
    if out.numel():
        _build.launch(launch_name(nf), "ash_gather_tri_rows", dev, tbl.data_ptr(),
                      local_tri.data_ptr(), out.data_ptr(), t, nf)
    return out


def persistent_wave(nf: int, device) -> int:
    """The kernel's persistent grid on CUDA ``device`` at F = ``nf``: the
    blocks that fit on all its SMs at once.  Above this many meshlets a
    block walks more than one."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.load(SOURCE).ash_gather_tri_rows_wave(nf, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"ash_gather_tri_rows_wave: CUDA error {rc}")
    return blocks.value


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
