"""The fused route's clip tail: the setup flags' clip candidates -> the tail
comb rows (written in place after the main block), their streaming keys
and the frame's setup counters.

Kernel K6.  ``clip_tail`` launches ``csrc/clip_tail.cu`` on CUDA tensors
and runs ``clip_tail_plain`` on CPU tensors: the torch chain
``geometry.clip_tail_fused``, ``tritables.comb_rows``,
``binsort.stream_keys``, which is bit-equal to the JAX package's.

It replaces no Pallas kernel.  The reference's clip tail is XLA glue under
one jit (``ash_renderer_tpu/pipeline.py:416-447``, ``_clip_tail_into``),
which XLA fuses; in eager torch the same chain is ~1,200 launches over
the whole ``clip_budget`` and two host reads (the budgeted select's
``nonzero`` and the candidate count), which stall the host mid-front.

What bounds it on the card: the bytes it moves, ~20 MB (the flags read,
the selected corners' table rows, 7 x ``clip_budget`` comb rows of 512
bytes and their keys), a few microseconds at 3.35 TB/s, which three launch
floors already exceed.  So it is one cooperative launch, its grid sized
from the occupancy, in three passes split by grid syncs:

1. count: the clip, valid and fast flags of each chunk of ``CHUNK`` rows
   (warp ballots);
2. select: each chunk's first-candidate rank from the counts before it,
   its candidates written in ascending order while the rank is under the
   budget, -1 fill, and the counters;
3. fan: 16 lanes per budget slot, one per table channel, clip the
   selected triangle's polygon against the 6 guard planes
   (Sutherland-Hodgman with the reference's select-accumulate placement),
   then 7 lanes fan, snap, cull and rewind its triangles, and the 16
   write the slot's 7 comb rows and keys.

No count comes back to the host: the counters are 0-dim int32 tensors on
the device, read by callers after the frame's synchronize.
"""

from __future__ import annotations

import torch

from .. import _build
from . import binsort, geometry, setup_kernel, tritables

KERNEL = "K6_clip_tail"
# the counters, in the order of the kernel's counter buffer
COUNTERS = ("n_clipped", "clip_overflow", "n_valid", "n_fast")
N_LAUNCHES = 1
CHUNK = 4096  # setup rows a chunk of the count and select passes
N_FLAG_COUNTS = 3  # per chunk: clip candidates, valid rows, fast rows


def clip_tail(tblT, tri_v, tri_mat, flags, comb, cfg, clip_budget: int,
              tile_row0: int = 0, tile_rows=None):
    """The clip tail of a meshlet frame: clip the first ``clip_budget``
    clip candidates (flag bit 1) in triangle order, write their 7 *
    ``clip_budget`` fan rows into ``comb[T:]`` in place (row T + 7 * slot
    + fan index, ids the row indices) and key them for the tile-row
    window ``[tile_row0, tile_row0 + tile_rows)`` (the whole grid by
    default).

    tblT: (16, V) int32 vertex table; tri_v: (T, 3) int32; tri_mat: (T,)
    int32; flags: (T,) int32 from the setup kernel; comb: (T + 7 *
    clip_budget, 128) int32.  Returns (keys (7 * clip_budget,) int32,
    {name: 0-dim int32 tensor on the device} for ``COUNTERS``; n_valid
    counts the valid main and tail rows).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    dev = flags.device
    if dev.type == "cpu":
        return clip_tail_plain(tblT, tri_v, tri_mat, flags, comb, cfg,
                               clip_budget, tile_row0, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"clip_tail: unsupported device {dev}")
    t = tri_v.shape[0]
    n_tail = clip_budget * geometry.MAX_CLIP_TRIS
    n_verts = tblT.shape[1]
    for name, x, shape in (
        ("tblT", tblT, (setup_kernel.N_TBL_ROWS, n_verts)),
        ("tri_v", tri_v, (t, 3)),
        ("tri_mat", tri_mat, (t,)),
        ("flags", flags, (t,)),
        ("comb", comb, (t + n_tail, tritables.TBL_COLS)),
    ):
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"clip_tail: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    # one allocation: the counters, the per-chunk counts, sel
    n_chunks = -(-t // CHUNK)
    scratch = torch.empty(len(COUNTERS) + N_FLAG_COUNTS * n_chunks
                          + clip_budget, dtype=torch.int32, device=dev)
    counters = scratch[: len(COUNTERS)]
    keys = torch.empty(n_tail, dtype=torch.int32, device=dev)
    tile_rows, py_lo, py_hi = binsort.window_rows(cfg, tile_row0, tile_rows)
    gx, gy = setup_kernel.guard_factors(cfg)
    _build.launch(
        KERNEL, "ash_clip_tail", dev,
        flags.data_ptr(), tblT.data_ptr(), tri_v.data_ptr(),
        tri_mat.data_ptr(), scratch.data_ptr(), comb[t:].data_ptr(),
        keys.data_ptr(), n_verts, t, clip_budget, cfg.width, cfg.height,
        cfg.min_coord, cfg.max_coord_x, cfg.max_coord_y, cfg.subpixel_scale,
        float(gx), float(gy), tile_row0, py_lo, py_hi, cfg.tile_h,
        cfg.grid_w, tile_rows * cfg.grid_w, count=N_LAUNCHES,
    )
    return keys, dict(zip(COUNTERS, counters.unbind()))


def clip_tail_plain(tblT, tri_v, tri_mat, flags, comb, cfg, clip_budget: int,
                    tile_row0: int = 0, tile_rows=None):
    """clip_tail in torch ops (any device): ``geometry.clip_tail_fused``,
    ``tritables.comb_rows`` and ``binsort.stream_keys``."""
    t = tri_v.shape[0]
    tail_f, (a0, a1, a2), cstats = geometry.clip_tail_fused(
        tblT, tri_v, tri_mat, ((flags >> 1) & 1).bool(), cfg, clip_budget)
    comb[t:] = tritables.comb_rows(tail_f, a0, a1, a2, cfg, id_base=t)
    keys = binsort.stream_keys(
        tail_f["valid"], tail_f["x0"], tail_f["y0"], tail_f["x1"],
        tail_f["y1"], tail_f["x2"], tail_f["y2"], cfg, tile_row0, tile_rows)
    values = (cstats["n_clipped"], cstats["clip_overflow"],
              (flags & 1).sum() + tail_f["valid"].sum(),
              ((flags >> 2) & 1).sum())
    return keys, {k: torch.as_tensor(v, dtype=torch.int32, device=flags.device)
                  for k, v in zip(COUNTERS, values)}
