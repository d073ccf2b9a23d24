"""The fused route's vertex stage: scene vertices + model / MVP matrices ->
the (16, V) int32 table [clip4 | colour4 | world normal3 | uv2 | world
pos3] (float32 bits) that the setup kernel K1 and the clip tail K6 read.

Kernel K8.  ``transform_vertices_T`` launches ``csrc/transform.cu`` on CUDA
tensors and runs ``transform_vertices_T_plain`` on CPU tensors: the torch
chain ``geometry.vertex_rows`` stacked, bit-equal to the JAX package's
``setup_kernel.transform_vertices_T``.

It replaces no Pallas kernel.  The reference's transform is XLA glue under
one jit (``ash_renderer_tpu/pipeline.py:413``), which XLA fuses; in eager
torch the same chain is ~64 launches of ~2.6 MB each.

What bounds it on the card: bytes.  Each vertex reads 48 bytes (position,
normal, colour, uv, object id) and writes 64, so at config4 subdiv 8
(655,362 vertices) it moves ~73 MB, ~0.022 ms at 3.35 TB/s.  One thread a
vertex; a warp writes 32 neighbouring columns of each table row.

The classic route and the non-meshlet fallback take the same transform
in row layout, kernel K8C (``geometry.transform_vertices``), a second
entry of the same source.
"""

from __future__ import annotations

import torch

from .. import _build
from .. import specmath as sm
from .geometry import check_transform_args, vertex_rows

KERNEL = "K8_vertex_transform"
N_ROWS = 16


def transform_vertices_T(positions, vert_obj, normals, colors, uvs,
                         model_mats, mvp_mats):
    """(16, V) int32 table of the vertices under the model (``model_mats``)
    and MVP (``mvp_mats``) matrices, (O, 4, 4) float32 each: one object's
    are broadcast, several are taken by ``vert_obj``.  positions, normals
    (V, 3), colors (V, 4), uvs (V, 2) float32; vert_obj (V,) int32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    dev = positions.device
    if dev.type == "cpu":
        return transform_vertices_T_plain(positions, vert_obj, normals, colors,
                                          uvs, model_mats, mvp_mats)
    if dev.type != "cuda":
        raise ValueError(f"transform_vertices_T: unsupported device {dev}")
    check_transform_args("transform_vertices_T", positions, vert_obj,
                         normals, colors, uvs, model_mats, mvp_mats)
    v = positions.shape[0]
    n_obj = model_mats.shape[0]
    out = torch.empty((N_ROWS, v), dtype=torch.int32, device=dev)
    _build.launch(
        KERNEL, "ash_vertex_transform", dev,
        positions.data_ptr(), vert_obj.data_ptr(), normals.data_ptr(),
        colors.data_ptr(), uvs.data_ptr(), model_mats.data_ptr(),
        mvp_mats.data_ptr(), out.data_ptr(), v, n_obj,
    )
    return out


def transform_vertices_T_plain(positions, vert_obj, normals, colors, uvs,
                               model_mats, mvp_mats):
    """transform_vertices_T in torch ops (any device):
    ``geometry.vertex_rows`` stacked and bitcast."""
    rows = vertex_rows(positions, vert_obj, normals, colors, uvs, model_mats,
                       mvp_mats)
    return sm.bitcast_i32(torch.stack(rows, dim=0))
