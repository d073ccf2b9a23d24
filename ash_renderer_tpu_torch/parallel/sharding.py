"""Multi-device rendering: the framebuffer's tile rows split into slabs,
one slab per entry of a device mesh (the counterpart of
``ash_renderer_tpu/parallel/sharding.py``).

* Slab size: each slab owns ``rows_per = ceil(grid_h / n)`` tile rows
  (of ``cfg.tile_h`` pixel rows: 8 or 4 on the fused route, 16 on the
  classic one) from ``tile_row0 = i * rows_per``.  Rows past the screen key nothing and
  render the background; the assembled frame is cropped to the height.
* Geometry and triangle setup (K1) are replicated: each slab runs them
  whole on its own device.  Keys, run bounds (K2), the wide expansion and
  binning take the slab's window, and the rasters (K3 / K3F, K4) run over
  its tiles (``pipeline``'s ``tile_row0`` / ``tile_rows``).
* Each slab gets the full pair budget: its pairs are a subset of the
  frame's, so a scene that fits one device fits every slab.
* Counters: the worst slab's, as the reference's ``pmax``.
* The one step across devices is the frame's assembly: each slab's RGBA8
  rows are copied to the mesh's first device and concatenated, in place of
  ``shard_map``'s all-gather.

A mesh is a tuple of ``torch.device``s of one type.  It may repeat a
device: that is how one card, or the CPU, renders N slabs; on N cards the
same code renders each slab on its own card.  The slabs run one after
another from one host thread, each with its own tables, which are freed
before the next slab starts.
"""

from __future__ import annotations

import torch

from .. import pipeline


def make_render_mesh(devices) -> tuple:
    """The mesh of ``devices`` (torch devices or their names), in slab
    order.  Raises if it is empty or mixes device types."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_render_mesh: no devices")
    if len({d.type for d in mesh}) != 1:
        raise ValueError("make_render_mesh: the devices are of more than one "
                         f"type: {', '.join(map(str, mesh))}")
    return mesh


def slab_rows(statics, n_slabs: int) -> int:
    """Tile rows per slab for ``n_slabs`` slabs; raises if a slab's display
    rows do not resolve to whole rows under the supersampling factor."""
    rows_per = -(-statics.cfg.grid_h // n_slabs)
    if rows_per * statics.cfg.tile_h % statics.settings.supersample:
        raise ValueError("slab rows not divisible by supersample factor")
    return rows_per


def _per_device(mesh, x):
    """``x`` (a tensor or None) on each distinct device of the mesh."""
    return {d: None if x is None else x.to(d) for d in dict.fromkeys(mesh)}


def _assemble(mesh, statics, slabs, stats):
    """(the frame on mesh[0], cropped to the height; the worst slab's
    counters on mesh[0])."""
    dev0 = mesh[0]
    frame = torch.cat([s.to(dev0) for s in slabs])[: statics.settings.height]
    worst = {k: torch.stack([torch.as_tensor(s[k]).to(dev0, torch.int64)
                             for s in stats]).max() for k in stats[0]}
    return frame, worst


def _render_slabs(statics, mesh, state_per_device, slab, inputs, on_stage):
    """Each slab through ``slab`` on its device, in mesh order, then the
    assembly.  ``inputs``: tensors (or None) every slab takes, moved once to
    each distinct device."""
    mesh = make_render_mesh(mesh)
    missing = [d for d in mesh if d not in state_per_device]
    if missing:
        raise ValueError(f"no scene state on {missing[0]}")
    rows_per = slab_rows(statics, len(mesh))
    on_dev = [_per_device(mesh, x) for x in inputs]
    slabs, stats = [], []
    for i, d in enumerate(mesh):
        # the slab's tables live only inside ``slab``: freed before the next
        rgba8, st = slab(statics, state_per_device[d], *(x[d] for x in on_dev),
                         i * rows_per, rows_per,
                         lambda name, i=i: on_stage(f"{name}@{i}"))
        slabs.append(rgba8)
        stats.append(st)
    out = _assemble(mesh, statics, slabs, stats)
    on_stage("assemble")
    return out


def _classic_slab(statics, state, mm, mvp, cam, local_tri, tile_row0,
                  rows_per, on_stage):
    rgba8, aux = pipeline.render_frame(
        statics, state, mm, mvp, cam, local_tri=local_tri,
        on_stage=on_stage, tile_row0=tile_row0, tile_rows=rows_per)
    return rgba8, {"pairs_overflow": aux["pairs_overflow"]}


def render_frame_sharded(statics, mesh, state_per_device, model_mats,
                         mvp_mats, camera_pos, local_tri=None,
                         on_stage=pipeline._no_stage):
    """The classic pipeline's frame over the mesh's slabs.  ``mesh``:
    ``make_render_mesh``'s tuple; ``state_per_device``: {device: the scene
    state uploaded there} for each device of the mesh; the matrices, the
    camera position and ``local_tri`` (the meshlet-local corner ids of a
    meshlet-packed scene, gathered through K5) are tensors on any device.
    ``on_stage(name)`` is called as each stage of each slab has been
    issued, the name tagged "@<slab>", and as the frame is assembled.
    Returns (rgba8 (H, W, 4) uint8 on mesh[0], {"pairs_overflow": the
    worst slab's})."""
    return _render_slabs(statics, mesh, state_per_device, _classic_slab,
                         (model_mats, mvp_mats, camera_pos, local_tri),
                         on_stage)


FUSED_COUNTERS = ("clip_overflow", "n_wide", "wide_pairs_n", "wide_leftover",
                  "live_rows", "n_clipped")


def _fused_slab(statics, state, mm, mvp, cam, tile_row0, rows_per,
                on_stage):
    front = pipeline.render_front(statics, state, mm, mvp, on_stage,
                                  tile_row0=tile_row0, tile_rows=rows_per)
    rgba8, aux = pipeline._raster_shade(statics, state, front[:4], cam,
                                        front[4], on_stage, tile_row0,
                                        rows_per)
    return rgba8, {k: aux[k] for k in FUSED_COUNTERS}


def render_frame_sharded_fused(statics, mesh, state_per_device, model_mats,
                               mvp_mats, camera_pos,
                               on_stage=pipeline._no_stage):
    """The fused pipeline's frame (meshlet-packed states) over the mesh's
    slabs; arguments as ``render_frame_sharded``.  Returns (rgba8 on
    mesh[0], the worst slab's clip_overflow, n_wide, wide_pairs_n,
    wide_leftover, live_rows and n_clipped)."""
    if any(st.ltT is None for st in state_per_device.values()):
        raise ValueError("render_frame_sharded_fused takes a meshlet-packed "
                         "scene state")
    return _render_slabs(statics, mesh, state_per_device, _fused_slab,
                         (model_mats, mvp_mats, camera_pos), on_stage)
