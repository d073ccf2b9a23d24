#!/usr/bin/env python3
"""What the classic binning stage pays for K4's record boxes, on one CUDA
card, at the config4 subdiv-8 classic frame (plain packing, static camera).

    python3 experiments/torch_binning_box_cost.py [--reps 10]

Times, on the same inputs, with CUDA events (device ms, a sleep kernel
queued ahead as in ``chip_smoke.run_timed``) and with the host clock (the
wall time of one call after a synchronize, median of ``reps``: the issue
time, since nothing in it waits for the card):

* the row gather of the packed triangle table by advanced indexing
  (``tbl[idx]``, what ``binning.bin_triangles`` does) with its 18 columns
  and with the first 16 (the table before it carried the pixel AABB), and
  by ``index_select``;
* the pairs' boxes four ways, each clipped to the tile and packed: from
  the two AABB columns of the gathered table row (what ``bin_triangles``
  does), from the triangles' pixel AABBs gathered apart by advanced
  indexing or by ``index_select``, and computed per pair from the corners
  in the gathered row (x0 = x2 + B1, y0 = y2 - A1); all must equal
  ``bin_triangles``' ``rec_box``;
* ``binning.bin_triangles`` whole.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch.ops import binning, geometry  # noqa: E402
from ash_renderer_tpu_torch.ops.binsort import pixel_aabb_of  # noqa: E402


def host_ms(fn, reps):
    """Median wall ms of one call of ``fn`` after a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def clip_pack(aabb, tile_c, live_p, cfg):
    px0 = (tile_c % cfg.grid_w) * cfg.tile_w
    py0 = (tile_c // cfg.grid_w) * cfg.tile_h
    box = binning.pack_box(torch.clamp(aabb[0] - px0, min=0),
                           torch.clamp(aabb[1] - px0, max=cfg.tile_w - 1),
                           torch.clamp(aabb[2] - py0, min=0),
                           torch.clamp(aabb[3] - py0, max=cfg.tile_h - 1))
    return torch.where(live_p, box, 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_binning_box_cost: no CUDA device")
    card = cs.card_line()
    print(card)

    from ash_renderer_tpu_torch.benchmarks import config4_million_tri
    from ash_renderer_tpu_torch.renderer import Renderer

    dev = torch.device("cuda", 0)
    scene, st, cams = config4_million_tri(8)
    r = Renderer(scene, dataclasses.replace(st, pipeline="classic"), device=dev)
    statics = cs.classic_statics(r)
    cfg, s = statics.cfg, r.state
    mm_t, mvp_t, _ = cs.front_inputs(r, cams[0])
    clip, attrs = geometry.transform_vertices(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    su, _, _ = geometry.geometry_device(clip, attrs, s.tri_v, s.tri_mat, cfg,
                                        r.settings.clip_budget)
    max_pairs = statics.settings.max_pairs
    rec_i, _, rec_box, start, count, _ = binning.bin_triangles(su, cfg, max_pairs)
    n_live = int(count.sum())
    # the pairs' triangle and tile, as bin_triangles has them after its sort
    tri = torch.full((max_pairs,), -1, dtype=torch.int32, device=dev)
    tri[:n_live] = rec_i[12, :n_live]
    tile = torch.full((max_pairs,), cfg.n_tiles, dtype=torch.int32, device=dev)
    tile[:n_live] = torch.repeat_interleave(
        torch.arange(cfg.n_tiles, dtype=torch.int32, device=dev), count.long())
    s_rows = su.x0.shape[0]
    t_s = torch.clamp(tri, 0, s_rows - 1).long()
    tile_c = torch.clamp(tile, 0, cfg.n_tiles - 1)
    live_p = tri >= 0
    aabb = pixel_aabb_of(su.x0, su.y0, su.x1, su.y1, su.x2, su.y2, cfg)
    tbl = binning._pack_tri_table(su, *aabb)
    tbl16 = tbl[:, :16].contiguous()
    aabb_t = torch.stack(aabb, dim=1)
    tpack = tbl[t_s]

    def box_columns():
        xr, yr = tpack[:, 16], tpack[:, 17]
        return clip_pack((xr & 0xFFFF, xr >> 16, yr & 0xFFFF, yr >> 16),
                         tile_c, live_p, cfg)

    def box_gather():
        return clip_pack(aabb_t[t_s].T, tile_c, live_p, cfg)

    def box_index_select():
        return clip_pack(aabb_t.index_select(0, t_s).T, tile_c, live_p, cfg)

    def box_corners():
        x2, y2 = tpack[:, 8], tpack[:, 9]
        return clip_pack(pixel_aabb_of(x2 + tpack[:, 3], y2 - tpack[:, 2],
                                       tpack[:, 6], tpack[:, 7], x2, y2, cfg),
                         tile_c, live_p, cfg)

    want = rec_box[0]
    for name, fn in (("columns", box_columns), ("gather", box_gather),
                     ("index_select", box_index_select), ("corners", box_corners)):
        cs.require(torch.equal(fn(), want), f"box by {name} != bin_triangles' rec_box")
    cs.require(torch.equal(tbl[t_s], tbl.index_select(0, t_s)), "gathers differ")
    print(f"{n_live} live pairs of {max_pairs}; {s_rows} setup rows; the four "
          "boxes equal rec_box")
    calls = {
        "table gather tbl[idx], 18 columns": lambda: tbl[t_s],
        "table gather tbl[idx], 16 columns": lambda: tbl16[t_s],
        "table gather index_select, 18 columns": lambda: tbl.index_select(0, t_s),
        "box from the row's AABB columns": box_columns,
        "box by gather": box_gather,
        "box by index_select": box_index_select,
        "box from the row's corners": box_corners,
        "bin_triangles": lambda: binning.bin_triangles(su, cfg, max_pairs),
    }
    for name, fn in calls.items():
        dev_ms = cs.run_timed(fn, args.reps)[1]
        print(f"[{card}] {name}: device {dev_ms:.4f} ms, host issue "
              f"{host_ms(fn, args.reps):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
