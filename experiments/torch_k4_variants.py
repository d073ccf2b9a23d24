#!/usr/bin/env python3
"""Time design variants of K4 (``csrc/raster_classic.cu``) against each
other on one CUDA card, on the classic frames ``chip_smoke.py`` feeds it.

    python3 experiments/torch_k4_variants.py [--source NAME=PATH ...] [--reps 20]

Builds ``csrc/raster_classic.cu`` (as "csrc") and each extra source given,
for example ``experiments/k4_warp_footprint.cu`` or a copy of it with
another ``PX`` made with ``sed``, with the same C entry point (``-I csrc``
finds ``specmath.cuh``), all compilers started together, and prints
ptxas's report for each.  Every variant is held bit
for bit to the plain version on the records of: config4 subdiv 8 on the
Renderer's classic route (plain packing) and meshlet-packed, the subdiv-5
fly-by frame 12 (clipped), the reference scene at 800x600 and config2.
Then each is timed with CUDA events in turns (a, b, ..., ..., b, a) on the
two subdiv-8 frames and the reference scene.  Prints each frame's live
records, box pixels and brute-force record-pixels.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch.ops import raster_visibility as rv  # noqa: E402
from torch_k3_variants import build_variants, use  # noqa: E402

SOURCE = "raster_classic.cu"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another raster_classic.cu to build and time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k4_variants: no CUDA device")
    card = cs.card_line()
    print(card)
    libs = build_variants([s.split("=", 1) for s in args.source], SOURCE)

    from ash_renderer_tpu_torch.benchmarks import (config2_multi_mesh,
                                                   config4_million_tri)
    from ash_renderer_tpu_torch.camera import Camera
    from ash_renderer_tpu_torch.renderer import Renderer
    from ash_renderer_tpu_torch.scene import reference_two_triangle_scene

    dev = torch.device("cuda", 0)
    scene8, st8, cams8 = config4_million_tri(8)
    scene5, st5, _ = config4_million_tri(5)
    scene2, st2, cams2 = config2_multi_mesh()
    frames = {  # name -> (renderer, camera, timed)
        "subdiv 8 classic": (Renderer(scene8, dataclasses.replace(
            st8, pipeline="classic"), device=dev), cams8[0], True),
        "subdiv 8 meshlets": (Renderer(scene8, st8, device=dev), cams8[0], True),
        "subdiv 5 fly-by 12": (Renderer(scene5, st5, device=dev),
                               cs.flyby_camera(cs.FLYBY_FRAME, cs.N_FRAMES), False),
        "reference 800x600": (Renderer(reference_two_triangle_scene(), device=dev),
                              Camera(), True),
        "config2": (Renderer(scene2, st2, device=dev), cams2[0], False),
    }
    calls, want = {}, {}
    for name, (r, cam, timed) in frames.items():
        cfg, _, _, (rec_i, rec_f, rec_box, start, count), _ = cs.classic_records(r, cam)
        n_rec = int(count.sum())
        n_box = int(rv.box_pixels(rec_box[0, :n_rec]).sum())
        print(f"{name}: {n_rec} records, box pixels {n_box}, brute-force "
              f"record-pixels {n_rec * rv.N_PIX}")
        want[name] = rv.rasterize_visibility_plain(rec_i, rec_f, start, count, cfg)
        calls[name] = (lambda a=(rec_i, rec_f, start, count, cfg), b=rec_box:
                       rv.rasterize_visibility(*a, rec_box=b))
    timed = [n for n, (_, _, t) in frames.items() if t]
    del frames
    for name, lib in libs.items():
        use(lib, SOURCE)
        for k, (vd_p, vt_p) in want.items():
            vd, vt = calls[k]()
            err = cs._max_err([(vd, vd_p), (vt, vt_p)])
            cs.require(err == 0, f"{name}: K4 differs from its plain version "
                       f"on {k}: {err}")
        print(f"{name}: K4 bit-equal to plain on {len(want)} frames")
    del want
    names = list(libs)
    times = {(n, k): [] for n in names for k in timed}
    for n in names + names[::-1]:
        use(libs[n], SOURCE)
        for k in timed:
            times[(n, k)].append(cs.run_timed(calls[k], args.reps)[1])
    for k in timed:
        print(f"[{card}] K4 ms, {k}, in turns: " + "; ".join(
            f"{n} {', '.join(f'{t:.4f}' for t in times[(n, k)])}" for n in names))
    return 0


if __name__ == "__main__":
    sys.exit(main())
