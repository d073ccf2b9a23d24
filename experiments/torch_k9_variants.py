#!/usr/bin/env python3
"""Time design variants of K9 (``csrc/front_meta.cu``) against each other
on one CUDA card, at the fused front's inputs.

    python3 experiments/torch_k9_variants.py [--source NAME=PATH ...] [--reps 20]

Builds ``csrc/front_meta.cu`` (as "csrc") and each extra source given,
with the same C entry point, for example ``experiments/k9_tile_blocks.cu``
(the first design: passes 2 and 4 one block per tile), all compilers
started together, and prints ptxas's report for each.  Inputs: the sorted
front (``chip_smoke.front_sorted``) of terrain at the walk's first frame
and of config4 subdiv 8 at the fly-by's closest approach, whole grid and 4-row
tiles.  Every variant is held bit for bit to ``front_meta_plain`` on each;
then each is timed with CUDA events in turns (a, b, ..., ..., b, a),
beside the launch floor (``torch.cuda._sleep(1)``), and its device time
is split by kernel under ``torch.profiler``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch.ops import front_meta  # noqa: E402
from torch_k3_variants import build_variants, use  # noqa: E402

SOURCE = "front_meta.cu"


def kernel_split(fn, reps: int) -> dict:
    """{kernel: device us a call} of ``fn``'s kernels under torch.profiler
    (its ``reps`` calls after a warm one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        name = re.search(r"\w+_kernel(<\w+>)?", e.key)
        if us and name:
            out[name.group(0)] = out.get(name.group(0), 0.0) + us / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another front_meta.cu to build and time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k9_variants: no CUDA device")
    card = cs.card_line()
    print(card)
    libs = build_variants([s.split("=", 1) for s in args.source], SOURCE)

    from ash_renderer_tpu_torch.benchmarks import (config4_million_tri,
                                                   config4_terrain)
    from ash_renderer_tpu_torch.renderer import Renderer
    from benchmark import cells

    dev = torch.device("cuda", 0)
    scene_t, st_t, _ = config4_terrain()
    walk = cells.path_of(cells.load()["terrain-walk"], 1, cells.DEFAULT_SEED)[0]
    scene8, st8, _ = config4_million_tri(8)
    fly = cs.flyby_camera(cs.FLYBY_FRAME, cs.N_FRAMES)
    cases = {}
    for label, scene, st, cam in (
            ("terrain walk frame 0", scene_t, st_t, walk),
            ("config4 subdiv 8 fly-by", scene8, st8, fly),
            ("config4 subdiv 8 fly-by, 4-row tiles", scene8,
             dataclasses.replace(st8, fused_tile_h=4), fly)):
        r = Renderer(scene, st, device=dev)
        cases[label] = (*cs.front_sorted(r, cam), r.cfg, st.wide_rows,
                        st.wide_pairs)
        del r
    want = {k: front_meta.front_meta_plain(*a) for k, a in cases.items()}
    for name, lib in libs.items():
        use(lib, SOURCE)
        for label, a in cases.items():
            got, w = front_meta.front_meta(*a), want[label]
            n = int(w[3][3])  # pair rows past n_pairs are unspecified
            err = cs._max_err([(got[0][:n], w[0][:n]), *zip(got[1:], w[1:])])
            cs.require(err == 0, f"{name}: K9 differs from front_meta_plain "
                       f"at {label}: {err}")
        print(f"{name}: K9 bit-equal to front_meta_plain on {len(cases)} "
              "inputs: " + "; ".join(
                  f"{k} {w[3].tolist()} [ws, we, new_ws, n_pairs]"
                  for k, w in want.items()))
    del want
    _, floor_ms = cs.run_timed(lambda: torch.cuda._sleep(1), args.reps)
    print(f"[{card}] launch floor (torch.cuda._sleep(1)) {floor_ms:.4f} ms "
          f"a launch; K9 makes {front_meta.N_LAUNCHES}")
    names = list(libs)
    times = {(n, k): [] for n in names for k in cases}
    for n in names + names[::-1]:
        use(libs[n], SOURCE)
        for k, a in cases.items():
            times[(n, k)].append(cs.run_timed(
                lambda: front_meta.front_meta(*a), args.reps)[1])
    for k in cases:
        print(f"[{card}] K9 ms, {k}, in turns: " + "; ".join(
            f"{n} {', '.join(f'{v:.4f}' for v in times[(n, k)])}" for n in names))
    for n in names:
        use(libs[n], SOURCE)
        for k, a in cases.items():
            split = kernel_split(lambda: front_meta.front_meta(*a), args.reps)
            print(f"[{card}] {n}, {k}: device us a call by kernel "
                  "(torch.profiler): " + ", ".join(
                      f"{kn} {us:.1f}" for kn, us in split.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
