#!/usr/bin/env python3
"""Time K6 (``csrc/clip_tail.cu``) and K9 (``csrc/front_meta.cu``) pass by
pass, and design variants of them, on one CUDA card at the fused front's
inputs.

    python3 experiments/torch_front_variants.py [--kernel k6|k9 ...]
        [--source k6|k9:NAME=PATH ...] [--reps 20]

For each kernel it builds the source in ``csrc`` ("csrc"), copies of it
cut short (each returns where one of ``CUTS``' marks begins: the passes
before it alone, so the differences between cuts are each pass's share)
or made to skip a step (``SKIPS``), copies with another
``COOP_MAX_BLOCKS_PER_SM`` (``csrc/coop.cuh``: the cooperative grid's
blocks a SM) and each extra source given, all compilers started together, and
prints ptxas's report for each.  "csrc", the grid copies and the extra
sources are held bit for bit to the plain version (``clip_tail_plain``,
``front_meta_plain``) on each input; then every build is timed with CUDA
events in turns (a, b, ..., ..., b, a), beside the launch floor
(``torch.cuda._sleep(1)``).  Inputs: K1's outputs and the sorted front
(``chip_smoke.front_sorted``) of terrain at the walk's first frame and of
config4 subdiv 8 at the fly-by's closest approach.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch import _build  # noqa: E402
from ash_renderer_tpu_torch.ops import clip_tail, front_meta  # noqa: E402
from torch_k3_variants import build_variants, use  # noqa: E402

SOURCES = {"k6": "clip_tail.cu", "k9": "front_meta.cu"}
# per source: (name, the text a cut copy returns before, which occurrence)
CUTS = {
    "clip_tail.cu": (("cut:count", "grid.sync();", 1),
                     ("cut:count+select", "grid.sync();", 2),
                     ("cut:+clip", "    // the fan: lane j < FAN", 1),
                     ("cut:+fan", "    // the slot's 7 rows", 1)),
    "front_meta.cu": (("cut:rows", "grid.sync();", 1),
                      ("cut:rows+cut", "grid.sync();", 2),
                      ("cut:no-gather", "  // 3. the sorted records", 1)),
}
# per source: (name, text, its replacement): copies that skip a step
SKIPS = {
    "clip_tail.cu": (("cut:no-planes", "for (int p = 0; p < 6; ++p) {",
                      "for (int p = 6; p < 6; ++p) {"),
                     ("cut:1-plane", "for (int p = 0; p < 6; ++p) {",
                      "for (int p = 0; p < 1; ++p) {")),
    "front_meta.cu": (("cut:no-walk",
                       "for (int ty = blockIdx.x; ty < tile_rows;",
                       "for (int ty = tile_rows; ty < tile_rows;"),
                      ("cut:no-atomics",
                       "atomicAdd(&P.tile_cnt[(q.z + dy) * P.grid_w + q.x + dx], 1);",
                       "(void)0;"),
                      ("walk2", "constexpr int WALK_ROWS = 4;",
                       "constexpr int WALK_ROWS = 2;"),
                      ("walk8", "constexpr int WALK_ROWS = 4;",
                       "constexpr int WALK_ROWS = 8;"),
                      ("gather2", "constexpr int GATHER_ROWS = 1;",
                       "constexpr int GATHER_ROWS = 2;"),
                      ("gather4", "constexpr int GATHER_ROWS = 1;",
                       "constexpr int GATHER_ROWS = 4;")),
}
GRIDS = (1, 4)  # COOP_MAX_BLOCKS_PER_SM of the grid copies (csrc's is 2)


def derived_sources(source: str, out_dir: str) -> list:
    """[(name, path)]: the cut copies, the copies that skip a step and the
    grid copies of csrc/``source``, written under ``out_dir``."""
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    out = []
    for name, mark, nth in CUTS[source]:
        at = -1
        for _ in range(nth):
            at = text.index(mark, at + 1)
        line = text.rindex("\n", 0, at) + 1
        out.append((name, text[:line] + "  return;  // cut here\n"
                    + text[line:]))
    for name, old, new in SKIPS[source]:
        assert text.count(old) == 1, (source, old)
        out.append((name, text.replace(old, new)))
    # the grid copies take coop.cuh inline, its block cap replaced
    with open(os.path.join(_build.CSRC, "coop.cuh")) as f:
        coop = f.read().replace("#pragma once\n", "")
    include = '#include "coop.cuh"\n'
    assert text.count(include) == 1, source
    for g in GRIDS:
        sub, n = re.subn(r"constexpr int COOP_MAX_BLOCKS_PER_SM = \d+;",
                         f"constexpr int COOP_MAX_BLOCKS_PER_SM = {g};", coop)
        assert n == 1, source
        out.append((f"grid{g}", text.replace(include, sub)))
    paths = []
    os.makedirs(out_dir, exist_ok=True)
    for name, body in out:
        path = os.path.join(out_dir, re.sub(r"\W", "_", name) + "_" + source)
        with open(path, "w") as f:
            f.write(body)
        paths.append((name, path))
    return paths


def k6_args(r, cam):
    """The arguments of ``clip_tail.clip_tail`` on renderer ``r``'s K1
    outputs at ``cam``: (tblT, tri_v, tri_mat, flags, comb, cfg, budget)."""
    from ash_renderer_tpu_torch.ops import geometry, setup_kernel

    s, cfg = r.state, r.cfg
    budget = r.settings.clip_budget
    _, _, tblT = cs.front_inputs(r, cam)
    comb, _, flags, _, _ = setup_kernel.triangle_setup(
        tblT, s.ltT, s.matT, cfg, tail_rows=budget * geometry.MAX_CLIP_TRIS)
    return (tblT, s.tri_v, s.tri_mat, flags, comb, cfg, budget)


def check(kernel: str, name: str, cases: dict, want: dict) -> None:
    """Hold the wrapper's current library to the plain version."""
    for label, a in cases.items():
        w = want[label]
        if kernel == "k6":
            t = a[3].shape[0]
            comb = a[4].clone()
            keys, cnt = clip_tail.clip_tail(*a[:4], comb, *a[5:])
            pairs = [(comb[t:], w[2][t:]), (keys, w[0])] + [
                (cnt[k].reshape(1), w[1][k].reshape(1))
                for k in clip_tail.COUNTERS]
        else:
            got = front_meta.front_meta(*a)
            we, n = int(w[3][1]), int(w[3][3])
            pairs = [(got[0][:n], w[0][:n]), (got[1], w[1]), (got[2], w[2]),
                     (got[3], w[3]), (got[4][:we], w[4]), (got[5][:n], w[5])]
        err = cs._max_err(pairs)
        cs.require(err == 0, f"{name}: {kernel} differs from its plain "
                   f"version at {label}: {err}")
    print(f"{name}: {kernel} bit-equal to its plain version on "
          f"{len(cases)} inputs")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append", choices=sorted(SOURCES),
                    help="the kernels to time (both by default)")
    ap.add_argument("--source", action="append", default=[],
                    help="k6|k9:NAME=PATH of another source to build and time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_front_variants: no CUDA device")
    card = cs.card_line()
    print(card)

    from ash_renderer_tpu_torch.benchmarks import (config4_million_tri,
                                                   config4_terrain)
    from ash_renderer_tpu_torch.renderer import Renderer
    from benchmark import cells

    dev = torch.device("cuda", 0)
    scene_t, st_t, _ = config4_terrain()
    walk = cells.path_of(cells.load()["terrain-walk"], 1, cells.DEFAULT_SEED)[0]
    scene8, st8, _ = config4_million_tri(8)
    fly = cs.flyby_camera(cs.FLYBY_FRAME, cs.N_FRAMES)
    renderers = {"terrain walk frame 0": (Renderer(scene_t, st_t, device=dev),
                                          walk),
                 "config4 subdiv 8 fly-by": (Renderer(scene8, st8, device=dev),
                                             fly)}
    _, floor_ms = cs.run_timed(lambda: torch.cuda._sleep(1), args.reps)
    print(f"[{card}] launch floor (torch.cuda._sleep(1)) {floor_ms:.4f} ms")
    for kernel in args.kernel or sorted(SOURCES):
        source = SOURCES[kernel]
        extra = [s.split(":", 1)[1].split("=", 1) for s in args.source
                 if s.startswith(kernel + ":")]
        derived = derived_sources(source, os.path.join(
            ROOT, "build", "front_variants"))
        libs = build_variants(derived + extra, source)
        if kernel == "k6":
            cases = {k: k6_args(r, cam) for k, (r, cam) in renderers.items()}
            want = {}
            for k, a in cases.items():
                comb = a[4].clone()
                keys, cnt = clip_tail.clip_tail_plain(*a[:4], comb, *a[5:])
                want[k] = (keys, cnt, comb)

            def call(a):
                return clip_tail.clip_tail(*a)
        else:
            cases = {k: (*cs.front_sorted(r, cam), r.cfg,
                         r.settings.wide_rows, r.settings.wide_pairs)
                     for k, (r, cam) in renderers.items()}
            want = {k: front_meta.front_meta_plain(*a)
                    for k, a in cases.items()}

            def call(a):
                return front_meta.front_meta(*a)
        for name, lib in libs.items():
            if not name.startswith("cut:"):
                use(lib, source)
                check(kernel, name, cases, want)
        del want
        names = list(libs)
        times = {(n, k): [] for n in names for k in cases}
        for n in names + names[::-1]:
            use(libs[n], source)
            for k, a in cases.items():
                times[(n, k)].append(cs.run_timed(lambda: call(a),
                                                  args.reps)[1])
        for k in cases:
            print(f"[{card}] {kernel} ms, {k}, in turns: " + "; ".join(
                f"{n} {', '.join(f'{v:.4f}' for v in times[(n, k)])}"
                for n in names))
        use(libs["csrc"], source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
