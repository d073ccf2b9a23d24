#!/usr/bin/env python3
"""Time design variants of K5 (``csrc/gather.cu``) against each other on
one CUDA card, at the shapes of the meshlet-packed config4 subdiv-8 frame.

    python3 experiments/torch_k5_variants.py [--source NAME=PATH ...] [--reps 20]

Builds ``csrc/gather.cu`` (as "csrc") and each extra source given, with
the same C entry point, for example ``experiments/k5_vector_rows.cu``
(design B: no shared memory, 16-byte row copies from L1 / L2) or
``experiments/k5_word_per_thread.cu`` (the first design: a thread per
output word), all compilers started together, and prints ptxas's report
for each.  Inputs at the static camera: the (V, 8) vertex rows
``geometry_device`` gathers (F = 8) and the first V attribute rows as
int32 (F = 12, the reference's ``tritables.build_comb_table`` call), each
with the scene's local ids.  Every variant is held bit for bit to the
plain version on both and on ``chip_smoke.k5_edge_cases``; then each is
timed with CUDA events in turns (a, b, ..., ..., b, a) at both widths,
beside ``tbl[idx]``, the bound and a device copy (``Tensor.copy_``) of
the same bytes.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch.ops import geometry  # noqa: E402
from ash_renderer_tpu_torch.ops import meshlet_gather as mg  # noqa: E402
from torch_k3_variants import build_variants, use  # noqa: E402

SOURCE = "gather.cu"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another gather.cu to build and time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k5_variants: no CUDA device")
    card = cs.card_line()
    print(card)
    libs = build_variants([s.split("=", 1) for s in args.source], SOURCE)

    from ash_renderer_tpu_torch.benchmarks import config4_million_tri
    from ash_renderer_tpu_torch.renderer import Renderer

    dev = torch.device("cuda", 0)
    scene8, st8, cams8 = config4_million_tri(8)
    r = Renderer(scene8, st8, device=dev)
    s = r.state
    mm_t, mvp_t, _ = cs.front_inputs(r, cams8[0])
    lt = torch.from_numpy(r.packed.local_tri).to(dev)
    clip, attrs = geometry.transform_vertices(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    t = lt.shape[0]
    tables = {
        "F=8 vertex rows": geometry._vertex_post(clip, cs.classic_statics(r).cfg),
        "F=12 attribute rows": attrs.view(torch.int32)[:t],
    }
    del r, clip, attrs
    use(libs["csrc"], SOURCE)
    cases = [(k, tbl, lt) for k, tbl in tables.items()] + cs.k5_edge_cases(dev)
    want = [mg.gather_tri_rows_plain(tbl, ids) for _, tbl, ids in cases]
    for name, lib in libs.items():
        use(lib, SOURCE)
        for (label, tbl, ids), w in zip(cases, want):
            err = cs._max_err([(mg.gather_tri_rows(tbl, ids), w)])
            cs.require(err == 0, f"{name}: K5 differs from its plain version "
                       f"at {label}: {err}")
        print(f"{name}: K5 bit-equal to plain on {len(cases)} inputs")
    del want, cases

    idx = (torch.arange(t, device=dev)[:, None] // 128 * 128 + lt.long())
    for label, tbl in tables.items():
        words = t * 3 * tbl.shape[1]
        n_bytes = (tbl.numel() + lt.numel() + words) * 4
        bound, by = cs.bound_ms(n_bytes, words)
        _, lib_ms = cs.run_timed(lambda: tbl[idx].reshape(t, -1), args.reps)
        # what a plain device copy reaches on the same bytes (half read,
        # half written): a practical ceiling, not a bound
        src = torch.empty(n_bytes // 8, dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        _, copy_ms = cs.run_timed(lambda: dst.copy_(src), args.reps)
        del src, dst
        print(f"[{card}] {label}: bound {bound:.4f} ms ({by}), tbl[idx] "
              f"{lib_ms:.4f} ms, device copy of the same bytes {copy_ms:.4f} ms")
    names = list(libs)
    times = {(n, k): [] for n in names for k in tables}
    for n in names + names[::-1]:
        use(libs[n], SOURCE)
        for k, tbl in tables.items():
            times[(n, k)].append(cs.run_timed(
                lambda: mg.gather_tri_rows(tbl, lt), args.reps)[1])
    for k in tables:
        print(f"[{card}] K5 ms, {k}, in turns: " + "; ".join(
            f"{n} {', '.join(f'{v:.4f}' for v in times[(n, k)])}" for n in names))
    return 0


if __name__ == "__main__":
    sys.exit(main())
