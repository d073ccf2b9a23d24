#!/usr/bin/env python3
"""Time design variants of K3 / K3F (``csrc/raster.cu``) against each other
on one CUDA card, at the config4 subdiv-8 static headline inputs.

    python3 experiments/torch_k3_variants.py [--source NAME=PATH ...] [--reps 20]

Builds ``csrc/raster.cu`` (as "csrc") and each extra source given, for
example an earlier ``raster.cu`` or a copy with another ``PX``, with the
same C entry points (``-I csrc`` finds ``specmath.cuh``), all compilers
started together, and prints ptxas's report for each.  Every variant is
held bit for bit to the plain version: K3 on the inputs of the "auto"
route, K3F on the same inputs with the scene's full shade mode (what
``fused_surface_shade="on"`` gives), background attribute rows under the
validity mask.  Then each is timed with CUDA events in turns (a, b, ...,
..., b, a): K3, K3F, and K3 with ``rmeta`` zeroed (phases D and E alone).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch import _build, pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel as fk  # noqa: E402
from ash_renderer_tpu_torch.ops import shade  # noqa: E402

SOURCE = "raster.cu"


def build_variants(extra, source=SOURCE):
    """{name: loaded library} for csrc/``source`` and each (name, path) of
    ``extra`` (other versions of it, with the same C entry points); prints
    ptxas's resource lines for each."""
    out_dir = os.path.join(ROOT, "build", f"{os.path.splitext(source)[0]}_variants")
    os.makedirs(out_dir, exist_ok=True)
    sources = {"csrc": os.path.join(_build.CSRC, source)}
    sources.update((name, os.path.abspath(path)) for name, path in extra)
    jobs, outs = {}, {}
    for name, src in sources.items():
        outs[name] = os.path.join(out_dir, f"{name}.so")
        cmd = _build._command(source, outs[name], ptxas_report=True)
        jobs[name] = cmd[:1] + ["-I", _build.CSRC] + cmd[1:-1] + [src]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for n, c in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        for line in log.splitlines():
            if "Used" in line or "stack frame" in line:
                print(f"  ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(outs[name])
        for entry, argtypes in _build.KERNELS[source].items():
            if hasattr(lib, entry):  # a variant may lack a query entry
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def use(lib, source=SOURCE):
    """Route the port's wrapper of csrc/``source`` to ``lib``."""
    _build._LIBS[source] = lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another raster.cu to build and time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k3_variants: no CUDA device")
    card = cs.card_line()
    print(card)
    libs = build_variants([s.split("=", 1) for s in args.source])

    from ash_renderer_tpu_torch.benchmarks import config4_million_tri
    from ash_renderer_tpu_torch.renderer import Renderer

    dev = torch.device("cuda", 0)
    scene, st, cams = config4_million_tri(8)
    r = Renderer(scene, st, device=dev)
    mm_t, mvp_t, _ = cs.front_inputs(r, cams[0])
    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        r.statics, r.state, mm_t, mvp_t)
    s = r.state
    atlas = s.atlas if r.statics.has_atlas else None
    light = s.light if r.statics.has_light else None
    mode = pipeline.surface_mode(r.statics, s.materials, atlas, light)
    consts = shade.pack_shade_consts(
        mode, s.materials, atlas, light,
        torch.from_numpy(cams[0].position.astype("float32")).to(dev))
    per_range, n_box = cs.k3_slots(rmeta, tbl_sorted, tbl_ext, r.cfg)
    print(f"slots per range {dict(zip(cs.RANGE_NAMES, per_range))}, "
          f"box slot-pixels {n_box}, brute-force {sum(per_range) * fk.N_PIX}")
    zero = torch.zeros_like(rmeta)
    calls = {
        "K3": lambda: fk.rasterize_distribute(rmeta, tbl_sorted, tbl_ext, comb, r.cfg),
        "K3F": lambda: fk.rasterize_distribute(rmeta, tbl_sorted, tbl_ext, comb,
                                               r.cfg, mode, consts),
        "K3 rmeta zeroed": lambda: fk.rasterize_distribute(
            zero, tbl_sorted, tbl_ext, comb, r.cfg),
    }
    want = {
        "K3": fk.rasterize_distribute_plain(rmeta, tbl_sorted, tbl_ext, comb, r.cfg),
        "K3F": fk.rasterize_distribute_plain(rmeta, tbl_sorted, tbl_ext, comb,
                                             r.cfg, mode, consts),
    }
    for name, lib in libs.items():
        use(lib)
        for k, (vd_p, vt_p, pl_p) in want.items():
            vd, vt, pl = calls[k]()
            valid = (pl_p[:, fk.VIS_ROW, :] >= 0)[:, None, :]
            first = fk.F_TEXMASK + 1 if k == "K3F" else 16  # rows compared everywhere
            err = cs._max_err([(vd, vd_p), (vt, vt_p),
                               (torch.where(valid, pl, 0), torch.where(valid, pl_p, 0)),
                               (pl[:, first:], pl_p[:, first:])])
            cs.require(err == 0, f"{name}: {k} differs from its plain version: {err}")
        print(f"{name}: K3 and K3F bit-equal to plain")
    del want
    names = list(libs)
    times = {(n, k): [] for n in names for k in calls}
    for n in names + names[::-1]:
        use(libs[n])
        for k, fn in calls.items():
            times[(n, k)].append(cs.run_timed(fn, args.reps)[1])
    for k in calls:
        print(f"[{card}] {k} ms, in turns: " + "; ".join(
            f"{n} {', '.join(f'{t:.4f}' for t in times[(n, k)])}" for n in names))
    return 0


if __name__ == "__main__":
    sys.exit(main())
