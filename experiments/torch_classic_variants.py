#!/usr/bin/env python3
"""Time K12 (``csrc/binning.cu``) and K10 (``csrc/geometry.cu``) pass by
pass, K10 beside its parent design, on one CUDA card at the classic
route's inputs.

    python3 experiments/torch_classic_variants.py [--kernel k10|k12 ...]
        [--source k10|k12:NAME=PATH ...] [--sweep] [--reps 20]

For each kernel it builds the source in ``csrc`` ("csrc"), K10's parent
design kept under ``experiments/`` ("parent": ``k10_two_launch.cu``,
K10's first: a vertex launch, then one cooperative grid), copies of each
cut short (each returns where one of ``CUTS``' marks begins: the passes
before it alone, so the differences between cuts are each pass's share)
or made to skip a step (``SKIPS``), and each extra source given (a
variant of csrc, same C entry points), all compilers started together,
and prints ptxas's report for each.  K10's csrc runs through the port's
wrapper once for each of its designs (``geometry.k10_design`` forced to
"cluster" or "grid"), K12's in its one design (one cooperative grid),
the parent and its copies through the calls that parent's wrapper made.
csrc in each design, the parent and the extra sources are held bit for
bit to the plain version (``bin_triangles_plain``,
``geometry_device_plain``) on each input; then every build is timed
with CUDA events in turns (a, b, ..., ..., b, a), beside the launch floor
(``torch.cuda._sleep(1)``).

Inputs: the gate frame (``chip_smoke.gate_scene`` at the Renderer's
default 800x600, orbit frame 0, plain-packed: K10 on its one-launch path)
and the meshlet-packed config4 subdiv-5 frame of ``chip_smoke.py`` phase
29 (K10 with K5's corner gather); with ``--sweep`` also the plain-packed
classic frames of 2,048 random triangles at 800x600, the reference scene,
config4 subdiv 3-6 and the gate frame at clip budgets 256 and 16,384, the
sizes K10's crossover between its two designs is read from.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch import _build  # noqa: E402
from ash_renderer_tpu_torch.ops import binning, geometry  # noqa: E402
from torch_k3_variants import build_variants, use  # noqa: E402

SOURCES = {"k12": "binning.cu", "k10": "geometry.cu"}
PARENTS = {"k10": os.path.join(ROOT, "experiments", "k10_two_launch.cu")}
# per (kernel, build): (name, the text a cut copy returns before, which
# occurrence, the text it inserts there); a cut of K10's cluster after its
# blocks read each other's shared memory first meets the cluster's
# barrier, so no block exits while another still reads it
RETURN = "  return;  // cut here\n"
BARRIER_RETURN = "  barrier<CLUSTER>();\n" + RETURN
CUTS = {
    ("k12", "csrc"): (("cut:rows", "grid.sync();", 1, RETURN),
                      ("cut:rows+cut", "grid.sync();", 2, RETURN)),
    ("k10", "parent"): (("parent cut:vertex",
                         "  // 1. each triangle's setup row and flags", 1,
                         RETURN),
                        ("parent cut:setup", "grid.sync();", 1, RETURN),
                        ("parent cut:+select", "grid.sync();", 2, RETURN),
                        ("parent cut:+clip", "    // the fan: lane j < FAN",
                         1, RETURN)),
    ("k10", "csrc"): (("cut:setup", "  barrier<CLUSTER>();", 1, RETURN),
                      ("cut:+select", "  barrier<CLUSTER>();", 2,
                       BARRIER_RETURN),
                      ("cut:+clip", "    // the fan: lane j < FAN", 1,
                       RETURN)),
}
# per (kernel, build): (name, text, its replacement): copies that skip a
# step
SKIPS = {
    ("k12", "csrc"): (("no-walk",
                       "for (int ty = blockIdx.x; ty < tile_rows; "
                       "ty += gridDim.x) {",
                       "for (int ty = tile_rows; ty < tile_rows; "
                       "ty += gridDim.x) {"),
                      ("no-zero", "k < REC_ROWS * tail;", "k < 0;")),
    ("k10", "parent"): (),
    ("k10", "csrc"): (),
}
# the designs csrc (and each copy of it) runs in: K10's two (its passes
# are one template of both), K12's one (None: the wrapper's own)
DESIGNS = {"k10": ("cluster", "grid"), "k12": (None,)}

def cut_copies(kernel: str, build: str, text: str, out_dir: str) -> list:
    """[(name, path)]: the cut copies and the copies that skip a step of
    ``text`` (the source of ``build``), written under ``out_dir``."""
    out = []
    for name, mark, nth, cut in CUTS[(kernel, build)]:
        at = -1
        for _ in range(nth):
            at = text.index(mark, at + 1)
        line = text.rindex("\n", 0, at) + 1
        out.append((name, text[:line] + cut + text[line:]))
    for name, old, new in SKIPS[(kernel, build)]:
        assert text.count(old) == 1, (kernel, build, old)
        out.append((name, text.replace(old, new)))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, body in out:
        path = os.path.join(out_dir, "".join(
            c if c.isalnum() else "_" for c in name) + "_" + SOURCES[kernel])
        with open(path, "w") as f:
            f.write(body)
        paths.append((name, path))
    return paths


def frames(dev, sweep: bool) -> dict:
    """{label: (renderer, classic statics, camera, local_tri)}."""
    import dataclasses

    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES,
                                                   config4_million_tri)
    from ash_renderer_tpu_torch.camera import Camera, orbit_path
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.renderer import Renderer

    out = {}
    scene_g, _ = cs.gate_scene()
    orbit = orbit_path(cs.N_FRAMES, radius=6.0, center=[0.0, 0.0, 3.5])
    rg = Renderer(scene_g, RendererSettings(), device=dev)
    out["gate 800x600 orbit 0"] = (rg, rg.statics, orbit[0], None)
    scene5, st5, cams5 = config4_million_tri(5)
    r5 = Renderer(scene5, st5, device=dev)
    out["config4 subdiv 5 meshlets"] = (
        r5, cs.classic_statics(r5), cams5[0],
        torch.from_numpy(r5.packed.local_tri).to(dev))
    if not sweep:
        return out
    classic = dict(pipeline="classic")
    for budget in (256, 16384):
        r = Renderer(scene_g, RendererSettings(clip_budget=budget),
                     device=dev)
        out[f"gate 800x600 budget {budget}"] = (r, r.statics, orbit[0], None)
    # 2,048 random triangles at 800x600
    import numpy as np

    from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject

    rng = np.random.default_rng(5)
    pos = rng.uniform(-2, 2, (1000, 3)).astype(np.float32)
    pos[:, 2] += 3.5
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=pos,
        indices=rng.integers(0, 1000, (2048, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (1000, 4)).astype(np.float32)))))
    r = Renderer(sc, RendererSettings(**classic), device=dev)
    out["random 2048 triangles 800x600"] = (r, r.statics, orbit[0], None)
    ref_scene, ref_st = GOLDEN_SCENES["reference"]()
    r = Renderer(ref_scene, RendererSettings(**classic), device=dev)
    out["reference 800x600"] = (r, r.statics, Camera(), None)
    for n in (3, 4, 5, 6):
        sc, st, cams = config4_million_tri(n)
        r = Renderer(sc, dataclasses.replace(st, **classic), device=dev)
        out[f"config4 subdiv {n} plain"] = (r, r.statics, cams[0], None)
    return out


def inputs(frame) -> tuple:
    """(K10's arguments, K12's arguments) of one classic frame."""
    r, statics, cam, lt = frame
    s, cfg, st = r.state, statics.cfg, statics.settings
    mm_t, mvp_t, _ = cs.frame_mats(r, cam)
    clip, attrs = geometry.transform_vertices(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    a10 = (clip, attrs, s.tri_v, s.tri_mat, cfg, st.clip_budget, lt)
    su, _, _ = geometry.geometry_device_plain(*a10[:6], local_tri=lt)
    a12 = (geometry.setup_table(su), su.valid.clone(), cfg, st.max_pairs)
    return a10, a12


def plain(kernel: str, a):
    """The plain version's outputs on input ``a``."""
    if kernel == "k12":
        rows, valid, cfg, p = a
        return binning.bin_triangles_plain(
            geometry.setup_from_rows(rows, valid), cfg, p)
    su, af, st = geometry.geometry_device_plain(*a[:6], local_tri=a[6])
    return geometry.setup_table(su), su.valid, af, st


def same(got, want) -> int:
    """Max |got - want| over the arrays, -1 where the counters differ."""
    *arrs, stats = got
    *w_arrs, w_stats = want
    if {k: int(v) for k, v in stats.items()} != {
            k: int(v) for k, v in w_stats.items()}:
        return -1
    return cs._max_err([(cs._bits(x), cs._bits(y))
                        for x, y in zip(arrs, w_arrs)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append", choices=sorted(SOURCES),
                    help="the kernels to time (both by default)")
    ap.add_argument("--source", action="append", default=[],
                    help="k10|k12:NAME=PATH of another source to build and "
                    "time")
    ap.add_argument("--sweep", action="store_true",
                    help="also time csrc on the sweep's frames")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_classic_variants: no CUDA device")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    cases = {}
    for label, fr in frames(dev, args.sweep).items():
        cases[label] = inputs(fr)
    torch.cuda.synchronize()
    _, floor_ms = cs.run_timed(lambda: torch.cuda._sleep(1), args.reps)
    print(f"[{card}] launch floor (torch.cuda._sleep(1)) {floor_ms:.4f} ms")
    out_dir = os.path.join(ROOT, "build", "classic_variants")
    for kernel in args.kernel or sorted(SOURCES):
        source = SOURCES[kernel]
        with open(os.path.join(_build.CSRC, source)) as f:
            csrc_text = f.read()
        extra = [s.split(":", 1)[1].split("=", 1) for s in args.source
                 if s.startswith(kernel + ":")]
        derived = cut_copies(kernel, "csrc", csrc_text, out_dir)
        if kernel in PARENTS:
            with open(PARENTS[kernel]) as f:
                parent_text = f.read()
            derived = ([("parent", PARENTS[kernel])]
                       + cut_copies(kernel, "parent", parent_text, out_dir)
                       + derived)
        libs = build_variants(derived + extra, source)
        parent_like = {n for n in libs if n.startswith("parent")}
        for name in parent_like:  # the parent's C entry points
            for entry, types in cs._parent_argtypes().items():
                if hasattr(libs[name], entry):
                    getattr(libs[name], entry).argtypes = types
                    getattr(libs[name], entry).restype = ctypes.c_int
        k = 0 if kernel == "k10" else 1
        # legs: (name, lib, design or None, the inputs it takes)
        legs = []
        for name in libs:
            if name in parent_like:
                legs.append((name, None))
            else:
                legs += [(name, d) for d in DESIGNS[kernel]]
        call_of = {}
        for name, design in legs:
            lib = libs[name]
            if name in parent_like:
                def call(a, lib=lib):
                    return cs.parent_k10(lib, *a)
            elif kernel == "k10":
                def call(a, lib=lib, design=design):
                    use(lib, source)
                    with cs.forced_design(design):
                        return geometry.geometry_rows(*a[:6], local_tri=a[6])
            else:
                def call(a, lib=lib):
                    use(lib, source)
                    return binning.bin_rows(*a)
            call_of[(name, design)] = call
        # (leg, input) pairs a leg does not take (a source's launch refuses
        # the input)
        skip = set()
        for label, ins in cases.items():
            a = ins[k]
            want = plain(kernel, a)
            for (name, design), call in call_of.items():
                try:
                    got = call(a)
                except RuntimeError as e:
                    print(f"{name} {design} refuses {label}: {e}")
                    skip.add(((name, design), label))
                    continue
                if "cut" in name or "no-" in name:
                    continue
                err = same(got, want)
                cs.require(err == 0, f"{name} {design}: {kernel} differs "
                           f"from its plain version at {label}: {err}")
            print(f"{kernel} bit-equal to its plain version at {label} "
                  "(csrc in each design, parent, sources given)")
        order = list(call_of)
        times = {(leg, lab): [] for leg in order for lab in cases}
        for leg in order + order[::-1]:
            for label, ins in cases.items():
                a = ins[k]
                if (leg, label) in skip:
                    continue
                times[(leg, label)].append(cs.run_timed(
                    lambda: call_of[leg](a), args.reps)[1])
        for label in cases:
            print(f"[{card}] {kernel} ms, {label}, in turns: " + "; ".join(
                f"{n}{' ' + d if d else ''} "
                f"{', '.join(f'{v:.4f}' for v in times[((n, d), label)])}"
                for (n, d) in order if times[((n, d), label)]))
        use(libs["csrc"], source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
