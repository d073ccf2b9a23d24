#!/usr/bin/env python3
"""Time K12 (``csrc/binning.cu``), K10 (``csrc/geometry.cu``) and K11
(``csrc/shade_pack.cu``'s classic entry) pass by pass, each beside its
parent design, on one CUDA card at the classic route's inputs.

    python3 experiments/torch_classic_variants.py [--kernel k10|k11|k12 ...]
        [--parent DIR] [--source k10|k11|k12:NAME=PATH ...] [--sweep]
        [--reps 20]

For each kernel it builds the source in ``csrc`` ("csrc"); with
``--parent DIR``, a directory holding another tree's ``csrc`` sources (the
parent commit's, unpacked with ``git archive``), that tree's source
("parent"); copies of either cut short (each returns where one of
``CUTS``' marks begins: the passes before it alone, so the differences
between cuts are each pass's share) or made to skip a step (``SKIPS``);
and each extra source given (a variant with the same C entry points); all
compilers started together, and prints ptxas's report for each.  K10's
csrc runs through the port's stage entry (``geometry.stage_geometry_rows``:
the vertex transform folded into its launch) once for each of its designs
(``geometry.k10_design`` forced to "cluster" or "grid"), and as the pair
that entry replaced on the frame ("csrc K8C+K10": ``transform_vertices``,
then ``geometry_rows`` on its rows), and on K8C's rows made beforehand
("csrc on rows": the passes read stored clip positions and attributes
where the stage entry transforms them again); the parent's K10 runs as
the K8C + K10 pair on the parent's ``transform.cu`` and ``geometry.cu``.  K12 runs in its
one design (one cooperative grid), K11 through
``shade.shade_pack_classic``.  Every build but the cut copies is held bit
for bit to the plain version (``bin_triangles_plain``,
``geometry_device_plain`` after ``transform_vertices_plain``,
``shade_pack_classic_plain``) on each input; then every build is timed
with CUDA events in turns (a, b, ..., ..., b, a), beside the launch floor
(``torch.cuda._sleep(1)``).

Inputs: the gate frame (``chip_smoke.gate_scene`` at the Renderer's
default 800x600, orbit frame 0, plain-packed: K10 on its one-launch path),
the meshlet-packed config4 subdiv-5 frame of ``chip_smoke.py`` phase 29
(K10 with K5's corner gather; K11 textured and lit at 1080p), the
``ssaa_srgb`` golden scene under "classic" (2x SSAA, sRGB) and phase 29's
two clipping scenes (within and over their clip budgets); with
``--sweep`` also the plain-packed classic frames of 2,048 random triangles
at 800x600, the reference scene, config4 subdiv 3-6 and the gate frame at
clip budgets 256 and 16,384, the sizes K10's crossover between its two
designs is read from.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ash_renderer_tpu_torch import _build, pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import (binning, geometry,  # noqa: E402
                                        raster_visibility, shade)
from torch_k3_variants import build_variants, use  # noqa: E402

SOURCES = {"k12": "binning.cu", "k10": "geometry.cu", "k11": "shade_pack.cu"}
# per (kernel, build): (name, the text a cut copy returns before, which
# occurrence, the text it inserts there); a cut of K10's cluster after its
# blocks read each other's shared memory first meets the cluster's
# barrier, so no block exits while another still reads it
RETURN = "  return;  // cut here\n"
BARRIER_RETURN = "  barrier<CLUSTER>();\n" + RETURN
# K11's per-pixel design (one thread an output pixel, every covered
# sample its winner's whole setup), cut after the winner's setup words and corner
# rows are loaded (their sum returned), and after the interpolation (the
# 12 attributes and the uv derivatives summed); the cut to the vis read
# and the clear alone is a SKIPS entry
K11_LOADS = """  {  // cut here: the loads alone
    float acc = fadd(fadd(i2f(x0 ^ y0 ^ x1 ^ y1 ^ x2 ^ y2 ^ q3.y), inv_area),
                     fadd(fadd(iw0, iw1), iw2));
    for (int q = 0; q < ATTR / 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(A0) + q);
      const float4 v = __ldg(reinterpret_cast<const float4*>(A1) + q);
      const float4 w = __ldg(reinterpret_cast<const float4*>(A2) + q);
      acc = fadd(acc, fadd(fadd(fadd(u.x, u.y), fadd(u.z, u.w)),
                           fadd(fadd(fadd(v.x, v.y), fadd(v.z, v.w)),
                                fadd(fadd(w.x, w.y), fadd(w.z, w.w)))));
    }
    return make_float4(acc, 0.0f, 0.0f, 1.0f);
  }
"""
K11_INTERP = """  {  // cut here: the interpolation
    float acc = fadd(fadd(durx, dvrx), fadd(dury, dvry));
    for (int ch = 0; ch < ATTR; ++ch) acc = fadd(acc, a[ch]);
    return make_float4(acc, i2f(q3.y), 0.0f, 1.0f);
  }
"""
CUTS = {
    ("k12", "csrc"): (("cut:rows", "grid.sync();", 1, RETURN),
                      ("cut:rows+cut", "grid.sync();", 2, RETURN)),
    ("k10", "csrc"): (("cut:setup", "  barrier<CLUSTER>();", 1, RETURN),
                      ("cut:+select", "  barrier<CLUSTER>();", 2,
                       BARRIER_RETURN),
                      ("cut:+clip", "    // the fan: lane j < FAN", 1,
                       RETURN)),
    ("k11", "parent"): (
        ("parent cut:+loads",
         "  // interp_fields_stacked: the edges at the pixel's sample", 1,
         K11_LOADS),
        ("parent cut:+interp", "  const Prelight s = prelight(", 1,
         K11_INTERP)),
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
    ("k11", "parent"): (
        ("parent cut:vis+clear",
         "      return shade_classic_sample(P, t, rx, ry + P.py_offset, lr, "
         "lg, lb);",
         "      return make_float4(i2f(t), 0.0f, 0.0f, 1.0f);  // cut here"),),
}
# the designs csrc (and each copy of it) runs in: K10's two (its passes
# are one template of both), K12's and K11's one (None: the wrapper's own)
DESIGNS = {"k10": ("cluster", "grid"), "k12": (None,), "k11": (None,)}


def cut_copies(kernel: str, build: str, text: str, out_dir: str) -> list:
    """[(name, path)]: the cut copies and the copies that skip a step of
    ``text`` (the source of ``build``), written under ``out_dir``."""
    out = []
    for name, mark, nth, cut in CUTS.get((kernel, build), ()):
        at = -1
        for _ in range(nth):
            at = text.index(mark, at + 1)
        line = text.rindex("\n", 0, at) + 1
        out.append((name, text[:line] + cut + text[line:]))
    for name, old, new in SKIPS.get((kernel, build), ()):
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
    classic = dict(pipeline="classic")
    scene_g, _ = cs.gate_scene()
    orbit = orbit_path(cs.N_FRAMES, radius=6.0, center=[0.0, 0.0, 3.5])
    rg = Renderer(scene_g, RendererSettings(), device=dev)
    out["gate 800x600 orbit 0"] = (rg, rg.statics, orbit[0], None)
    scene5, st5, cams5 = config4_million_tri(5)
    r5 = Renderer(scene5, st5, device=dev)
    out["config4 subdiv 5 meshlets"] = (
        r5, cs.classic_statics(r5), cams5[0],
        torch.from_numpy(r5.packed.local_tri).to(dev))
    scene_s, st_s = GOLDEN_SCENES["ssaa_srgb"]()
    rs = Renderer(scene_s, dataclasses.replace(st_s, **classic), device=dev)
    out["ssaa_srgb"] = (rs, rs.statics, Camera(), None)
    # phase 29's clipping scenes: K10's clip pass reads its candidates'
    # corners (transformed again, or K8C's rows)
    for label, args, st in (
            ("clip within budget", (6, 60, 50, 4.0, 0.8),
             RendererSettings(width=128, height=64, clip_budget=64)),
            ("clip over budget", (2, 170, 300, 8.0, 2.5),
             RendererSettings(width=192, height=128, clip_budget=8))):
        r = Renderer(cs._clip_scene(*args), dataclasses.replace(st, **classic),
                     device=dev)
        out[label] = (r, r.statics, Camera(), None)
    if not sweep:
        return out
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


def inputs(frame) -> dict:
    """{kernel: its arguments} of one classic frame: K10's the scene's
    vertex tensors, the matrices, the triangles, the config, the clip
    budget and local_tri; K12's the plain setup table; K11's (args,
    keyword args) of ``shade_pack_classic`` on this tree's K10, K12 and K4
    outputs."""
    r, statics, cam, lt = frame
    s, cfg, st = r.state, statics.cfg, statics.settings
    mm_t, mvp_t, cam_t = cs.frame_mats(r, cam)
    a10 = (s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t,
           s.tri_v, s.tri_mat, cfg, st.clip_budget, lt)
    clip, attrs = geometry.transform_vertices_plain(*a10[:7])
    su, _, _ = geometry.geometry_device_plain(clip, attrs, *a10[7:11],
                                              local_tri=lt)
    a12 = (geometry.setup_table(su), su.valid.clone(), cfg, st.max_pairs)
    clip, attrs = geometry.transform_vertices(*a10[:7])
    rows, valid, af, _ = geometry.geometry_rows(clip, attrs, *a10[7:11],
                                                local_tri=lt)
    rec_i, rec_f, rec_box, start, count, _ = binning.bin_rows(
        rows, valid, cfg, st.max_pairs)
    _, vis_t = raster_visibility.rasterize_visibility(
        rec_i, rec_f, start, count, cfg, rec_box=rec_box)
    atlas = s.atlas if statics.has_atlas else None
    light = s.light if statics.has_light else None
    mode = pipeline.surface_mode(statics, s.materials, atlas, light)
    consts = shade.pack_shade_consts(mode, s.materials, atlas, light, cam_t)
    a11 = ((vis_t, rows, af, mode, consts),
           dict(atlas=atlas, light=light, cfg=cfg, clear_color=st.clear_color,
                supersample=st.supersample, srgb=st.srgb_output))
    return {"k10": a10, "k12": a12, "k11": a11}


def plain(kernel: str, a):
    """The plain version's outputs on input ``a``."""
    if kernel == "k12":
        rows, valid, cfg, p = a
        return binning.bin_triangles_plain(
            geometry.setup_from_rows(rows, valid), cfg, p)
    if kernel == "k11":
        return shade.shade_pack_classic_plain(*a[0], **a[1])
    clip, attrs = geometry.transform_vertices_plain(*a[:7])
    su, af, st = geometry.geometry_device_plain(clip, attrs, *a[7:11],
                                                local_tri=a[11])
    return geometry.setup_table(su), su.valid, af, st


def same(kernel: str, got, want) -> int:
    """Max |got - want| over the arrays, -1 where the counters differ."""
    if kernel == "k11":
        return cs._max_err([(got.to(torch.int32), want.to(torch.int32))])
    *arrs, stats = got
    *w_arrs, w_stats = want
    if {k: int(v) for k, v in stats.items()} != {
            k: int(v) for k, v in w_stats.items()}:
        return -1
    return cs._max_err([(cs._bits(x), cs._bits(y))
                        for x, y in zip(arrs, w_arrs)])


def leg_calls(kernel: str, libs: dict, parent_like: set,
              transform_libs: dict) -> dict:
    """{(build, design): fn(input)}: each build of ``kernel`` through the
    port's wrappers, its library (and, for K10's K8C + K10 pair, the
    transform's) routed in first."""
    source = SOURCES[kernel]
    calls = {}
    for name, lib in libs.items():
        if kernel == "k11":
            def call(a, lib=lib):
                use(lib, source)
                return shade.shade_pack_classic(*a[0], **a[1])
            calls[(name, None)] = call
        elif kernel == "k12":
            def call(a, lib=lib):
                use(lib, source)
                return binning.bin_rows(*a)
            calls[(name, None)] = call
        elif name in parent_like:
            def call(a, lib=lib):
                use(lib, source)
                use(transform_libs["parent"], "transform.cu")
                clip, attrs = geometry.transform_vertices(*a[:7])
                return geometry.geometry_rows(clip, attrs, *a[7:11],
                                              local_tri=a[11])
            calls[(name, None)] = call
        else:
            for design in DESIGNS[kernel]:
                def call(a, lib=lib, design=design):
                    use(lib, source)
                    with cs.forced_design(design):
                        return geometry.stage_geometry_rows(
                            *a[:11], local_tri=a[11])
                calls[(name, design)] = call
            if name == "csrc":
                rows_of = {}  # K8C's rows of each input, made untimed

                def on_rows(a, lib=lib):
                    use(lib, source)
                    if id(a) not in rows_of:
                        rows_of[id(a)] = geometry.transform_vertices(*a[:7])
                    return geometry.geometry_rows(*rows_of[id(a)], *a[7:11],
                                                  local_tri=a[11])
                calls[("csrc on rows", None)] = on_rows

                def pair(a, lib=lib):
                    use(lib, source)
                    use(transform_libs.get("csrc")
                        or _build.load("transform.cu"), "transform.cu")
                    clip, attrs = geometry.transform_vertices(*a[:7])
                    return geometry.geometry_rows(clip, attrs, *a[7:11],
                                                  local_tri=a[11])
                calls[("csrc K8C+K10", None)] = pair
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append", choices=sorted(SOURCES),
                    help="the kernels to time (all three by default)")
    ap.add_argument("--parent", default=None,
                    help="a directory holding another tree's csrc sources "
                    "(the parent's, from git archive), built as 'parent'")
    ap.add_argument("--source", action="append", default=[],
                    help="k10|k11|k12:NAME=PATH of another source to build "
                    "and time")
    ap.add_argument("--sweep", action="store_true",
                    help="also time csrc on the sweep's frames")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_classic_variants: no CUDA device")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    cases = {label: inputs(fr)
             for label, fr in frames(dev, args.sweep).items()}
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
        transform_libs = {}
        if args.parent:
            parent_src = os.path.abspath(os.path.join(args.parent, source))
            with open(parent_src) as f:
                parent_text = f.read()
            # the parent's copies beside its own headers
            derived = ([("parent", parent_src)]
                       + cut_copies(kernel, "parent", parent_text,
                                    os.path.dirname(parent_src))
                       + derived)
            if kernel == "k10":
                transform_libs = build_variants(
                    [("parent", os.path.join(args.parent, "transform.cu"))],
                    "transform.cu")
        libs = build_variants(derived + extra, source)
        parent_like = {n for n in libs if n.startswith("parent")}
        call_of = leg_calls(kernel, libs, parent_like, transform_libs)
        # (leg, input) pairs a leg does not take (a source's launch refuses
        # the input)
        skip = set()
        for label, ins in cases.items():
            a = ins[kernel]
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
                err = same(kernel, got, want)
                cs.require(err == 0, f"{name} {design}: {kernel} differs "
                           f"from its plain version at {label}: {err}")
            print(f"{kernel} bit-equal to its plain version at {label} "
                  "(csrc, parent, sources given)")
        order = list(call_of)
        times = {(leg, lab): [] for leg in order for lab in cases}
        for leg in order + order[::-1]:
            for label, ins in cases.items():
                a = ins[kernel]
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
        if transform_libs:
            use(transform_libs["csrc"], "transform.cu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
