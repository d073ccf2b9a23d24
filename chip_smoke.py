#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ash_renderer_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; imports nothing of JAX.  Phases (each prints its
lines and seconds; any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels and the native meshlet builder from
   ``ash_renderer_tpu_torch/csrc`` (one compiler process per source, all
   at once; ptxas register and spill counts printed), and hold the native
   meshlet builder equal to the Python one;
3. each kernel against its plain torch version on the card, on config4 at
   subdiv 5 (20,480 triangles, 1080p), at the static camera and at a
   grazing fly-by camera (clip tail, wide pairs, fine runs);
4. frames through ``Renderer``: the subdiv-5 and subdiv-8 (1,310,720
   triangles) frames against the sha256 goldens in ``docs/golden/``, then
   static -> moved -> static, whose last frame must equal the first;
5. the kernel launch counts of phase 4 (each must be > 0);
6. CUDA-event timings at subdiv 8: frame ms (static with the front cache
   off, static cached, orbit, fly-by) and ms per stage;
7. each kernel against its plain version at the headline shapes (subdiv
   8, static and fly-by cameras), bit for bit as in phase 3, with each
   kernel's and plain version's CUDA-event ms at the static camera;
8. K3F (the raster kernel with phase F) against its plain version, bit
   for bit: on config3 (5,120 untextured triangles, 800x600) at the static
   camera and an orbit camera, and on config4 subdiv 8 with
   ``fused_surface_shade="on"`` at the static camera (timed) and fly-by
   frame 12;
9. the phase F path through ``Renderer``, launch counts zeroed before it:
   config3 with "auto" (phase F) equals config3 with "off" (phase E) byte
   for byte; config4 subdiv 5 and subdiv 8 with "on" equal their goldens;
   static -> moved -> static with "on"; K3F must have launched;
10. CUDA-event frame ms: config3 "auto" vs "off", and config4 subdiv 8
   static uncached "on" vs "auto", in turns;
11. K4 (the classic visibility raster) and K5 (the meshlet corner gather)
   against their plain versions, bit for bit, on the classic frame of the
   meshlet-packed config4 at subdiv 5 (static camera and fly-by frame 12,
   which clips) and at subdiv 8 (static camera, timed, with K5's library
   call ``tbl[idx]``);
12. classic frames, launch counts zeroed before them: the reference scene
   (320x240) and the four feature scenes through ``Renderer`` ("auto"
   routes them to classic) against their pinned sha256; the meshlet-packed
   config4 subdiv-5 and subdiv-8 frames through ``pipeline.render_frame``
   (K5 + K4) against their goldens, with no pair or clip overflow; config2
   (800x600, "auto" -> classic) byte-equal to the same frame rendered on
   the CPU, then static -> moved -> static; K4 and K5 must have launched;
   then, outside the counted run, K4 against its plain version on the
   records of the Renderer's own classic route at subdiv 8 (plain
   packing), with no pair or clip overflow;
13. CUDA-event frame ms of the classic pipeline: the reference scene and
   config2 (800x600) through ``Renderer``, each also against "fused"
   (front cache off) in turns, config4 subdiv 8 static "classic" vs
   "fused" in turns, and the classic stage ms.

The line before the last is a JSON object with one entry per kernel (its
time, its plain version's, its bound and, where one PyTorch call computes
the same function, that call's time); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 24
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz boost clock
# Bounds (the least time the card could take for a kernel's work): bytes
# over the H100 SXM's 3.35 TB/s HBM rate, operations over its 67 TFLOP/s
# float32 rate outside the tensor cores (integer ops counted at the same
# rate, which only lowers the bound); the larger of the two binds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# operations per unit of work, counted from the kernels' sources
K1_OPS_PER_TRI = 150  # 3 corner snaps, outcodes, area, recip_spec, depths
K2_OPS_PER_KEY = 2  # one compare, one store
K3_OPS_PER_SLOT_PX = 20  # 3 edge functions (5 ops each), 3 compares, 2 ands
K4_OPS_PER_REC_PX = 20  # 3 edge functions, 3 compares, 2 ands
K4_WORDS_PER_REC = 15  # 14 int32 record words + inv_area2
K3F_OPS_PER_PX = 160  # phase F: 3 rsqrt_spec chains, powi, mip and tap math


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        say(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_native_meshlets() -> None:
    """The port's native meshlet builder (built in phase 2) must give the
    Python builder's arrays; scenes are packed with it from here on."""
    import numpy as np

    from ash_renderer_tpu_torch import native, scene
    from ash_renderer_tpu_torch.benchmarks import config3_blinn_phong

    require(native.available(), "no host C++ compiler")
    mesh = config3_blinn_phong()[0].meshes[0]
    # a shuffled walk order, far from the Morton order of a packed scene
    order = np.random.default_rng(0).permutation(
        mesh.num_triangles).astype(np.int32)
    t0 = time.perf_counter()
    fast = native.build_meshlets(mesh.indices, order, mesh.num_vertices)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = scene.greedy_meshlets(mesh.indices, order)
    t_python = time.perf_counter() - t0
    for name, a, b in zip(("vertex_src", "local_tri", "tri_perm"), fast, slow):
        require(np.array_equal(a, b),
                f"native meshlets differ from the Python builder's ({name})")
    say(f"native meshlet builder: equal to the Python builder on config3 "
        f"({mesh.num_triangles} tris, {len(fast[2]) // 128} meshlets; "
        f"{t_native * 1e3:.1f} vs {t_python * 1e3:.1f} ms)")


def golden(name: str) -> dict:
    with open(os.path.join(ROOT, "docs", "golden", name)) as f:
        return json.load(f)


def sha(frame) -> str:
    return hashlib.sha256(frame.tobytes()).hexdigest()


def flyby_camera(i: int, n: int):
    """The reference bench's fly-by grazing the headline sphere (centre
    [0, 0, 2], r = 1) at impact parameter 1.02."""
    import numpy as np

    from ash_renderer_tpu_torch.camera import Camera

    z = -1.0 + 6.0 * i / max(n - 1, 1)
    return Camera(position=np.array([1.02, 0.0, z], np.float32))


def run_timed(fn, reps: int = 0):
    """``fn()``'s output and, with ``reps``, its mean CUDA-event ms over
    ``reps`` calls after the first (else None).  A sleep kernel ahead of
    the first event lets the host queue the calls before the card reaches
    them, so a kernel that runs faster than the host issues it is timed on
    the device, not on the host's issue rate."""
    import torch

    out = fn()
    if not reps:
        return out, None
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / reps


def front_inputs(r, cam):
    """The tensors the kernels see for one frame of renderer ``r``."""
    import numpy as np
    import torch

    from ash_renderer_tpu_torch.ops import setup_kernel
    from ash_renderer_tpu_torch.renderer import compose_mvp

    st = r.settings
    mm = np.ascontiguousarray(r.scene.model_matrices(), np.float32)
    mvp = compose_mvp(mm, cam.view_matrix(),
                      cam.projection_matrix(st.render_width / st.render_height))
    s = r.state
    mm_t = torch.from_numpy(mm).to(r.device)
    mvp_t = torch.from_numpy(np.ascontiguousarray(mvp)).to(r.device)
    tblT = setup_kernel.transform_vertices_T(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t
    )
    return mm_t, mvp_t, tblT


def _max_err(pairs) -> int:
    """Largest |a - b| over pairs of int32 tensors (0 when bit-equal)."""
    return max(
        (int((a.long() - b.long()).abs().max()) if a.numel() else 0)
        for a, b in pairs
    )


# CUDA-event repetitions (kernel, plain) per kernel when compare_kernels
# also times them; the plain K3 takes ~0.3 s a call at the headline
TIMING_REPS = {"K1": (10, 3), "K2": (20, 20), "K3": (10, 1), "K3F": (10, 1),
               "K4": (10, 1), "K5": (20, 10)}


def bound_ms(n_bytes: float, n_ops: float):
    """(the least ms for the work, "bytes" or "operations")."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k3_work(rmeta, vis_t, planes, stats):
    """(bytes, ops) K3 needs at least for these inputs: the range meta, each
    streamed table row's 7 record words once, each winner's 48 fields once,
    vis_d, vis_t and planes written once; ops per slot-pixel evaluation."""
    import torch

    n_slots = int((rmeta[1::2] - rmeta[0::2]).sum())
    n_rows = stats["live_rows"] + stats["wide_pairs_n"]
    n_winners = int(torch.unique(vis_t[vis_t >= 0]).numel())
    n_bytes = (rmeta.numel() * 4 + n_rows * 7 * 4 + n_winners * 48 * 4
               + 2 * vis_t.numel() * 4 + planes.numel() * 4)
    return n_bytes, n_slots * 1024 * K3_OPS_PER_SLOT_PX


def compare_kernels(r, cam, label: str, errs: dict, timed: bool = False):
    """Each kernel against its plain version on the same card inputs, the
    ones the main path gives it for camera ``cam``.  Folds each kernel's
    max |kernel - plain| into ``errs``; returns the front's counters and,
    with ``timed``, {kernel: (kernel ms, plain ms, library ms or None,
    (bound ms, bound by))} of the same calls."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import bincount, fused_kernel, geometry, setup_kernel

    cfg = r.cfg
    s = r.state
    ntail = r.settings.clip_budget * geometry.MAX_CLIP_TRIS
    mm_t, mvp_t, tblT = front_inputs(r, cam)
    t = s.ltT.shape[0] * 128
    reps = TIMING_REPS if timed else {k: (0, 0) for k in TIMING_REPS}
    ms = {}

    k1, k1_ms = run_timed(lambda: setup_kernel.triangle_setup(
        tblT, s.ltT, s.matT, cfg, tail_rows=ntail), reps["K1"][0])
    p1, p1_ms = run_timed(lambda: setup_kernel.triangle_setup_plain(
        tblT, s.ltT, s.matT, cfg, ntail), reps["K1"][1])
    k1_bytes = ((tblT.numel() + s.ltT.numel() + s.matT.numel()) * 4
                + t * (128 + 4) * 4)  # comb rows, keys, flags, extx, exty
    ms["K1"] = (k1_ms, p1_ms, None, bound_ms(k1_bytes, t * K1_OPS_PER_TRI))
    err1 = _max_err((a[:t], b[:t]) for a, b in zip(k1, p1))
    require(err1 == 0, f"K1 differs from its plain version ({label}): {err1}")
    del p1

    comb, keys_tail, _ = pipeline._clip_tail_into(
        r.statics, tblT, s.tri_v, s.tri_mat, k1[2], k1[0]
    )
    keys_sorted = torch.sort(torch.cat([k1[1], keys_tail]), stable=True)[0]
    del k1, comb
    nb = cfg.n_tiles * 12 + 2
    b2, k2_ms = run_timed(lambda: bincount.sorted_run_bounds(keys_sorted, nb),
                          reps["K2"][0])
    b2_p, p2_ms = run_timed(
        lambda: bincount.sorted_run_bounds_plain(keys_sorted, nb), reps["K2"][1])
    bins = torch.arange(nb, dtype=torch.int32, device=keys_sorted.device)
    _, lib2_ms = run_timed(lambda: torch.searchsorted(keys_sorted, bins),
                           reps["K2"][1])
    n_keys = keys_sorted.numel()
    ms["K2"] = (k2_ms, p2_ms, lib2_ms,
                bound_ms((n_keys + nb) * 4, n_keys * K2_OPS_PER_KEY))
    err2 = _max_err([(b2, b2_p)])
    require(err2 == 0, f"K2 differs from its plain version ({label}): {err2}")

    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        r.statics, s, mm_t, mvp_t
    )
    (vd, vt, pl), k3_ms = run_timed(lambda: fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, cfg), reps["K3"][0])
    (vd_p, vt_p, pl_p), p3_ms = run_timed(
        lambda: fused_kernel.rasterize_distribute_plain(
            rmeta, tbl_sorted, tbl_ext, comb, cfg), reps["K3"][1])
    ms["K3"] = (k3_ms, p3_ms, None,
                bound_ms(*k3_work(rmeta, vt, pl, {k: int(v) for k, v in stats.items()})))
    # background pixels carry NaN attributes whose payload bits are the
    # device's: planes are compared under the validity mask, and the
    # material / id / pad rows everywhere
    valid = (pl_p[:, fused_kernel.VIS_ROW, :] >= 0)[:, None, :]
    err3 = _max_err([
        (vd, vd_p), (vt, vt_p),
        (torch.where(valid, pl, 0), torch.where(valid, pl_p, 0)),
        (pl[:, 16:], pl_p[:, 16:]),
    ])
    require(err3 == 0, f"K3 differs from its plain version ({label}): {err3} "
            f"({int((vt != vt_p).sum())} winner ids differ)")
    for k, e in (("K1", err1), ("K2", err2), ("K3", err3)):
        errs[k] = max(errs.get(k, 0), e)
    stats = {k: int(v) for k, v in stats.items()}
    n_slots = int((rmeta[1::2] - rmeta[0::2]).sum())
    say(f"{label}: K1, K2, K3 bit-equal to plain; covered px "
        f"{int((vt >= 0).sum())}, clipped {stats['n_clipped']}, "
        f"wide {stats['n_wide']}, wide pairs {stats['wide_pairs_n']}, "
        f"live rows {stats['live_rows']}, K3 streamed slots {n_slots}")
    return stats, (ms if timed else None)


FLYBY_FRAME = 12  # near closest approach: clip tail and wide pairs live


def compare_flyby(r, label: str, errs: dict) -> None:
    """compare_kernels at the fly-by frame that clips and expands wide
    pairs; fails if that frame no longer exercises both."""
    stats, _ = compare_kernels(r, flyby_camera(FLYBY_FRAME, N_FRAMES), label,
                               errs)
    require(stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0,
            f"{label}: the frame neither clips nor expands wide pairs")


def compare_k3f(r, cam, label: str, errs: dict, timed: bool = False):
    """K3F (the raster kernel with phase F) against its plain version on
    the inputs the phase F path gives it for camera ``cam``; folds the max
    |kernel - plain| into ``errs``.  Returns the front's counters and, with
    ``timed``, (kernel ms, plain ms, None, (bound ms, bound by))."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.ops import shade

    s, cfg = r.state, r.cfg
    mm_t, mvp_t, _ = front_inputs(r, cam)
    atlas = s.atlas if r.statics.has_atlas else None
    light = s.light if r.statics.has_light else None
    smode = pipeline.shade_mode_for(r.statics, s.materials, atlas, light)
    require(smode is not None, f"{label}: the settings route to phase E")
    cam_t = torch.from_numpy(cam.position.astype("float32")).to(r.device)
    consts = shade.pack_shade_consts(smode, s.materials, atlas, light, cam_t)
    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        r.statics, s, mm_t, mvp_t
    )
    reps = TIMING_REPS["K3F"] if timed else (0, 0)
    (vd, vt, pl), k_ms = run_timed(lambda: fk.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, cfg, smode, consts), reps[0])
    (vd_p, vt_p, pl_p), p_ms = run_timed(
        lambda: fk.rasterize_distribute_plain(
            rmeta, tbl_sorted, tbl_ext, comb, cfg, smode, consts), reps[1])
    # rows 0-12 under the validity mask (background pixels shade NaN
    # attributes), the zero, id and pad rows everywhere
    valid = (pl_p[:, fk.VIS_ROW, :] >= 0)[:, None, :]
    err = _max_err([
        (vd, vd_p), (vt, vt_p),
        (torch.where(valid, pl, 0), torch.where(valid, pl_p, 0)),
        (pl[:, fk.F_TEXMASK + 1:], pl_p[:, fk.F_TEXMASK + 1:]),
    ])
    require(err == 0, f"K3F differs from its plain version ({label}): {err} "
            f"({int((vt != vt_p).sum())} winner ids differ)")
    errs["K3F"] = max(errs.get("K3F", 0), err)
    stats = {k: int(v) for k, v in stats.items()}
    v2 = valid[:, 0, :]
    say(f"{label}: K3F bit-equal to plain (shade mode {smode}); covered px "
        f"{int(v2.sum())}, lit {int((pl[:, fk.F_LIT][v2] != 0).sum())}, "
        f"textured {int((pl[:, fk.F_TEXMASK][v2] != 0).sum())}, clipped "
        f"{stats['n_clipped']}, wide pairs {stats['wide_pairs_n']}")
    if not timed:
        return stats, None
    n_bytes, n_ops = k3_work(rmeta, vt, pl, stats)
    n_ops += int(v2.sum()) * K3F_OPS_PER_PX
    return stats, (k_ms, p_ms, None,
                   bound_ms(n_bytes + consts.numel() * 4, n_ops))


def classic_statics(r):
    """The classic pipeline's statics (tiles, capped pair budget) for
    renderer ``r``'s settings and packed scene."""
    import dataclasses

    from ash_renderer_tpu_torch.renderer import frame_statics

    return frame_statics(
        dataclasses.replace(r.settings, pipeline="classic"),
        r.packed.tri_v.shape[0], r.statics.has_atlas, r.statics.has_light)


def compare_classic(r, cam, label: str, errs: dict, timed: bool = False):
    """K4, and K5 where the scene is meshlet-packed, against their plain
    versions on the inputs the classic frame of renderer ``r``'s scene gives
    them for camera ``cam``; folds each max |kernel - plain| into ``errs``.
    Returns the geometry and binning counters and, with ``timed``, {kernel:
    (kernel ms, plain ms, library ms or None, (bound ms, bound by))}."""
    import torch

    from ash_renderer_tpu_torch.ops import (binning, geometry, meshlet_gather,
                                            raster_visibility)

    s = r.state
    statics = classic_statics(r)
    cfg = statics.cfg
    mm_t, mvp_t, _ = front_inputs(r, cam)
    lt = (None if r.packed.local_tri is None
          else torch.from_numpy(r.packed.local_tri).to(r.device))
    reps = TIMING_REPS if timed else {k: (0, 0) for k in TIMING_REPS}
    ms = {}

    clip, attrs = geometry.transform_vertices(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    if lt is not None:
        vtx = geometry._vertex_post(clip, cfg)
        g, k5_ms = run_timed(lambda: meshlet_gather.gather_tri_rows(vtx, lt),
                             reps["K5"][0])
        g_p, p5_ms = run_timed(
            lambda: meshlet_gather.gather_tri_rows_plain(vtx, lt), reps["K5"][1])
        t = lt.shape[0]
        idx = (torch.arange(t, device=lt.device)[:, None] // 128 * 128
               + lt.long())  # every id of a packed scene lies in [0, 128)
        g_lib, lib5_ms = run_timed(lambda: vtx[idx].reshape(t, -1),
                                   reps["K5"][1])
        # the table and the local ids read once (the 3 corners of a
        # meshlet re-read its rows from L2), the gathered rows written once
        n5 = t * 3 * vtx.shape[1]
        ms["K5"] = (k5_ms, p5_ms, lib5_ms, bound_ms(
            (vtx.numel() + lt.numel() + n5) * 4, n5))
        err5 = _max_err([(g, g_p), (g, g_lib)])
        require(err5 == 0, f"K5 differs from its plain version ({label}): {err5}")
        errs["K5"] = max(errs.get("K5", 0), err5)
        del g_p, g_lib

    su, _, gstats = geometry.geometry_device(
        clip, attrs, s.tri_v, s.tri_mat, cfg, r.settings.clip_budget,
        local_tri=lt)
    rec_i, rec_f, start, count, bstats = binning.bin_triangles(
        su, cfg, statics.settings.max_pairs)
    (vd, vt), k4_ms = run_timed(lambda: raster_visibility.rasterize_visibility(
        rec_i, rec_f, start, count, cfg), reps["K4"][0])
    (vd_p, vt_p), p4_ms = run_timed(
        lambda: raster_visibility.rasterize_visibility_plain(
            rec_i, rec_f, start, count, cfg), reps["K4"][1])
    n_rec = int(count.sum())
    n_px = cfg.grid_h * 16 * cfg.grid_w * 128
    ms["K4"] = (k4_ms, p4_ms, None, bound_ms(
        n_rec * K4_WORDS_PER_REC * 4 + count.numel() * 2 * 4 + 2 * n_px * 4,
        n_rec * 16 * 128 * K4_OPS_PER_REC_PX))
    err4 = _max_err([(vd, vd_p), (vt, vt_p)])
    require(err4 == 0, f"K4 differs from its plain version ({label}): {err4} "
            f"({int((vt != vt_p).sum())} winner ids differ)")
    errs["K4"] = max(errs.get("K4", 0), err4)
    stats = {k: int(v) for k, v in {**gstats, **bstats}.items()}
    say(f"{label}: {'K4' if lt is None else 'K5, K4'} bit-equal to plain; covered px "
        f"{int((vt >= 0).sum())}, clipped {stats['n_clipped']}, valid "
        f"{stats['n_valid']}, pairs {stats['pairs_total']} (max per tile "
        f"{int(count.max())})")
    return stats, (ms if timed else None)


def turns(card: str, label: str, legs, cams) -> None:
    """Frame medians of each (name, renderer) leg in turns (a, b, b, a)."""
    med = {name: [] for name, _ in legs}
    for name, r in legs + legs[::-1]:
        med[name].append(frames_ms(r, cams)[0])
    say(f"[{card}] frame ms, {label}, median per leg in turns: " + "; ".join(
        f"{name} {', '.join(f'{m:.3f}' for m in ms)}" for name, ms in med.items()))


def stage_ms(r, cam) -> dict:
    """Per-stage CUDA-event times of one frame through ``r.render_frame``
    (the events go where the pipeline reports each stage issued)."""
    import torch

    ev = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append((name, e))

    torch.cuda.synchronize()
    mark("start")
    r.render_frame(cam, on_stage=mark)
    torch.cuda.synchronize()
    return {
        name: ev[i - 1][1].elapsed_time(e)
        for i, (name, e) in enumerate(ev) if i > 0
    }


def frames_ms(r, cams):
    """Per-frame device-clock times (CUDA events between frame starts) over
    the camera list, after two warm-up frames: (median, mean, max)."""
    import torch

    for c in cams[:2]:
        r.render_frame(c)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(cams) + 1)]
    ev[0].record()
    for c, e in zip(cams, ev[1:]):
        r.render_frame(c)
        e.record()
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
    return per[len(per) // 2], sum(per) / len(per), per[-1]


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    require(os.path.isdir(os.path.join(ROOT, "ash_renderer_tpu_torch")),
            "the ash_renderer_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    with Phase("1 card"):
        card = card_line()
        say(card)
        say(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        say(f"device 0: {torch.cuda.get_device_name(0)}, "
            f"count {torch.cuda.device_count()}")

    from ash_renderer_tpu_torch import _build

    with Phase("2 build"):
        t0 = time.perf_counter()
        paths, logs = _build.build(tuple(_build.KERNELS) + _build.HOST_SOURCES,
                                   ptxas_report=True)
        for src in paths:
            _build.load(src)
        say(f"built {len(logs)} of {len(paths)} libraries in "
            f"{time.perf_counter() - t0:.1f} s: "
            + ", ".join(os.path.relpath(p, ROOT) for p in paths.values()))
        for src, log in logs.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line or "Compiling" in line:
                    say(f"  ptxas {src}: {line.strip()}")
        check_native_meshlets()

    import dataclasses

    from ash_renderer_tpu_torch.benchmarks import (config3_blinn_phong,
                                                   config4_million_tri)
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.renderer import Renderer

    errs: dict = {}
    with Phase("3 kernels vs plain (subdiv 5)"):
        scene5, st5, cams5 = config4_million_tri(5)
        r5 = Renderer(scene5, st5, device=dev)
        compare_kernels(r5, cams5[0], "static", errs)
        compare_flyby(r5, "fly-by", errs)
        torch.cuda.synchronize()

    with Phase("4 frames through Renderer"):
        t0 = time.perf_counter()
        scene8, st8, cams8 = config4_million_tri(8)
        r8 = Renderer(scene8, st8, device=dev)
        torch.cuda.synchronize()
        say(f"subdiv-8 scene set-up (mesh, meshlets, upload): "
            f"{time.perf_counter() - t0:.1f} s")
        _build.launches.clear()
        f5 = r5.read_frame(r5.render_frame(cams5[0])[0])
        g5 = golden("headline_config4_s5.json")
        require(sha(f5) == g5["sha256"],
                f"subdiv-5 frame sha256 {sha(f5)} != golden {g5['sha256']}")
        say(f"subdiv-5 frame {f5.shape[1]}x{f5.shape[0]}: golden sha256 EXACT")
        f8, aux8 = r8.render_frame(cams8[0])
        f8 = r8.read_frame(f8)
        g8 = golden("headline_config4.json")
        covered = int((aux8["vis_tri"] >= 0).sum())
        require(sha(f8) == g8["sha256"],
                f"subdiv-8 frame sha256 {sha(f8)} != golden {g8['sha256']} "
                f"(covered {covered} px, golden {g8['covered_px']})")
        say(f"subdiv-8 frame ({g8['n_tris']} tris, {f8.shape[1]}x{f8.shape[0]}, "
            f"covered {covered} px): golden sha256 EXACT")
        moved = orbit_path(N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])[5]
        fm = r8.read_frame(r8.render_frame(moved)[0])
        fs = r8.read_frame(r8.render_frame(cams8[0])[0])
        require(not (fm == f8).all(), "the moved frame equals the static one")
        require((fs == f8).all(), "static -> moved -> static: last frame differs")
        say("static -> moved -> static: final frame byte-equal to the first")
        torch.cuda.synchronize()
        counts = dict(_build.launches)

    with Phase("5 launch counts"):
        say(json.dumps(counts, sort_keys=True))
        for k in ("K1_setup", "K2_run_bounds", "K3_raster"):
            require(counts.get(k, 0) > 0, f"{k} was not launched in phase 4")

    with Phase("6 timings (subdiv 8)"):
        static = [cams8[0]] * N_FRAMES
        r8u = Renderer(scene8, dataclasses.replace(st8, front_coherence=False),
                       device=dev)
        orbit = orbit_path(N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])
        flyby = [flyby_camera(i, N_FRAMES) for i in range(N_FRAMES)]
        for label, r, cams in (("static uncached", r8u, static),
                               ("static cached", r8, static),
                               ("orbit", r8, orbit), ("fly-by", r8, flyby)):
            med, mean, worst = frames_ms(r, cams)
            say(f"[{card}] frame ms, {label}: median {med:.3f}, mean "
                f"{mean:.3f}, max {worst:.3f} ({len(cams)} frames)")
        stage_ms(r8u, cams8[0])  # warm-up
        stages = stage_ms(r8u, cams8[0])
        say(f"[{card}] stage ms (static, uncached): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
        stages_o = stage_ms(r8u, orbit[5])
        say(f"[{card}] stage ms (orbit frame 5): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages_o.items()))
        del r8u

    with Phase("7 kernels vs plain (subdiv 8, headline shapes)"):
        # the same comparison as phase 3 at the shapes the headline frame
        # gives the kernels; the static camera's calls are also the timed ones
        _, timing = compare_kernels(r8, cams8[0], "static subdiv 8", errs,
                                    timed=True)
        compare_flyby(r8, "fly-by subdiv 8", errs)

    on = dataclasses.replace(st8, fused_surface_shade="on")
    with Phase("8 K3F vs plain (config3; config4 subdiv 8 \"on\")"):
        scene3, st3, cams3 = config3_blinn_phong()
        r3 = Renderer(scene3, st3, device=dev)
        orbit3 = orbit_path(8, radius=3.0, center=[0.0, 0.0, 3.0])
        compare_k3f(r3, cams3[0], "config3 static", errs)
        compare_k3f(r3, orbit3[3], "config3 orbit frame 3", errs)
        r8on = Renderer(scene8, on, device=dev)
        _, timing["K3F"] = compare_k3f(r8on, cams8[0],
                                       "config4 subdiv 8 on, static", errs,
                                       timed=True)
        stats = compare_k3f(r8on, flyby_camera(FLYBY_FRAME, N_FRAMES),
                            "config4 subdiv 8 on, fly-by", errs)[0]
        require(stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0,
                "K3F fly-by frame neither clips nor expands wide pairs")
        for k, (kt, pt, lt, (bt, by)) in timing.items():
            say(f"[{card}] {k}: kernel {kt:.4f} ms, plain torch {pt:.4f} ms, "
                f"library {'none' if lt is None else f'{lt:.4f} ms'}, "
                f"bound {bt:.4f} ms ({by})")
        torch.cuda.synchronize()

    with Phase("9 the phase F path through Renderer"):
        r3off = Renderer(scene3, dataclasses.replace(
            st3, fused_surface_shade="off"), device=dev)
        r5on = Renderer(scene5, dataclasses.replace(
            st5, fused_surface_shade="on"), device=dev)
        _build.launches.clear()
        a3 = r3.read_frame(r3.render_frame(cams3[0])[0])
        o3 = r3off.read_frame(r3off.render_frame(cams3[0])[0])
        require(int((a3 != o3).sum()) == 0,
                "config3: the auto (phase F) frame differs from the off frame")
        require(int(a3[..., :3].max()) > 0, "config3: the frame is black")
        say(f"config3 {a3.shape[1]}x{a3.shape[0]}: auto (K3F) frame byte-equal "
            "to off (K3)")
        f5on = r5on.read_frame(r5on.render_frame(cams5[0])[0])
        require(sha(f5on) == g5["sha256"], "subdiv-5 on: frame != golden")
        say("subdiv-5 frame, on: golden sha256 EXACT")
        f8on = r8on.read_frame(r8on.render_frame(cams8[0])[0])
        require(sha(f8on) == g8["sha256"], "subdiv-8 on: frame != golden")
        say("subdiv-8 frame, on: golden sha256 EXACT")
        fm = r8on.read_frame(r8on.render_frame(moved)[0])
        fs = r8on.read_frame(r8on.render_frame(cams8[0])[0])
        require(not (fm == f8on).all(), "on: the moved frame equals the static one")
        require((fs == f8on).all(), "on: static -> moved -> static differs")
        say("on: static -> moved -> static: final frame byte-equal to the first")
        torch.cuda.synchronize()
        counts_f = dict(_build.launches)
        say(json.dumps(counts_f, sort_keys=True))
        for k in ("K1_setup", "K2_run_bounds", "K3F_raster_shade"):
            require(counts_f.get(k, 0) > 0, f"{k} was not launched in phase 9")
        del r5on, r3off

    with Phase("10 phase F timings"):
        nocache = dict(front_coherence=False)
        r3u = Renderer(scene3, dataclasses.replace(st3, **nocache), device=dev)
        r3u_off = Renderer(scene3, dataclasses.replace(
            st3, fused_surface_shade="off", **nocache), device=dev)
        turns(card, "config3 static uncached", [("auto", r3u), ("off", r3u_off)],
              [cams3[0]] * N_FRAMES)
        del r3u, r3u_off, r8on
        r8u = Renderer(scene8, dataclasses.replace(st8, **nocache), device=dev)
        r8u_on = Renderer(scene8, dataclasses.replace(on, **nocache), device=dev)
        turns(card, "config4 subdiv 8 static uncached", [("auto", r8u), ("on", r8u_on)],
              [cams8[0]] * N_FRAMES)
        stage_ms(r8u_on, cams8[0])  # warm-up
        say(f"[{card}] stage ms (subdiv 8 on, static, uncached): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stage_ms(r8u_on, cams8[0]).items()))
        del r8u, r8u_on

    with Phase("11 K4 and K5 vs plain (classic frame, config4 meshlets)"):
        compare_classic(r5, cams5[0], "classic static subdiv 5", errs)
        stats = compare_classic(r5, flyby_camera(FLYBY_FRAME, N_FRAMES),
                                "classic fly-by subdiv 5", errs)[0]
        require(stats["n_clipped"] > 0, "classic fly-by frame does not clip")
        _, timing_c = compare_classic(r8, cams8[0], "classic static subdiv 8",
                                      errs, timed=True)
        timing.update(timing_c)
        for k, (kt, pt, lt, (bt, by)) in timing_c.items():
            say(f"[{card}] {k}: kernel {kt:.4f} ms, plain torch {pt:.4f} ms, "
                f"library {'none' if lt is None else f'{lt:.4f} ms'}, "
                f"bound {bt:.4f} ms ({by})")
        torch.cuda.synchronize()

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES, GOLDEN_SHA,
                                                   config2_multi_mesh)
    from ash_renderer_tpu_torch.camera import Camera

    with Phase("12 classic frames"):
        _build.launches.clear()
        for name, build in GOLDEN_SCENES.items():
            scene_g, st_g = build()
            rg = Renderer(scene_g, st_g, device=dev)
            require(rg.settings.pipeline == "classic",
                    f"{name}: auto routes to {rg.settings.pipeline}")
            fg = rg.read_frame(rg.render_frame(Camera())[0])
            require(sha(fg) == GOLDEN_SHA[name], f"{name}: frame != golden")
            say(f"{name} {fg.shape[1]}x{fg.shape[0]} (auto -> classic): "
                "golden sha256 EXACT")
        for label, r, cam, g in (("subdiv-5", r5, cams5[0], g5),
                                 ("subdiv-8", r8, cams8[0], g8)):
            mm_t, mvp_t, _ = front_inputs(r, cam)
            fc, aux = pipeline.render_frame(
                classic_statics(r), r.state, mm_t, mvp_t,
                torch.from_numpy(cam.position.astype("float32")).to(dev),
                local_tri=torch.from_numpy(r.packed.local_tri).to(dev))
            fc = fc.cpu().numpy()
            require(int(aux["pairs_overflow"]) == 0
                    and int(aux["clip_overflow"]) == 0,
                    f"classic {label}: pairs or clip candidates overflow")
            require(sha(fc) == g["sha256"], f"classic {label}: frame != golden")
            say(f"classic {label} frame (meshlets, K5 + K4, "
                f"{int(aux['pairs_total'])} pairs): golden sha256 EXACT")
        scene2, st2, cams2 = config2_multi_mesh()
        r2 = Renderer(scene2, st2, device=dev)
        require(r2.settings.pipeline == "classic", "config2: auto is not classic")
        f2 = r2.read_frame(r2.render_frame(cams2[0])[0])
        r2cpu = Renderer(scene2, st2, device="cpu")
        f2cpu = r2cpu.read_frame(r2cpu.render_frame(cams2[0])[0])
        require((f2 == f2cpu).all(), "config2: card frame != CPU frame")
        require(int(f2[..., :3].max()) > 0, "config2: the frame is black")
        say(f"config2 {f2.shape[1]}x{f2.shape[0]} (auto -> classic): card "
            "frame byte-equal to the CPU frame (plain versions)")
        moved2 = orbit_path(N_FRAMES, radius=4.0, center=[0.0, 0.0, 4.0])[5]
        fm = r2.read_frame(r2.render_frame(moved2)[0])
        fs = r2.read_frame(r2.render_frame(cams2[0])[0])
        require(not (fm == f2).all(), "config2: the moved frame equals the static one")
        require((fs == f2).all(), "config2: static -> moved -> static differs")
        say("config2: static -> moved -> static: final frame byte-equal to the first")
        torch.cuda.synchronize()
        counts_c = dict(_build.launches)
        say(json.dumps(counts_c, sort_keys=True))
        for k in ("K4_raster_classic", "K5_gather_rows"):
            require(counts_c.get(k, 0) > 0, f"{k} was not launched in phase 12")
        del r2cpu
        # the Renderer's own classic route at the headline size (plain
        # packing, the records phase 13 times): K4 against its plain version
        r8c = Renderer(scene8, dataclasses.replace(st8, pipeline="classic"),
                       device=dev)
        stats = compare_classic(r8c, cams8[0], "Renderer classic subdiv 8", errs)[0]
        require(stats["pairs_overflow"] == 0 and stats["clip_overflow"] == 0,
                "Renderer classic subdiv 8: pairs or clip candidates overflow")

    with Phase("13 classic timings"):
        from ash_renderer_tpu_torch.scene import reference_two_triangle_scene

        rref = Renderer(reference_two_triangle_scene(), device=dev)
        for label, r, cam in (("reference 800x600", rref, Camera()),
                              ("config2 800x600", r2, cams2[0])):
            require(r.settings.pipeline == "classic", f"{label}: not classic")
            med, mean, worst = frames_ms(r, [cam] * N_FRAMES)
            say(f"[{card}] frame ms, {label} (classic): median {med:.3f}, mean "
                f"{mean:.3f}, max {worst:.3f} ({N_FRAMES} frames)")
            # the same scene on the fused route, for the auto rule's threshold
            rf = Renderer(r.scene, dataclasses.replace(
                r.settings, pipeline="fused", front_coherence=False), device=dev)
            turns(card, f"{label} static", [("classic", r), ("fused", rf)],
                  [cam] * N_FRAMES)
            stage_ms(r, cam)  # warm-up
            say(f"[{card}] stage ms ({label} classic, static): " + ", ".join(
                f"{k} {v:.3f}" for k, v in stage_ms(r, cam).items()))
        del rref, r2, rf
        r8f = Renderer(scene8, dataclasses.replace(st8, front_coherence=False),
                       device=dev)
        turns(card, "config4 subdiv 8 static", [("classic", r8c), ("fused", r8f)],
              [cams8[0]] * N_FRAMES)
        stage_ms(r8c, cams8[0])  # warm-up
        say(f"[{card}] stage ms (subdiv 8 classic, static): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stage_ms(r8c, cams8[0]).items()))
        del r8c, r8f
        say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    meta = {
        "K1": ("K1_setup", "ash_renderer_tpu_torch/csrc/setup.cu",
               "ash_renderer_tpu/ops/setup_kernel.py:351", counts),
        "K2": ("K2_run_bounds", "ash_renderer_tpu_torch/csrc/bincount.cu",
               "ash_renderer_tpu/ops/bincount.py:129", counts),
        "K3": ("K3_raster", "ash_renderer_tpu_torch/csrc/raster.cu",
               "ash_renderer_tpu/ops/fused_kernel.py:1087", counts),
        "K3F": ("K3F_raster_shade", "ash_renderer_tpu_torch/csrc/raster.cu",
                "ash_renderer_tpu/ops/fused_kernel.py:128", counts_f),
        "K4": ("K4_raster_classic", "ash_renderer_tpu_torch/csrc/raster_classic.cu",
               "ash_renderer_tpu/ops/raster_pallas.py:203", counts_c),
        "K5": ("K5_gather_rows", "ash_renderer_tpu_torch/csrc/gather.cu",
               "ash_renderer_tpu/ops/meshlet_gather.py:97", counts_c),
    }
    kernels = []
    for k, (name, src, rep, n) in meta.items():
        kt, pt, lt, (bt, by) = timing[k]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n[name], "max_abs_err": errs[k], "ms": kt,
            "plain_ms": pt, "bound_ms": bt, "bound_by": by, "library_ms": lt,
        })
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
