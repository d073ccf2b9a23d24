#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ash_renderer_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; imports nothing of JAX.  Phases (each prints its
lines and seconds; any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``ash_renderer_tpu_torch/csrc``;
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
   kernel's and plain version's CUDA-event ms at the static camera.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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


def ensure_native_meshlets() -> None:
    """Build the reference's native meshlet builder (the pure-Python one
    gives identical meshlets, slower) when it is missing."""
    so = os.path.join(ROOT, "ash_renderer_tpu", "native", "libashtpu.so")
    if not os.path.exists(so):
        subprocess.run(
            ["make", "-C", os.path.join(ROOT, "ash_renderer_tpu", "native")],
            capture_output=True, text=True, timeout=300,
        )
    say(f"native meshlet builder: {'yes' if os.path.exists(so) else 'no'}")


def golden(name: str) -> dict:
    with open(os.path.join(ROOT, "docs", "golden", name)) as f:
        return json.load(f)


def sha(frame) -> str:
    return hashlib.sha256(frame.tobytes()).hexdigest()


def flyby_camera(i: int, n: int):
    """The reference bench's fly-by grazing the headline sphere (centre
    [0, 0, 2], r = 1) at impact parameter 1.02."""
    import numpy as np

    from ash_renderer_tpu.camera import Camera

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
TIMING_REPS = {"K1": (10, 3), "K2": (20, 20), "K3": (10, 1)}


def compare_kernels(r, cam, label: str, errs: dict, timed: bool = False):
    """Each kernel against its plain version on the same card inputs, the
    ones the main path gives it for camera ``cam``.  Folds each kernel's
    max |kernel - plain| into ``errs``; returns the front's counters and,
    with ``timed``, {kernel: (kernel ms, plain ms)} of the same calls."""
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
    ms["K1"] = (k1_ms, p1_ms)
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
    ms["K2"] = (k2_ms, p2_ms)
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
    ms["K3"] = (k3_ms, p3_ms)
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
        path = _build.build()
        _build.lib()
        say(f"kernels: {os.path.relpath(path, ROOT)} "
            f"({time.perf_counter() - t0:.1f} s)")

    import dataclasses

    from ash_renderer_tpu.camera import orbit_path
    from ash_renderer_tpu_torch.benchmarks import config4_million_tri
    from ash_renderer_tpu_torch.renderer import Renderer

    errs: dict = {}
    with Phase("3 kernels vs plain (subdiv 5)"):
        scene5, st5, cams5 = config4_million_tri(5)
        r5 = Renderer(scene5, st5, device=dev)
        compare_kernels(r5, cams5[0], "static", errs)
        compare_flyby(r5, "fly-by", errs)
        torch.cuda.synchronize()

    with Phase("4 frames through Renderer"):
        ensure_native_meshlets()
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
        def frames_ms(r, cams):
            """Per-frame device-clock times (CUDA events between frame
            starts) over the camera list, after two warm-up frames."""
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
        for k, (kt, pt) in timing.items():
            say(f"[{card}] {k}: kernel {kt:.3f} ms, plain torch {pt:.3f} ms")
        say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    meta = {
        "K1": ("K1_setup", "ash_renderer_tpu_torch/csrc/setup.cu",
               "ash_renderer_tpu/ops/setup_kernel.py:351"),
        "K2": ("K2_run_bounds", "ash_renderer_tpu_torch/csrc/bincount.cu",
               "ash_renderer_tpu/ops/bincount.py:129"),
        "K3": ("K3_raster", "ash_renderer_tpu_torch/csrc/raster.cu",
               "ash_renderer_tpu/ops/fused_kernel.py:1087"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[k],
         "ms": round(timing[k][0], 4), "plain_ms": round(timing[k][1], 4)}
        for k, (name, src, rep) in meta.items()
    ]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
