#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port: frames/sec at 1920x1080 on
a 1M-triangle textured, lit scene (config 4), plus a pixel-parity gate
against the port's numpy oracle and the headline's sha256 goldens.

The jax-free counterpart of ``bench.py`` (the JAX package's benchmark):
the same functions, flags and output.  It imports only the port, torch,
numpy and the standard library, and runs on the CUDA card unless
``--device`` names another device; without a card it raises.  On the CPU
(``--device cpu``) the kernels' plain versions run: use small configs.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline"}
where vs_baseline is value / 60 FPS, plus moving_camera_fps,
orbit_camera_fps and static_uncached_fps on config4; a failed gate flags
``metric``.  Diagnostics go to stderr.

Usage: python bench_torch.py [--config N] [--frames N] [--small] [--sweep]
                             [--device DEV]
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ash_renderer_tpu_torch import benchmarks, state  # noqa: E402
from ash_renderer_tpu_torch import pipeline as pl  # noqa: E402
from ash_renderer_tpu_torch.app import require_device  # noqa: E402
from ash_renderer_tpu_torch.camera import Camera, orbit_path  # noqa: E402
from ash_renderer_tpu_torch.config import RendererSettings  # noqa: E402
from ash_renderer_tpu_torch.debugging import numpy_pack  # noqa: E402
from ash_renderer_tpu_torch.oracle import render_oracle  # noqa: E402
from ash_renderer_tpu_torch.oracle.raster_cpu import compose_mvp  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer, frame_statics  # noqa: E402
from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject  # noqa: E402

F32 = np.float32


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host(rgba8) -> np.ndarray:
    """A frame (a tensor on any device, or an array) as a numpy array."""
    if isinstance(rgba8, torch.Tensor):
        return rgba8.cpu().numpy()
    return np.asarray(rgba8)


def device_lines(dev: torch.device) -> list:
    """The log's first lines: the card's name and power limit as
    ``nvidia-smi`` gives them, the torch and CUDA versions, the device."""
    lines = []
    if dev.type == "cuda":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        lines += [f"card: {c}" for c in out.stdout.strip().splitlines()]
        name = f" ({torch.cuda.get_device_name(dev)})"
    else:
        name = ""
    lines.append(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
                 f"device: {dev}{name}")
    return lines


def parity_gate(pipeline: str = "classic", device="cuda") -> bool:
    """Small-scene pixel parity against the port's numpy oracle on
    ``device``: 160 random triangles over 200 vertices (seed 5) at 256x192,
    plain-packed, through ``pipeline.render_frame_fused`` (the non-meshlet
    fused fallback: K2, K3F) for "fused" or ``pipeline.render_frame`` (K4)
    for "classic", compared byte for byte.  The oracle takes the materials
    pack the device state holds (one default material)."""
    dev = torch.device(device)
    rng = np.random.default_rng(5)
    nv, nt = 200, 160
    pos = rng.uniform(-2, 2, (nv, 3)).astype(F32)
    pos[:, 2] += 3.5
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(F32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    settings = RendererSettings(width=256, height=192, pipeline=pipeline)
    cam = Camera()
    packed = scene.pack(meshlets=False)
    statics = frame_statics(settings, packed.tri_v.shape[0], has_atlas=False,
                            has_light=False)
    s = state.upload(packed, scene.materials, None, None, dev)
    view = cam.view_matrix()
    proj = cam.projection_matrix(256 / 192)
    mm = np.ascontiguousarray(scene.model_matrices(), F32)
    mvp = np.ascontiguousarray(compose_mvp(mm, view, proj))
    inputs = [torch.from_numpy(a).to(dev)
              for a in (mm, mvp, cam.position.astype(F32))]
    fn = pl.render_frame_fused if pipeline == "fused" else pl.render_frame
    rgba8, _ = fn(statics, s, *inputs)
    o = render_oracle(packed, mm, view, proj, settings,
                      materials=numpy_pack(s.materials), cfg=statics.cfg)
    ok = bool(np.array_equal(host(rgba8), o["rgba8"]))
    log(
        f"parity gate (256x192, 160 tris, {pipeline}): "
        f"{'EXACT' if ok else 'MISMATCH'}"
    )
    return ok


def oracle_frame(config: str) -> np.ndarray:
    """The port's numpy oracle frame of benchmark ``config`` at its first
    camera: packed, configured and shaded as a Renderer with the config's
    settings packs it (built on the CPU; no frame is rendered)."""
    scene, settings, cams = benchmarks.ALL_CONFIGS[config]()
    r = Renderer(scene, settings, device="cpu")
    cam, st, s = cams[0], r.settings, r.state
    return render_oracle(
        r.packed, np.asarray(scene.model_matrices(), F32), cam.view_matrix(),
        cam.projection_matrix(st.render_width / st.render_height), st,
        materials=numpy_pack(s.materials),
        atlas=None if s.atlas is None else numpy_pack(s.atlas),
        light=None if s.light is None else numpy_pack(s.light),
        camera_pos=cam.position.astype(F32), cfg=r.cfg)["rgba8"]


def log_differing(frame: np.ndarray, ref: np.ndarray) -> None:
    if ref.shape == frame.shape:
        bad = int((ref != frame).any(axis=-1).sum())
        log(f"  differing pixels: {bad} / {frame.shape[0]*frame.shape[1]}")


def headline_hash_gate(rgba8, subdiv: int, config: str) -> bool | None:
    """Scale-exactness gate: the headline frame must byte-equal the offline
    numpy-oracle render (docs/golden/headline_*.json): the 1.31M-tri sphere,
    the 1.0M-tri terrain and config5.  Returns None when no golden matches
    (non-headline subdiv), else pass/fail.

    config5's golden was rendered with the reference's texture asset; where
    ``benchmarks.reference_texture_found()`` says the asset is absent, the
    golden does not apply, and the frame is held to ``oracle_frame`` of the
    same config instead (logged as such)."""
    if config == "config4_terrain":
        name = "headline_terrain.json"
    elif config == "config5_flythrough":
        name = "headline_config5.json"
    elif subdiv == 8:
        name = "headline_config4.json"
    else:
        name = f"headline_config4_s{subdiv}.json"
    path = os.path.join(ROOT, "docs", "golden", name)
    if not os.path.exists(path):
        log(f"headline hash gate: no golden for subdiv={subdiv}, skipped")
        return None
    with open(path) as f:
        golden = json.load(f)
    frame = host(rgba8)
    size = f"{frame.shape[1]}x{frame.shape[0]}, {golden['n_tris']} tris"
    if config == "config5_flythrough" and not benchmarks.reference_texture_found():
        log(f"headline hash gate: {name} skipped: it was rendered with the "
            "reference's texture asset, which is absent "
            f"(${benchmarks.REFERENCE_TEXTURE_ENV}), so checkerboard(512) "
            "stands in; the frame is held to the numpy oracle instead")
        ref = oracle_frame(config)
        ok = bool(np.array_equal(frame, ref))
        log(f"headline oracle gate ({size}): {'EXACT' if ok else 'MISMATCH'}")
        if not ok:
            log_differing(frame, ref)
        return ok
    digest = hashlib.sha256(frame.tobytes()).hexdigest()
    ok = digest == golden["sha256"]
    log(f"headline hash gate ({size}): {'EXACT' if ok else 'MISMATCH'}")
    if not ok:
        npz = path.replace(".json", "_rgba8.npz")
        if os.path.exists(npz):
            log_differing(frame, np.load(npz)["rgba8"])
    return ok


def flyby_path(n_frames: int):
    """Camera path that grazes the headline sphere (center [0,0,2], r=1):
    a straight fly-by at impact parameter 1.02 looking along +Z, so frames
    near closest approach have surface geometry crossing the near plane —
    the clip-tail branch runs for real (the static headline camera never
    takes it)."""
    cams = []
    for i in range(n_frames):
        z = -1.0 + 6.0 * i / max(n_frames - 1, 1)
        cams.append(Camera(position=np.array([1.02, 0.0, z], F32)))
    return cams


def sweep(args):
    """All benchmark configs, one process: per-config cold-start (warmup +
    first frame) and steady-state FPS, ending with the headline JSON.
    ``args.device``: the torch device (``main`` resolves it)."""
    dev = args.device
    results = {}
    headline = None
    for name, builder in benchmarks.ALL_CONFIGS.items():
        t0 = time.perf_counter()
        scene, settings, cams = builder()
        r = Renderer(scene, settings, device=dev)
        wu = 0.0
        if r.settings.pipeline == "fused":
            wu = r.warmup()
        t1 = time.perf_counter()
        r.render_frame(cams[0])
        sync(dev)
        first = time.perf_counter() - t1
        nf = args.frames
        t1 = time.perf_counter()
        for i in range(nf):
            r.render_frame(cams[i % len(cams)])
        sync(dev)
        fps = nf / (time.perf_counter() - t1)
        results[name] = fps
        if name == "config4_million_tri":
            headline = (fps, settings, scene)
        log(
            f"{name:22s} {fps:7.2f} FPS  [{r.settings.pipeline}] "
            f"warmup {wu:5.1f}s first-frame {first:5.2f}s "
            f"(total cold {time.perf_counter()-t0:5.1f}s)"
        )
        del r
    fps, settings, scene = headline
    n_tris = sum(m.num_triangles for m in scene.meshes)
    result = {
        "metric": (
            f"frames/sec at {settings.width}x{settings.height} on "
            f"config4_million_tri ({n_tris} tris) [sweep]"
        ),
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 4),
    }
    print(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--config", default="config4_million_tri",
                    help="benchmark config name (see ash_renderer_tpu_torch."
                         "benchmarks.ALL_CONFIGS)")
    ap.add_argument("--subdiv", type=int, default=8,
                    help="icosphere subdivisions (20*4^s triangles)")
    ap.add_argument("--small", action="store_true",
                    help="reduced scene for smoke testing")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--pipeline", default=None, choices=["classic", "fused"],
                    help="override RendererSettings.pipeline")
    ap.add_argument("--sweep", action="store_true",
                    help="run EVERY benchmark config in this one process "
                         "and print a summary table; the final JSON line "
                         "still reports the headline")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda; the "
                         "CPU only when named)")
    args = ap.parse_args(argv)
    dev = args.device = require_device(args.device)
    for line in device_lines(dev):
        log(line)

    if args.sweep:
        return sweep(args)

    parity_ok = True
    if not args.skip_parity:
        try:
            parity_ok = parity_gate(
                args.pipeline or ("fused" if dev.type == "cuda" else "classic"),
                dev,
            )
        except Exception as e:  # a gate that cannot run has failed
            log(f"parity gate error: {e!r}\n{traceback.format_exc()}")
            parity_ok = False

    t0 = time.perf_counter()
    if args.config == "config4_million_tri":
        n = 4 if args.small else args.subdiv
        scene, settings, cams = benchmarks.config4_million_tri(subdiv=n)
    else:
        scene, settings, cams = benchmarks.ALL_CONFIGS[args.config]()
    if args.pipeline is not None:
        settings = dataclasses.replace(settings, pipeline=args.pipeline)
    n_tris = sum(m.num_triangles for m in scene.meshes)
    log(f"scene: {n_tris} triangles (built in {time.perf_counter()-t0:.1f}s)")

    r = Renderer(scene, settings, device=dev)
    log(f"pipeline={r.settings.pipeline}")
    if r.settings.pipeline == "fused":
        t0 = time.perf_counter()
        r.warmup()
        log(f"warmup (kernel build + one frame): {time.perf_counter()-t0:.1f}s")
    cam = cams[0]

    cached = r._front_cache.value if r._front_cache is not None else None
    t0 = time.perf_counter()
    rgba8, aux = r.render_frame(cam)
    sync(dev)
    hit = cached is not None and r._front_cache.value is cached
    log(f"first frame: {time.perf_counter()-t0:.1f}s"
        + (" (front cache hit: the warm-up frame's camera)" if hit else ""))
    pair_info = (
        f" pairs: {int(aux['pairs_total'])},"
        f" overflow: {int(aux['pairs_overflow'])},"
        if "pairs_total" in aux
        else ""  # the fused pipeline is budget-free (no pair machinery)
    )
    log(
        f"valid tris: {int(aux['n_valid'])},{pair_info}"
        f" covered px: {int((aux['vis_tri'] >= 0).sum())}"
    )
    if "n_wide" in aux:  # static-pose stream population
        log(
            "static pose: "
            f"live rows={int(aux.get('live_rows', 0))} "
            f"wide={int(aux['n_wide'])} "
            f"pairs={int(aux['wide_pairs_n'])} "
            f"leftover={int(aux['wide_leftover'])}"
        )

    # scale-exactness gate: headline frame vs the offline oracle render
    hash_ok = True
    if (
        args.config
        in ("config4_million_tri", "config4_terrain", "config5_flythrough")
        and not args.small
        and r.settings.pipeline == "fused"
    ):
        res = headline_hash_gate(rgba8, args.subdiv, args.config)
        hash_ok = res is not False

    # steady-state timing (static camera): best of 2 passes, both logged
    nf = args.frames
    passes = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(nf):
            rgba8, aux = r.render_frame(cam)
        sync(dev)
        passes.append((time.perf_counter() - t0) / nf)
    dt = min(passes)
    fps = 1.0 / dt
    log(
        "steady state: "
        + " / ".join(f"{p*1000:.1f}" for p in passes)
        + f" ms/frame (2 passes) -> best {dt*1000:.1f} ms = {fps:.2f} FPS"
    )

    # moving-camera steady state: a fly-by grazing the scene, so clip-active
    # frames pay their real cost (the static camera never takes the
    # clip-tail branch)
    orbit_fps = None
    orbit_const_fps = None
    if args.config == "config4_million_tri" and not args.small:
        fcams = flyby_path(24)
        r.render_frame(fcams[0])
        per = []  # per-frame counters, read after the loop
        sync(dev)
        t0 = time.perf_counter()
        for fc in fcams:
            _, aux_m = r.render_frame(fc)
            per.append({
                k: aux_m[k]
                for k in ("n_clipped", "n_wide", "wide_pairs_n",
                          "wide_leftover")
                if k in aux_m
            })
        sync(dev)
        mdt = (time.perf_counter() - t0) / len(fcams)
        orbit_fps = 1.0 / mdt
        per = [{k: int(v) for k, v in d.items()} for d in per]
        ncl = [d.get("n_clipped", 0) for d in per]
        log(
            f"moving camera (fly-by): {mdt*1000:.1f} ms/frame = "
            f"{orbit_fps:.2f} FPS; clipped tris/frame min={min(ncl)} "
            f"max={max(ncl)} (frames with clips: "
            f"{sum(1 for c in ncl if c > 0)}/{len(ncl)})"
        )
        for i, d in enumerate(per):  # wide-run population per frame
            if any(d.get(k, 0) for k in ("n_wide", "wide_leftover")):
                log(
                    f"  frame {i:2d}: clipped={d.get('n_clipped', 0):5d} "
                    f"wide={d.get('n_wide', 0):6d} "
                    f"pairs={d.get('wide_pairs_n', 0):7d} "
                    f"global-run leftover={d.get('wide_leftover', 0):6d}"
                )

        # coverage-constant moving camera: an orbit at the static pose's
        # radius keeping the sphere frame-filling on every frame (frame 0
        # is the static pose)
        ocams = orbit_path(24, radius=2.0, center=np.array([0, 0, 2.0]))
        r.render_frame(ocams[1])  # absorb any first-call overhead
        sync(dev)
        t0 = time.perf_counter()
        for oc in ocams:
            r.render_frame(oc)
        sync(dev)
        odt = (time.perf_counter() - t0) / len(ocams)
        orbit_const_fps = 1.0 / odt
        log(
            f"moving camera (orbit, coverage-constant): {odt*1000:.1f} "
            f"ms/frame = {orbit_const_fps:.2f} FPS"
        )

        # uncached static control: the same static pose with the front
        # cache disabled, the per-frame cost when no temporal reuse is
        # possible (the orbit should sit at about this rate)
        saved_cache = r._front_cache
        r._front_cache = None
        r.render_frame(cam)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            r.render_frame(cam)
        sync(dev)
        udt = (time.perf_counter() - t0) / 20
        r._front_cache = saved_cache
        result_uncached = 1.0 / udt
        log(
            f"static pose, front cache disabled: {udt*1000:.1f} ms/frame "
            f"= {result_uncached:.2f} FPS (orbit at "
            f"{100*orbit_const_fps/result_uncached:.0f}% of it)"
        )

        # staleness canary: a static frame rendered after the moving
        # sequences must still byte-equal the golden
        rgba8_s, _ = r.render_frame(cam)
        res2 = headline_hash_gate(rgba8_s, args.subdiv, args.config)
        if res2 is not None:
            hash_ok = hash_ok and res2
            log(f"post-motion static re-gate: {'EXACT' if res2 else 'MISMATCH'}")

    value = round(fps, 3)
    flags = ("" if parity_ok else " [PARITY GATE FAILED]") + (
        "" if hash_ok else " [HEADLINE HASH MISMATCH]"
    )
    result = {
        "metric": (
            f"frames/sec at {settings.width}x{settings.height} on "
            f"{args.config} ({n_tris} tris)" + flags
        ),
        "value": value,
        "unit": "fps",
        "vs_baseline": round(value / 60.0, 4),
    }
    if orbit_fps is not None:
        result["moving_camera_fps"] = round(orbit_fps, 3)
    if orbit_const_fps is not None:
        result["orbit_camera_fps"] = round(orbit_const_fps, 3)
        result["static_uncached_fps"] = round(result_uncached, 3)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
