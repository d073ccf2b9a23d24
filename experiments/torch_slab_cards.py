"""Row slabs of the PyTorch/CUDA port (``ash_renderer_tpu_torch.parallel``)
on distinct CUDA cards.

    python3 experiments/torch_slab_cards.py [--frames N]

Needs two cards or more: ``chip_smoke.py`` phase 19 emulates the slabs on
one card, and this script runs the same frames with each slab on a card of
its own.  In one process, with the mesh of every card (one slab each) and
8 slabs dealt round the cards (cuda:0, cuda:1, ... again):

- config4 subdiv 8 at 1920x1080: the golden under "auto" (K3) and "on"
  (K3F); fly-by frame 12 byte-equal to cuda:0's single-device frame, with
  the worst slab's wide, pair and clip counters; static -> moved ->
  static;
- the reference scene (classic, K4): its golden; the meshlet-packed
  subdiv-5 classic frame through ``render_frame_sharded(local_tri=)``
  (K5 + K4) with the scene state uploaded to each card: its golden;
- the kernel launches of those frames (each of K1-K5 and K3F at least
  once a slab);
- frame ms at subdiv 8, static, front cache off, on the host clock with
  every card synchronised after each frame (a frame ends on cuda:0, but
  its slabs run on every card): one card, every card, and 8 slabs round
  the cards, in turns; each card's peak memory.

Exits non-zero on any mismatch.  Imports nothing of JAX.
"""

import argparse
import collections
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def synced_frames_ms(r, cam, n: int):
    """Median and max of ``n`` frames' host-clock ms, every card synchronised
    before and after each frame (two warm-up frames first)."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(2):
        r.render_frame(cam)
    per = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        r.render_frame(cam)
        sync()
        per.append((time.perf_counter() - t0) * 1e3)
    per.sort()
    return per[len(per) // 2], per[-1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"torch_slab_cards: needs two CUDA cards or more, found "
              f"{n_cards}", file=sys.stderr)
        return 2

    from ash_renderer_tpu_torch import _build
    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES, GOLDEN_SHA,
                                                   config4_million_tri)
    from ash_renderer_tpu_torch.camera import Camera, orbit_path
    from ash_renderer_tpu_torch.parallel import (make_render_mesh,
                                                 render_frame_sharded,
                                                 slab_rows)
    from ash_renderer_tpu_torch.renderer import Renderer
    from ash_renderer_tpu_torch.state import upload

    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{n_cards} cards: " + ", ".join(
              torch.cuda.get_device_name(i) for i in range(n_cards)))
    _build.build()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    meshes = {f"{n_cards} cards": make_render_mesh(cards),
              f"8 slabs on {n_cards} cards": make_render_mesh(
                  cards[i % n_cards] for i in range(8))}
    dev0 = cards[0]
    g8, g5 = cs.golden("headline_config4.json"), cs.golden(
        "headline_config4_s5.json")
    scene8, st8, cams8 = config4_million_tri(8)
    scene5, st5, cams5 = config4_million_tri(5)
    cam8, cam5 = cams8[0], cams5[0]
    flyby = cs.flyby_camera(cs.FLYBY_FRAME, cs.N_FRAMES)
    moved = orbit_path(cs.N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])[5]
    nocache = dataclasses.replace(st8, front_coherence=False)
    single = Renderer(scene8, nocache, device=dev0)
    f_fly1 = single.read_frame(single.render_frame(flyby)[0])
    ref_scene, ref_st = GOLDEN_SCENES["reference"]()
    r5 = Renderer(scene5, st5, device=dev0)  # meshlet-packed
    cls5 = cs.classic_statics(r5)
    lt5 = torch.from_numpy(r5.packed.local_tri)
    states5 = None
    failed = []

    def check(cond, msg):
        print(("  " if cond else "  FAILED: ") + msg, flush=True)
        if not cond:
            failed.append(msg)

    for name, mesh in meshes.items():
        print(f"== {name}: {', '.join(map(str, mesh))}")
        launched = collections.Counter()
        on = dataclasses.replace(st8, fused_surface_shade="on")
        for label, settings in (("auto (K3)", st8), ("on (K3F)", on)):
            r = Renderer(scene8, settings, mesh=mesh)
            _build.launches.clear()
            f, aux = r.render_frame(cam8)
            f = r.read_frame(f)
            check(cs.sha(f) == g8["sha256"],
                  f"subdiv 8 {label}, {slab_rows(r.statics, len(mesh))} tile "
                  "rows a slab: golden sha256")
            if label.startswith("auto"):
                f_fly, aux = r.render_frame(flyby)
                cnt = {k: int(aux[k]) for k in ("n_wide", "wide_pairs_n",
                                                "n_clipped", "clip_overflow")}
                check((r.read_frame(f_fly) == f_fly1).all()
                      and cnt["n_clipped"] > 0 and cnt["wide_pairs_n"] > 0,
                      f"fly-by frame {cs.FLYBY_FRAME} == cuda:0's single "
                      f"device frame; worst slab {cnt}")
                fs = r.read_frame(r.render_frame(cam8)[0])
                fm = r.read_frame(r.render_frame(moved)[0])
                fs2 = r.read_frame(r.render_frame(cam8)[0])
                check(not (fm == fs).all() and (fs2 == fs).all(),
                      "static -> moved -> static: last frame == first")
            launched.update(_build.launches)
            del r
        rr = Renderer(ref_scene, ref_st, mesh=mesh)
        _build.launches.clear()
        check(cs.sha(rr.read_frame(rr.render_frame(Camera())[0]))
              == GOLDEN_SHA["reference"], "reference (classic, K4): golden")
        if states5 is None:
            states5 = {d: upload(r5.packed, scene5.materials, scene5.atlas,
                                 scene5.light, d) for d in cards}
        mm_t, mvp_t, _ = cs.front_inputs(r5, cam5)
        f, st = render_frame_sharded(
            cls5, mesh, states5, mm_t, mvp_t,
            torch.from_numpy(cam5.position.astype("float32")), local_tri=lt5)
        check(cs.sha(f.cpu().numpy()) == g5["sha256"]
              and int(st["pairs_overflow"]) == 0,
              "classic subdiv 5 (meshlets, K5 + K4): golden")
        launched.update(_build.launches)
        print(f"  launches: {dict(sorted(launched.items()))}")
        for k in cs.SLAB_KERNELS:
            check(launched.get(k, 0) >= len(mesh), f"{k} launched once a slab "
                  "or more")
        del rr

    for i in range(n_cards):
        torch.cuda.reset_peak_memory_stats(i)
    legs = [("1 card", single)] + [
        (name, Renderer(scene8, nocache, mesh=mesh))
        for name, mesh in meshes.items()]
    med = {name: [] for name, _ in legs}
    for name, r in legs + legs[::-1]:
        med[name].append(synced_frames_ms(r, cam8, args.frames))
    print(f"[{card}] frame ms, config4 subdiv 8 static uncached, host clock "
          f"with every card synced, median (max) per leg in turns: " + "; ".join(
              f"{name} " + ", ".join(f"{m:.3f} ({x:.3f})" for m, x in v)
              for name, v in med.items()))
    print(f"[{card}] peak memory per card (GiB): " + ", ".join(
        f"cuda:{i} {torch.cuda.max_memory_allocated(i) / 2**30:.2f}"
        for i in range(n_cards)))
    if failed:
        print(f"torch_slab_cards: {len(failed)} check(s) failed",
              file=sys.stderr)
        return 1
    print("torch_slab_cards: every check held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
