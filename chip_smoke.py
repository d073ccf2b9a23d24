#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ash_renderer_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; imports nothing of JAX.  Phases (each prints its
lines and seconds; any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels and the native meshlet builder from
   ``ash_renderer_tpu_torch/csrc`` (one compiler process per source, all
   at once; ptxas register and spill counts printed; fails if ptxas gives
   K3's and K3F's ``raster_kernel`` (at 8 and at 4 rows), K4's
   ``raster_classic_kernel``, K2's
   ``run_bounds_kernel``, K5's ``gather_tile_kernel``, K7's
   ``shade_pack_kernel``, K11's ``shade_classic_kernel``, K8's and K8C's
   ``transform_kernel``, K10's ``vertex_kernel`` or ``tri_kernel`` (its
   cluster and grid designs), K9's ``front_meta_kernel`` or K12's
   ``bin_kernel`` a stack frame or spills), and hold
   ``native.build_meshlets`` equal to the Python meshlets;
3. each kernel against its plain torch version on the card, on config4 at
   subdiv 5 (20,480 triangles, 1080p), at the static camera and at a
   grazing fly-by camera (clip tail, wide pairs, fine runs); K2 also at
   key counts on its kernel's chunk, warp and block edges (0-2049 keys),
   and it must refuse a key view that is not 16-byte aligned; then K3 and
   K3F on the 150x64 fine-padding scene (fine rows whose true extent runs
   past their 16-px window into the padding columns);
4. frames through ``Renderer``: the subdiv-5 (``fused_surface_shade=
   "off"``, K3's counted run) and subdiv-8 (1,310,720 triangles, "auto")
   frames against the sha256 goldens in ``docs/golden/``, then static ->
   moved -> static, whose last frame must equal the first;
5. the kernel launch counts of phase 4: the subdiv-5 frame's those of
   "off", the headline's those of the route "auto" takes on the card
   (``route_kernels``), each > 0, and none of another route; K6 and K9
   once a front (as often as K8);
6. CUDA-event timings at subdiv 8: frame ms (static with the front cache
   off, static cached, orbit, fly-by) and ms per stage;
7. each kernel against its plain version at the headline shapes (subdiv
   8, static and fly-by cameras), bit for bit as in phase 3, with each
   kernel's and plain version's CUDA-event ms at the static camera, K2's
   beside ``torch.searchsorted`` and the launch floor (``torch.cuda.
   _sleep(1)`` timed alike), and K3's ms with ``rmeta`` zeroed (no record
   streamed: phases D and E alone); every K3 comparison prints the
   streamed slots per range, the slots' box pixels
   (``fused_kernel.slot_pixel_boxes``), the brute-force slot-pixels
   (slots x 1024) and the covered pixels;
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
   static uncached "off" vs "on", in turns;
11. K5 (the meshlet corner gather) against its plain version, bit for
   bit, at F = 1, 3, 4, 8, 12 and 32 on 1, 2, one more than a full wave of
   its persistent grid (SMs x blocks per SM) and twice that plus one
   meshlets, with random int32 tables holding NaN and Inf bit patterns
   and local ids that mix -1, 128, INT_MIN, INT_MAX and padding rows; it
   must refuse a table view 4 bytes off a 16-byte boundary.  Then K4 (the
   classic visibility raster) and K5 against their plain versions, bit for
   bit, on the classic frame of the
   meshlet-packed config4 at subdiv 5 (static camera and fly-by frame 12,
   which clips) and at subdiv 8 (static camera, timed, with K5's library
   call ``tbl[idx]``); every K4 comparison prints the live records' box
   pixels (``raster_visibility.box_pixels``, the operation count of K4's
   bound) against the brute-force record-pixels (records x 2048), and the
   timed one checks that K4's CUDA path refuses to run without
   ``rec_box``;
12. classic frames, launch counts zeroed before them: the reference scene
   (320x240) and the four feature scenes through ``Renderer`` with
   ``pipeline="classic"`` against their pinned sha256; the meshlet-packed
   config4 subdiv-5 and subdiv-8 frames through ``pipeline.render_frame``
   (K5 + K4) against their goldens, with no pair or clip overflow; config2
   (800x600, classic) byte-equal to the same frame rendered on
   the CPU, then static -> moved -> static; K4 and K5 must have launched;
   then, outside the counted run, K4 against its plain version on the
   records of the five pinned scenes and config2;
13. K4 against its plain version, timed, on the records of the Renderer's
   own classic route at subdiv 8 (plain packing), with no pair or clip
   overflow; CUDA-event frame ms of the classic pipeline: the reference
   scene and config2 (800x600) through ``Renderer``, each also against
   "fused" (front cache off) in turns, config4 subdiv 8 static "classic"
   vs "fused" in turns, and the classic stage ms;
14. the non-meshlet fused fallback (``pipeline.render_frame_fused`` on
   plain-packed uploads), launch counts zeroed before it: bench.py's
   parity-gate scene (the same seed and shapes, 256x192, K3F) equals the
   port's numpy oracle and the same function on CPU tensors; the five
   pinned golden scenes and config4 at subdiv 5 and 8 under "off" (K3)
   and "on" (K3F) equal their sha256; K2, K3, K3F and K9 must have
   launched, with K8C and K10 (the fallback's transform and setup), K1,
   K5 and K8 not; then K3 / K3F against their plain versions on the
   fallback's own tables (gate scene, subdiv 8 static, subdiv 5 fly-by),
   and the subdiv-8 static uncached frame ms (median, mean, max) beside
   ``render_frame_fused_staged``'s, in turns, with the fallback's stage
   ms;
15. ``tritables.build_comb_table`` through K5 at F = 12 on config4 subdiv
   8 (meshlet-packed), launch counts zeroed before it: its comb equals the
   row-gather branch's on every valid row and on the setup and id columns
   of every row, and K1's comb on the real rows of alive meshlets; K5 at
   this call site timed beside its plain version, ``tbl[idx]`` and its
   bound;
16. the oracle, debug and profiling layer: ``debugging.compare_with_oracle``
   pixel-exact on CUDA Renderers of the reference scene (classic), config3
   (fused, K3F) and config4 subdiv 5 (fused, textured), with the oracle's
   seconds; ``validate_frame`` finds the subdiv-8 frames (staged and
   fallback) clean; ``profiling.trace`` writes a Chrome trace of one
   fallback frame under ``build/traces/``; a CUDA ``profiling.Timer``
   reads each stage of that frame;
17. the app, asset loaders and serialization, launch counts zeroed just
   before ``app.main`` and read just after it: ``app.main
   ["config4_terrain"]`` without ``--device`` (the card by default) writes
   a PNG that decodes (stdlib inflate) to ``docs/golden/
   headline_terrain.json``'s sha256 (1,002,528 triangles, 1920x1080),
   ``app.main ["reference", "--size", "320x240"]`` to the pinned
   reference golden, each launching the kernels of the route "auto"
   takes on the card (``route_kernels``); config1 (its OBJ through
   ``native.parse_obj``, held to the Python parser) over three scripted
   ``App.run`` events, each presented frame equal to the port's oracle at
   the controller's camera; ``request_resize`` recovered inside
   ``draw_frame`` and ``update_mesh``, each equal to a fresh Renderer; an
   untextured glTF through ``app.main`` equal to the oracle; config5 frame
   0 byte-equal across ``save_scene`` / ``load_scene`` and equal to the
   oracle; ``App.run`` fps for terrain and config1;
18. diffrender on examples/inverse_rendering.py's scene (icosphere 3,
   128x128): the classic route's ``vis_tri`` (K4) equals
   ``visibility_oracle``'s; ``shade_params_fn``'s card forward equals the
   CPU's bit for bit (unlit and lit); card gradients (vertex colours, base
   colour, specular, light direction, colour, ambient) equal the CPU's
   within rtol 1e-4 / atol 1e-6; ``fit_to_image`` converges on the card as
   on the CPU, with ms per step;
19. row slabs (``parallel``) on the card, emulated as a mesh that repeats
   ``cuda:0`` when there is one card, every kernel's plain version made to
   raise and the launch counts zeroed before the counted frames: config4
   subdiv 8 at 1920x1080 in 8 slabs of 17 tile rows (the last padded past
   the screen) equals its golden under "off" (K3) and "on" (K3F), subdiv
   5 in 2 and 3 slabs its golden; fly-by frame 12 in 8 slabs equals the
   single-device frame with the worst slab's wide, pair and clip counters
   live; static -> moved -> static in 8 slabs; the reference scene
   (classic, K4) in 2 and 3 slabs its golden, and the meshlet-packed
   subdiv-5 classic frame through ``render_frame_sharded(local_tri=)``
   (K5 + K4) its golden; config5 frame 0 (2x SSAA) in 2 slabs equals its
   single-device frame; K1-K5 and K3F must have launched, and
   ``n_devices`` beyond the cards present must raise.  With two cards or
   more, the same frames on distinct cards.  Then K3 and K3F on a middle
   slab's tables (and K3 on a fly-by slab) against their plain versions at
   the slab's row origin, bit for bit, timed; CUDA-event frame ms at
   subdiv 8, static, front cache off, on 1 device and in 2 and 8 slabs in
   turns; the 8-slab frame's stage ms summed over the slabs and its ms per
   slab; peak device memory;
20. the examples and the last host helpers, every kernel's plain version
   made to raise and the launch counts zeroed before each run and read
   after it: ``examples/torch_render_scene.py`` (run in this process,
   without ``--device``) on config4 at subdiv 8 (1920x1080) writes a PNG
   that decodes to the headline golden and on the reference scene at
   320x240 the PNG of ``tests/golden/reference_320x240.png``, each on the
   route "auto" takes (``route_kernels``); ``torch_inverse_rendering.py`` on the
   card writes the target PNG of a ``--device cpu`` run byte for byte, its
   loss falls and its last loss is the CPU's within ``INV_LOSS_RTOL``;
   ``torch_interactive.py --frames 8 --size 320x240`` with stdin not a tty
   prints its frame count and fps (K1, K2, K3F); ``binsort.bin_sort`` on
   the subdiv-5 headline's setup gives the CPU's bounds and run rows (K2),
   for the whole frame and a slab window; ``Renderer`` with
   ``preferred_device_index=0`` and no device renders on cuda:0 the frame
   of ``device="cuda:0"``;
21. ``bench_torch.py`` (the port's ``bench.py``) in this process, every
   kernel's plain version made to raise and the launch counts zeroed
   before each run and read after it: the headline (config4 subdiv 8,
   1080p, ``--frames 10``), ``--config config4_terrain`` and
   ``--config config5_flythrough`` (``--frames 5``) and ``--sweep
   --frames 3``.  Each prints one unflagged JSON line with ``value > 0``
   (the headline's with ``moving_camera_fps``, ``orbit_camera_fps`` and
   ``static_uncached_fps``); its log holds the fused parity gate EXACT,
   the hash gate EXACT (config5 without the reference's texture asset:
   its frame EXACT against the numpy oracle) and the headline's
   post-motion re-gate EXACT; K1, K2 and K3F launched, K3 exactly when
   the CUDA rule's shade knob is "off", K4 in the sweep exactly
   when a config there takes the classic route, K5 not;
22. the auto rules (``renderer.auto_route``; ``--auto-rules`` runs phases
   1, 2 and 22 alone): interleaved A/B rounds in this process (both
   renderers built and warmed, front cache off, 12 pairs of rounds of 20
   frames, each pair's order alternating, wall ms between synchronizes
   and the median CUDA-event frame ms of each round; the alternative
   clears when it wins 10 of the 12 pairs on the wall metric): classic
   against fused on every scene the CPU rule sends to classic and on
   config3 and config4 subdiv 4, static and
   orbit; "off" against "on" on every textured scene (the fused route),
   static and orbit, config4 subdiv 8 also on the fly-by and in 8 row
   slabs; what the decision rule of PERF.md gives on that table beside
   the constants ``renderer.py`` holds.  Then, every plain version made
   to raise, for each config of ``ALL_CONFIGS`` and each pinned golden
   scene the route "auto" resolves to on the card and the kernels one
   frame launched (those of that route), every frame exact: the goldens
   against ``tests/golden/*.png``, config4 subdivs 8 and 5 and terrain
   against ``docs/golden/``, config5 against the port's oracle without
   the texture asset, the other configs against the port's oracle, and
   config4 subdiv 8 in 8 row slabs against the single device's frame;
23. the benchmark's cells (``benchmark/run.py``; ``--bench-cells`` runs
   phases 1, 2 and 23 alone): every one-card cell of ``BENCHMARK.json``
   in this process at 24 frames of its default-seed path, each printing
   its metric lines; every gated frame (the static pose before and after
   the path against ``docs/golden/``, two path frames against the frames
   stored in ``benchmark/golden/`` and the classic route on the card) must
   be exact;
24. K3 and K3F on the reference's 4-row tiles (``fused_tile_h=4``;
   ``--tile-h4`` runs phases 1, 2 and 24 alone): every plain version made
   to raise and the launch counts zeroed before the counted frames,
   config4 subdiv 5 ("off", ``K3_raster_t4``) and subdiv 8 ("off", and
   "auto": ``K3F_raster_shade_t4``) through ``Renderer`` equal their
   goldens, and subdiv 8 in 2 and 4 slabs on the card equals the single
   card's frame; no 8-row raster may launch there.  Then K3 at 4 rows
   against its plain version at subdiv 8 (static, timed, and fly-by frame
   12) and K3F at subdiv 8 (static, timed; fly-by frame 12, which clips
   and expands wide pairs) and on config3 "on", bit for bit; and K3 and
   K3F at 8 and at 4 rows on the same subdiv-8 frame, CUDA-event ms in
   turns (8, 4, 4, 8);
25. the clip tail, kernel K6 (``ops/clip_tail.clip_tail``; ``--clip-tail``
   runs phases 1, 2 and 25 alone): its one cooperative launch against
   ``clip_tail_plain`` on the card, bit for bit (the tail comb rows as
   int32 words, the keys and the counters), on K1's outputs for terrain
   at its golden pose (no clip) and at the terrain walk's first frame
   (clips; timed with CUDA events beside the plain chain, with its bound),
   that frame with a 16- and a 17-triangle budget (overflow; 17 is no
   multiple of the kernel's 16 slots a block) and at a middle and the
   last of 8 row slabs' windows, and config4 subdiv 8 at the fly-by's
   closest approach and at an orbit frame that clips nothing; the
   kernel's call runs under ``torch.cuda.set_sync_debug_mode("error")``
   (no host read); one terrain front, every plain version raising,
   launches K6 once;
26. shade + pack, kernel K7 (``ops/shade_pack.shade_pack``;
   ``--shade-pack`` runs phases 1, 2 and 26 alone): its one launch against
   ``shade_pack_plain`` on the card, bit for bit (the RGBA8 frame), on
   K3F's planes of config4 subdiv 8 at the static pose (timed with CUDA
   events beside the plain chain, with its bound) and at an orbit frame
   on 8- and on 4-row tiles, of slab 3 of the 8-slab split (rows
   uncropped), of config5 frame 0 (2x SSAA) and of the ``ssaa_srgb``
   golden scene on the fused route with "on" (2x SSAA, sRGB), each
   kernel call after the first under ``torch.cuda.set_sync_debug_mode(
   "error")``; then the static planes with NaN, +-Inf and -0.0 in rows
   0-7 of a tenth of the covered samples: bit-equal on every channel
   whose float value is not NaN, each NaN channel packed to 0, and with
   sRGB equal to the plain LUT and pack of the frame with NaN as 0.0.
   Every frame of K3F's route launches K7 (``route_kernels``);
27. the vertex transform, kernel K8 (``ops/vertex_transform.
   transform_vertices_T``; ``--front-glue`` runs phases 1, 2, 27 and 28
   alone): its launch against ``transform_vertices_T_plain`` on the card,
   bit for bit (the (16, V) table as int32 words), under
   ``torch.cuda.set_sync_debug_mode("error")``, on config4 subdiv 8 at
   the static pose (timed with CUDA events beside the plain chain, with
   its bound) and the fly-by's closest approach, and on config5's two
   objects (the ``vert_obj`` gather) at two frames;
28. the wide-pair expansion, range metadata and sorted-table records,
   kernel K9 (``ops/front_meta.front_meta``): its one cooperative launch
   against ``front_meta_plain`` on the card, bit for bit (pair_starts,
   rmeta, the counts, the first n_pairs pair rows and the records of the
   live prefixes, ``tbl_sorted[:we]`` and ``tbl_ext[:n_pairs]``), under
   ``torch.cuda.set_sync_debug_mode("error")``, on config4 subdiv 8 at
   the fly-by's closest approach (wide pairs live), in slab 3 of 8 and
   on 4-row tiles there, on terrain at the walk's first frame (timed,
   beside the launch floor and the two ``index_select`` gathers of whole
   rows the front ran before, on the same inputs) and there with
   ``wide_rows`` 64 and with half its pairs as ``wide_pairs`` (each cut);
   one moving front makes no host read (``set_sync_debug_mode("warn")``),
   and one moving fused frame and one 8-slab frame run under
   ``set_sync_debug_mode("error")``, each equal to the frame of the same
   camera through ``Renderer``; a moving frame launches K8 and K9 once, a
   cached static frame neither (``route_kernels``).  Every frame that
   computes a fused front launches K8 and K9; the fallback's front (phase
   14) launches K9, not K8;
29. the classic route's glue, kernels K8C, K10, K12 and K11
   (``geometry.transform_vertices``, on no frame path since the transform
   was folded into K10; ``geometry.stage_geometry_rows`` and
   ``geometry_rows``; ``binning.bin_rows``, ``shade.shade_pack_classic``;
   ``--classic-glue`` runs phases 1, 2 and 29 alone): each against its
   plain version on the card, bit for bit (clip and attribute rows; every
   TriangleSetup field, the combined attributes and the counters; every
   record, box, tile
   start and count and the pair counters, entry for entry; the RGBA8
   frame of K4's visibility buffer on K12's records), on the gate scene
   at 800x600 on three orbit frames (the first timed with CUDA events
   beside the plain chains, with the bounds, and binned again at
   ``max_pairs`` 128 and 100, which cut its pairs, the second inside a
   triangle's rectangle), the reference scene at
   320x240, two clipping scenes under "classic" (one within its budget,
   one over it), the ``ssaa_srgb`` and ``multi_material`` golden scenes
   under "classic", the second of two row slabs of the reference scene,
   and config4 subdiv 5 meshlet-packed with its local corner ids (K10's
   corner rows through K5); every frame EXACT against the port's oracle
   or its golden.  K10 runs with the transform folded in and on K8C's
   rows, each in both its designs (one thread block cluster and one
   cooperative grid, ``geometry.k10_design`` forced); K10 and K12 also on
   zero triangles (a clip budget of 0 and of 4096: S = 0 and S = 28,672
   dead rows), a gate slab from tile row 19 and the plain-packed config4
   frames at subdiv 4 and 5, either side of K10's crossover; the timed
   frames print each leg's ms beside the plain version's and the bound.
   One gate frame, every plain version raising, launches K10, K12, K4 and
   K11 once each and nothing else (``route_kernels``), K10 takes its
   cluster design there; a meshlet-packed classic frame launches K10
   twice around K5, K12, K4 and K11; the gate frame's device kernels a
   frame by ``torch.profiler``, in the first window of a new process,
   hold the port's launches over the same frames and are at most 5; and one whole classic frame runs under
   ``torch.cuda.set_sync_debug_mode("error")``.

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

T_START = time.perf_counter()  # this process's start: its age in readings

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
K4_WORDS_PER_REC = 16  # 14 int32 record words, inv_area2 and the box
K3F_OPS_PER_PX = 160  # phase F: 3 rsqrt_spec chains, powi, mip and tap math
# K3's 7 streamed ranges, in rmeta order
RANGE_NAMES = ("own", "above", "left", "diag", "wide", "pairs", "fine")


CARD = "card not read"  # the nvidia-smi name and power limit (phase 1)


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


# (source, kernel symbol, instantiations) whose ptxas report phase 2 holds
# to no stack frame and no spills
NO_FRAME_KERNELS = (("raster.cu", "raster_kernel", 4),
                    ("raster_classic.cu", "raster_classic_kernel", 1),
                    ("bincount.cu", "run_bounds_kernel", 1),
                    ("gather.cu", "gather_tile_kernel", 3),
                    ("shade_pack.cu", "shade_pack_kernel", 1),
                    ("shade_pack.cu", "shade_classic_kernel", 1),
                    ("transform.cu", "transform_kernel", 2),
                    ("geometry.cu", "vertex_kernel", 1),
                    ("geometry.cu", "tri_kernel", 2),
                    ("front_meta.cu", "front_meta_kernel", 1),
                    ("binning.cu", "bin_kernel", 1))


def check_frames(logs: dict) -> None:
    """ptxas's report: every kernel of ``NO_FRAME_KERNELS`` (K3 and K3F at
    8 and 4 rows, K4, K2, K5, K7, K11, K8 and K8C, K10's vertex pass and
    both designs of its triangle pass, K9, K12) must have
    no stack frame and no spills."""
    import re

    for src, kernel, want in NO_FRAME_KERNELS:
        name, seen = None, 0
        for line in logs[src].splitlines():
            if "Function properties for" in line:
                name = line.split("Function properties for", 1)[1].strip()
            elif name and kernel in name and "stack frame" in line:
                sizes = [int(v) for v in re.findall(r"(\d+) bytes", line)]
                require(sizes and not any(sizes),
                        f"ptxas: {name}: {line.strip()}")
                seen += 1
        require(seen == want, f"ptxas reported {seen} {kernel} "
                f"instantiations in {src}, not {want}")
        say(f"  ptxas {src}: no stack frame and no spills in {kernel} "
            f"({want} instantiation{'s' if want > 1 else ''})")


def fine_padding_renderer(dev):
    """The 150x64 frame of ``tests/test_torch_raster.py::
    test_fine_rows_only_touch_their_window``, built with the port's own
    scene and camera modules: three thin triangles (both windings) whose
    clamped pixel boxes fit one 16-px window, so they stream as fine rows,
    but whose true extent runs on into the padding columns 150-255 of the
    last tile.  Returns (fused-route Renderer, camera)."""
    import numpy as np

    from ash_renderer_tpu_torch.camera import Camera
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.renderer import Renderer
    from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject

    w, h, depth = 150, 64, 3.0
    tris = [((145.3, 17.2), (162.6, 18.4), (149.1, 22.7)),
            ((146.8, 9.1), (171.2, 11.3), (147.5, 14.6)),
            ((144.6, 1.4), (158.9, 6.2), (148.2, 6.9))]
    cam = Camera()
    vp = (cam.projection_matrix(w / h).astype(np.float64)
          @ cam.view_matrix().astype(np.float64))
    c0 = vp @ np.array([0.0, 0.0, depth, 1.0])
    inv = np.linalg.inv(vp)
    pos = []
    for tri in tris:
        for x, y in tri:
            p = inv @ np.array([(2 * x / w - 1) * c0[3],
                                (2 * y / h - 1) * c0[3], c0[2], c0[3]])
            pos.append(p[:3] / p[3])
    idx = np.arange(3 * len(tris)).reshape(-1, 3)
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=np.array(pos, np.float32),
        indices=np.concatenate([idx, idx[:, ::-1]]).astype(np.int32)))))
    st = RendererSettings(width=w, height=h, clip_budget=64, pipeline="fused")
    return Renderer(sc, st, device=dev), cam


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


TIMING_BATCHES = 3


def run_timed(fn, reps: int = 0):
    """``fn()``'s output and, with ``reps``, its CUDA-event ms per call: the
    median over ``TIMING_BATCHES`` batches of the mean over ``reps`` calls
    after the first (else None).  A sleep kernel ahead of each batch lets
    the host queue the calls before the card reaches them, so a kernel that
    runs faster than the host issues it is timed on the device, not on the
    host's issue rate; a host stall longer than the sleep leaves the card
    idle inside one batch, which the median sets aside.  (An event after
    every call would add its own few microseconds to each.)"""
    import torch

    out = fn()
    if not reps:
        return out, None
    means = []
    for _ in range(TIMING_BATCHES):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        means.append(a.elapsed_time(b) / reps)
    return out, sorted(means)[len(means) // 2]


def front_inputs(r, cam):
    """The tensors the kernels see for one frame of renderer ``r``."""
    import numpy as np
    import torch

    from ash_renderer_tpu_torch.ops import setup_kernel
    from ash_renderer_tpu_torch.oracle.raster_cpu import compose_mvp

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


def k3_key(kernel: str, cfg) -> str:
    """The key of K3 or K3F (``kernel``) in the timing and error dicts:
    ``kernel`` on the default 8-row tiles, with ``_t4`` on 4-row ones."""
    return kernel if cfg.tile_h == 8 else f"{kernel}_t{cfg.tile_h}"


def k3_slots(rmeta, tbl_sorted, tbl_ext, cfg):
    """(streamed slots per range, the slots' box pixels): the pixels each
    slot can cover (``fused_kernel.slot_pixel_boxes``), which is K3's
    phase V work whatever the kernel's design."""
    from ash_renderer_tpu_torch.ops import fused_kernel

    m = rmeta.reshape(-1, fused_kernel.N_RANGES, 2).long()
    per_range = (m[..., 1] - m[..., 0]).sum(0).tolist()
    _, _, box = fused_kernel.slot_pixel_boxes(rmeta, tbl_sorted, tbl_ext, cfg)
    return per_range, int(fused_kernel.box_pixels(box).sum())


def k3_work(rmeta, n_box_px, vis_t, planes, stats):
    """(bytes, ops) K3 needs at least for these inputs: the range meta, each
    streamed table row's 7 record words once, each winner's 48 fields once,
    vis_d, vis_t and planes written once; ops per pixel of each streamed
    slot's pixel box (``n_box_px``, from ``k3_slots``)."""
    import torch

    n_rows = stats["live_rows"] + stats["wide_pairs_n"]
    n_winners = int(torch.unique(vis_t[vis_t >= 0]).numel())
    n_bytes = (rmeta.numel() * 4 + n_rows * 7 * 4 + n_winners * 48 * 4
               + 2 * vis_t.numel() * 4 + planes.numel() * 4)
    return n_bytes, n_box_px * K3_OPS_PER_SLOT_PX


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
    if timed:
        # the launch floor: a kernel that does next to nothing, timed alike
        _, floor_ms = run_timed(lambda: torch.cuda._sleep(1), reps["K2"][0])
        say(f"{label}: K2 {k2_ms:.4f} ms, torch.searchsorted {lib2_ms:.4f} ms, "
            f"launch floor (torch.cuda._sleep(1)) {floor_ms:.4f} ms, bound "
            f"{ms['K2'][3][0]:.4f} ms ({n_keys} keys, {nb} bins)")

    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        r.statics, s, mm_t, mvp_t
    )
    k3 = k3_key("K3", cfg)
    (vd, vt, pl), k3_ms = run_timed(lambda: fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, cfg), reps["K3"][0])
    (vd_p, vt_p, pl_p), p3_ms = run_timed(
        lambda: fused_kernel.rasterize_distribute_plain(
            rmeta, tbl_sorted, tbl_ext, comb, cfg), reps["K3"][1])
    per_range, n_box = k3_slots(rmeta, tbl_sorted, tbl_ext, cfg)
    stats = {k: int(v) for k, v in stats.items()}
    ms[k3] = (k3_ms, p3_ms, None,
              bound_ms(*k3_work(rmeta, n_box, vt, pl, stats)))
    # background pixels carry NaN attributes whose payload bits are the
    # device's: planes are compared under the validity mask, and the
    # material / id / pad rows everywhere
    valid = (pl_p[:, fused_kernel.VIS_ROW, :] >= 0)[:, None, :]
    err3 = _max_err([
        (vd, vd_p), (vt, vt_p),
        (torch.where(valid, pl, 0), torch.where(valid, pl_p, 0)),
        (pl[:, 16:], pl_p[:, 16:]),
    ])
    require(err3 == 0, f"{k3} differs from its plain version ({label}): "
            f"{err3} ({int((vt != vt_p).sum())} winner ids differ)")
    for k, e in (("K1", err1), ("K2", err2), (k3, err3)):
        errs[k] = max(errs.get(k, 0), e)
    n_slots = sum(per_range)
    stats["fine_slots"] = per_range[fused_kernel.FINE_RANGE]
    say(f"{label}: K1, K2, {k3} bit-equal to plain; covered px "
        f"{int((vt >= 0).sum())}, clipped {stats['n_clipped']}, "
        f"wide {stats['n_wide']}, wide pairs {stats['wide_pairs_n']}, "
        f"live rows {stats['live_rows']}, K3 streamed slots {n_slots} ("
        + ", ".join(f"{k} {v}" for k, v in zip(RANGE_NAMES, per_range))
        + f"), box slot-pixels {n_box}, brute-force slot-pixels "
        f"{n_slots * cfg.tile_h * fused_kernel.TILE_W}")
    if timed:
        # phases D and E alone: no record streamed, every plane written
        zero = torch.zeros_like(rmeta)
        _, z_ms = run_timed(lambda: fused_kernel.rasterize_distribute(
            zero, tbl_sorted, tbl_ext, comb, cfg), reps["K3"][0])
        say(f"{label}: {k3} with rmeta zeroed {z_ms:.4f} ms (with the "
            f"records {k3_ms:.4f} ms)")
    return stats, (ms if timed else None)


FLYBY_FRAME = 12  # near closest approach: clip tail and wide pairs live


# key counts at csrc/bincount.cu's edges: 8 keys a thread, 256 a warp,
# 2048 a block
K2_EDGE_COUNTS = (0, 1, 7, 8, 9, 255, 256, 257, 2047, 2048, 2049)


def compare_k2_edges(dev, errs: dict) -> None:
    """K2 against its plain version at key counts on the kernel's chunk,
    warp and block edges, dense and sparse bins; a key view that starts
    off a 16-byte boundary must be refused with a ValueError."""
    import numpy as np
    import torch

    from ash_renderer_tpu_torch.ops import bincount

    rng = np.random.default_rng(6)
    err = 0
    for n in K2_EDGE_COUNTS:
        for nb in (5, 300, 24_302):
            keys = torch.from_numpy(np.sort(rng.integers(0, nb, n)).astype(
                np.int32)).to(dev)
            got = bincount.sorted_run_bounds(keys, nb)
            err = max(err, _max_err([(got, bincount.sorted_run_bounds_plain(keys, nb))]))
    require(err == 0, f"K2 differs from its plain version at an edge count: {err}")
    errs["K2"] = max(errs.get("K2", 0), err)
    keys = torch.arange(64, dtype=torch.int32, device=dev)
    try:
        bincount.sorted_run_bounds(keys[1:], 64)
    except ValueError as e:
        require("16-byte" in str(e), f"K2 misaligned keys: {e}")
    else:
        raise RuntimeError("K2 took a key view that is not 16-byte aligned")
    say(f"K2 bit-equal to plain at {len(K2_EDGE_COUNTS)} edge key counts x 3 "
        "bin counts; a misaligned key view raises ValueError")


# K5's widths: the two compiled ones (8, 12) and the run-time width's word
# (1, 3) and 16-byte (4, 32) copies
K5_EDGE_COLS = (1, 3, 4, 8, 12, 32)
# float32 NaN (quiet, signalling, negative with a payload), +-Inf, -0.0
K5_SPECIAL_WORDS = (0x7FC00000, 0x7F800001, 0xFFC12345, 0x7F800000,
                    0xFF800000, 0x80000000)
K5_BAD_IDS = (-1, 128, -2**31, 2**31 - 1)


def k5_edge_inputs(nf: int, n_m: int, rng, dev):
    """(tbl (n_m*128, nf), local_tri (n_m*128, 3)) int32 on ``dev``: random
    words with one in 8 a NaN / Inf / -0.0 pattern; one id in 5 from
    ``K5_BAD_IDS``; the last 5 triangles padding rows (0, 0, 0), as the
    meshlet builder pads."""
    import numpy as np
    import torch

    n = n_m * 128
    tbl = rng.integers(-2**31, 2**31, (n, nf), dtype=np.int64).astype(np.int32)
    flat = tbl.reshape(-1)
    at = rng.choice(flat.size, max(1, flat.size // 8), replace=False)
    special = np.array(K5_SPECIAL_WORDS, np.uint32).view(np.int32)
    flat[at] = special[rng.integers(0, special.size, at.size)]
    ids = rng.integers(0, 128, (n, 3)).astype(np.int32)
    bad = rng.random((n, 3)) < 0.2
    ids[bad] = np.array(K5_BAD_IDS, np.int32)[
        rng.integers(0, len(K5_BAD_IDS), int(bad.sum()))]
    ids[-5:] = 0
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(ids).to(dev)


def k5_edge_cases(dev):
    """[(label, tbl, local_tri)]: each width of ``K5_EDGE_COLS`` at 1, 2,
    wave + 1 (a block walks two meshlets) and 2 wave + 1 (three: a ring
    stage and an output tile reused) meshlets, where wave is K5's
    persistent grid at that width."""
    import numpy as np

    from ash_renderer_tpu_torch.ops import meshlet_gather

    rng = np.random.default_rng(7)
    cases = []
    for nf in K5_EDGE_COLS:
        wave = meshlet_gather.persistent_wave(nf, dev)
        for n_m in (1, 2, wave + 1, 2 * wave + 1):
            cases.append((f"F={nf} meshlets={n_m}",
                          *k5_edge_inputs(nf, n_m, rng, dev)))
    return cases


def compare_k5_edges(dev, errs: dict) -> None:
    """K5 against its plain version on ``k5_edge_cases``, bit for bit; a
    table view that starts 4 bytes off a 16-byte boundary must be refused
    with a ValueError."""
    import torch

    from ash_renderer_tpu_torch.ops import meshlet_gather

    cases = k5_edge_cases(dev)
    err = 0
    for label, tbl, lt in cases:
        got = meshlet_gather.gather_tri_rows(tbl, lt)
        e = _max_err([(got, meshlet_gather.gather_tri_rows_plain(tbl, lt))])
        require(e == 0, f"K5 differs from its plain version at {label}: {e}")
        err = max(err, e)
    errs["K5"] = max(errs.get("K5", 0), err)
    buf = torch.zeros(128 * 8 + 4, dtype=torch.int32, device=dev)
    lt = torch.zeros((128, 3), dtype=torch.int32, device=dev)
    try:
        meshlet_gather.gather_tri_rows(buf[1:1 + 128 * 8].view(128, 8), lt)
    except ValueError as e:
        require("16-byte" in str(e), f"K5 misaligned table: {e}")
    else:
        raise RuntimeError("K5 took a table view that is not 16-byte aligned")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = ", ".join(f"F={nf} {meshlet_gather.persistent_wave(nf, dev) // sms}"
                      for nf in K5_EDGE_COLS)
    say(f"K5 bit-equal to plain on {len(cases)} edge cases ({sms} SMs; blocks "
        f"per SM: {waves}); a misaligned table view raises ValueError")


def compare_flyby(r, label: str, errs: dict) -> None:
    """compare_kernels at the fly-by frame that clips and expands wide
    pairs; fails if that frame no longer exercises both."""
    stats, _ = compare_kernels(r, flyby_camera(FLYBY_FRAME, N_FRAMES), label,
                               errs)
    require(stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0,
            f"{label}: the frame neither clips nor expands wide pairs")


def raster_inputs(r, cam, label: str):
    """(the front's (rmeta, tbl_sorted, tbl_ext, comb, stats), shade mode,
    consts) of renderer ``r``'s frame at ``cam``: what K3 (shade mode
    None) and K3F take there.  Fails if ``r``'s settings route to phase
    E."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import shade

    s = r.state
    mm_t, mvp_t, _ = front_inputs(r, cam)
    atlas = s.atlas if r.statics.has_atlas else None
    light = s.light if r.statics.has_light else None
    smode = pipeline.shade_mode_for(r.statics, s.materials, atlas, light)
    require(smode is not None, f"{label}: the settings route to phase E")
    consts = shade.pack_shade_consts(
        smode, s.materials, atlas, light,
        torch.from_numpy(cam.position.astype("float32")).to(r.device))
    return pipeline.render_front(r.statics, s, mm_t, mvp_t), smode, consts


def compare_k3f(r, cam, label: str, errs: dict, timed: bool = False):
    """K3F (the raster kernel with phase F) against its plain version on
    the inputs the phase F path gives it for camera ``cam``; folds the max
    |kernel - plain| into ``errs``.  Returns the front's counters and, with
    ``timed``, (kernel ms, plain ms, None, (bound ms, bound by))."""
    import torch

    from ash_renderer_tpu_torch.ops import fused_kernel as fk

    cfg = r.cfg
    (rmeta, tbl_sorted, tbl_ext, comb, stats), smode, consts = raster_inputs(
        r, cam, label)
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
    name = k3_key("K3F", cfg)
    require(err == 0, f"{name} differs from its plain version ({label}): "
            f"{err} ({int((vt != vt_p).sum())} winner ids differ)")
    errs[name] = max(errs.get(name, 0), err)
    stats = {k: int(v) for k, v in stats.items()}
    v2 = valid[:, 0, :]
    say(f"{label}: {name} bit-equal to plain (shade mode {smode}); covered px "
        f"{int(v2.sum())}, lit {int((pl[:, fk.F_LIT][v2] != 0).sum())}, "
        f"textured {int((pl[:, fk.F_TEXMASK][v2] != 0).sum())}, clipped "
        f"{stats['n_clipped']}, wide pairs {stats['wide_pairs_n']}")
    if not timed:
        return stats, None
    n_bytes, n_ops = k3_work(rmeta, k3_slots(rmeta, tbl_sorted, tbl_ext, cfg)[1],
                             vt, pl, stats)
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


def classic_records(r, cam):
    """The classic frame of renderer ``r``'s scene for camera ``cam`` up to
    K4's inputs: (cfg, clip-space vertices, the meshlet-local corner ids or
    None, (rec_i, rec_f, rec_box, tile_start, tile_count), the geometry and
    binning counters)."""
    import torch

    from ash_renderer_tpu_torch.ops import binning, geometry

    s = r.state
    statics = classic_statics(r)
    cfg = statics.cfg
    mm_t, mvp_t, _ = front_inputs(r, cam)
    lt = (None if r.packed.local_tri is None
          else torch.from_numpy(r.packed.local_tri).to(r.device))
    clip, attrs = geometry.transform_vertices(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    su, _, gstats = geometry.geometry_device(
        clip, attrs, s.tri_v, s.tri_mat, cfg, r.settings.clip_budget,
        local_tri=lt)
    *recs, bstats = binning.bin_triangles(su, cfg, statics.settings.max_pairs)
    stats = {k: int(v) for k, v in {**gstats, **bstats}.items()}
    return cfg, clip, lt, recs, stats


def compare_classic(r, cam, label: str, errs: dict, timed: bool = False):
    """K4, and K5 where the scene is meshlet-packed, against their plain
    versions on the inputs the classic frame of renderer ``r``'s scene gives
    them for camera ``cam``; folds each max |kernel - plain| into ``errs``.
    Returns the geometry and binning counters and, with ``timed``, {kernel:
    (kernel ms, plain ms, library ms or None, (bound ms, bound by))}."""
    import torch

    from ash_renderer_tpu_torch.ops import geometry, meshlet_gather, raster_visibility

    cfg, clip, lt, (rec_i, rec_f, rec_box, start, count), stats = (
        classic_records(r, cam))
    reps = TIMING_REPS if timed else {k: (0, 0) for k in TIMING_REPS}
    ms = {}

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

    (vd, vt), k4_ms = run_timed(lambda: raster_visibility.rasterize_visibility(
        rec_i, rec_f, start, count, cfg, rec_box=rec_box), reps["K4"][0])
    (vd_p, vt_p), p4_ms = run_timed(
        lambda: raster_visibility.rasterize_visibility_plain(
            rec_i, rec_f, start, count, cfg), reps["K4"][1])
    n_rec = int(count.sum())
    n_box = int(raster_visibility.box_pixels(rec_box[0, :n_rec]).sum())
    n_px = cfg.grid_h * 16 * cfg.grid_w * 128
    # each live record's words once, the tile table, vis_d and vis_t over
    # the padded frame; operations per pixel of each live record's box
    ms["K4"] = (k4_ms, p4_ms, None, bound_ms(
        n_rec * K4_WORDS_PER_REC * 4 + count.numel() * 2 * 4 + 2 * n_px * 4,
        n_box * K4_OPS_PER_REC_PX))
    err4 = _max_err([(vd, vd_p), (vt, vt_p)])
    require(err4 == 0, f"K4 differs from its plain version ({label}): {err4} "
            f"({int((vt != vt_p).sum())} winner ids differ)")
    errs["K4"] = max(errs.get("K4", 0), err4)
    say(f"{label}: {'K4' if lt is None else 'K5, K4'} bit-equal to plain; covered px "
        f"{int((vt >= 0).sum())}, clipped {stats['n_clipped']}, valid "
        f"{stats['n_valid']}, pairs {stats['pairs_total']} (max per tile "
        f"{int(count.max())}), box record-pixels {n_box}, brute-force "
        f"record-pixels {n_rec * raster_visibility.N_PIX}")
    if timed:
        try:
            raster_visibility.rasterize_visibility(rec_i, rec_f, start, count, cfg)
        except ValueError as e:
            require("rec_box" in str(e), f"K4 without rec_box: {e}")
        else:
            raise RuntimeError("K4's CUDA path ran without rec_box")
        say(f"{label}: K4 {k4_ms:.4f} ms, bound {ms['K4'][3][0]:.4f} ms "
            f"({ms['K4'][3][1]}); without rec_box the CUDA path raises")
    return stats, (ms if timed else None)


def say_timing(card: str, timing: dict, label: str = "") -> None:
    """One line per kernel of a {kernel: (ms, plain ms, library ms or None,
    (bound ms, bound by))} dict."""
    for k, (kt, pt, lt, (bt, by)) in timing.items():
        say(f"[{card}] {k}{label}: kernel {kt:.4f} ms, plain torch {pt:.4f} ms, "
            f"library {'none' if lt is None else f'{lt:.4f} ms'}, "
            f"bound {bt:.4f} ms ({by})")


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


class Fallback:
    """``pipeline.render_frame_fused`` (the non-meshlet fused fallback) on
    a plain-packed upload of ``scene``, behind the ``Renderer``'s frame
    interface (``render_frame(camera, on_stage=)``, ``read_frame``), so
    ``frames_ms``, ``turns`` and ``stage_ms`` time it as they time a
    ``Renderer``.  The settings take the fused pipeline's statics."""

    def __init__(self, scene, settings, dev):
        import dataclasses

        import torch

        from ash_renderer_tpu_torch import state
        from ash_renderer_tpu_torch.renderer import frame_statics

        self.scene = scene
        self.device = torch.device(dev)
        self.settings = dataclasses.replace(settings, pipeline="fused")
        self.packed = scene.pack()
        self.state = state.upload(self.packed, scene.materials, scene.atlas,
                                  scene.light, self.device)
        self.statics = frame_statics(
            self.settings, self.packed.tri_v.shape[0],
            self.state.atlas is not None, self.state.light is not None)
        self.cfg = self.statics.cfg

    def inputs(self, cam):
        """(model, MVP, camera position) tensors of camera ``cam``."""
        import numpy as np
        import torch

        from ash_renderer_tpu_torch.oracle.raster_cpu import compose_mvp

        st = self.settings
        mm = np.ascontiguousarray(self.scene.model_matrices(), np.float32)
        mvp = compose_mvp(mm, cam.view_matrix(), cam.projection_matrix(
            st.render_width / st.render_height))
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (mm, mvp, cam.position.astype(np.float32)))

    def render_frame(self, cam, on_stage=None):
        from ash_renderer_tpu_torch import pipeline

        on_stage = on_stage or pipeline._no_stage
        mm_t, mvp_t, cam_t = self.inputs(cam)
        on_stage("mvp_upload")
        return pipeline.render_frame_fused(self.statics, self.state, mm_t,
                                           mvp_t, cam_t, on_stage=on_stage)

    def tables(self, cam):
        """(front tables (rmeta, tbl_sorted, tbl_ext, comb), shade mode,
        consts, counters) of camera ``cam``: what K3 or K3F sees."""
        from ash_renderer_tpu_torch import pipeline
        from ash_renderer_tpu_torch.ops import shade

        s, statics = self.state, self.statics
        mm_t, mvp_t, cam_t = self.inputs(cam)
        *tables, stats = pipeline.render_front_fallback(statics, s, mm_t, mvp_t)
        atlas = s.atlas if statics.has_atlas else None
        light = s.light if statics.has_light else None
        mode = pipeline.surface_mode(statics, s.materials, atlas, light)
        smode = pipeline.shade_mode_for(statics, s.materials, atlas, light)
        consts = shade.pack_shade_consts(mode, s.materials, atlas, light, cam_t)
        return tables, smode, None if smode is None else consts, stats

    @staticmethod
    def read_frame(rgba8):
        return rgba8.cpu().numpy()


def gate_scene():
    """bench.py's parity-gate scene (``parity_gate``: the same seed and
    shapes, built with the port's scene module): 160 random triangles over
    200 vertices at 256x192, one default material, no texture, no light,
    so "auto" takes phase F (K3F)."""
    import numpy as np

    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject

    rng = np.random.default_rng(5)
    nv, nt = 200, 160
    pos = rng.uniform(-2, 2, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.5
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=pos, indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32)))))
    return sc, RendererSettings(width=256, height=192)


def oracle_frame(r, cam):
    """(the port's numpy oracle frame of ``r``'s packed scene for camera
    ``cam``, seconds)."""
    import numpy as np

    from ash_renderer_tpu_torch.debugging import numpy_pack
    from ash_renderer_tpu_torch.oracle import render_oracle

    st, s = r.settings, r.state
    t0 = time.perf_counter()
    o = render_oracle(
        r.packed, np.asarray(r.scene.model_matrices(), np.float32),
        cam.view_matrix(),
        cam.projection_matrix(st.render_width / st.render_height), st,
        materials=numpy_pack(s.materials),
        atlas=None if s.atlas is None else numpy_pack(s.atlas),
        light=None if s.light is None else numpy_pack(s.light),
        camera_pos=cam.position.astype(np.float32), cfg=r.cfg)
    return o, time.perf_counter() - t0


def compare_raster(tables, cfg, smode, consts, label: str, errs: dict):
    """K3 (``smode`` None) or K3F against its plain version on one set of
    front tables, by ``compare_kernels``' rule: vis_d and vis_t exactly,
    the plane rows of covered pixels, and the material / id / pad rows
    (K3F: the rows after its texture mask) everywhere.  Folds the max
    |kernel - plain| into ``errs``; returns the kernel's vis_t."""
    import torch

    from ash_renderer_tpu_torch.ops import fused_kernel as fk

    vd, vt, pl = fk.rasterize_distribute(*tables, cfg, smode, consts)
    vd_p, vt_p, pl_p = fk.rasterize_distribute_plain(*tables, cfg, smode, consts)
    valid = (pl_p[:, fk.VIS_ROW, :] >= 0)[:, None, :]
    exact = 16 if smode is None else fk.F_TEXMASK + 1
    err = _max_err([
        (vd, vd_p), (vt, vt_p),
        (torch.where(valid, pl, 0), torch.where(valid, pl_p, 0)),
        (pl[:, exact:], pl_p[:, exact:]),
    ])
    k = k3_key("K3" if smode is None else "K3F", cfg)
    require(err == 0, f"{k} differs from its plain version ({label}): {err} "
            f"({int((vt != vt_p).sum())} winner ids differ)")
    errs[k] = max(errs.get(k, 0), err)
    say(f"{label}: {k} bit-equal to plain on the fallback's tables; covered "
        f"px {int((vt >= 0).sum())}")
    return vt


def comb_k5_check(r, cam, errs: dict, timed: bool = False):
    """``tritables.build_comb_table`` through K5 at F = 12 on renderer
    ``r``'s meshlet-packed scene: ``geometry_device(..., local_tri=)`` (K5
    at F = 8), then ``build_comb_table(..., local_tri=)`` (K5 at F = 12),
    with the launch counts zeroed just before and read just after.  Its
    comb must equal the row-gather branch's on every valid row and on
    every row in the setup and id columns (dead rows' attribute columns
    differ by design: zeroed vertex ids gather vertex 0), and K1's comb
    on the real rows of alive meshlets (dead meshlets zero-filled).  Then
    K5 at this call site against its plain version and ``tbl[idx]``.
    Returns (launch counts, {"K5_F12": (ms, plain ms, library ms,
    (bound ms, by))} with ``timed``)."""
    import torch

    from ash_renderer_tpu_torch import _build
    from ash_renderer_tpu_torch import specmath as sm
    from ash_renderer_tpu_torch.ops import (geometry, meshlet_gather,
                                            setup_kernel, tritables)

    s, cfg = r.state, r.cfg
    mm_t, mvp_t, tblT = front_inputs(r, cam)
    lt = torch.from_numpy(r.packed.local_tri).to(r.device)
    torch.cuda.synchronize()
    _build.launches.clear()
    clip, attrs = geometry.transform_vertices(
        s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    su, attrs_full, _ = geometry.geometry_device(
        clip, attrs, s.tri_v, s.tri_mat, cfg, r.settings.clip_budget,
        local_tri=lt)
    comb = tritables.build_comb_table(su, attrs_full, cfg, local_tri=lt)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    say(json.dumps(counts, sort_keys=True))
    for k in ("K5_gather_rows", meshlet_gather.launch_name(12)):
        require(counts.get(k, 0) > 0, f"{k} was not launched in phase 15")

    plain = tritables.build_comb_table(su, attrs_full, cfg)
    valid = su.valid
    require(int(valid.sum()) > 0, "phase 15: no valid row")
    err = _max_err([(comb[valid], plain[valid]), (comb[:, :10], plain[:, :10]),
                    (comb[:, 46:], plain[:, 46:])])
    require(err == 0, f"build_comb_table: the K5 branch differs from the "
            f"row-gather branch: {err}")
    t = lt.shape[0]
    comb_k1, _, flags, _, _ = setup_kernel.triangle_setup(
        tblT, s.ltT, s.matT, cfg,
        tail_rows=r.settings.clip_budget * geometry.MAX_CLIP_TRIS)
    alive = ((flags.reshape(-1, 128) & 3) != 0).any(1).repeat_interleave(128)
    real = (s.tri_v[:, 0] >= 0) & alive
    err1 = _max_err([(comb_k1[:t][real], comb[:t][real])])
    require(err1 == 0, f"build_comb_table: K1's comb differs on alive rows: {err1}")
    require(not bool(comb_k1[:t][~alive].any()), "K1: a dead meshlet not zero-filled")
    say(f"build_comb_table (K5 at F = 12): {comb.shape[0]} rows, {int(valid.sum())} "
        f"valid; equal to the row-gather branch on valid rows and the setup and "
        f"id columns, and to K1's comb on {int(real.sum())} real rows of "
        f"{int(alive.sum()) // 128} alive meshlets")
    del plain, comb_k1

    v_main = (t // 128) * 128
    tbl = sm.bitcast_i32(attrs_full[:v_main])
    reps = TIMING_REPS["K5"] if timed else (0, 0)
    g, k_ms = run_timed(lambda: meshlet_gather.gather_tri_rows(tbl, lt), reps[0])
    g_p, p_ms = run_timed(lambda: meshlet_gather.gather_tri_rows_plain(tbl, lt),
                          reps[1])
    idx = torch.arange(t, device=lt.device)[:, None] // 128 * 128 + lt.long()
    g_lib, lib_ms = run_timed(lambda: tbl[idx].reshape(t, -1), reps[1])
    e5 = _max_err([(g, g_p), (g, g_lib)])
    require(e5 == 0, f"K5 at F = 12 differs from its plain version: {e5}")
    errs["K5_F12"] = max(errs.get("K5_F12", 0), e5)
    n5 = t * 3 * tbl.shape[1]
    timing = {"K5_F12": (k_ms, p_ms, lib_ms, bound_ms(
        (tbl.numel() + lt.numel() + n5) * 4, n5))} if timed else None
    say(f"K5 at F = 12 (build_comb_table's call site, {tuple(tbl.shape)} table): "
        "bit-equal to plain and tbl[idx]")
    return counts, timing


def fallback_checks(dev, card, errs: dict, head5, head8):
    """Phase 14: the non-meshlet fused fallback (``render_frame_fused``) on
    plain-packed uploads.  With the launch counts zeroed just before and
    read just after: bench.py's gate scene, the five pinned golden scenes
    and the config4 frames of ``head5`` and ``head8`` ((scene, settings,
    camera, golden)) under "off" (K3) and "on" (K3F).  Then: the gate
    frame equals
    the port's oracle and the CPU frame; every golden holds; K3 / K3F
    equal their plain versions on the fallback's own tables; the head8
    frame's ms beside the staged route's, in turns.
    Returns (launch counts, the head8 "off" frame's aux, its Fallback)."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch import _build
    from ash_renderer_tpu_torch.benchmarks import GOLDEN_SCENES, GOLDEN_SHA
    from ash_renderer_tpu_torch.camera import Camera
    from ash_renderer_tpu_torch.renderer import Renderer

    scene_g, st_g = gate_scene()
    fbg = Fallback(scene_g, st_g, dev)
    fb_gold = {name: Fallback(*build(), dev) for name, build in GOLDEN_SCENES.items()}
    heads = []
    for sub, (scene, st, cam, g) in (("5", head5), ("8", head8)):
        for knob in ("off", "on"):
            heads.append((f"subdiv-{sub} {knob}", Fallback(
                scene, dataclasses.replace(st, fused_surface_shade=knob), dev),
                cam, g))
    torch.cuda.synchronize()
    _build.launches.clear()
    fgate, aux_g = fbg.render_frame(Camera())
    fgate = fbg.read_frame(fgate)
    f_gold = {name: fb.read_frame(fb.render_frame(Camera())[0])
              for name, fb in fb_gold.items()}
    f_head = {}
    for label, fb, cam, _ in heads:
        f, aux = fb.render_frame(cam)
        f_head[label] = (fb.read_frame(f), aux)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    say(json.dumps(counts, sort_keys=True))
    for k in ("K2_run_bounds", "K3_raster", "K3F_raster_shade",
              "K9_front_meta", "K10_geometry"):
        require(counts.get(k, 0) > 0, f"{k} was not launched in phase 14")
    # the fallback's transform and setup are the classic route's: K10 with
    # the transform folded in
    for k in ("K1_setup", "K5_gather_rows", "K8_vertex_transform",
              "K8C_vertex_transform_rows"):
        require(counts.get(k, 0) == 0, f"{k} ran on the fallback route")

    covered = int((aux_g["vis_tri"] >= 0).sum())
    require(covered > 0, "gate scene: no covered pixel")
    o_gate, o_s = oracle_frame(fbg, Camera())
    require((fgate == o_gate["rgba8"]).all(),
            "gate scene: card frame != the port's oracle frame")
    fcpu = Fallback(scene_g, st_g, "cpu")
    require((fgate == fcpu.read_frame(fcpu.render_frame(Camera())[0])).all(),
            "gate scene: card frame != CPU frame")
    say(f"bench.py gate scene 256x192 (160 tris, fallback, K3F): card frame == "
        f"port oracle == CPU frame, covered {covered} px (oracle {o_s:.2f} s)")
    for name, f in f_gold.items():
        require(sha(f) == GOLDEN_SHA[name], f"fallback {name}: frame != golden")
        say(f"{name} {f.shape[1]}x{f.shape[0]} (fallback): golden sha256 EXACT")
    for label, _, _, g in heads:
        f, aux = f_head[label]
        require(sha(f) == g["sha256"], f"fallback {label}: frame != golden")
        say(f"fallback {label} ({int(aux['n_valid'])} valid setup rows, "
            f"{int(aux['live_rows'])} live rows): golden sha256 EXACT")
    aux8 = f_head["subdiv-8 off"][1]
    del f_gold, f_head, fb_gold, fcpu

    # K3 / K3F on the fallback's own tables, outside the counted run
    fly = flyby_camera(FLYBY_FRAME, N_FRAMES)
    fbs = {label: fb for label, fb, _, _ in heads}
    for label, fb, cam in (("gate scene", fbg, Camera()),
                           ("subdiv 8 off, static", fbs["subdiv-8 off"], head8[2]),
                           ("subdiv 8 on, static", fbs["subdiv-8 on"], head8[2]),
                           ("subdiv 5 off, fly-by", fbs["subdiv-5 off"], fly),
                           ("subdiv 5 on, fly-by", fbs["subdiv-5 on"], fly)):
        tables, smode, consts, stats = fb.tables(cam)
        compare_raster(tables, fb.cfg, smode, consts, f"fallback {label}", errs)
        if "fly-by" in label:
            require(int(stats["n_clipped"]) > 0 and int(stats["wide_pairs_n"]) > 0,
                    f"fallback {label}: the frame neither clips nor expands "
                    "wide pairs")
        del tables
    fb8 = fbs["subdiv-8 off"]
    del heads, fbs

    # frame ms beside the staged route's, in turns
    scene8, st8, cam8, _ = head8
    r8u = Renderer(scene8, dataclasses.replace(
        st8, front_coherence=False, fused_surface_shade="off"), device=dev)
    legs = (("staged", r8u), ("fallback", fb8))
    for name, r in legs + legs[::-1]:
        med, mean, worst = frames_ms(r, [cam8] * N_FRAMES)
        say(f"[{card}] frame ms, subdiv 8 static uncached off, {name}: median "
            f"{med:.3f}, mean {mean:.3f}, max {worst:.3f} ({N_FRAMES} frames)")
    del r8u
    stage_ms(fb8, cam8)  # warm-up
    say(f"[{card}] stage ms (subdiv 8 fallback, static): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms(fb8, cam8).items()))
    return counts, aux8, fb8


def debug_checks(dev, card, oracle_cases, auxes, fb, cam) -> None:
    """Phase 16: ``debugging.compare_with_oracle`` is pixel-exact on each
    (label, Renderer, camera) of ``oracle_cases``; ``validate_frame`` on
    each (label, aux) of ``auxes`` finds the frame clean; ``profiling.trace``
    around one frame of the Fallback ``fb`` writes a trace under build/;
    a ``profiling.Timer`` on ``dev`` reads each stage of that frame > 0."""
    from ash_renderer_tpu_torch import debugging, pipeline, profiling

    for label, r, c in oracle_cases:
        t0 = time.perf_counter()
        found = [str(f) for f in debugging.compare_with_oracle(r, c)]
        require(found == ["[INFO][oracle] pixel-exact match"],
                f"{label}: compare_with_oracle: {found}")
        say(f"{label}: compare_with_oracle pixel-exact ({r.cfg.width}x"
            f"{r.cfg.height}, {r.packed.num_triangles} tris; "
            f"{time.perf_counter() - t0:.2f} s for the numpy oracle's frame "
            "and one card frame)")
    for label, aux in auxes:
        found = [str(f) for f in debugging.validate_frame(aux)]
        require(found == ["[INFO][ok] frame clean"],
                f"validate_frame ({label}): {found}")
    say("validate_frame on the headline aux (" + ", ".join(
        label for label, _ in auxes) + "): frame clean")

    path = os.path.join(ROOT, "build", "traces", "fallback_frame.json")
    with profiling.trace(path, device=dev) as prof:
        fb.render_frame(cam)
    require(os.path.getsize(path) > 0, f"empty trace {path}")
    ops = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in ops)
    say(f"profiling.trace: {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} "
        f"bytes); device self time {dev_us / 1e3:.3f} ms over {len(ops)} ops")

    timer = profiling.Timer(device=dev)
    mm_t, mvp_t, cam_t = fb.inputs(cam)
    with timer.scope("front"):
        *tables, stats = pipeline.render_front_fallback(fb.statics, fb.state,
                                                        mm_t, mvp_t)
    with timer.scope("raster_shade"):
        pipeline._raster_shade(fb.statics, fb.state, tables, cam_t, stats,
                               pipeline._no_stage)
    times = timer.times
    require(set(times) == {"front", "raster_shade"}
            and all(v > 0 for v in times.values()), f"profiling.Timer: {times}")
    say(f"[{card}] profiling.Timer on {dev}, fallback frame: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in times.items()))


def decode_png(path: str):
    """An 8-bit RGBA PNG as (H, W, 4) uint8, with the standard library's
    inflate and the five row filters undone: the frame a user of
    ``app.main`` gets, or a stored golden, read back without PIL."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            require((depth, ctype, interlace) == (8, 6, 0),
                    f"{path}: not 8-bit RGBA without interlace")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    out = np.zeros((h + 1, 4 * (w + 1)), np.int32)  # a zero row and pixel
    for y in range(h):
        raw, up = rows[y, 1:].astype(np.int32), out[y, 4:]
        cur = out[y + 1]
        kind = int(rows[y, 0])
        if kind in (0, 2):
            cur[4:] = (raw + (up if kind == 2 else 0)) & 255
        elif kind == 1:  # Sub: a running sum per channel
            cur[4:] = np.cumsum(raw.reshape(w, 4), axis=0).reshape(-1) & 255
        elif kind in (3, 4):  # Average, Paeth: pixel after pixel
            for x in range(4, 4 * w + 4, 4):
                a, b, c = cur[x - 4:x], out[y, x:x + 4], out[y, x - 4:x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + 4] = (raw[x - 4:x] + pred) & 255
        else:
            require(False, f"{path}: row filter {kind}")
    return out[1:, 4:].astype(np.uint8).reshape(h, w, 4)


# scripted input for the App runs of phase 17: every key, both mouse axes
APP_EVENTS = (dict(forward=True), dict(mouse_dx=3.0, right=True),
              dict(left=True, mouse_dy=-2.0, backward=True))


def replay_cameras(cam0, events, speed=0.01, mouse_sens=0.01):
    """The camera after each event of ``events`` (dicts of InputEvent
    fields), replayed from a copy of ``cam0`` through a fresh
    CameraController: the cameras App.run draws."""
    import dataclasses

    from ash_renderer_tpu_torch.camera import CameraController

    cam = dataclasses.replace(cam0, position=cam0.position.copy())
    ctl = CameraController(speed=speed, mouse_sens=mouse_sens)
    out = []
    for ev in events:
        ctl.forward_pressed = ev.get("forward", False)
        ctl.backward_pressed = ev.get("backward", False)
        ctl.left_pressed = ev.get("left", False)
        ctl.right_pressed = ev.get("right", False)
        ctl.process_mouse(ev.get("mouse_dx", 0.0), ev.get("mouse_dy", 0.0))
        ctl.update_camera(cam)
        out.append(dataclasses.replace(cam, position=cam.position.copy()))
    return out


def app_fps(card: str, label: str, scene, settings, dev, n: int) -> None:
    """``n`` frames of App.run (events cycling APP_EVENTS) after a
    two-frame warm-up run: FrameStats' host-loop fps and the wall-clock fps
    up to the drained ring; then the stage ms of one frame at a camera the
    front cache has not seen."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch.app import App, InputEvent

    a = App(scene, settings, device=dev)
    a.run(2)
    torch.cuda.synchronize()
    a.renderer.stats.frame_times.clear()
    events = [InputEvent(**APP_EVENTS[i % len(APP_EVENTS)]) for i in range(n)]
    t0 = time.perf_counter()
    stats = a.run(n, events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"[{card}] App.run {label}: {n} frames, FrameStats fps "
        f"{stats.fps:.2f}, wall {n / wall:.2f} fps ({wall * 1e3 / n:.2f} ms "
        f"a frame, ring drained); last frame's counters {stats.summary()}")
    # where a moving frame's time goes (each camera new to the front cache)
    cam = a.camera
    for dtheta in (0.01, 0.02):
        stages = stage_ms(a.renderer, dataclasses.replace(
            cam, theta=cam.theta + dtheta))
    say(f"[{card}] stage ms ({label}, moving): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))


def untextured_gltf(path: str) -> None:
    """Write a glTF (external .bin) of an icosphere (subdiv 4, 5,120
    triangles, untextured, vertex colours and normals) under a node with a
    translation and a rotation, and one coloured material."""
    import numpy as np

    from ash_renderer_tpu_torch.models import icosphere

    m = icosphere(4, 1.2)
    n = m.num_vertices
    col = np.stack([0.5 + 0.5 * np.sin(np.arange(n) * 0.05),
                    0.5 + 0.5 * np.cos(np.arange(n) * 0.07),
                    np.linspace(0.2, 1.0, n)], axis=1).astype(np.float32)
    blobs = [m.positions, m.normals, col, m.indices.astype(np.uint32)]
    data, views = b"", []
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": len(data),
                      "byteLength": b.nbytes})
        data += b.tobytes()
    acc = [{"bufferView": i, "componentType": ct, "count": c, "type": t}
           for i, (ct, c, t) in enumerate(((5126, n, "VEC3"), (5126, n, "VEC3"),
                                           (5126, n, "VEC3"),
                                           (5125, m.indices.size, "SCALAR")))]
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
           "nodes": [{"mesh": 0, "translation": [0.2, -0.1, 0.3],
                      "rotation": [0.0, 0.3826834, 0.0, 0.9238795]}],
           "meshes": [{"primitives": [{"attributes": {
               "POSITION": 0, "NORMAL": 1, "COLOR_0": 2}, "indices": 3,
               "material": 0}]}],
           "materials": [{"pbrMetallicRoughness": {
               "baseColorFactor": [0.9, 0.8, 0.7, 1.0]}}],
           "accessors": acc, "bufferViews": views,
           "buffers": [{"uri": os.path.basename(path) + ".bin",
                        "byteLength": len(data)}]}
    with open(path + ".bin", "wb") as f:
        f.write(data)
    with open(path, "w") as f:
        json.dump(doc, f)


def app_checks(dev, card: str, ref_golden: str) -> dict:
    """Phase 17: the app, the asset loaders and serialization on the card.
    ``app.main`` without ``--device`` renders config4_terrain and the
    reference scene at 320x240 (launch counts zeroed just before and read
    just after: the kernels of the route "auto" takes on the card,
    ``route_kernels``) to PNGs that decode to their goldens; config1
    (its OBJ through the native parser) runs App.run over scripted input
    with every presented frame equal to the port's oracle at the
    controller's camera, then self-recovers a resize and takes a mesh edit;
    an untextured glTF through ``main`` equals the oracle; config5 frame 0
    survives a save_scene / load_scene round trip byte for byte and equals
    the oracle; App.run fps for terrain and config1.  Returns the terrain
    run's launch counts."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from ash_renderer_tpu_torch import _build, app, benchmarks, native
    from ash_renderer_tpu_torch import serialization
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.models import load_gltf
    from ash_renderer_tpu_torch.models.obj import load_obj_python, save_obj
    from ash_renderer_tpu_torch.present import FrameCollector
    from ash_renderer_tpu_torch.renderer import Renderer
    from ash_renderer_tpu_torch.scene import Mesh

    out = os.path.join(ROOT, "build", "app")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    # config4_terrain through the CLI, on the card by default
    scene_t, st_t, _ = benchmarks.config4_terrain()
    gt = golden("headline_terrain.json")
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    paths = app.main(["config4_terrain", "--frames", "1", "--out",
                      os.path.join(out, "terrain")])
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    counts = dict(_build.launches)
    say(json.dumps(counts, sort_keys=True))
    route_t = require_route("app.main config4_terrain", counts,
                            Renderer(scene_t, st_t, device=dev))
    ft = decode_png(paths[0])
    covered = int((ft[..., :3] != 0).any(axis=-1).sum())
    require(sha(ft) == gt["sha256"], f"terrain: app.main frame sha256 "
            f"{sha(ft)} != golden {gt['sha256']}")
    say(f"app.main config4_terrain ({gt['n_tris']} tris, {ft.shape[1]}x"
        f"{ft.shape[0]}, {covered} non-black px, {route_t}): PNG decodes "
        "to the golden "
        f"sha256 EXACT ({t_main:.1f} s: scene, meshlets, upload, frame, PNG)")

    # the reference scene through the CLI, on the route "auto" takes
    _build.launches.clear()
    paths = app.main(["reference", "--size", "320x240", "--out",
                      os.path.join(out, "reference")])
    torch.cuda.synchronize()
    counts_r = dict(_build.launches)
    scene_r, st_r, _ = benchmarks.ALL_CONFIGS["reference"]()
    route_r = require_route("app.main reference", counts_r, Renderer(
        scene_r, dataclasses.replace(st_r, width=320, height=240), device=dev))
    fr = decode_png(paths[0])
    require(sha(fr) == ref_golden, "reference 320x240: app.main frame != golden")
    say(f"app.main reference 320x240 ({route_r}, launches "
        f"{json.dumps(counts_r, sort_keys=True)}): PNG decodes to the golden "
        "sha256 EXACT")

    # config1: the OBJ through the native parser, then App.run
    require(native.available(), "no host C++ compiler for the OBJ parser")
    scene1, st1, cams1 = benchmarks.config1_textured_obj()
    obj_path = os.path.join(out, "sphere.obj")
    save_obj(obj_path, scene1.meshes[0])
    parsed = native.parse_obj(obj_path)
    slow = load_obj_python(obj_path, compute_normals_if_missing=False)
    for got, k in zip(parsed, ("positions", "uvs", "normals", "indices")):
        require(np.array_equal(got, getattr(slow, k)),
                f"native.parse_obj != load_obj_python ({k})")
    events = [dict(e) for e in APP_EVENTS]
    a1 = app.App(scene1, st1, device=dev)
    require(a1.renderer.settings.pipeline == "fused", "config1 is not fused")
    coll = FrameCollector()
    a1.run(len(events), [app.InputEvent(**e) for e in events], on_present=coll)
    cams = replay_cameras(cams1[0], events)
    require(len(coll.frames) == len(events), "config1: frames missing")
    for i, (f, cam) in enumerate(zip(coll.frames, cams)):
        o, o_s = oracle_frame(a1.renderer, cam)
        require((f == o["rgba8"]).all(),
                f"config1 App.run frame {i} != the port's oracle")
    require(np.array_equal(a1.camera.position, cams[-1].position),
            "config1: the App's camera != the replayed controller's")
    say(f"config1 ({scene1.meshes[0].num_triangles} tris via native.parse_obj, "
        f"{st1.width}x{st1.height}, fused): App.run over {len(events)} scripted "
        f"events, every presented frame == the port's oracle ({o_s:.2f} s a "
        "frame)")
    # a resize event mid-run: recovered inside draw_frame
    a1.request_resize(640, 480)
    coll = FrameCollector()
    a1.step(app.InputEvent(), on_present=coll)
    a1.renderer.finish()
    require(coll.frames[-1].shape == (480, 640, 4), "resize: wrong frame size")
    fresh = Renderer(scene1, dataclasses.replace(st1, width=640, height=480),
                     device=dev)
    require((coll.frames[-1] == fresh.read_frame(
        fresh.render_frame(a1.camera)[0])).all(),
        "resize: frame != a fresh Renderer's at 640x480")
    # a mesh edit
    m = scene1.meshes[0]
    edited = Mesh(positions=m.positions * np.float32(0.7), indices=m.indices,
                  normals=m.normals, uvs=m.uvs, colors=m.colors)
    before = a1.renderer.read_frame(a1.renderer.render_frame(a1.camera)[0])
    a1.renderer.update_mesh(0, edited)
    after = a1.renderer.read_frame(a1.renderer.render_frame(a1.camera)[0])
    s2, _, _ = benchmarks.config1_textured_obj()
    s2.meshes[0] = edited
    fresh = Renderer(s2, dataclasses.replace(st1, width=640, height=480),
                     device=dev)
    require((after == fresh.read_frame(fresh.render_frame(a1.camera)[0])).all()
            and not (after == before).all(),
            "update_mesh: frame != a fresh Renderer's on the edited scene")
    say("config1: request_resize(640, 480) recovered in draw_frame == fresh "
        "Renderer; update_mesh == fresh Renderer on the edited mesh")
    del a1, fresh

    # an untextured glTF through the CLI (5,120 tris: fused, phase F)
    gpath = os.path.join(out, "ico.gltf")
    untextured_gltf(gpath)
    gout = os.path.join(out, "gltf")
    paths = app.main([gpath, "--size", "320x240", "--frames", "2", "--out",
                      gout])
    rg = Renderer(load_gltf(gpath), RendererSettings(width=320, height=240),
                  device=dev)
    for p, cam in zip(paths, orbit_path(2, radius=4.0)):
        f = decode_png(p)
        require(int(f[..., :3].max()) > 0, "glTF: black frame")
        require((f == oracle_frame(rg, cam)[0]["rgba8"]).all(),
                f"glTF {os.path.basename(p)} != the port's oracle")
    say(f"app.main on an untextured glTF (5120 tris, 320x240, "
        f"{rg.settings.pipeline}): 2 orbit frames == the port's oracle")
    del rg

    # config5 frame 0 across save_scene / load_scene
    scene5, st5, cams5 = benchmarks.config5_flythrough()
    r5 = Renderer(scene5, st5, device=dev)
    f5 = r5.read_frame(r5.render_frame(cams5[0])[0])
    npz = os.path.join(out, "config5.npz")
    serialization.save_scene(npz, scene5, cams5)
    back, back_cams = serialization.load_scene(npz)
    require(len(back_cams) == len(cams5), "config5: cameras lost")
    rb = Renderer(back, st5, device=dev)
    fb = rb.read_frame(rb.render_frame(cams5[0])[0])
    require((fb == f5).all(), "config5: frame 0 differs after load_scene")
    o5, o_s = oracle_frame(r5, cams5[0])
    require((f5 == o5["rgba8"]).all(), "config5 frame 0 != the port's oracle")
    say(f"config5 frame 0 ({sum(mm.num_triangles for mm in scene5.meshes)} "
        f"tris, {st5.width}x{st5.height} ss {st5.supersample}): byte-equal "
        f"after save_scene / load_scene, == the port's oracle ({o_s:.2f} s)")
    del r5, rb

    # frame rates through App.run
    for label, sc, st in (("config4_terrain", scene_t, st_t),
                          ("config1", scene1, st1)):
        app_fps(card, f"{label} {st.width}x{st.height}", sc, st, dev, N_FRAMES)
    torch.cuda.synchronize()
    return counts


def diffrender_checks(dev, card: str) -> None:
    """Phase 18: diffrender on the card, on examples/inverse_rendering.py's
    scene (icosphere subdiv 3 at z = 3, seeded colours, 128x128).  The
    classic pipeline's visibility on the card (K4) equals the port's
    visibility oracle; shade_params_fn's forward on the card equals the
    CPU's bit for bit, unlit and lit; gradients of a weighted image mean
    with respect to vertex colours, base colour, specular and the light
    equal the CPU's within rtol 1e-4 / atol 1e-6 (NaNs in the same
    places); fit_to_image converges as on the CPU; ms per step."""
    import dataclasses

    import numpy as np
    import torch

    from ash_renderer_tpu_torch import _build, diffrender, mathx
    from ash_renderer_tpu_torch.camera import Camera
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.models import icosphere
    from ash_renderer_tpu_torch.oracle import geometry_oracle, visibility_oracle
    from ash_renderer_tpu_torch.renderer import Renderer
    from ash_renderer_tpu_torch.rtypes import (LightPack, MaterialsPack,
                                               TriangleSetup)
    from ash_renderer_tpu_torch.scene import Scene, SceneObject

    rng = np.random.default_rng(0)
    mesh = icosphere(3)
    colors = rng.uniform(0.1, 1.0, (mesh.num_vertices, 4)).astype(np.float32)
    colors[:, 3] = 1.0
    mesh.colors = colors
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh),
                                 model=mathx.translation([0, 0, 3])))
    cam = Camera()
    # "classic" named: diffrender takes the classic route's visibility,
    # whatever "auto" takes for a frame of this scene
    r = Renderer(scene, RendererSettings(width=128, height=128, clip_budget=64,
                                         pipeline="classic"), device=dev)
    _build.launches.clear()
    _, aux = r.render_frame(cam)
    vis_card = aux["vis_tri"].cpu().numpy()
    require(_build.launches.get("K4_raster_classic", 0) > 0, "K4 not launched")
    su, attrs = geometry_oracle(scene.pack(), scene.model_matrices(),
                                cam.view_matrix(), cam.projection_matrix(1.0),
                                r.cfg, 64)
    _, vis_o = visibility_oracle(su, r.cfg)
    require(np.array_equal(vis_card, vis_o),
            "diffrender: the card's classic vis_tri != visibility_oracle's")
    say(f"diffrender scene (icosphere 3, 128x128): the card's vis_tri (K4) == "
        f"visibility_oracle ({int((vis_o >= 0).sum())} covered px)")

    nv = attrs.shape[0]
    lit = dict(light=(np.array([0.3, -0.6, 0.75], np.float32),
                      np.array([1.0, 0.95, 0.9], np.float32),
                      np.array(0.15, np.float32)),
               camera_pos=cam.position.astype(np.float32))

    def make(device, with_light):
        def t(a):
            return torch.from_numpy(np.array(a)).to(device)

        s = TriangleSetup(**{f.name: t(getattr(su, f.name))
                             for f in dataclasses.fields(TriangleSetup)})
        mats = MaterialsPack(t(np.full((1, 4), 0.9, np.float32)),
                             t(np.full(1, -1, np.int32)),
                             t(np.full(1, 0.4, np.float32)),
                             t(np.full(1, 16, np.int32)))
        light = LightPack(*map(t, lit["light"])) if with_light else None
        fn = diffrender.shade_params_fn(
            t(vis_card), s, t(attrs), r.cfg, mats, light=light,
            camera_pos=lit["camera_pos"] if with_light else None)
        return fn, mats, light, t(attrs)

    wts = np.random.default_rng(1).uniform(0.5, 1.5, (128, 128, 3)).astype(
        np.float32)
    for with_light in (False, True):
        grads, imgs = {}, {}
        for device in ("cpu", dev):
            fn, mats, light, at = make(device, with_light)
            leaves = {"vc": at[:, :4].clone().requires_grad_(True),
                      "base": mats.base_color.clone().requires_grad_(True),
                      "spec": mats.specular.clone().requires_grad_(True)}
            p = {"vertex_colors": leaves["vc"], "materials": dataclasses.replace(
                mats, base_color=leaves["base"], specular=leaves["spec"])}
            if with_light:
                leaves.update(ldir=light.direction.clone().requires_grad_(True),
                              lcol=light.color.clone().requires_grad_(True),
                              amb=light.ambient.clone().requires_grad_(True))
                p["light"] = LightPack(leaves["ldir"], leaves["lcol"],
                                       leaves["amb"])
            img = fn(p)
            torch.mean(img[..., :3] * torch.from_numpy(wts).to(img.device)
                       ).backward()
            imgs[str(device)] = img.detach().cpu().numpy()
            grads[str(device)] = {k: v.grad.cpu().numpy()
                                  for k, v in leaves.items()}
        label = "lit" if with_light else "unlit"
        require(np.array_equal(imgs["cpu"].view(np.int32),
                               imgs[str(dev)].view(np.int32)),
                f"diffrender {label}: card forward != CPU forward")
        for k, g in grads["cpu"].items():
            gc = grads[str(dev)][k]
            require(np.array_equal(np.isnan(g), np.isnan(gc)),
                    f"diffrender {label}: NaN gradients differ ({k})")
            ok = np.isnan(g) | np.isclose(gc, g, rtol=1e-4, atol=1e-6)
            if not ok.all():
                require(False, f"diffrender {label}: card gradient != CPU "
                        f"({k}: max |d| {np.abs(gc - g)[~ok].max():.3g})")
        say(f"diffrender {label}: card forward == CPU bit for bit; gradients "
            f"({', '.join(sorted(grads['cpu']))}) == CPU within rtol 1e-4, "
            "atol 1e-6")

    # the inverse-rendering fit, as examples/inverse_rendering.py runs it
    steps = 120
    res = {}
    for device in ("cpu", dev):
        fn, _, _, at = make(device, False)
        target = fn({"vertex_colors": at[:, :4]}).detach()
        p0 = {"vertex_colors": torch.full_like(at[:, :4], 0.5)}
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = diffrender.fit_to_image(target, fn, p0, steps=steps,
                                                 lr=0.1)
        if device != "cpu":
            torch.cuda.synchronize()
        res[str(device)] = (losses, (time.perf_counter() - t0) * 1e3 / steps,
                            params["vertex_colors"].cpu().numpy())
    (lc, mc, pc), (lg, mg, pg) = res["cpu"], res[str(dev)]
    require(lg[-1] < 0.05 * lg[0] and lg[-1] <= 2.0 * lc[-1] + 1e-7,
            f"diffrender fit on the card: loss {lg[0]:.3e} -> {lg[-1]:.3e} "
            f"(CPU {lc[-1]:.3e})")
    seen = np.unique(su.v0[vis_o[vis_o >= 0]].tolist()
                     + su.v1[vis_o[vis_o >= 0]].tolist()
                     + su.v2[vis_o[vis_o >= 0]].tolist())
    seen = seen[seen < nv]
    err_g = np.median(np.abs(pg[seen, :3] - attrs[seen, :3]))
    err_c = np.median(np.abs(pc[seen, :3] - attrs[seen, :3]))
    require(err_g < 0.06, f"diffrender fit on the card: median colour "
            f"error {err_g:.4f}")
    say(f"[{card}] diffrender fit_to_image ({steps} Adam steps, lr 0.1): "
        f"card loss {lg[0]:.4e} -> {lg[-1]:.4e}, CPU {lc[0]:.4e} -> "
        f"{lc[-1]:.4e}; median colour error on {len(seen)} seen vertices "
        f"card {err_g:.5f}, CPU {err_c:.5f}; ms per step card {mg:.3f}, "
        f"CPU {mc:.3f}")


# the plain versions a CUDA mesh must never take (phase 19 makes each raise)
PLAIN_VERSIONS = (
    ("ops.setup_kernel", "triangle_setup_plain"),
    ("ops.bincount", "sorted_run_bounds_plain"),
    ("ops.fused_kernel", "rasterize_distribute_plain"),
    ("ops.raster_visibility", "rasterize_visibility_plain"),
    ("ops.meshlet_gather", "gather_tri_rows_plain"),
    ("ops.clip_tail", "clip_tail_plain"),
    ("ops.shade_pack", "shade_pack_plain"),
    ("ops.vertex_transform", "transform_vertices_T_plain"),
    ("ops.front_meta", "front_meta_plain"),
    ("ops.geometry", "transform_vertices_plain"),
    ("ops.geometry", "geometry_device_plain"),
    ("ops.shade", "shade_pack_classic_plain"),
    ("ops.binning", "bin_triangles_plain"),
)
SLAB_KERNELS = ("K1_setup", "K2_run_bounds", "K3_raster", "K3F_raster_shade",
                "K4_raster_classic", "K5_gather_rows", "K6_clip_tail",
                "K7_shade_pack", "K8_vertex_transform", "K9_front_meta",
                "K10_geometry", "K11_shade_pack_classic", "K12_binning")


class PlainVersionsRaise:
    """Within the block, every kernel's plain version raises: the wrappers
    on CUDA tensors must launch their kernels."""

    def __enter__(self):
        import importlib

        self.saved = []
        for mod, name in PLAIN_VERSIONS:
            m = importlib.import_module(f"ash_renderer_tpu_torch.{mod}")
            self.saved.append((m, name, getattr(m, name)))

            def refuse(*args, _name=name, **kw):
                raise RuntimeError(f"{_name} ran on a CUDA mesh")

            setattr(m, name, refuse)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)
        return False


def compare_slab_raster(r, cam, tile_row0: int, rows_per: int, label: str,
                        errs: dict) -> None:
    """K3 (or K3F, when renderer ``r``'s settings give a shade mode) on the
    tables of the slab [tile_row0, tile_row0 + rows_per) against its plain
    version at the slab's row origin, bit for bit, with the kernel's and
    the plain version's CUDA-event ms."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.ops import shade

    s, cfg = r.state, r.cfg
    mm_t, mvp_t, _ = front_inputs(r, cam)
    atlas = s.atlas if r.statics.has_atlas else None
    light = s.light if r.statics.has_light else None
    smode = pipeline.shade_mode_for(r.statics, s.materials, atlas, light)
    consts = None if smode is None else shade.pack_shade_consts(
        smode, s.materials, atlas, light,
        torch.from_numpy(cam.position.astype("float32")).to(r.device))
    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        r.statics, s, mm_t, mvp_t, tile_row0=tile_row0, tile_rows=rows_per)
    win = dict(tile_row0=tile_row0, tile_rows=rows_per)
    name = k3_key("K3" if smode is None else "K3F", cfg)
    (vd, vt, pl), k_ms = run_timed(lambda: fk.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, cfg, smode, consts, **win), 10)
    (vd_p, vt_p, pl_p), p_ms = run_timed(
        lambda: fk.rasterize_distribute_plain(
            rmeta, tbl_sorted, tbl_ext, comb, cfg, smode, consts, **win), 1)
    valid = (pl_p[:, fk.VIS_ROW, :] >= 0)[:, None, :]
    pad = fk.VIS_ROW - 1 if smode is None else fk.F_TEXMASK + 1
    err = _max_err([
        (vd, vd_p), (vt, vt_p),
        (torch.where(valid, pl, 0), torch.where(valid, pl_p, 0)),
        (pl[:, pad:], pl_p[:, pad:]),
    ])
    require(err == 0, f"{name} differs from its plain version on slab rows "
            f"{tile_row0}+{rows_per} ({label}): {err} "
            f"({int((vt != vt_p).sum())} winner ids differ)")
    require(vt.shape[0] == rows_per * cfg.tile_h and int((vt >= 0).sum()) > 0,
            f"{label}: the slab covers nothing")
    errs[name] = max(errs.get(name, 0), err)
    say(f"{label}: {name} on slab tile rows {tile_row0}-"
        f"{tile_row0 + rows_per - 1} bit-equal to plain; covered px "
        f"{int((vt >= 0).sum())}, live rows {int(stats['live_rows'])}, "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")


def slab_checks(dev, card: str, errs: dict, head5, head8) -> dict:
    """Phase 19: row slabs (``parallel``) on the card.  Every counted
    frame runs with the plain versions made to raise; returns the launch
    counts of those frames."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch import _build
    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES, GOLDEN_SHA,
                                                   config5_flythrough)
    from ash_renderer_tpu_torch.camera import Camera, orbit_path
    from ash_renderer_tpu_torch.parallel import (make_render_mesh,
                                                 render_frame_sharded,
                                                 slab_rows)
    from ash_renderer_tpu_torch.renderer import Renderer

    (scene5, st5, cam5, g5), (scene8, st8, cam8, g8) = head5, head8
    n_cards = torch.cuda.device_count()

    def emulated(n):
        return make_render_mesh([dev] * n)

    # no fallback: more slabs than cards through n_devices raises
    try:
        Renderer(scene5, dataclasses.replace(st5, n_devices=n_cards + 1),
                 device=dev)
    except ValueError as e:
        say(f"n_devices={n_cards + 1} with {n_cards} card(s): ValueError ({e})")
    else:
        raise RuntimeError("n_devices beyond the cards present did not raise")

    torch.cuda.reset_peak_memory_stats()
    nocache = dataclasses.replace(st8, front_coherence=False)
    on = dataclasses.replace(st8, fused_surface_shade="on")
    r8_8 = Renderer(scene8, dataclasses.replace(st8, fused_surface_shade="off"),
                    mesh=emulated(8))
    r8on_8 = Renderer(scene8, on, mesh=emulated(8))
    r8_1 = Renderer(scene8, nocache, device=dev)
    r5_n = {n: Renderer(scene5, st5, mesh=emulated(n)) for n in (2, 3)}
    ref_scene, ref_st = GOLDEN_SCENES["reference"]()
    ref_n = {n: Renderer(ref_scene, dataclasses.replace(
        ref_st, pipeline="classic"), mesh=emulated(n)) for n in (2, 3)}
    r5c = Renderer(scene5, st5, device=dev)  # meshlet-packed state
    cls5 = classic_statics(r5c)
    scene_c5, st_c5, cams_c5 = config5_flythrough()
    rc5_1 = Renderer(scene_c5, st_c5, device=dev)
    rc5_2 = Renderer(scene_c5, st_c5, mesh=emulated(2))
    flyby = flyby_camera(FLYBY_FRAME, N_FRAMES)
    moved = orbit_path(N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])[5]
    rows8 = slab_rows(r8_8.statics, 8)
    require(rows8 == 17 and rows8 * 8 * 8 > st8.height,
            f"1080p in 8 slabs: {rows8} tile rows a slab, not 17 (padded)")
    # single-device frames to compare with, outside the counted run
    f_fly1 = r8_1.read_frame(r8_1.render_frame(flyby)[0])
    f_c5 = rc5_1.read_frame(rc5_1.render_frame(cams_c5[0])[0])
    torch.cuda.synchronize()

    with PlainVersionsRaise():
        _build.launches.clear()
        for label, r in (("off (K3)", r8_8), ("on (K3F)", r8on_8)):
            f, aux = r.render_frame(cam8)
            f = r.read_frame(f)
            require(sha(f) == g8["sha256"],
                    f"subdiv 8 in 8 slabs, {label}: frame != golden")
            require(int(aux["clip_overflow"]) == 0, f"{label}: clip overflow")
            say(f"subdiv-8 frame 1920x1080 in 8 slabs of {rows8} tile rows "
                f"on {dev}, {label}: golden sha256 EXACT")
        for n, r in r5_n.items():
            f = r.read_frame(r.render_frame(cam5)[0])
            require(sha(f) == g5["sha256"], f"subdiv 5 in {n} slabs != golden")
            say(f"subdiv-5 frame in {n} slabs "
                f"({slab_rows(r.statics, n)} tile rows each): golden sha256 EXACT")
        f_fly, aux = r8_8.render_frame(flyby)
        f_fly = r8_8.read_frame(f_fly)
        cnt = {k: int(aux[k]) for k in ("n_wide", "wide_pairs_n", "n_clipped",
                                        "wide_leftover", "clip_overflow")}
        require((f_fly == f_fly1).all(),
                "fly-by frame 12 in 8 slabs != the single-device frame")
        require(cnt["n_wide"] > 0 and cnt["wide_pairs_n"] > 0
                and cnt["n_clipped"] > 0,
                f"fly-by in 8 slabs: the worst slab's counters are dead {cnt}")
        say(f"fly-by frame {FLYBY_FRAME} in 8 slabs: byte-equal to the single "
            f"device's; worst slab {cnt}")
        fs = r8_8.read_frame(r8_8.render_frame(cam8)[0])
        fm = r8_8.read_frame(r8_8.render_frame(moved)[0])
        fs2 = r8_8.read_frame(r8_8.render_frame(cam8)[0])
        require(not (fm == fs).all(), "8 slabs: the moved frame equals the static one")
        require((fs2 == fs).all(), "8 slabs: static -> moved -> static differs")
        say("8 slabs: static -> moved -> static: final frame byte-equal to the first")
        for n, r in ref_n.items():
            require(r.settings.pipeline == "classic", "reference: not classic")
            f = r.read_frame(r.render_frame(Camera())[0])
            require(sha(f) == GOLDEN_SHA["reference"],
                    f"reference in {n} slabs: frame != golden")
            say(f"reference {f.shape[1]}x{f.shape[0]} (classic, K4) in {n} "
                "slabs: golden sha256 EXACT")
        mm_t, mvp_t, _ = front_inputs(r5c, cam5)
        lt = torch.from_numpy(r5c.packed.local_tri).to(dev)
        for n in (2, 3):
            f, st = render_frame_sharded(
                cls5, emulated(n), {dev: r5c.state}, mm_t, mvp_t,
                torch.from_numpy(cam5.position.astype("float32")).to(dev),
                local_tri=lt)
            f = f.cpu().numpy()
            require(int(st["pairs_overflow"]) == 0, "classic slabs: overflow")
            require(sha(f) == g5["sha256"],
                    f"classic subdiv 5 (meshlets) in {n} slabs != golden")
            say(f"classic subdiv-5 frame (meshlets, K5 + K4) in {n} slabs: "
                "golden sha256 EXACT")
        f = rc5_2.read_frame(rc5_2.render_frame(cams_c5[0])[0])
        require((f == f_c5).all(), "config5 frame 0 in 2 slabs != single device")
        say(f"config5 frame 0 ({st_c5.width}x{st_c5.height}, ss "
            f"{st_c5.supersample}) in 2 slabs: byte-equal to the single device's")
        torch.cuda.synchronize()
        counts = dict(_build.launches)
    say(json.dumps(counts, sort_keys=True))
    for k in SLAB_KERNELS:
        require(counts.get(k, 0) > 0, f"{k} was not launched in phase 19")
    # a classic slab's transform is folded into K10
    require(counts.get("K8C_vertex_transform_rows", 0) == 0,
            "K8C was launched in phase 19")

    if n_cards >= 2:
        cards = make_render_mesh(torch.device("cuda", i)
                                 for i in range(min(n_cards, 8)))
        rc = Renderer(scene8, st8, mesh=cards)
        require(sha(rc.read_frame(rc.render_frame(cam8)[0])) == g8["sha256"],
                f"subdiv 8 on {len(cards)} cards != golden")
        require((rc.read_frame(rc.render_frame(flyby)[0]) == f_fly1).all(),
                f"fly-by on {len(cards)} cards != the single device's")
        rr = Renderer(ref_scene, ref_st, mesh=cards)
        require(sha(rr.read_frame(rr.render_frame(Camera())[0]))
                == GOLDEN_SHA["reference"], "reference on cards != golden")
        say(f"the same frames on {len(cards)} distinct cards: EXACT")
        del rc, rr
    else:
        say(f"one card: the slabs were emulated on {dev} (a mesh that repeats "
            "it); no frame ran on distinct cards")

    # K3 and K3F on a middle slab's tables against their plain versions
    compare_slab_raster(r8_8, cam8, 4 * rows8, rows8, "subdiv 8 off", errs)
    compare_slab_raster(r8on_8, cam8, 4 * rows8, rows8, "subdiv 8 on", errs)
    compare_slab_raster(r8_8, flyby, 3 * rows8, rows8, "subdiv 8 fly-by", errs)
    del r8_8, r8on_8, r5_n, ref_n, r5c, rc5_1, rc5_2

    legs = [("1 device", r8_1)] + [
        (f"{n} slabs", Renderer(scene8, nocache, mesh=emulated(n)))
        for n in (2, 8)]
    turns(card, "config4 subdiv 8 static uncached, slabs on one card", legs,
          [cam8] * N_FRAMES)
    stage_ms(legs[2][1], cam8)  # warm-up
    per_slab = stage_ms(legs[2][1], cam8)
    summed: dict = {}
    for k, v in per_slab.items():
        summed[k.split("@")[0]] = summed.get(k.split("@")[0], 0.0) + v
    say(f"[{card}] stage ms (8 slabs, static, summed over the slabs): "
        + ", ".join(f"{k} {v:.3f}" for k, v in summed.items()))
    say(f"[{card}] ms per slab (static): " + ", ".join(
        f"{i} {sum(v for k, v in per_slab.items() if k.endswith(f'@{i}')):.3f}"
        for i in range(8)))
    say(f"[{card}] peak device memory (phase 19): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del legs, r8_1
    return counts


def tile_h4_checks(dev, card: str, errs: dict, head5, head8, head3, r8_8):
    """Phase 24: K3 and K3F on the reference's 4-row tiles
    (``fused_tile_h=4``).  ``r8_8``: the default (8-row) subdiv-8 Renderer
    the 4-row kernels are timed beside.  Returns ({"K3_t4", "K3F_t4"}:
    (kernel ms, plain ms, None, (bound ms, bound by))}, the launch counts
    of the counted frames)."""
    import dataclasses

    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.parallel import make_render_mesh, slab_rows
    from ash_renderer_tpu_torch.renderer import Renderer

    (scene5, st5, cam5, g5), (scene8, st8, cam8, g8) = head5, head8
    scene3, st3, cam3 = head3
    t4 = dict(pipeline="fused", fused_tile_h=4)
    r5 = Renderer(scene5, dataclasses.replace(
        st5, fused_surface_shade="off", **t4), device=dev)
    r8off = Renderer(scene8, dataclasses.replace(
        st8, fused_surface_shade="off", **t4), device=dev)
    r8 = Renderer(scene8, dataclasses.replace(st8, **t4), device=dev)
    r8_n = {n: Renderer(scene8, dataclasses.replace(st8, **t4),
                        mesh=make_render_mesh([dev] * n)) for n in (2, 4)}
    r3 = Renderer(scene3, dataclasses.replace(
        st3, fused_surface_shade="on", **t4), device=dev)
    for r in (r5, r8off, r8, r3, *r8_n.values()):
        require(r.cfg.tile_h == 4, f"fused_tile_h=4 gave {r.cfg.tile_h}-row tiles")

    # the counted run: the goldens and the slab frames, plain versions
    # raising
    legs = (("subdiv 5 off", r5, cam5, g5), ("subdiv 8 off", r8off, cam8, g8),
            (f"subdiv 8 {r8.settings.fused_surface_shade}", r8, cam8, g8))

    def frames():
        out = [r.read_frame(r.render_frame(cam)[0]) for _, r, cam, _ in legs]
        return out + [r.read_frame(r.render_frame(cam8)[0])
                      for r in r8_n.values()]

    out, counts, _, _ = run_counted(frames)
    for (label, r, _, g), f in zip(legs, out):
        require(sha(f) == g["sha256"], f"tile_h 4, {label}: frame != golden")
        say(f"tile_h 4, {label} ({f.shape[1]}x{f.shape[0]}, {r.cfg.grid_h} "
            f"tile rows): golden sha256 EXACT")
    for (n, r), f in zip(r8_n.items(), out[3:]):
        require((f == out[2]).all(),
                f"tile_h 4: the {n}-slab frame differs from the single card's")
        say(f"tile_h 4, subdiv 8 in {n} slabs of {slab_rows(r.statics, n)} "
            f"tile rows on {dev}: byte-equal to the single card's frame")
    say(json.dumps(counts, sort_keys=True))
    for k in ("K1_setup", "K2_run_bounds", "K3_raster_t4", "K3F_raster_shade_t4"):
        require(counts.get(k, 0) > 0, f"{k} was not launched in phase 24")
    for k in ("K3_raster", "K3F_raster_shade"):
        require(not counts.get(k), f"{k} (8-row tiles) ran on 4-row tiles")
    del r5, r8_n

    # each kernel against its plain version, the static calls timed
    timing = {}
    timing["K3_t4"] = compare_kernels(r8off, cam8, "tile_h 4, subdiv 8 static",
                                      errs, timed=True)[1]["K3_t4"]
    compare_flyby(r8off, "tile_h 4, subdiv 8 fly-by", errs)
    del r8off
    timing["K3F_t4"] = compare_k3f(r8, cam8, "tile_h 4, subdiv 8 "
                                   f"{r8.settings.fused_surface_shade}, static",
                                   errs, timed=True)[1]
    stats = compare_k3f(r8, flyby_camera(FLYBY_FRAME, N_FRAMES),
                        "tile_h 4, subdiv 8 fly-by", errs)[0]
    require(stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0,
            "tile_h 4: the fly-by frame neither clips nor expands wide pairs")
    compare_k3f(r3, cam3, "tile_h 4, config3 on", errs)
    say_timing(card, timing, " (subdiv 8 static)")

    # the kernels at 8 and 4 rows on the same frame, in turns (8, 4, 4, 8)
    inputs = {th: (r.cfg, *raster_inputs(r, cam8, f"{th} rows"))
              for th, r in ((8, r8_8), (4, r8))}
    for name, shaded in (("K3", False), ("K3F", True)):
        med = {8: [], 4: []}
        for th in (8, 4, 4, 8):
            cfg, front, smode, consts = inputs[th]
            med[th].append(run_timed(lambda: fk.rasterize_distribute(
                *front[:4], cfg, smode if shaded else None,
                consts if shaded else None), TIMING_REPS[name][0])[1])
        say(f"[{card}] {name} ms at subdiv 8 static in turns (8, 4, 4, 8 "
            "rows): " + "; ".join(f"{th} rows {', '.join(f'{m:.4f}' for m in v)}"
                                  for th, v in med.items()))
    return timing, counts


# operations per selected triangle of K6, counted from its source: 6 planes
# x 12 polygon slots x 16 channels x ~6 (intersection and placement), then
# 7 fan triangles of ~150 (3 snaps, the area, recip_spec, the key)
K6_OPS_PER_CLIP = 6 * 12 * 16 * 6 + 7 * 150
K6_REPS = (20, 3)  # CUDA-event repetitions (kernel, plain chain)


def clip_tail_case(r, cam, label: str, errs: dict, budget=None,
                   tile_row0: int = 0, tile_rows=None, timed: bool = False):
    """K6 (``clip_tail.clip_tail``) against ``clip_tail_plain`` on the
    inputs renderer ``r``'s front gives for camera ``cam`` (K1's comb and
    flags), with ``budget`` (the renderer's by default) and the tile-row
    window: the tail comb rows as int32 words, the keys and the counters,
    bit for bit; the main rows untouched.  The kernel's call runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host read on its
    path raises.  Returns (the counters as ints, with ``timed`` (kernel
    ms, plain ms, None, (bound ms, bound by)) else None)."""
    import torch

    from ash_renderer_tpu_torch.ops import clip_tail, geometry, setup_kernel

    s, cfg = r.state, r.cfg
    budget = r.settings.clip_budget if budget is None else budget
    _, _, tblT = front_inputs(r, cam)
    comb, _, flags, _, _ = setup_kernel.triangle_setup(
        tblT, s.ltT, s.matT, cfg, tail_rows=budget * geometry.MAX_CLIP_TRIS)
    t = flags.shape[0]
    args = (tblT, s.tri_v, s.tri_mat, flags)
    win = (cfg, budget, tile_row0, tile_rows)
    comb_k, comb_p = comb.clone(), comb.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keys, cnt = clip_tail.clip_tail(*args, comb_k, *win)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reps = K6_REPS if timed else (0, 0)
    (keys, cnt), k_ms = run_timed(
        lambda: clip_tail.clip_tail(*args, comb_k, *win), reps[0])
    (keys_p, cnt_p), p_ms = run_timed(
        lambda: clip_tail.clip_tail_plain(*args, comb_p, *win), reps[1])
    err = _max_err([(comb_k[t:], comb_p[t:]), (keys, keys_p)]
                   + [(cnt[k].reshape(1), cnt_p[k].reshape(1))
                      for k in clip_tail.COUNTERS])
    errs["K6"] = max(errs.get("K6", 0), err)
    require(err == 0, f"K6 differs from clip_tail_plain ({label}): {err}")
    require(bool((comb_k[:t] == comb[:t]).all()),
            f"K6 wrote into the main comb rows ({label})")
    stats = {k: int(v) for k, v in cnt.items()}
    say(f"{label}: K6 bit-equal to clip_tail_plain ({budget * 7} tail rows, "
        f"keys, counters; window rows {tile_row0}+{tile_rows or cfg.grid_h}): "
        + ", ".join(f"{k} {v}" for k, v in stats.items()))
    if not timed:
        return stats, None
    n_sel = min(stats["n_clipped"], budget)
    n_bytes = (t * 4  # flags
               + n_sel * (3 + 3 * 16 + 1) * 4  # corner ids, rows, material
               + budget * geometry.MAX_CLIP_TRIS * (128 + 1) * 4)  # rows, keys
    return stats, (k_ms, p_ms, None, bound_ms(n_bytes, n_sel * K6_OPS_PER_CLIP))


def clip_tail_checks(dev, card: str, errs: dict, r8) -> dict:
    """Phase 25: the clip tail, kernel K6, against ``clip_tail_plain`` on
    the card, bit for bit: terrain at its golden pose (no clip) and at the
    walk's first frame (clips; timed), the walk frame with a 16- and a
    17-triangle budget (overflow) and in a middle and the last of 8 row
    slabs, config4
    subdiv 8 (``r8``) at the fly-by's closest approach and at an orbit
    frame that clips nothing; then the launches of one front.  Returns
    {"K6": (kernel ms, plain ms, None, (bound ms, bound by))}."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.benchmarks import config4_terrain
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.ops import clip_tail
    from ash_renderer_tpu_torch.parallel import slab_rows
    from ash_renderer_tpu_torch.renderer import Renderer
    from benchmark import cells

    scene_t, st_t, cams_t = config4_terrain()
    rt = Renderer(scene_t, st_t, device=dev)
    walk = cells.path_of(cells.load()["terrain-walk"], 1, cells.DEFAULT_SEED)[0]
    stats = clip_tail_case(rt, cams_t[0], "terrain golden pose", errs)[0]
    stats, timed = clip_tail_case(rt, walk, "terrain walk frame 0", errs,
                                  timed=True)
    require(stats["n_clipped"] > 16 and stats["clip_overflow"] == 0,
            "terrain walk frame 0 clips too little or overflows")
    n_clipped = stats["n_clipped"]
    for budget in (16, 17):  # 17: the last group of 16 slots is partial
        stats = clip_tail_case(rt, walk,
                               f"terrain walk frame 0, budget {budget}", errs,
                               budget=budget)[0]
        require(stats["clip_overflow"] == n_clipped - budget,
                f"budget {budget}: the overflow is not the candidates past "
                "the budget")
    rows_per = slab_rows(rt.statics, 8)
    for i in (3, 7):
        clip_tail_case(rt, walk, f"terrain walk frame 0, slab {i} of 8", errs,
                       tile_row0=i * rows_per, tile_rows=rows_per)
    stats = clip_tail_case(r8, flyby_camera(FLYBY_FRAME, N_FRAMES),
                           "config4 subdiv 8 fly-by closest approach", errs)[0]
    require(stats["n_clipped"] > 0, "the fly-by frame does not clip")
    orbit = orbit_path(N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])[5]
    stats = clip_tail_case(r8, orbit, "config4 subdiv 8 orbit frame 5", errs)[0]
    require(stats["n_clipped"] == 0, "the orbit frame clips")

    # the launches of one terrain front on the card
    mm_t, mvp_t, _ = front_inputs(rt, walk)
    _, counts, _, _ = run_counted(lambda: pipeline.render_front(
        rt.statics, rt.state, mm_t, mvp_t))
    n = counts.get(clip_tail.KERNEL, 0)
    require(n == clip_tail.N_LAUNCHES,
            f"K6 launched {n} times in one front, not once")
    k_ms, p_ms, _, (b_ms, by) = timed
    say(f"[{card}] K6 at the terrain walk frame ({n_clipped} clipped, budget "
        f"{rt.settings.clip_budget}): {k_ms:.4f} ms for its one launch, "
        f"clip_tail_plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by}), {b_ms / k_ms:.0%} of it; launches of one "
        f"front: {json.dumps(counts, sort_keys=True)}")
    del rt
    torch.cuda.synchronize()
    return {"K6": timed}


# operations per render sample of K7, counted from its source: the quad's
# 4 channels x (4 byte scalings and 3 lerps of 3 ops), the modulation, the
# light combine (9) and the resolve (4); the LUT and pack per pixel
K7_OPS_PER_SAMPLE = 80
K7_REPS = (20, 5)  # CUDA-event repetitions (kernel, plain chain)
K7_SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0)


def k7_inputs(r, cam, label: str, tile_row0: int = 0, tile_rows=None):
    """(K3F's planes of renderer ``r``'s frame at ``cam``, for the whole
    grid or the slab window, and ``shade_pack``'s other arguments as the
    pipeline passes them).  Fails if ``r``'s settings route to phase E."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.ops import shade

    s, st = r.state, r.settings
    mm_t, mvp_t, _ = front_inputs(r, cam)
    atlas = s.atlas if r.statics.has_atlas else None
    light = s.light if r.statics.has_light else None
    smode = pipeline.shade_mode_for(r.statics, s.materials, atlas, light)
    require(smode is not None, f"{label}: the settings route to phase E")
    consts = shade.pack_shade_consts(
        smode, s.materials, atlas, light,
        torch.from_numpy(cam.position.astype("float32")).to(r.device))
    win = dict(tile_row0=tile_row0, tile_rows=tile_rows)
    front = pipeline.render_front(r.statics, s, mm_t, mvp_t, **win)
    planes = fk.rasterize_distribute(*front[:4], r.cfg, smode, consts,
                                     **win)[2]
    _, _, has_m, has_a, has_l = smode
    return planes, (r.cfg, st.supersample, st.srgb_output, st.clear_color,
                    atlas if has_a else None, light if has_l else None,
                    has_m, tile_rows is None)


def k7_float_frame(planes, args):
    """The plain chain's RGBA before sRGB and pack: combine, relayout,
    SSAA box."""
    from ash_renderer_tpu_torch.ops import shade, shade_pack

    cfg, ss, _, clear, atlas, light, has_m, full = args
    return shade.box_resolve(shade_pack.tile_image(shade_pack.combine_planes(
        planes, clear, atlas, light, has_m), cfg, full), ss)


def k7_work(planes, args, out):
    """(bytes, ops) K7 needs at least for these planes: each render sample
    of the frame's crop reads its winner id, a covered one its P words,
    with a light its lit word (and diffuse, and specular with materials,
    where lit), with an atlas its texmask (and tap, fu, fv where
    textured) and each distinct quad it taps once; the sRGB LUT; the RGBA8
    frame written once.  Ops per sample: ``K7_OPS_PER_SAMPLE``."""
    import torch

    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.ops import shade_pack

    cfg, _, srgb, _, atlas, light, has_m, full = args

    def img(row):
        return shade_pack.tile_image(planes[:, row], cfg, full)

    valid = img(fk.VIS_ROW) >= 0
    n_valid = int(valid.sum())
    words = valid.numel() + 4 * n_valid + out.numel() // 4
    if light is not None:
        words += n_valid + int((valid & (img(fk.F_LIT) != 0)).sum()) * (
            3 + int(has_m))
    if atlas is not None:
        tex = valid & (img(fk.F_TEXMASK) != 0)
        taps = img(fk.F_TAP)[tex].clamp(0, atlas.quads.shape[0] - 1)
        words += n_valid + 3 * int(tex.sum()) + 4 * int(
            torch.unique(taps).numel())
    if srgb:
        words += 4096
    return words * 4, valid.numel() * K7_OPS_PER_SAMPLE


def k7_case(r, cam, label: str, errs: dict, tile_row0: int = 0,
            tile_rows=None, timed: bool = False):
    """K7 (``shade_pack.shade_pack``) against ``shade_pack_plain`` on
    K3F's planes of renderer ``r``'s frame at ``cam`` (the whole frame or
    the slab window), bit for bit; the kernel's second call runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read: the first
    builds the device's sRGB LUT).  Returns (planes, shade_pack's other
    arguments, with ``timed`` (kernel ms, plain ms, None, (bound ms,
    bound by)) else None)."""
    import torch

    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.ops import shade_pack

    planes, args = k7_inputs(r, cam, label, tile_row0, tile_rows)
    shade_pack.shade_pack(planes, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        shade_pack.shade_pack(planes, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reps = K7_REPS if timed else (0, 0)
    out, k_ms = run_timed(lambda: shade_pack.shade_pack(planes, *args),
                          reps[0])
    out_p, p_ms = run_timed(
        lambda: shade_pack.shade_pack_plain(planes, *args), reps[1])
    require(out.shape == out_p.shape and out.dtype == out_p.dtype,
            f"K7 gives {tuple(out.shape)} {out.dtype}, the plain chain "
            f"{tuple(out_p.shape)} {out_p.dtype} ({label})")
    err = _max_err([(out.int(), out_p.int())])
    errs["K7"] = max(errs.get("K7", 0), err)
    require(err == 0, f"K7 differs from shade_pack_plain ({label}): {err} "
            f"({int((out != out_p).any(-1).sum())} pixels)")
    cfg, ss, srgb = args[0], args[1], args[2]
    say(f"{label}: K7 bit-equal to shade_pack_plain ({out.shape[1]}x"
        f"{out.shape[0]}, tile_h {cfg.tile_h}, ss {ss}, sRGB {srgb}, atlas "
        f"{args[4] is not None}, light {args[5] is not None}, materials "
        f"{args[6]}, rows {'cropped' if args[7] else 'whole'}); covered "
        f"samples {int((planes[:, fk.VIS_ROW] >= 0).sum())}")
    if not timed:
        return planes, args, None
    return planes, args, (k_ms, p_ms, None, bound_ms(*k7_work(planes, args,
                                                               out)))


def k7_non_finite(planes, args, label: str, errs: dict) -> None:
    """K7 on ``planes`` with NaN, +-Inf and -0.0 written into rows 0-7 of
    a tenth of the covered samples (seeded): bit-equal to the plain chain
    on every channel whose float value is not NaN, and 0 on every NaN
    channel; with sRGB, bit-equal to the plain chain's LUT and pack of the
    float frame with each NaN taken as 0.0 (the plain chain's own sRGB
    path is not run on NaN: its index cast is undefined, and an index out
    of the LUT would stop the card)."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch.ops import fused_kernel as fk
    from ash_renderer_tpu_torch.ops import shade, shade_pack

    g = torch.Generator(device=planes.device).manual_seed(26)
    bad = planes.clone()
    shape = (bad.shape[0], bad.shape[2])
    pick = torch.randint(0, len(K7_SPECIALS), shape, generator=g,
                         device=bad.device)
    vals = torch.tensor(K7_SPECIALS, device=bad.device)[pick].view(torch.int32)
    for row in range(fk.F_SPEC + 1):
        hit = (bad[:, fk.VIS_ROW] >= 0) & (
            torch.rand(shape, generator=g, device=bad.device) < 0.1)
        bad[:, row] = torch.where(hit, vals, bad[:, row])
    f = k7_float_frame(bad, args)
    nan = torch.isnan(f)
    out = shade_pack.shade_pack(bad, *args)
    out_p = shade_pack.shade_pack_plain(bad, *args)
    err = _max_err([(torch.where(nan, 0, out.int()),
                     torch.where(nan, 0, out_p.int()))])
    pinned = int(out[nan].int().abs().max()) if bool(nan.any()) else 0
    errs["K7"] = max(errs.get("K7", 0), err)
    require(int(nan.sum()) > 1000 and bool(torch.isinf(f).any()),
            f"{label}: too few NaN or Inf channels reach the pack")
    require(err == 0, f"K7 differs from shade_pack_plain on non-NaN "
            f"channels ({label}, non-finite planes): {err}")
    require(pinned == 0, f"K7 packs a NaN channel to {pinned}, not 0")
    plain_nan = torch.unique(out_p[nan]).tolist()
    srgb_args = (args[0], args[1], True, *args[3:])
    out_s = shade_pack.shade_pack(bad, *srgb_args)
    want_s = shade.resolve_and_pack(torch.where(nan, 0.0, f), 1, True)
    err_s = _max_err([(out_s.int(), want_s.int())])
    errs["K7"] = max(errs.get("K7", 0), err_s)
    require(err_s == 0, f"K7 with sRGB differs on non-finite planes "
            f"({label}): {err_s}")
    say(f"{label} with NaN, +-Inf, -0.0 in rows 0-7: K7 bit-equal to "
        f"shade_pack_plain on every non-NaN channel; {int(nan.sum())} NaN "
        f"channels pack to 0 (the plain chain gives {plain_nan} there); "
        f"with sRGB equal to the NaN-as-0.0 frame; {int(torch.isinf(f).sum())}"
        " Inf channels")


def shade_pack_checks(dev, card: str, errs: dict, r8, cam8) -> dict:
    """Phase 26: shade + pack, kernel K7, against ``shade_pack_plain`` on
    the card, bit for bit, on K3F's planes of: config4 subdiv 8 (``r8``)
    at the static pose ``cam8`` (timed) and an orbit frame at 8- and at 4-row
    tiles, a middle slab of the 8-slab split, config5 frame 0 (2x SSAA),
    the ``ssaa_srgb`` golden scene on the fused route, and the static
    planes carrying NaN, +-Inf and -0.0.  Returns {"K7": (kernel ms, plain
    ms, None, (bound ms, bound by))}."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES,
                                                   config5_flythrough)
    from ash_renderer_tpu_torch.camera import Camera, orbit_path
    from ash_renderer_tpu_torch.parallel import slab_rows
    from ash_renderer_tpu_torch.renderer import Renderer

    static = cam8
    orbit = orbit_path(N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])[5]
    planes, args, timed = k7_case(r8, static, "config4 subdiv 8 static",
                                  errs, timed=True)
    k7_case(r8, orbit, "config4 subdiv 8 orbit frame 5", errs)
    r8_4 = Renderer(r8.scene, dataclasses.replace(r8.settings,
                                                  fused_tile_h=4), device=dev)
    k7_case(r8_4, orbit, "config4 subdiv 8 orbit frame 5, 4-row tiles", errs)
    del r8_4
    rows_per = slab_rows(r8.statics, 8)
    k7_case(r8, static, "config4 subdiv 8 static, slab 3 of 8", errs,
            tile_row0=3 * rows_per, tile_rows=rows_per)
    scene5, st5, cams5 = config5_flythrough()
    k7_case(Renderer(scene5, st5, device=dev), cams5[0],
            "config5 frame 0", errs)
    scene_g, st_g = GOLDEN_SCENES["ssaa_srgb"]()
    k7_case(Renderer(scene_g, dataclasses.replace(
        st_g, pipeline="fused", fused_surface_shade="on"), device=dev),
        Camera(), "ssaa_srgb golden scene (fused, on)", errs)
    k7_non_finite(planes, args, "config4 subdiv 8 static", errs)
    k_ms, p_ms, _, (b_ms, by) = timed
    say(f"[{card}] K7 at the subdiv-8 static frame: {k_ms:.4f} ms, "
        f"shade_pack_plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
        f"{b_ms / k_ms:.0%} of it")
    torch.cuda.synchronize()
    return {"K7": timed}


# operations per vertex of K8, counted from its source: 7 rows of
# apply_mat4_point (4 mul, 3 add) and 3 of apply_mat3_vec (3 mul, 2 add)
K8_OPS_PER_VERT = 7 * 7 + 3 * 5
K8_REPS = (20, 5)  # CUDA-event repetitions (kernel, plain chain)


def k8_case(r, cam, label: str, errs: dict, timed: bool = False):
    """K8 (``vertex_transform.transform_vertices_T``) against
    ``transform_vertices_T_plain`` on renderer ``r``'s vertices and the
    matrices of camera ``cam``, bit for bit (the (16, V) table as int32
    words); the kernel's call runs under
    ``torch.cuda.set_sync_debug_mode("error")``.  Returns, with ``timed``,
    (kernel ms, plain ms, None, (bound ms, bound by)), else None."""
    import torch

    from ash_renderer_tpu_torch.ops import vertex_transform as vt

    s = r.state
    mm_t, mvp_t, _ = front_inputs(r, cam)
    args = (s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vt.transform_vertices_T(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reps = K8_REPS if timed else (0, 0)
    out, k_ms = run_timed(lambda: vt.transform_vertices_T(*args), reps[0])
    out_p, p_ms = run_timed(lambda: vt.transform_vertices_T_plain(*args),
                            reps[1])
    require(out.shape == out_p.shape and out.dtype == out_p.dtype,
            f"K8 gives {tuple(out.shape)} {out.dtype} ({label})")
    err = _max_err([(out, out_p)])
    errs["K8"] = max(errs.get("K8", 0), err)
    require(err == 0, f"K8 differs from transform_vertices_T_plain ({label}): "
            f"{err} ({int((out != out_p).any(0).sum())} vertices)")
    v, n_obj = out.shape[1], mm_t.shape[0]
    say(f"{label}: K8 bit-equal to transform_vertices_T_plain ({v} vertices, "
        f"{n_obj} object{'s' if n_obj > 1 else ''})")
    if not timed:
        return None
    # each vertex's position, normal, colour, uv (and object id with more
    # than one object) read once, its 16 words written once; the matrices
    n_bytes = v * (48 + 4 * (n_obj > 1) + 64) + n_obj * 2 * 64
    return k_ms, p_ms, None, bound_ms(n_bytes, v * K8_OPS_PER_VERT)


def front_sorted(r, cam, tile_row0: int = 0, tile_rows=None):
    """(comb, order, bounds) that renderer ``r``'s fused front hands K9 for
    camera ``cam``, for the whole grid or the slab window: stages 1-4 of
    ``pipeline.render_front``."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import binsort, geometry, setup_kernel

    s, cfg = r.state, r.cfg
    _, _, tblT = front_inputs(r, cam)
    comb, keys_main, flags, extx, exty = setup_kernel.triangle_setup(
        tblT, s.ltT, s.matT, cfg,
        tail_rows=r.settings.clip_budget * geometry.MAX_CLIP_TRIS)
    if tile_rows is not None:
        keys_main = binsort.stream_keys_from_aabb(
            (flags & 1).bool(), extx, exty, cfg, tile_row0, tile_rows)
    comb, keys_tail, _ = pipeline._clip_tail_into(
        r.statics, tblT, s.tri_v, s.tri_mat, flags, comb, tile_row0, tile_rows)
    order, bounds = binsort.sort_and_bounds(
        torch.cat([keys_main, keys_tail]), cfg, tile_rows)
    return comb, order, bounds


# operations of K9 per wide row (unpack, box, clamps, rectangle, scan) and
# per pair written, counted from its source
K9_OPS_PER_ROW = 60
K9_OPS_PER_PAIR = 4
K9_REPS = (20, 3)  # CUDA-event repetitions (kernel, plain chain)
# a record's comb words, read once: columns 0-5 (its id word is the row's
# index, the order word already counted)
REC_READ_BYTES = 4 * 6


def k9_case(r, cam, label: str, errs: dict, tile_row0: int = 0,
            tile_rows=None, budgets=None, timed: bool = False):
    """K9 (``front_meta.front_meta``) against ``front_meta_plain`` on the
    sorted front renderer ``r`` gives for camera ``cam`` (the whole grid or
    the slab window), with ``budgets`` (wide_rows, wide_pairs; the
    renderer's by default): pair_starts, rmeta, the counts, the first
    n_pairs pair rows and the live records (``tbl_sorted[:we]``,
    ``tbl_ext[:n_pairs]``, also against the rows' ``REC_COLS`` words), bit
    for bit; the kernel's call runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read).  Returns
    ({n_wide, n_fit, n_pairs, leftover, live}, with ``timed`` (kernel ms,
    plain ms, the two ``index_select`` gathers' ms, (bound ms, bound by))
    else None)."""
    import torch

    from ash_renderer_tpu_torch.ops import binsort, front_meta, tritables

    st = r.settings
    wide_rows, wide_pairs = budgets or (st.wide_rows, st.wide_pairs)
    comb, order, bounds = front_sorted(r, cam, tile_row0, tile_rows)
    args = (comb, order, bounds, r.cfg, wide_rows, wide_pairs, tile_row0,
            tile_rows)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        front_meta.front_meta(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reps = K9_REPS if timed else (0, 0)
    (rows, starts, rmeta, counts, tbl, ext), k_ms = run_timed(
        lambda: front_meta.front_meta(*args), reps[0])
    (rows_p, starts_p, rmeta_p, counts_p, tbl_p, ext_p), p_ms = run_timed(
        lambda: front_meta.front_meta_plain(*args), reps[1])
    ws, we, new_ws, n_pairs = counts_p.tolist()[:4]
    require(tuple(tbl.shape) == (order.shape[0], tritables.REC_WORDS)
            and tuple(ext.shape) == (wide_pairs, tritables.REC_WORDS),
            f"K9's tables are {tuple(tbl.shape)} and {tuple(ext.shape)} "
            f"({label})")
    # the records also word for word against the rows' REC_COLS: the id
    # word comes from the row's index, which a comb table holds at ID_COL
    cols = list(tritables.REC_COLS)
    n_rec = len(cols)
    err = _max_err([(starts, starts_p), (rmeta, rmeta_p), (counts, counts_p),
                    (rows[:n_pairs], rows_p[:n_pairs]), (tbl[:we], tbl_p),
                    (ext[:n_pairs], ext_p),
                    (tbl[:we, :n_rec],
                     comb.index_select(0, order[:we])[:, cols]),
                    (ext[:n_pairs, :n_rec],
                     comb.index_select(0, rows[:n_pairs])[:, cols])])
    errs["K9"] = max(errs.get("K9", 0), err)
    require(err == 0, f"K9 differs from front_meta_plain ({label}): {err}")
    stats = {"n_wide": we - ws, "n_fit": new_ws - ws, "n_pairs": n_pairs,
             "leftover": we - new_ws, "live": we}
    n_tiles = starts.numel() - 1
    say(f"{label}: K9 bit-equal to front_meta_plain, records included "
        f"({n_tiles} tiles of {r.cfg.tile_h} rows, window rows {tile_row0}+"
        f"{tile_rows or r.cfg.grid_h}, budgets {wide_rows} rows / "
        f"{wide_pairs} pairs): " + ", ".join(f"{k} {v}"
                                             for k, v in stats.items()))
    if not timed:
        return stats, None
    # the gathers the front ran before K9 wrote the records: whole rows of
    # the live prefix and of the pairs, by index_select (a library call,
    # timed here only)
    live, pairs = order[:we], rows[:n_pairs]
    _, lib_ms = run_timed(lambda: (comb.index_select(0, live),
                                   comb.index_select(0, pairs)), reps[0])
    # the run bounds K9 reads once (each tile's 4 coarse words and first
    # fine word, ws and we; the other fine words it never reads); rmeta,
    # pair_starts and the counts written once; each live row's order word
    # and comb words read once and its record written (the wide rows are
    # live rows, so their words are counted there); each pair's row id and
    # record written (copied from its wide row's record, nothing read)
    n_live = min(we - ws, wide_rows)
    n_bounds = (binsort.N_GRP + 1) * n_tiles + 2
    rec_bytes = 4 * tritables.REC_WORDS
    n_bytes = ((n_bounds + rmeta.numel() + starts.numel() + counts.numel())
               * 4 + we * (4 + REC_READ_BYTES + rec_bytes)
               + n_pairs * (4 + rec_bytes))
    return stats, (k_ms, p_ms, lib_ms, bound_ms(
        n_bytes, n_live * K9_OPS_PER_ROW + n_pairs * K9_OPS_PER_PAIR))


def transform_checks(dev, card: str, errs: dict, r8, cam8) -> dict:
    """Phase 27: the vertex transform, kernel K8, against
    ``transform_vertices_T_plain`` on the card, bit for bit: config4 subdiv
    8 (``r8``, one object) at the static pose ``cam8`` (timed) and at the
    fly-by's closest approach, and config5's two objects (a terrain and an
    icosphere: the ``vert_obj`` gather) at its first camera.  Returns
    {"K8": (kernel ms, plain ms, None, (bound ms, bound by))}."""
    import torch

    from ash_renderer_tpu_torch.benchmarks import config5_flythrough
    from ash_renderer_tpu_torch.renderer import Renderer

    timed = k8_case(r8, cam8, "config4 subdiv 8 static", errs, timed=True)
    k8_case(r8, flyby_camera(FLYBY_FRAME, N_FRAMES),
            "config4 subdiv 8 fly-by closest approach", errs)
    scene5, st5, cams5 = config5_flythrough()
    r5 = Renderer(scene5, st5, device=dev)
    require(r5.scene.model_matrices().shape[0] == 2,
            "config5 does not hold two objects")
    k8_case(r5, cams5[0], "config5 frame 0", errs)
    k8_case(r5, cams5[len(cams5) // 2], "config5 mid-path frame", errs)
    k_ms, p_ms, _, (b_ms, by) = timed
    say(f"[{card}] K8 at config4 subdiv 8: {k_ms:.4f} ms, "
        f"transform_vertices_T_plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({by}), {b_ms / k_ms:.0%} of it")
    del r5
    torch.cuda.synchronize()
    return {"K8": timed}


def count_syncs(fn):
    """(``fn()``, the synchronizing CUDA calls it made: the messages of
    ``torch.cuda.set_sync_debug_mode("warn")``, without the notice that
    the mode is a prototype, which torch gives the first time a process
    sets it)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message)
                 and "prototype" not in str(w.message)]


def front_meta_checks(dev, card: str, errs: dict, r8, cam8) -> dict:
    """Phase 28: the wide-pair expansion, range metadata and sorted-table
    records, kernel K9, against ``front_meta_plain`` on the card, bit for
    bit: config4 subdiv 8 (``r8``) at the fly-by's closest approach (wide
    pairs live), in slab 3 of 8 there, and on 4-row tiles there; terrain
    at the walk's first frame (timed), and there with a small
    ``wide_rows`` and a small ``wide_pairs`` (each cut); then one moving
    front's host reads (none), one moving fused frame and one 8-slab frame
    under ``set_sync_debug_mode("error")`` against the Renderer's frame,
    the launches of a moving frame (K8 and K9 once) and of a cached static
    frame (neither).  Returns {"K9": (kernel ms, plain ms, the gathers'
    ms, (bound ms, bound by))}."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.benchmarks import config4_terrain
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.ops import front_meta, vertex_transform
    from ash_renderer_tpu_torch.parallel import (render_frame_sharded_fused,
                                                 slab_rows)
    from ash_renderer_tpu_torch.renderer import Renderer
    from benchmark import cells

    fly = flyby_camera(FLYBY_FRAME, N_FRAMES)
    stats = k9_case(r8, fly, "config4 subdiv 8 fly-by closest approach",
                    errs)[0]
    require(stats["n_pairs"] > 0, "the fly-by frame expands no wide pair")
    rows_per = slab_rows(r8.statics, 8)
    k9_case(r8, fly, "config4 subdiv 8 fly-by, slab 3 of 8", errs,
            tile_row0=3 * rows_per, tile_rows=rows_per)
    r8_4 = Renderer(r8.scene, dataclasses.replace(r8.settings,
                                                  fused_tile_h=4), device=dev)
    stats = k9_case(r8_4, fly, "config4 subdiv 8 fly-by, 4-row tiles",
                    errs)[0]
    require(stats["n_pairs"] > 0, "4-row tiles: no wide pair")
    del r8_4
    scene_t, st_t, _ = config4_terrain()
    rt = Renderer(scene_t, st_t, device=dev)
    walk = cells.path_of(cells.load()["terrain-walk"], 1, cells.DEFAULT_SEED)[0]
    stats, timed = k9_case(rt, walk, "terrain walk frame 0", errs, timed=True)
    n_wide = stats["n_wide"]
    require(n_wide > 64 and stats["leftover"] == 0,
            "terrain walk frame 0: too few wide rows, or a leftover")
    cut_rows = k9_case(rt, walk, "terrain walk frame 0, wide_rows 64", errs,
                       budgets=(64, st_t.wide_pairs))[0]
    require(cut_rows["n_fit"] == 64 and cut_rows["leftover"] == n_wide - 64,
            "wide_rows 64: the cut is not at 64 rows")
    budget = stats["n_pairs"] // 2
    cut_pairs = k9_case(rt, walk, f"terrain walk frame 0, wide_pairs {budget}",
                        errs, budgets=(st_t.wide_rows, budget))[0]
    require(0 < cut_pairs["n_fit"] < n_wide and cut_pairs["n_pairs"] <= budget,
            f"wide_pairs {budget}: no positional cut")

    # one moving front: no host read; a moving frame and an 8-slab frame
    # under "error", equal to the Renderer's frame; the frame's launches
    orbit = orbit_path(N_FRAMES, radius=2.0, center=[0.0, 0.0, 2.0])[5]
    mm_t, mvp_t, _ = front_inputs(r8, orbit)
    cam_t = torch.from_numpy(orbit.position.astype("float32")).to(dev)
    _, syncs = count_syncs(lambda: pipeline.render_front(
        r8.statics, r8.state, mm_t, mvp_t))
    require(not syncs, f"one moving front made {len(syncs)} host reads, "
            f"not 0: {syncs}")
    # the Renderer's frame, counted: a moving frame (its front-cache entry
    # is another camera's)
    (frame_o, _), counts, _, _ = run_counted(lambda: r8.render_frame(orbit))
    want = r8.read_frame(frame_o)
    slabs = (r8.statics, (dev,) * 8, {dev: r8.state}, mm_t, mvp_t, cam_t)
    render_frame_sharded_fused(*slabs)  # first use of the 8-slab shapes
    for label, frame in (
            ("moving fused frame", lambda: pipeline.render_frame_fused_staged(
                r8.statics, r8.state, mm_t, mvp_t, cam_t)),
            ("8-slab frame", lambda: render_frame_sharded_fused(*slabs))):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = frame()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require((r8.read_frame(got) == want).all(),
                f"the {label} under sync debug \"error\" differs from the "
                "Renderer's frame")
        say(f"config4 subdiv 8 orbit frame 5: the {label} ran under "
            "set_sync_debug_mode(\"error\") (no host read) and equals the "
            "Renderer's frame")
    require(counts.get(vertex_transform.KERNEL, 0) == 1
            and counts.get(front_meta.KERNEL, 0) == front_meta.N_LAUNCHES,
            f"a moving frame's launches: {counts}")
    route = require_route("config4 subdiv 8 orbit frame", counts, r8)
    r8.render_frame(cam8)
    _, counts_c, _, _ = run_counted(lambda: r8.render_frame(cam8))
    require_route("config4 subdiv 8 cached static frame", counts_c, r8,
                  cached=True)
    k_ms, p_ms, lib_ms, (b_ms, by) = timed
    say(f"[{card}] one moving front ({route}): host reads {syncs}; frame "
        f"launches {json.dumps(counts, sort_keys=True)}; "
        f"cached static frame {json.dumps(counts_c, sort_keys=True)}")
    _, floor_ms = run_timed(lambda: torch.cuda._sleep(1), K9_REPS[0])
    say(f"[{card}] K9 at the terrain walk frame ({n_wide} wide rows, "
        f"{stats['n_pairs']} pairs, {stats['live']} live rows): {k_ms:.4f} ms "
        f"for its one launch, records included; "
        f"front_meta_plain {p_ms:.4f} ms; the two index_select gathers of "
        f"whole rows {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({by}), "
        f"{b_ms / k_ms:.0%} of it; launch floor (torch.cuda._sleep(1)) "
        f"{floor_ms:.4f} ms")
    del rt
    torch.cuda.synchronize()
    return {"K9": timed}


# ---------------------------------------------------------------------------
# Phase 29: the classic route's glue kernels K8C, K10, K12 and K11
# ---------------------------------------------------------------------------

# operations a unit of work, counted from the sources: K8C's three matrix
# products a vertex (64 fmul / fadd), which K10 runs too since the
# transform was folded into it; K10's vertex snap and outcode (~60 a
# vertex) and a triangle's classification and setup row (~40); K11's
# per-sample interpolation of a covered render sample (~135: edge values,
# weights, 12 attributes, raw uv derivatives) with the material (~4), the
# gate frame's untextured, unlit mode, and each distinct winner's terms
# once (~30: three edges' coefficients, six gradients)
K8C_OPS_PER_VERT = 64
K8C_BYTES_IN_PER_VERT = 12 + 12 + 16 + 8 + 4  # position, normal, colour, uv, id
K10_OPS_PER_VERT = 60
K10_OPS_PER_TRI = 40
K11_OPS_PER_SAMPLE = 140
K11_OPS_PER_WINNER = 30
GLUE_REPS = (10, 3)  # CUDA-event repetitions (kernel, plain)


class forced_design:
    """K10's wrapper made to take ``design`` ("cluster" or "grid") inside
    the block."""

    def __init__(self, design: str):
        self.design = design

    def __enter__(self):
        from ash_renderer_tpu_torch.ops import geometry

        self.real = geometry.k10_design
        geometry.k10_design = lambda n_tris: self.design
        return self

    def __exit__(self, *exc):
        from ash_renderer_tpu_torch.ops import geometry

        geometry.k10_design = self.real
        return False


def frame_mats(r, cam):
    """(model, MVP, camera position) tensors of renderer ``r``'s frame for
    camera ``cam``, as ``Renderer.render_frame`` builds them."""
    import numpy as np
    import torch

    from ash_renderer_tpu_torch.oracle.raster_cpu import compose_mvp

    st = r.settings
    mm = np.ascontiguousarray(r.scene.model_matrices(), np.float32)
    mvp = compose_mvp(mm, cam.view_matrix(),
                      cam.projection_matrix(st.render_width / st.render_height))
    return (torch.from_numpy(mm).to(r.device),
            torch.from_numpy(np.ascontiguousarray(mvp)).to(r.device),
            torch.from_numpy(cam.position.astype(np.float32)).to(r.device))


def _bits(x):
    """A float / bool / int tensor's words as int32 (bool as 0 / 1)."""
    import torch

    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


# K12's bound: a valid setup row's 11 words read (x0-y2, inv_area2, area2,
# zq0-2; an invalid row needs its valid byte alone); operations counted
# from the source: a valid row's AABB, window clamps and rectangle (~20),
# a kept pair's record (~60: three edges, two edge values, E2c, the AABB
# again and the box)
K12_ROW_WORDS = 11
K12_OPS_PER_ROW = 20
K12_OPS_PER_PAIR = 60


def _say_legs(kernel: str, label: str, ms: dict, plain_ms, bound) -> None:
    say(f"[{CARD}] {label}: {kernel} ms " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items())
        + f"; plain {plain_ms:.4f}; bound {bound[0]:.5f} ({bound[1]})")


def k12_case(rows, valid, cfg, max_pairs: int, label: str, errs: dict,
             tile_row0: int = 0, tile_rows=None, reps=(0, 0)):
    """K12 (``binning.bin_rows``) against its plain version
    (``bin_triangles_plain`` on the table's column views), entry for
    entry: the records, inv_area2's bits, the boxes, the tile starts and
    counts, and the counters.  Folds the max |kernel - plain| into
    ``errs``.  Returns (K12's outputs, with ``reps`` (ms, plain ms, None,
    (bound ms, bound by)), else None); with ``reps`` it prints them."""
    from ash_renderer_tpu_torch.ops import binning, geometry

    args = (cfg, max_pairs, tile_row0, tile_rows)
    out, k_ms = run_timed(lambda: binning.bin_rows(rows, valid, *args),
                          reps[0])
    want, p_ms = run_timed(lambda: binning.bin_triangles_plain(
        geometry.setup_from_rows(rows, valid), *args), reps[1])
    *arrs, stats = out
    *w_arrs, w_stats = want
    same_shapes = all(a.shape == b.shape and a.dtype == b.dtype
                      for a, b in zip(arrs, w_arrs))
    err = (_max_err([(_bits(a), _bits(b)) for a, b in zip(arrs, w_arrs)])
           if same_shapes else -1)
    got_c = {k: int(v) for k, v in stats.items()}
    want_c = {k: int(v) for k, v in w_stats.items()}
    require(same_shapes and err == 0 and got_c == want_c,
            f"K12 differs from its plain version ({label}): {err}, "
            f"counters {got_c} != {want_c}")
    errs["K12"] = max(errs.get("K12", 0), err)
    tile_count = out[4]
    n_kept = int(tile_count.sum())
    say(f"{label}: K12 bit-equal to plain ({rows.shape[0]} setup rows); "
        f"pairs {got_c['pairs_total']} (overflow {got_c['pairs_overflow']}), "
        f"{n_kept} of {max_pairs} record columns live, {tile_count.numel()} "
        f"tiles (max {int(tile_count.max()) if tile_count.numel() else 0} a "
        "tile)")
    if not reps[0]:
        return out, None
    n_valid = int(valid.sum())
    # inputs read once, outputs written once: the valid rows' words and
    # every valid byte; every record column's 16 words, each tile's start
    # and count, the two counters
    n_bytes = (n_valid * 4 * K12_ROW_WORDS + valid.numel()
               + max_pairs * 4 * binning.REC_ALL_ROWS
               + tile_count.numel() * 8 + 8)
    n_ops = n_valid * K12_OPS_PER_ROW + n_kept * K12_OPS_PER_PAIR
    bound = bound_ms(n_bytes, n_ops)
    _say_legs("K12", label, {"grid": k_ms}, p_ms, bound)
    return out, (k_ms, p_ms, None, bound)


def k10_case(s_args, local_tri, label: str, errs: dict, reps=(0, 0)):
    """K10 against its plain stage (``transform_vertices_plain``, then
    ``geometry_device_plain``), bit for bit: the setup table against
    ``setup_table`` of the plain fields, the valid flags, the combined
    attributes and the counters; with the transform folded in
    (``geometry.stage_geometry_rows``, the frame's call) in the design the
    wrapper takes (``geometry.k10_design``) and in the other one, and on
    K8C's rows (``transform_vertices``, then ``geometry_rows``: the pair
    the frame ran before the fold) in each design.  ``s_args``: the
    scene's positions, vert_obj, normals, colors, uvs, the model and MVP
    matrices, tri_v, tri_mat, cfg and the clip budget.  Folds the max
    |kernel - plain| into ``errs``.  Returns (rows, valid, attrs_full,
    stats of the folded K10 in its own design, counters as ints, its ms,
    {leg: ms}, the plain stage's ms; the ms None without ``reps``)."""
    from ash_renderer_tpu_torch.ops import geometry

    tri_v, budget = s_args[7], s_args[10]
    design = geometry.k10_design(tri_v.shape[0])
    other = "grid" if design == "cluster" else "cluster"

    def plain():
        clip, attrs = geometry.transform_vertices_plain(*s_args[:7])
        return geometry.geometry_device_plain(clip, attrs, *s_args[7:],
                                              local_tri=local_tri)

    (su_p, af_p, gst_p), p_ms = run_timed(plain, reps[1])
    w_rows, want = geometry.setup_table(su_p), {
        k: int(v) for k, v in gst_p.items()}

    def folded(d):
        with forced_design(d):
            return geometry.stage_geometry_rows(*s_args, local_tri=local_tri)

    def pair(d):
        with forced_design(d):
            clip, attrs = geometry.transform_vertices(*s_args[:7])
            return geometry.geometry_rows(clip, attrs, *s_args[7:],
                                          local_tri=local_tri)

    legs = {design: lambda: folded(design), other: lambda: folded(other),
            f"K8C+K10 {design}": lambda: pair(design),
            f"K8C+K10 {other}": lambda: pair(other)}
    out, ms = None, {}
    for leg, fn in legs.items():
        (rows, valid, af, gst), ms[leg] = run_timed(fn, reps[0])
        err = _max_err([(rows, w_rows), (_bits(valid), _bits(su_p.valid)),
                        (_bits(af), _bits(af_p))])
        counters = {k: int(v) for k, v in gst.items()}
        require(err == 0 and counters == want,
                f"K10 ({leg}) differs from its plain stage ({label}): "
                f"{err}, counters {counters} != {want}")
        errs["K10"] = max(errs.get("K10", 0), err)
        out = out or (rows, valid, af, gst, counters)
    say(f"{label}: K10 bit-equal to the plain stage in {', '.join(legs)} "
        f"(its own: {design}, the transform folded in; {s_args[0].shape[0]} "
        f"vertices, {tri_v.shape[0]} triangles, budget {budget})")
    return (*out, ms[design], ms, p_ms)


def classic_glue_case(r, cam, label: str, errs: dict, timed: bool = False,
                      statics=None, local_tri=None, tile_row0: int = 0,
                      tile_rows=None, cut_pairs=()):
    """K8C, K10, K12 and K11 against their plain versions, bit for bit, on
    the classic frame of renderer ``r``'s scene for camera ``cam``
    (``statics`` the classic statics, by default ``classic_statics(r)``;
    ``local_tri`` takes K10's corner rows through K5; ``tile_rows`` the
    slab of that many tile rows from ``tile_row0``): K8C's clip and
    attribute rows (``transform_vertices``, on no frame path), K10's setup
    table with the transform folded in and on K8C's rows (``k10_case``,
    against ``setup_table`` of the plain stage's fields), the valid flags,
    the combined attributes and the counters, K12's binning of that table
    (``k12_case``; also at each budget of ``cut_pairs``, which must cut
    the frame's pairs), and the RGBA8 frame of K4's visibility buffer on
    K12's records.  Folds each max |kernel - plain| into ``errs``.
    Returns (the K11 frame on the host, the counters as ints, {kernel:
    (ms, plain ms, None, (bound ms, bound by))} with ``timed``)."""
    import torch

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import geometry, raster_visibility, shade
    from ash_renderer_tpu_torch.rtypes import (SETUP_ROW_FIELDS,
                                               SETUP_SHADE_COLS)

    statics = statics or classic_statics(r)
    cfg, st, s = statics.cfg, statics.settings, r.state
    mm_t, mvp_t, cam_t = frame_mats(r, cam)
    kr, pr = GLUE_REPS if timed else (0, 0)
    s_args = (s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t,
              mvp_t, s.tri_v, s.tri_mat, cfg, st.clip_budget)
    # K8C runs on no frame path since its transform was folded into K10;
    # it stays a public entry, held here alone
    (clip, attrs), k8_ms = run_timed(
        lambda: geometry.transform_vertices(*s_args[:7]), kr)
    (clip_p, attrs_p), p8_ms = run_timed(
        lambda: geometry.transform_vertices_plain(*s_args[:7]), pr)
    err8 = _max_err([(_bits(clip), _bits(clip_p)),
                     (_bits(attrs), _bits(attrs_p))])
    require(err8 == 0, f"K8C differs from its plain version ({label}): {err8}")
    errs["K8C"] = max(errs.get("K8C", 0), err8)

    rows, valid, af, gst, counters, k10_ms, k10_legs, p10_ms = k10_case(
        s_args, local_tri, label, errs, (kr, pr))

    (rec_i, rec_f, rec_box, start, count, _), t12 = k12_case(
        rows, valid, cfg, st.max_pairs, label, errs, tile_row0, tile_rows,
        (kr, pr))
    for budget in cut_pairs:
        cut, _ = k12_case(rows, valid, cfg, budget,
                          f"{label}, max_pairs {budget}", errs, tile_row0,
                          tile_rows)
        require(int(cut[-1]["pairs_overflow"]) > 0,
                f"{label}: max_pairs {budget} cuts no pair")
    _, vis_t = raster_visibility.rasterize_visibility(
        rec_i, rec_f, start, count, cfg, rec_box=rec_box, tile_rows=tile_rows)
    atlas = s.atlas if statics.has_atlas else None
    light = s.light if statics.has_light else None
    mode = pipeline.surface_mode(statics, s.materials, atlas, light)
    consts = shade.pack_shade_consts(mode, s.materials, atlas, light, cam_t)
    sh_kw = dict(atlas=atlas, light=light, cfg=cfg,
                 clear_color=st.clear_color, supersample=st.supersample,
                 srgb=st.srgb_output, py_offset=tile_row0 * cfg.tile_h)
    rgba8, k11_ms = run_timed(lambda: shade.shade_pack_classic(
        vis_t, rows, af, mode, consts, **sh_kw), kr)
    rgba8_p, p11_ms = run_timed(lambda: shade.shade_pack_classic_plain(
        vis_t, rows, af, mode, consts, **sh_kw), pr)
    err11 = _max_err([(rgba8.to(torch.int32), rgba8_p.to(torch.int32))])
    require(err11 == 0, f"K11 differs from its plain version ({label}): "
            f"{err11} ({int((rgba8 != rgba8_p).any(-1).sum())} px)")
    errs["K11"] = max(errs.get("K11", 0), err11)
    covered = int((vis_t >= 0).sum())
    say(f"{label}: K8C, K10{' (K5 corners)' if local_tri is not None else ''}"
        f", K12 and K11 bit-equal to plain; {s.positions.shape[0]} vertices, "
        f"{s.tri_v.shape[0]} triangles, setup rows {gst['n_setup']}, "
        f"clipped {counters['n_clipped']} (overflow "
        f"{counters['clip_overflow']}), valid {counters['n_valid']}, covered "
        f"samples {covered} of {vis_t.numel()}, "
        f"{'sRGB ' if st.srgb_output else ''}SSAA {st.supersample}, "
        f"mode {mode}")
    timing = None
    if timed:
        v, t = s.positions.shape[0], s.tri_v.shape[0]
        n_setup, b = gst["n_setup"], st.clip_budget
        # K8C: positions, normals, colours, uvs, object ids read once, the
        # clip and attribute rows written once
        n8 = v * K8C_BYTES_IN_PER_VERT + v * (16 + 48)
        # K10 with the transform folded in, its function's inputs read once
        # and outputs written once: the scene's vertex tensors (K8C's
        # inputs) and the matrices, tri_v, tri_mat (and local_tri) read;
        # the setup's fields (SETUP_ROW_FIELDS' words and the valid byte,
        # not the table's zero words), the combined attribute rows and the
        # counters written (not a meshlet-packed scene's vertex rows,
        # scratch for K5's gather)
        n10 = (v * K8C_BYTES_IN_PER_VERT + mm_t.numel() * 4 * 2
               + t * (12 + 4) + (0 if local_tri is None else t * 12)
               + n_setup * (4 * len(SETUP_ROW_FIELDS) + 1)
               + (v + 9 * b) * 48 + 4 * len(geometry.COUNTERS))
        # K11: the winner ids read, each distinct winner's shading words
        # and corner rows once, 4 bytes a pixel written
        win = vis_t[vis_t >= 0].unique()
        n_win = int(win.numel())
        n11 = (vis_t.numel() * 4 + n_win * (4 * SETUP_SHADE_COLS + 3 * 48)
               + rgba8.numel())
        timing = {
            "K8C": (k8_ms, p8_ms, None,
                    bound_ms(n8, v * K8C_OPS_PER_VERT)),
            "K10": (k10_ms, p10_ms, None,
                    bound_ms(n10, v * (K8C_OPS_PER_VERT + K10_OPS_PER_VERT)
                             + t * K10_OPS_PER_TRI)),
            "K11": (k11_ms, p11_ms, None,
                    bound_ms(n11, covered * K11_OPS_PER_SAMPLE
                             + n_win * K11_OPS_PER_WINNER)),
            "K12": t12,
        }
        _say_legs("K10", label, k10_legs, p10_ms, timing["K10"][3])
        # K4's bound on this frame's records (compare_classic's count:
        # each live record's words once, the tile table, vis_d and vis_t)
        n_rec = int(count.sum())
        n_box = int(raster_visibility.box_pixels(rec_box[0, :n_rec]).sum())
        b4 = bound_ms(n_rec * K4_WORDS_PER_REC * 4 + count.numel() * 8
                      + 2 * vis_t.numel() * 4, n_box * K4_OPS_PER_REC_PX)
        say(f"[{CARD}] {label}: K4's bound {b4[0]:.5f} ms ({b4[1]}): "
            f"{n_rec} records, {n_box} box pixels, {covered} covered "
            "samples")
        say(f"{label}: K11 reads {n_win} distinct winners; bytes K8C {n8}, "
            f"K10 {n10}, K11 {n11}")
    return rgba8.cpu().numpy(), counters, timing


def _clip_scene(seed: int, nv: int, nt: int, spread: float, zoff: float):
    """Random triangles (colours per vertex, one default material) around
    the camera's near plane and guard band: clip candidates."""
    import numpy as np

    from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(np.float32)
    pos[:, 2] += zoff
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=pos, indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32)))))
    return sc


# device kernels a classic gate frame may launch: the port's K10, K12, K4
# and K11, and one torch op of the frame's glue
CLASSIC_DEVICE_KERNELS = 5
# the port's kernel functions (NO_FRAME_KERNELS' and K1's, K6's), by which
# the profiler's names are told from torch's
PORT_KERNEL_FUNCS = tuple(k for _, k, _ in NO_FRAME_KERNELS) + (
    "setup_kernel", "clip_tail_kernel")


def classic_launches_per_frame(r, cam, n: int = 4):
    """(device kernels a frame of renderer ``r`` launches by
    ``torch.profiler`` tracing the device alone over ``n`` frames after a
    warm one, copies and memsets not counted; the port's launches a frame
    by ``_build.launches`` over the same frames; the port's kernels a frame
    among the profiler's; {name: count a frame} of the device kernels that
    are not the port's; {kernel function: count a frame} of the port's),
    from one window."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ash_renderer_tpu_torch import _build

    r.render_frame(cam)
    torch.cuda.synchronize()
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            r.render_frame(cam)
        torch.cuda.synchronize()
    n_port = sum(_build.launches.values()) / n
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memcpy", "Memset"))]
    others = collections.Counter(
        e.name for e in kernels
        if not any(f in e.name for f in PORT_KERNEL_FUNCS))
    seen = (len(kernels) - sum(others.values())) / n
    port = collections.Counter(
        f for e in kernels for f in PORT_KERNEL_FUNCS if f in e.name)
    return (len(kernels) / n, n_port, seen,
            {k: v / n for k, v in others.items()},
            {k: v / n for k, v in port.items()})


# the gate orbit's frame that phase 29's profiler window traces
GATE_PROFILED_FRAME = 3


def gate_profiler_window(dev) -> None:
    """``classic_launches_per_frame`` of the gate scene at 800x600 on its
    own route (classic), printed as one JSON list: the child process of
    ``gate_launches_in_child``."""
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.renderer import Renderer

    rg = Renderer(gate_scene()[0], RendererSettings(), device=dev)
    orbit = orbit_path(N_FRAMES, radius=6.0, center=[0.0, 0.0, 3.5])
    print(json.dumps(classic_launches_per_frame(
        rg, orbit[GATE_PROFILED_FRAME])))


def gate_launches_in_child():
    """``classic_launches_per_frame`` of the gate frame, taken in a new
    process of this script (``--gate-profiler-window``) whose profiler
    window is its first: in a long process the profiler loses kernel
    records (PERF.md §7), so a count made there could pass on an
    undercount or fail on a frame that launched every kernel.  The child
    loads the kernels this run built (``_build``'s cache) and is stopped
    at its time limit."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--gate-profiler-window"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, "the profiler's child process exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def sources_launched(fn) -> set:
    """The kernel sources (``_build.KERNELS``' keys) whose entry points
    ``fn()`` launched."""
    from ash_renderer_tpu_torch import _build

    used, real = set(), _build.launch

    def launch(kernel, entry, *args, **kw):
        used.add(_build._ENTRY_SOURCE[entry])
        return real(kernel, entry, *args, **kw)

    _build.launch = launch
    try:
        fn()
    finally:
        _build.launch = real
    return used


# pair budgets that cut the gate frame's pairs (phase 29 holds K12 to its
# plain version at each): 128 ends on the last pair of the third triangle
# with pairs (46 + 42 + 40 at orbit frame 0), 100 splits that triangle's
# rectangle after 12 of its 40 pairs
GATE_CUT_PAIRS = (128, 100)
# the plain-packed config4 subdivisions phase 29 holds K10 and K12 on:
# K10's crossover (geometry.K10_CLUSTER_MAX_TRIS) lies between 4 (5,120
# triangles) and 5 (20,480)
CROSSOVER_SUBDIVS = (4, 5)


def classic_glue_checks(dev, card: str, errs: dict, r5, cam5, g5) -> dict:
    """Phase 29: K8C, K10, K12 and K11 against their plain versions on the
    card (``classic_glue_case``) on the gate scene at 800x600 on three
    orbit frames (the first timed, and K12 on it at each of
    ``GATE_CUT_PAIRS`` too), the reference scene at 320x240, two clipping
    scenes under "classic" (one within its budget, one over it), the
    ``ssaa_srgb`` and ``multi_material`` golden scenes under "classic"
    (textured, lit; 2x SSAA and sRGB), the second of two row slabs of the
    reference scene, K10 and K12 on zero triangles (clip budgets 0 and
    4096), a gate slab from its middle tile row, the plain-packed config4
    frames of ``CROSSOVER_SUBDIVS`` and the meshlet-packed ``r5`` (config4
    subdiv 5) at ``cam5`` with its local corner ids (K5; timed too, K10
    with K5's gather); every frame EXACT against the port's oracle or its
    golden where it has one; K10 with the transform folded in and on K8C's
    rows, each in both its designs.  Then one gate frame's launches (route
    ``classic``: K10, K12, K4 and K11 once each, no K8C and no fused
    kernel; K10 in its cluster design), a meshlet-packed classic frame's
    (K10 twice around K5, K12, K4, K11), device kernels a frame by
    ``torch.profiler`` in a new process (``gate_launches_in_child``: the
    port's kernels among them equal to its launches over the same frames,
    and at most ``CLASSIC_DEVICE_KERNELS`` in all), one whole classic frame
    (``pipeline.render_frame``, its matrices on the card) under
    ``torch.cuda.set_sync_debug_mode("error")``, and the Renderer's own
    frame with no synchronizing call but its three uploads; the sources
    whose kernels a classic frame and a fused one (``r5``'s own route)
    launch are the route's in ``_build.ROUTE_SOURCES``, which
    ``Renderer.warmup`` builds.  Returns the timing of the first gate
    frame and the launch counts of the counted frames."""
    import dataclasses

    import numpy as np
    import torch

    from ash_renderer_tpu_torch import _build, pipeline
    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES, GOLDEN_SHA,
                                                   config4_million_tri)
    from ash_renderer_tpu_torch.camera import Camera, orbit_path
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.ops import (binning, geometry, meshlet_gather,
                                            raster_visibility, shade)
    from ash_renderer_tpu_torch.parallel import make_render_mesh, slab_rows
    from ash_renderer_tpu_torch.renderer import Renderer

    classic = dict(pipeline="classic")
    scene_g, _ = gate_scene()
    rg = Renderer(scene_g, RendererSettings(), device=dev)
    require(rg.settings.pipeline == "classic",
            f"gate scene at 800x600: auto took {rg.settings.pipeline}")
    orbit = orbit_path(N_FRAMES, radius=6.0, center=[0.0, 0.0, 3.5])
    timing = None
    for i in (0, 7, 15):
        f, _, t = classic_glue_case(rg, orbit[i], f"gate 800x600 orbit {i}",
                                    errs, timed=timing is None,
                                    cut_pairs=GATE_CUT_PAIRS if i == 0 else ())
        timing = timing or t
        o, o_s = oracle_frame(rg, orbit[i])
        require((f == o["rgba8"]).all(), f"gate orbit {i}: K11 frame != oracle")
        fr = rg.read_frame(rg.render_frame(orbit[i])[0])
        require((fr == f).all(), f"gate orbit {i}: Renderer frame != K11 frame")
        say(f"gate orbit {i}: frame EXACT against the port's oracle "
            f"({o_s:.1f} s)")
    say_timing(card, timing, " (gate 800x600, orbit frame 0)")

    ref_png = decode_png(os.path.join(ROOT, "tests", "golden",
                                      "reference_320x240.png"))
    ref_scene, ref_st = GOLDEN_SCENES["reference"]()
    rref = Renderer(ref_scene, dataclasses.replace(ref_st, **classic),
                    device=dev)
    f, _, _ = classic_glue_case(rref, Camera(), "reference 320x240", errs)
    require((f == ref_png).all(), "reference: K11 frame != golden PNG")
    say("reference 320x240: frame EXACT against tests/golden/"
        "reference_320x240.png")

    for label, build, st in (
            ("clip within budget", lambda: _clip_scene(6, 60, 50, 4.0, 0.8),
             RendererSettings(width=128, height=64, clip_budget=64)),
            ("clip over budget", lambda: _clip_scene(2, 170, 300, 8.0, 2.5),
             RendererSettings(width=192, height=128, clip_budget=8))):
        rc = Renderer(build(), dataclasses.replace(st, **classic), device=dev)
        f, c, _ = classic_glue_case(rc, Camera(), label, errs)
        require(c["n_clipped"] > 0, f"{label}: nothing clipped")
        require((c["clip_overflow"] > 0) == ("over" in label),
                f"{label}: overflow {c['clip_overflow']}")
        o, _ = oracle_frame(rc, Camera())
        require((f == o["rgba8"]).all(), f"{label}: K11 frame != oracle")
        say(f"{label}: frame EXACT against the port's oracle")

    for name in ("ssaa_srgb", "multi_material"):
        scene_n, st_n = GOLDEN_SCENES[name]()
        rn = Renderer(scene_n, dataclasses.replace(st_n, **classic),
                      device=dev)
        f, _, _ = classic_glue_case(rn, Camera(), name, errs)
        require(sha(f) == GOLDEN_SHA[name], f"{name}: K11 frame != golden")
        say(f"{name} (classic): golden sha256 EXACT")

    r2 = Renderer(ref_scene, dataclasses.replace(ref_st, **classic),
                  mesh=make_render_mesh([dev] * 2))
    rows_per = slab_rows(r2.statics, 2)
    classic_glue_case(rref, Camera(), "reference slab 2 of 2", errs,
                      tile_row0=rows_per, tile_rows=rows_per)
    f2 = r2.read_frame(r2.render_frame(Camera())[0])
    require((f2 == ref_png).all(), "reference in 2 slabs != golden PNG")
    say("reference 320x240 in 2 row slabs: frame EXACT against the golden")

    # zero triangles: a clip budget of 0 (S = 0) and the gate's (S =
    # 28,672 dead rows), K10's table binned by K12
    mats0 = frame_mats(rg, orbit[0])
    for budget in (0, rg.statics.settings.clip_budget):
        g0 = (rg.state.positions, rg.state.vert_obj, rg.state.normals,
              rg.state.colors, rg.state.uvs, *mats0[:2],
              rg.state.tri_v[:0], rg.state.tri_mat[:0], rg.statics.cfg,
              budget)
        label = f"zero triangles, clip budget {budget}"
        rows0, valid0, _, _, c0, _, _, _ = k10_case(g0, None, label, errs)
        require(rows0.shape[0] == 7 * budget and c0["n_valid"] == 0,
                f"{label}: {rows0.shape[0]} setup rows, {c0}")
        k12_case(rows0, valid0, rg.statics.cfg, rg.statics.settings.max_pairs,
                 label, errs)
    # a gate slab whose first tile row is not 0
    gate_rows = rg.statics.cfg.grid_h
    classic_glue_case(rg, orbit[0], f"gate 800x600 slab of tile rows "
                      f"{gate_rows // 2}-{gate_rows - 1}", errs,
                      tile_row0=gate_rows // 2,
                      tile_rows=gate_rows - gate_rows // 2)
    # the plain-packed config4 frames, either side of each crossover
    for n in CROSSOVER_SUBDIVS:
        scene_n, st_n, cams_n = config4_million_tri(n)
        rn = Renderer(scene_n, dataclasses.replace(st_n, **classic),
                      device=dev)
        f, _, _ = classic_glue_case(rn, cams_n[0],
                                    f"config4 subdiv {n} plain", errs)
        if n == 5:
            require(sha(f) == g5["sha256"], "classic subdiv 5 plain != golden")
            say("config4 subdiv 5, plain-packed: golden sha256 EXACT")
        del rn

    require(r5.packed.local_tri is not None, "r5 is not meshlet-packed")
    lt = torch.from_numpy(r5.packed.local_tri).to(dev)
    f, _, t5 = classic_glue_case(r5, cam5, "config4 subdiv 5 meshlets", errs,
                                 timed=True, local_tri=lt)
    require(sha(f) == g5["sha256"], "classic subdiv 5 (K5 corners) != golden")
    say("config4 subdiv 5, meshlet-packed (K5 corners): golden sha256 EXACT")
    # K10's time here holds K5's corner gather between its two launches
    say_timing(card, t5, " (config4 subdiv 5 meshlets, K10 with K5)")

    # the route's launches: one gate frame, counts zeroed just before it
    torch.cuda.synchronize()
    _build.launches.clear()
    with PlainVersionsRaise():
        rg.read_frame(rg.render_frame(orbit[3])[0])
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    say(f"gate frame launches: {json.dumps(counts, sort_keys=True)}; route "
        + require_route("gate frame", counts, rg))
    want_g = {geometry.KERNEL: 1, binning.KERNEL: 1,
              raster_visibility.KERNEL: 1, shade.KERNEL: 1}
    require(counts == want_g, f"gate frame: launches {counts}, not K10, K12, "
            "K4 and K11 once each (no K8C: its transform is K10's)")
    design = geometry.k10_design(rg.state.tri_v.shape[0])
    require(design == "cluster", f"gate frame: K10 takes the {design}")
    say("gate frame: 4 launches of the port (5 with K8C): K10 once (one "
        "thread block cluster's barriers, the transform folded in), K12 once "
        "(a cooperative grid), K4, K11")
    # a meshlet-packed classic frame: K10's vertex and triangle launches
    # around K5's corner gather, then K12, K4, K11; no K8C
    mats5 = frame_mats(r5, cam5)
    statics5 = classic_statics(r5)
    torch.cuda.synchronize()
    _build.launches.clear()
    with PlainVersionsRaise():
        pipeline.render_frame(statics5, r5.state, *mats5, local_tri=lt)
    torch.cuda.synchronize()
    counts5 = dict(_build.launches)
    want5 = {geometry.KERNEL: 2, meshlet_gather.KERNEL: 1, binning.KERNEL: 1,
             raster_visibility.KERNEL: 1, shade.KERNEL: 1}
    require(counts5 == want5, f"config4 subdiv 5 meshlet-packed classic "
            f"frame: launches {counts5}, not {want5}")
    say(f"config4 subdiv 5 meshlet-packed classic frame: "
        f"{sum(counts5.values())} launches of the port (7 with K8C): "
        f"{json.dumps(counts5, sort_keys=True)}")
    for label, r, cam in (("gate frame", rg, orbit[4]),
                          ("config4 subdiv 5 frame", r5, orbit[4])):
        used = sources_launched(lambda: r.read_frame(r.render_frame(cam)[0]))
        want = set(_build.ROUTE_SOURCES[r.settings.pipeline])
        require(used == want, f"{label}: launched the kernels of {sorted(used)}"
                f", not the {r.settings.pipeline} route's {sorted(want)}")
        say(f"{label} ({r.settings.pipeline}): its kernels' sources are "
            f"_build.ROUTE_SOURCES[{r.settings.pipeline!r}]")
    n_dev, n_port, seen, others, _ = gate_launches_in_child()
    require(n_port == len(want_g) and seen == n_port and n_dev >= n_port,
            f"gate frame: the profiler saw {n_dev} device kernels a frame, "
            f"{seen} of them the port's, against the port's {n_port} "
            f"launches (_build.launches over the same frames); not the "
            f"port's: {others}")
    require(n_dev <= CLASSIC_DEVICE_KERNELS,
            f"gate frame: {n_dev} device kernels a frame, more than "
            f"{CLASSIC_DEVICE_KERNELS}; not the port's: {others}")
    say(f"[{card}] gate frame (classic, 800x600): {n_dev:.1f} device "
        f"kernels a frame, {seen:.1f} of them the port's, in a new process's "
        f"first profiler window; not the port's: "
        f"{json.dumps(others, sort_keys=True)} (6 with K8C, 7 with K10's "
        "two launches, 186 with plain binning, 701 with every glue stage "
        "plain)")
    # the same window in this process, read and not checked: whether a
    # long process's profiler still loses records (PERF.md §7)
    n_dev_here, n_port_here, seen_here, _, port_here = (
        classic_launches_per_frame(rg, orbit[GATE_PROFILED_FRAME]))
    say(f"gate frame, the same window in this process after "
        f"{time.perf_counter() - T_START:.0f} s: {n_dev_here:.2f} device "
        f"kernels a frame, {seen_here:.2f} of the port's {n_port_here:.2f}: "
        f"{json.dumps(port_here, sort_keys=True)}")
    # one whole classic frame with its matrices on the card (the Renderer's
    # uploads of them from the host are copies that synchronize)
    mats = frame_mats(rg, orbit[5])
    torch.cuda.synchronize()

    def frame():
        return pipeline.render_frame(rg.statics, rg.state, *mats)[0]

    _, syncs = count_syncs(frame)
    require(not syncs, f"gate frame: {len(syncs)} synchronizing calls"
            + "".join(f"\n  {m}" for m in syncs))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fe = frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require((fe.cpu().numpy() == rg.read_frame(rg.render_frame(orbit[5])[0])
             ).all(), "gate frame under sync debug mode != Renderer frame")
    say("gate frame (pipeline.render_frame) under set_sync_debug_mode("
        "\"error\"): no host read, equal to the Renderer's frame")
    # the Renderer's own frame adds its three pageable uploads of the
    # matrices and the camera position (ROADMAP queue 4 item 3)
    _, r_syncs = count_syncs(lambda: rg.render_frame(orbit[5])[0])
    require(len(r_syncs) <= 3, f"Renderer gate frame: {len(r_syncs)} "
            "synchronizing calls, more than its three uploads")
    say(f"gate frame (Renderer.render_frame): {len(r_syncs)} synchronizing "
        "calls, at most its three uploads")
    return timing, counts


# the loss of the inverse-rendering example on the card against the CPU's:
# the forward images are bit-equal, but Adam's mean reductions sum in
# another order on each device, so the fits drift apart by float rounding
INV_LOSS_RTOL = 1e-2


def run_counted(fn, stdin=None):
    """``fn()`` with every kernel's plain version made to raise, stdout
    captured and ``stdin`` (when given) in place of sys.stdin; the launch
    counts are zeroed just before and read just after.  Returns (result,
    launch counts, seconds, captured stdout)."""
    import contextlib
    import io

    import torch

    from ash_renderer_tpu_torch import _build

    buf = io.StringIO()
    saved_stdin = sys.stdin
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    try:
        if stdin is not None:
            sys.stdin = stdin
        with PlainVersionsRaise(), contextlib.redirect_stdout(buf):
            res = fn()
            torch.cuda.synchronize()
    finally:
        sys.stdin = saved_stdin
    return res, dict(_build.launches), time.perf_counter() - t0, buf.getvalue()


def run_example(name: str, argv: list, **kw):
    """``examples/<name>`` run in this process as ``__main__`` with
    ``argv`` (``run_counted``)."""
    import runpy

    path = os.path.join(ROOT, "examples", name)
    saved = sys.argv
    sys.argv = [path, *argv]
    try:
        return run_counted(lambda: runpy.run_path(path, run_name="__main__"),
                           **kw)
    finally:
        sys.argv = saved


def examples_checks(dev, card: str, head5, r8, ref_golden: str) -> None:
    """Phase 20: the port's examples and last host helpers on the card,
    every kernel's plain version made to raise and the launch counts zeroed
    before each run and read after it.  ``examples/torch_render_scene.py``
    without ``--device`` on config4 at subdiv 8 (1080p; ``r8``: its
    Renderer on the card) writes a PNG that decodes to the headline golden
    and on the reference scene at 320x240 one equal to
    ``tests/golden/reference_320x240.png``, each launching the kernels of
    the route "auto" takes on the card (``route_kernels`` of a default
    Renderer of the same scene);
    ``torch_inverse_rendering.py`` on the card writes the CPU run's target
    PNG byte for byte, its loss falls and its last loss is the CPU's within
    ``INV_LOSS_RTOL``; ``torch_interactive.py`` runs 8 frames unattended
    (stdin not a tty); ``binsort.bin_sort`` on the subdiv-5 headline's
    setup gives the CPU's bounds and run rows (K2), full frame and a slab
    window; ``Renderer`` with ``preferred_device_index=0`` and no device
    renders on cuda:0 the frame of ``device="cuda:0"``."""
    import dataclasses
    import re
    import runpy
    import shutil

    import numpy as np
    import torch

    from ash_renderer_tpu_torch import benchmarks
    from ash_renderer_tpu_torch.ops import binsort, geometry
    from ash_renderer_tpu_torch.renderer import Renderer
    from ash_renderer_tpu_torch.rtypes import TriangleSetup

    out = os.path.join(ROOT, "build", "examples")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    # the render example on the headline, at full width, on the card by default
    g8 = golden("headline_config4.json")
    d8 = os.path.join(out, "config4")
    _, counts, dt, text = run_example(
        "torch_render_scene.py",
        ["config4_million_tri", "--frames", "1", "--out", d8])
    say(text.strip())
    say(json.dumps(counts, sort_keys=True))
    route8 = require_route("torch_render_scene.py config4_million_tri",
                           counts, r8)
    f8 = decode_png(os.path.join(d8, "frame_0000.png"))
    require(sha(f8) == g8["sha256"], f"torch_render_scene.py config4: PNG "
            f"sha256 {sha(f8)} != golden {g8['sha256']}")
    say(f"[{card}] examples/torch_render_scene.py config4_million_tri "
        f"({g8['n_tris']} tris, {f8.shape[1]}x{f8.shape[0]}, {route8}): PNG "
        "decodes to "
        f"the golden sha256 EXACT; {dt:.2f} s wall (scene, meshlets, upload, "
        "frame, PNG)")

    dref = os.path.join(out, "reference")
    _, counts, dt, text = run_example(
        "torch_render_scene.py", ["reference", "--size", "320x240", "--out",
                                  dref])
    scene_r, st_r, _ = benchmarks.ALL_CONFIGS["reference"]()
    route_r = require_route(
        "torch_render_scene.py reference", counts, Renderer(
            scene_r, dataclasses.replace(st_r, width=320, height=240),
            device=dev))
    fr = decode_png(os.path.join(dref, "frame_0000.png"))
    want = decode_png(os.path.join(ROOT, "tests", "golden",
                                   "reference_320x240.png"))
    require(fr.shape == want.shape and (fr == want).all() and
            sha(fr) == ref_golden,
            "torch_render_scene.py reference 320x240 != tests/golden PNG")
    say(f"[{card}] examples/torch_render_scene.py reference 320x240 "
        f"({route_r}, launches {json.dumps(counts, sort_keys=True)}): PNG == "
        f"tests/golden/reference_320x240.png; {dt:.2f} s wall")

    # the inverse-rendering example on the card and on the CPU
    inv = runpy.run_path(os.path.join(ROOT, "examples",
                                      "torch_inverse_rendering.py"),
                         run_name="torch_inverse_rendering")
    runs = {}
    for device in ("cuda", "cpu"):
        d = os.path.join(out, f"inverse_{device}")
        argv = ["--out", d] + (["--device", "cpu"] if device == "cpu" else [])
        if device == "cpu":
            t0 = time.perf_counter()
            losses = inv["main"](argv)
            counts, dt = {}, time.perf_counter() - t0
        else:
            losses, counts, dt, text = run_counted(lambda: inv["main"](argv))
            say(text.strip())
        with open(os.path.join(d, "inv_target.png"), "rb") as f:
            runs[device] = (losses, dt, f.read(), counts)
    (lg, tg, png_g, counts), (lc, tc, png_c, _) = runs["cuda"], runs["cpu"]
    require(png_g == png_c, "torch_inverse_rendering.py: the card's target "
            "PNG differs from the CPU's")
    require(len(lg) == 120 and lg[-1] < lg[0],
            f"torch_inverse_rendering.py on the card: loss {lg[0]:.4e} -> "
            f"{lg[-1]:.4e}")
    rel = abs(lg[-1] - lc[-1]) / lc[-1]
    require(rel <= INV_LOSS_RTOL, f"torch_inverse_rendering.py: last loss "
            f"card {lg[-1]:.6e} vs CPU {lc[-1]:.6e} (rel {rel:.3e} > "
            f"{INV_LOSS_RTOL})")
    say(f"[{card}] examples/torch_inverse_rendering.py (120 steps): target PNG "
        f"card == CPU byte for byte; loss card {lg[0]:.6e} -> {lg[-1]:.6e}, "
        f"CPU {lc[0]:.6e} -> {lc[-1]:.6e} (last losses within rel "
        f"{rel:.3e} <= {INV_LOSS_RTOL}); wall card {tg:.2f} s, CPU {tc:.2f} s;"
        f" launches {json.dumps(counts, sort_keys=True)} (shading is plain "
        "torch)")

    # the interactive example, unattended
    with open(os.devnull) as null:
        _, counts, dt, text = run_example(
            "torch_interactive.py", ["--frames", "8", "--size", "320x240"],
            stdin=null)
    m = re.search(r"\n(\d+) frames, ([0-9.]+) FPS\n", text)
    require(m is not None and m.group(1) == "8",
            "torch_interactive.py: no '8 frames, ... FPS' line")
    for k in ("K1_setup", "K2_run_bounds", "K3F_raster_shade"):
        require(counts.get(k, 0) > 0, f"{k} was not launched by "
                "torch_interactive.py")
    say(f"[{card}] examples/torch_interactive.py config3 320x240, stdin not a "
        f"tty: '{m.group(0).strip()}', {dt:.2f} s wall; launches "
        f"{json.dumps(counts, sort_keys=True)}")

    # bin_sort on the subdiv-5 headline's setup
    scene5, st5, cam5, g5 = head5
    r5 = Renderer(scene5, st5, device=dev)
    cfg = r5.cfg
    mm_t, mvp_t, _ = front_inputs(r5, cam5)
    s = r5.state
    lt = torch.from_numpy(r5.packed.local_tri).to(dev)

    def setup():
        clip, attrs = geometry.transform_vertices(
            s.positions, s.vert_obj, s.normals, s.colors, s.uvs, mm_t, mvp_t)
        return geometry.geometry_device(clip, attrs, s.tri_v, s.tri_mat, cfg,
                                        st5.clip_budget, local_tri=lt)[0]

    su = run_counted(setup)[0]
    su_cpu = TriangleSetup(**{f.name: getattr(su, f.name).cpu()
                              for f in dataclasses.fields(TriangleSetup)})
    rows = -(-cfg.grid_h // 8)
    for row0, n_rows in ((0, None), (3 * rows, rows)):
        (order, bounds), counts, dt, _ = run_counted(
            lambda: binsort.bin_sort(su, cfg, row0, n_rows))
        require(counts.get("K2_run_bounds", 0) > 0, "bin_sort: K2 not launched")
        o_c, b_c = binsort.bin_sort(su_cpu, cfg, row0, n_rows)
        order, bounds = order.cpu().numpy(), bounds.cpu().numpy()
        o_c, b_c = o_c.numpy(), b_c.numpy()
        require((bounds == b_c).all(), f"bin_sort window ({row0}, {n_rows}): "
                "card bounds != CPU bounds")
        run = np.searchsorted(bounds, np.arange(order.shape[0]), "right") - 1
        require((np.sort(order + run.astype(np.int64) * (1 << 32))
                 == np.sort(o_c + run.astype(np.int64) * (1 << 32))).all(),
                f"bin_sort window ({row0}, {n_rows}): a run holds other rows")
        live = int(bounds[-3])  # rows before the wide run
        say(f"[{card}] bin_sort subdiv 5, tile rows {row0}..."
            f"{row0 + (n_rows or cfg.grid_h) - 1}: {order.shape[0]} rows, "
            f"{live} coarse + fine before the wide run, bounds ({bounds.shape[0]}) "
            f"and run rows card == CPU; K2 {counts.get('K2_run_bounds', 0)}x, "
            f"{dt * 1e3:.3f} ms wall")

    # preferred_device_index with no device
    f_dev = r5.read_frame(r5.render_frame(cam5)[0])
    ri = run_counted(lambda: Renderer(
        scene5, dataclasses.replace(st5, preferred_device_index=0)))[0]
    require(ri.device == torch.device("cuda", 0),
            f"preferred_device_index=0: renderer on {ri.device}")
    fi, counts, _, _ = run_counted(lambda: ri.read_frame(
        ri.render_frame(cam5)[0]))
    require_route("the preferred_device_index renderer", counts, ri)
    require((fi == f_dev).all() and sha(fi) == g5["sha256"],
            "preferred_device_index=0: frame != the device='cuda:0' frame")
    say("Renderer(RendererSettings(preferred_device_index=0)) without a "
        f"device: on {ri.device}, subdiv-5 frame == the device='cuda:0' frame "
        "== golden sha256 EXACT")


# bench_torch.py's runs in phase 21: (label, argv)
BENCH_RUNS = (
    ("headline", ["--frames", "10"]),
    ("terrain", ["--config", "config4_terrain", "--frames", "5"]),
    ("config5", ["--config", "config5_flythrough", "--frames", "5"]),
    ("sweep", ["--sweep", "--frames", "3"]),
)
BENCH_FLAGS = ("[PARITY GATE FAILED]", "[HEADLINE HASH MISMATCH]")


def bench_checks(card: str) -> dict:
    """Phase 21: ``bench_torch.main`` in this process (the card by
    default) on the headline, terrain, config5 and the sweep, every
    kernel's plain version made to raise and the launch counts zeroed
    before each run and read after it.  Each run's stdout is one JSON
    line, unflagged, with ``value > 0``; the headline's has the three
    config4 keys.  The log must hold the fused parity gate, the hash gate
    (config5 without the reference's texture asset: its oracle gate) and,
    on the headline, the post-motion re-gate, each EXACT.  K1, K2 and K3F
    (the parity gate) must have launched across the runs, K3 exactly when
    the CUDA rule's shade knob is "off" (every config is within the table
    caps), K4 in
    the sweep exactly when its log routes a config to "[classic]", K5
    never.  Returns the launch counts summed over the runs."""
    import collections
    import contextlib
    import io

    import bench_torch
    from ash_renderer_tpu_torch import benchmarks
    from ash_renderer_tpu_torch.renderer import CUDA_SURFACE_SHADE

    gate = "parity gate (256x192, 160 tris, fused): EXACT"
    config5 = ("headline hash gate" if benchmarks.reference_texture_found()
               else "headline oracle gate") + " (800x600, 34048 tris): EXACT"
    want = {
        "headline": (gate, "headline hash gate (1920x1080, 1310720 tris): "
                     "EXACT", "post-motion static re-gate: EXACT"),
        "terrain": (gate, "headline hash gate (1920x1080, 1002528 tris): "
                    "EXACT"),
        "config5": (gate, config5),
        "sweep": tuple(f"{name:22s}" for name in benchmarks.ALL_CONFIGS),
    }
    total = collections.Counter()
    for label, argv in BENCH_RUNS:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            _, counts, dt, out = run_counted(lambda: bench_torch.main(argv))
        log = err.getvalue()
        for line in log.splitlines():
            say(f"  bench_torch {label}: {line}")
        lines = out.strip().splitlines()
        require(len(lines) == 1, f"bench_torch {label}: {len(lines)} stdout "
                "lines, not one")
        res = json.loads(lines[0])
        require(not any(f in res["metric"] for f in BENCH_FLAGS),
                f"bench_torch {label}: flagged: {res['metric']}")
        require(res["value"] > 0, f"bench_torch {label}: value {res['value']}")
        if label == "headline":
            for k in ("moving_camera_fps", "orbit_camera_fps",
                      "static_uncached_fps"):
                require(res.get(k, 0) > 0, f"bench_torch headline: no {k}")
        for w in want[label]:
            require(w in log, f"bench_torch {label}: no '{w}' in its log")
        if label == "sweep":
            classic = "[classic]" in log
            require((counts.get("K4_raster_classic", 0) > 0) == classic,
                    f"bench_torch --sweep: K4 launched "
                    f"{counts.get('K4_raster_classic', 0)}x, a config routed "
                    f"to classic: {classic}")
        total.update(counts)
        say(f"[{card}] bench_torch {' '.join(argv)}: {json.dumps(res)}; "
            f"{dt:.1f} s wall; launches {json.dumps(counts, sort_keys=True)}")
    for k in ("K1_setup", "K2_run_bounds", "K3F_raster_shade"):
        require(total.get(k, 0) > 0, f"{k} was not launched by bench_torch")
    require((total.get("K3_raster", 0) > 0) == (CUDA_SURFACE_SHADE == "off"),
            f"bench_torch: K3 launched {total.get('K3_raster', 0)}x under "
            f"CUDA_SURFACE_SHADE {CUDA_SURFACE_SHADE!r}")
    require(total.get("K5_gather_rows", 0) == 0, "bench_torch launched K5")
    return dict(total)


# phase 22: the auto rules.  Interleaved A/B pairs of rounds on one card
# (the decision rule they feed is written in PERF.md §6), then the routes
# "auto" takes on the card, each frame held exact.  An alternative clears a
# cell when its round beats the reference rule's route (the CPU's, which
# the card took before this measurement) in at least AB_WINS of the AB_PAIRS
# pairs on the wall metric (a one-sided sign test, p = 0.019): a bar that
# does not grow with the number of rounds, and that a drift of the host's
# speed across the cell, which both rounds of a pair share, does not move
AB_PAIRS = 12
AB_WINS = 10
AB_FRAMES = 20


def _ab_orbit(radius: float, center=None, height: float = 0.0):
    """AB_FRAMES cameras once round ``center`` (default [0, 0, radius], so
    frame 0 is the default ``Camera()`` at the origin looking down +Z)."""
    from ash_renderer_tpu_torch.camera import orbit_path

    return orbit_path(AB_FRAMES, radius=radius, height=height,
                      center=[0.0, 0.0, radius] if center is None else center)


def ab_scene_builders() -> dict:
    """{label: builder} of every scene phase 22 times; a builder returns
    (scene, settings, static camera, orbit cameras).  Each orbit circles
    the scene's own centre (the goldens' objects, config4's sphere) at the
    static camera's distance; terrain's and config5's keep their heights."""
    from ash_renderer_tpu_torch import benchmarks as bm
    from ash_renderer_tpu_torch.camera import Camera

    def golden_scene(name, radius):
        def build():
            sc, st = bm.GOLDEN_SCENES[name]()
            return sc, st, Camera(), _ab_orbit(radius)
        return build

    def config(fn, radius, *args, center=None, height=0.0):
        def build():
            sc, st, cams = fn(*args)
            return sc, st, cams[0], _ab_orbit(radius, center, height)
        return build

    def gate():
        sc, st = gate_scene()
        return sc, st, Camera(), _ab_orbit(3.5)

    c4 = bm.config4_million_tri
    return {
        "reference 320x240": golden_scene("reference", 2.5),
        "textured_mipmap": golden_scene("textured_mipmap", 2.2),
        "blinn_phong_specular": golden_scene("blinn_phong_specular", 2.6),
        "multi_material": golden_scene("multi_material", 2.6),
        "ssaa_srgb": golden_scene("ssaa_srgb", 2.4),
        "gate scene": gate,
        "config2": config(bm.config2_multi_mesh, 4.0),
        **{f"config4 subdiv {s}": config(c4, 2.0, s)
           for s in (1, 2, 3, 4, 5, 8)},
        "config3": config(bm.config3_blinn_phong, 3.0),
        "config1": config(bm.config1_textured_obj, 3.0),
        "config5": config(bm.config5_flythrough, 5.0, center=[0.0, 0.0, 0.0],
                          height=-1.5),
        "terrain": config(bm.config4_terrain, 6.0, center=[0.0, 0.0, 0.0],
                          height=-2.0),
    }


# the pipeline rule's scenes: every one the CPU rule sends to classic, then
# two from 4096 triangles up (where the CPU rule takes fused)
AB_PIPELINE_SCENES = ("reference 320x240", "gate scene", "ssaa_srgb",
                      "config4 subdiv 1", "config4 subdiv 2", "multi_material",
                      "blinn_phong_specular", "config4 subdiv 3",
                      "textured_mipmap", "config2", "config3",
                      "config4 subdiv 4")
# the shade rule's scenes: every textured one, on the fused route
AB_SHADE_SCENES = ("ssaa_srgb", "multi_material", "textured_mipmap",
                   "config4 subdiv 1", "config4 subdiv 2", "config4 subdiv 3",
                   "config1", "config4 subdiv 5", "config5", "terrain",
                   "config4 subdiv 8")


def ab_round(r, cams):
    """One round of ``r``'s frames over ``cams``: (wall ms per frame
    between two synchronizes, as ``bench_torch.py`` times it; median
    CUDA-event frame ms, as phase 6 times it)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(cams) + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    for c, e in zip(cams, ev[1:]):
        r.render_frame(c)
        e.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(cams)
    per = sorted(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
    return wall, per[len(per) // 2]


def ab_cell(card: str, group: str, scene: str, n_tris: int, regime: str,
            legs, cams) -> dict:
    """AB_PAIRS pairs of rounds over ``cams`` of two warmed legs, ((the
    reference rule's route, renderer), (the alternative, renderer)), each
    pair's order alternating (A B, B A, A B, ...).  A pair is the
    alternative's win on a metric when its round's number is the lower;
    the alternative clears when it wins at least AB_WINS pairs on the wall
    metric (the event metric's wins are reported beside it)."""
    import statistics

    import torch

    for _, r in legs:
        for c in cams[:2]:
            r.render_frame(c)
    torch.cuda.synchronize()
    rounds = {name: [] for name, _ in legs}
    for i in range(AB_PAIRS):
        for name, r in (legs if i % 2 == 0 else legs[::-1]):
            rounds[name].append(ab_round(r, cams))
    (a, _), (b, _) = legs
    row = {"group": group, "scene": scene, "n_tris": n_tris,
           "regime": regime, "today": a, "alt": b}
    text = []
    for i, metric in enumerate(("wall", "event")):
        xa = [x[i] for x in rounds[a]]
        xb = [x[i] for x in rounds[b]]
        wins = sum(x < y for x, y in zip(xb, xa))
        row[metric] = {a: xa, b: xb, "wins": wins}
        text.append(f"{metric} ms {a} {statistics.median(xa):.3f} {b} "
                    f"{statistics.median(xb):.3f}, {b} wins {wins}/{AB_PAIRS}")
    row["clears"] = row["wall"]["wins"] >= AB_WINS
    say(f"[{card}] A/B {group} | {scene} ({n_tris} tris) | {regime} | "
        + " | ".join(text) + f" | {b} clears: "
        + ("yes" if row["clears"] else "no"))
    return row


def auto_rule_ab(dev, card: str) -> list:
    """The A/B table of both auto rules: AB_PAIRS interleaved pairs of
    rounds of AB_FRAMES frames a cell, every renderer built and warmed
    first, with its front cache off (an orbit misses it anyway), every
    plain version made to raise.  Returns the rows (``ab_cell``).

    * Pipeline: classic against fused on each of AB_PIPELINE_SCENES,
      static and orbit.  The fused leg takes the reference's shade meaning
      ("off" on a textured scene, "on" otherwise), so that the shade rule
      is measured apart.
    * Shade: "off" (the CPU rule's route on a textured scene) against
      "on" on each of AB_SHADE_SCENES on the fused route, static and
      orbit; config4 subdiv 8 also on the fly-by and in 8 row slabs on
      this card (static)."""
    import dataclasses

    import torch

    from ash_renderer_tpu_torch.parallel import make_render_mesh
    from ash_renderer_tpu_torch.renderer import Renderer

    builders = ab_scene_builders()
    rows = []

    def legs_of(sc, st, routes, **kw):
        return [(name, Renderer(sc, dataclasses.replace(
            st, front_coherence=False, **knobs), **kw))
            for name, knobs in routes]

    with PlainVersionsRaise():
        for label in AB_PIPELINE_SCENES:
            sc, st, cam, orbit = builders[label]()
            n = sum(m.num_triangles for m in sc.meshes)
            routes = [("classic", dict(pipeline="classic")),
                      ("fused", dict(pipeline="fused", fused_surface_shade=(
                          "off" if sc.atlas is not None else "on")))]
            if n >= 4096:  # the CPU rule takes fused there
                routes.reverse()
            legs = legs_of(sc, st, routes, device=dev)
            for regime, cams in (("static", [cam] * AB_FRAMES),
                                 ("orbit", orbit)):
                rows.append(ab_cell(card, "pipeline", label, n, regime, legs,
                                    cams))
            del legs
        for label in AB_SHADE_SCENES:
            sc, st, cam, orbit = builders[label]()
            n = sum(m.num_triangles for m in sc.meshes)
            routes = [(k, dict(pipeline="fused", fused_surface_shade=k))
                      for k in ("off", "on")]
            cells = [("static", [cam] * AB_FRAMES), ("orbit", orbit)]
            if label == "config4 subdiv 8":
                cells.append(("fly-by", [flyby_camera(i, AB_FRAMES)
                                         for i in range(AB_FRAMES)]))
            legs = legs_of(sc, st, routes, device=dev)
            for regime, cams in cells:
                rows.append(ab_cell(card, "shade", label, n, regime, legs,
                                    cams))
            del legs
            if label == "config4 subdiv 8":
                legs = legs_of(sc, st, routes,
                               mesh=make_render_mesh([dev] * 8))
                rows.append(ab_cell(card, "shade", label, n,
                                    "8 row slabs, static", legs,
                                    [cam] * AB_FRAMES))
                del legs
        torch.cuda.synchronize()
    return rows


def ab_decision(rows):
    """What the decision rule gives on the A/B table: (the CUDA pipeline
    threshold, the CUDA textured shade mode).

    * Fused replaces classic from the smallest triangle count from which
      it clears on every scene and regime above it: 0 if it clears on
      every scene measured, the CPU rule's 4096 if it fails on the largest
      classic one.  None where classic clears on a scene from 4096 up
      (the rule would have to rise: not a case the constants cover).
    * "on" replaces "off" only if it clears on every textured scene and
      regime."""
    from ash_renderer_tpu_torch.renderer import AUTO_FUSED_TRIS

    pipe = [r for r in rows if r["group"] == "pipeline"]
    if any(r["clears"] for r in pipe if r["today"] == "fused"):
        threshold = None
    else:
        counts = sorted({r["n_tris"] for r in pipe if r["today"] == "classic"},
                        reverse=True)
        threshold = 0
        for i, n in enumerate(counts):
            if not all(r["clears"] for r in pipe
                       if r["today"] == "classic" and r["n_tris"] == n):
                threshold = counts[i - 1] if i else AUTO_FUSED_TRIS
                break
    shade = [r["clears"] for r in rows if r["group"] == "shade"]
    return threshold, "on" if all(shade) else "off"


def route_kernels(r, cached: bool = False):
    """(the Renderer ``r``'s route as "pipeline / shade", the kernels each
    of its frames must launch, the kernels it must not launch): its
    resolved ``settings.pipeline``, and on the fused route K3F and K7
    exactly where ``pipeline.shade_mode_for`` gives its statics a shade
    mode (the table caps included), and the front's kernels (K8, K1, K6,
    K2, K9) on a frame that computes its front, none on a ``cached`` one
    (a front-cache hit); on the classic route K10, K12, K4 and K11, and no
    fused kernel and no K8C (its transform is K10's).  The Renderer packs
    the classic route plainly, so K5 is never among them."""
    from ash_renderer_tpu_torch import pipeline

    from ash_renderer_tpu_torch.ops import (binning, front_meta, geometry,
                                            shade, shade_pack,
                                            vertex_transform)
    from ash_renderer_tpu_torch.ops import fused_kernel as fk

    st = r.settings
    route = f"{st.pipeline} / {st.fused_surface_shade}"
    rasters = {fk.kernel_name(th, f) for th in fk.TILE_HEIGHTS
               for f in (False, True)}  # K3 and K3F at 8 and 4 rows
    front = {vertex_transform.KERNEL, "K1_setup", "K6_clip_tail",
             "K2_run_bounds", front_meta.KERNEL}
    classic = {geometry.KERNEL, binning.KERNEL, "K4_raster_classic",
               shade.KERNEL}
    if st.pipeline == "classic":
        return route, classic, {
            "K5_gather_rows", geometry.KERNEL_TRANSFORM, shade_pack.KERNEL,
            *front, *rasters}
    s = r.state
    phase_f = pipeline.shade_mode_for(
        r.statics, s.materials, s.atlas if r.statics.has_atlas else None,
        s.light if r.statics.has_light else None) is not None
    k3 = fk.kernel_name(r.cfg.tile_h, phase_f)
    shade_k = {shade_pack.KERNEL}
    must = {k3, *(shade_k if phase_f else ())}
    must_not = {"K5_gather_rows", geometry.KERNEL_TRANSFORM, *classic,
                *(rasters - {k3}),
                *(() if phase_f else shade_k)}
    return route, must | (set() if cached else front), must_not | (
        front if cached else set())


def require_route(label: str, counts: dict, r, cached: bool = False) -> str:
    """Fail unless ``counts`` (one run's launches) holds every kernel of
    the Renderer ``r``'s route (``route_kernels``, ``cached`` for runs of
    front-cache hits) and none it excludes; returns the route as
    "pipeline / shade"."""
    route, must, must_not = route_kernels(r, cached)
    require(all(counts.get(k, 0) > 0 for k in must)
            and not any(counts.get(k, 0) for k in must_not),
            f"{label}: launches {counts} are not route {route}'s")
    return route


def auto_route_gates(dev, card: str, head8) -> dict:
    """The routes "auto" now takes on the card: for every config of
    ``benchmarks.ALL_CONFIGS`` and each pinned golden scene, a default
    ``Renderer`` on the card, its resolved (pipeline, shade) and the
    kernels one frame launched (every plain version raising, the counts
    zeroed just before the frame and read just after).  The launched
    kernels must be the resolved route's; every frame must be exact: the
    goldens against ``tests/golden/*.png``, config4 subdivs 8 and 5 and
    terrain against ``docs/golden/``, config5 against its golden where the
    reference's texture asset is present, else against the port's oracle
    (``bench_torch.oracle_frame``), the other configs against the port's
    oracle; config4 subdiv 8 in 8 row slabs against the single device's
    frame.  ``head8``: config4 subdiv 8's (scene, settings, camera), built
    once by the caller.  Returns the launch counts summed over the
    frames."""
    import collections

    import numpy as np

    import bench_torch
    from ash_renderer_tpu_torch import benchmarks as bm
    from ash_renderer_tpu_torch.camera import Camera
    from ash_renderer_tpu_torch.parallel import make_render_mesh
    from ash_renderer_tpu_torch.renderer import (CUDA_AUTO_FUSED_TRIS,
                                                 CUDA_SURFACE_SHADE, Renderer,
                                                 auto_route)

    say(f"renderer.py: CUDA_AUTO_FUSED_TRIS = {CUDA_AUTO_FUSED_TRIS}, "
        f"CUDA_SURFACE_SHADE = {CUDA_SURFACE_SHADE!r}")
    pngs = {name: os.path.join(ROOT, "tests", "golden",
                               "reference_320x240.png" if name == "reference"
                               else f"golden_{name}.png")
            for name in bm.GOLDEN_SCENES}
    docs = {"config4_million_tri": "headline_config4.json",
            "config4_terrain": "headline_terrain.json"}
    total = collections.Counter()

    def check(label, r, settings, cam, want):
        """One counted frame of ``r``, built from ``settings``;
        ``want(frame)`` -> (ok, what)."""
        st = auto_route(settings, r.device,
                        sum(m.num_triangles for m in r.scene.meshes))
        require(r.settings == st and st.pipeline in ("fused", "classic")
                and st.fused_surface_shade in ("on", "off"),
                f"{label}: resolved to {r.settings.pipeline} / "
                f"{r.settings.fused_surface_shade}, auto_route gives "
                f"{st.pipeline} / {st.fused_surface_shade}")
        f, counts, _, _ = run_counted(lambda: r.read_frame(
            r.render_frame(cam)[0]))
        route = require_route(label, counts, r)
        ok, what = want(f)
        require(ok, f"{label} on its auto route: frame != {what}")
        total.update(counts)
        say(f"[{card}] auto route | {label} "
            f"({sum(m.num_triangles for m in r.scene.meshes)} tris, "
            f"{f.shape[1]}x{f.shape[0]}) | {route} | launches "
            f"{json.dumps(counts, sort_keys=True)} | {what}: EXACT")
        return f

    for name, build in bm.GOLDEN_SCENES.items():
        sc, st = build()
        png = decode_png(pngs[name])
        check(f"golden {name}", Renderer(sc, st, device=dev), st, Camera(),
              lambda f: (f.shape == png.shape and (f == png).all()
                         and sha(f) == bm.GOLDEN_SHA[name],
                         f"tests/golden/{os.path.basename(pngs[name])}"))
    for name, build in bm.ALL_CONFIGS.items():
        if name == "config4_million_tri":
            sc, st, cam = head8
        else:
            sc, st, cams = build()
            cam = cams[0]
        r = Renderer(sc, st, device=dev)
        if name in docs:
            g = golden(docs[name])
            want = (lambda f, g=g, d=docs[name]: (sha(f) == g["sha256"],
                                                  f"docs/golden/{d}"))
        elif name == "config5_flythrough" and not bm.reference_texture_found():
            o = bench_torch.oracle_frame(name)
            want = (lambda f, o=o: (np.array_equal(f, o),
                                    "the port's oracle (bench_torch."
                                    "oracle_frame; no texture asset)"))
        elif name == "config5_flythrough":
            g = golden("headline_config5.json")
            want = (lambda f, g=g: (sha(f) == g["sha256"],
                                    "docs/golden/headline_config5.json"))
        else:
            o = oracle_frame(r, cam)[0]["rgba8"]
            want = (lambda f, o=o: (np.array_equal(f, o), "the port's oracle"))
        f = check(name, r, st, cam, want)
        del r
        if name == "config4_million_tri":
            f8 = f
            sc5, st5, cams5 = build(5)
            g5 = golden("headline_config4_s5.json")
            check("config4_million_tri subdiv 5",
                  Renderer(sc5, st5, device=dev), st5, cams5[0],
                  lambda f: (sha(f) == g5["sha256"],
                             "docs/golden/headline_config4_s5.json"))
            rs = Renderer(sc, st, mesh=make_render_mesh([dev] * 8))
            check("config4_million_tri in 8 row slabs", rs, st, cam,
                  lambda f: (np.array_equal(f, f8) and sha(f) == g["sha256"],
                             "the single device's frame and docs/golden/"
                             "headline_config4.json"))
            del rs
    return dict(total)


def auto_rules_phase(dev, card: str, head8) -> dict:
    """Phase 22: the A/B table, what the decision rule gives on it beside
    the constants ``renderer.py`` holds, then ``auto_route_gates``."""
    from ash_renderer_tpu_torch.renderer import (CUDA_AUTO_FUSED_TRIS,
                                                 CUDA_SURFACE_SHADE)

    with Phase("22 the auto rules"):
        say(card)
        rows = auto_rule_ab(dev, card)
        threshold, shade = ab_decision(rows)
        agree = (threshold, shade) == (CUDA_AUTO_FUSED_TRIS,
                                       CUDA_SURFACE_SHADE)
        say(f"[{card}] decision rule on this table: fused from {threshold} "
            f"triangles, textured shade {shade!r}; renderer.py holds "
            f"{CUDA_AUTO_FUSED_TRIS} and {CUDA_SURFACE_SHADE!r}: "
            + ("the same" if agree else "NOT the same (PERF.md §6 names "
               "the run that set them)"))
        return auto_route_gates(dev, card, head8)


BENCH_CELL_FRAMES = 24


def bench_cells_phase(card: str) -> None:
    """Phase 23: ``benchmark.run.run`` on every one-card cell at
    ``BENCH_CELL_FRAMES`` frames of the default seed's path; every gate
    must come out exact."""
    from benchmark import cells, run

    with Phase("23 the benchmark's cells"):
        for cell in cells.load().values():
            if cell.chips != 1:
                continue
            t0 = time.perf_counter()
            rep = run.run(cell.name, frames=BENCH_CELL_FRAMES)
            bad = [what for what, ok in rep.gates if not ok]
            require(rep.correct, f"benchmark cell {cell.name}: gates failed: "
                    + "; ".join(bad))
            say(f"[{card}] benchmark cell {cell.name}: {len(rep.gates)} gated "
                f"frames EXACT, frame_ms_p50 {rep.metrics['frame_ms_p50']}, "
                f"p95 {rep.metrics['frame_ms_p95']} ({BENCH_CELL_FRAMES} "
                f"frames); {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of the "
                                 "PyTorch/CUDA port.")
    ap.add_argument("--auto-rules", action="store_true",
                    help="run phases 1, 2 and 22 alone (the auto rules' A/B "
                    "table and routes); prints no kernels or ok line")
    ap.add_argument("--bench-cells", action="store_true",
                    help="run phases 1, 2 and 23 alone (the benchmark's "
                    "one-card cells); prints no kernels or ok line")
    ap.add_argument("--tile-h4", action="store_true",
                    help="run phases 1, 2 and 24 alone (K3 and K3F on 4-row "
                    "tiles); prints no kernels or ok line")
    ap.add_argument("--clip-tail", action="store_true",
                    help="run phases 1, 2 and 25 alone (the clip tail, K6); "
                    "prints no kernels or ok line")
    ap.add_argument("--shade-pack", action="store_true",
                    help="run phases 1, 2 and 26 alone (shade + pack, K7); "
                    "prints no kernels or ok line")
    ap.add_argument("--classic-glue", action="store_true",
                    help="run phases 1, 2 and 29 alone (the classic route's "
                    "glue: K8C, K10 with the transform folded in, K12, K11); "
                    "prints no kernels or ok line")
    ap.add_argument("--gate-profiler-window", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--front-glue", action="store_true",
                    help="run phases 1, 2, 27 and 28 alone (the vertex "
                    "transform K8, the expansion and range meta K9); prints "
                    "no kernels or ok line")
    args = ap.parse_args(argv)
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
    if args.gate_profiler_window:
        gate_profiler_window(dev)
        return 0

    global CARD
    with Phase("1 card"):
        card = CARD = card_line()
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
        check_frames(logs)
        check_native_meshlets()

    import dataclasses

    from ash_renderer_tpu_torch.benchmarks import (config3_blinn_phong,
                                                   config4_million_tri)

    if args.bench_cells:
        bench_cells_phase(card)
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2 and "
            "23 alone)")
        return 0
    if args.auto_rules:
        scene8, st8, cams8 = config4_million_tri(8)
        auto_rules_phase(dev, card, (scene8, st8, cams8[0]))
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2 and "
            "22 alone)")
        return 0
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.renderer import Renderer

    def tile_h4_phase(errs, head5, head8, head3, r8_8):
        with Phase("24 K3 / K3F at 4-row tiles"):
            return tile_h4_checks(dev, card, errs, head5, head8, head3, r8_8)

    def clip_tail_phase(errs, r8):
        with Phase("25 the clip tail (K6) vs plain"):
            return clip_tail_checks(dev, card, errs, r8)

    def shade_pack_phase(errs, r8, cam8):
        with Phase("26 shade + pack (K7) vs plain"):
            return shade_pack_checks(dev, card, errs, r8, cam8)

    def front_glue_phases(errs, r8, cam8):
        with Phase("27 the vertex transform (K8) vs plain"):
            timing = transform_checks(dev, card, errs, r8, cam8)
        with Phase("28 the expansion and range meta (K9) vs plain"):
            timing.update(front_meta_checks(dev, card, errs, r8, cam8))
        return timing

    def classic_glue_phase(errs, head5):
        with Phase("29 the classic route's glue (K8C, K10, K12, K11) vs "
                   "plain"):
            scene5, st5, cam5, g5 = head5
            return classic_glue_checks(
                dev, card, errs, Renderer(scene5, st5, device=dev), cam5, g5)

    if args.classic_glue:
        scene5, st5, cams5 = config4_million_tri(5)
        classic_glue_phase({}, (scene5, st5, cams5[0],
                                golden("headline_config4_s5.json")))
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2 and "
            "29 alone)")
        return 0
    if args.clip_tail:
        scene8, st8, _ = config4_million_tri(8)
        clip_tail_phase({}, Renderer(scene8, st8, device=dev))
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2 and "
            "25 alone)")
        return 0
    if args.shade_pack:
        scene8, st8, cams8 = config4_million_tri(8)
        shade_pack_phase({}, Renderer(scene8, st8, device=dev), cams8[0])
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2 and "
            "26 alone)")
        return 0
    if args.front_glue:
        scene8, st8, cams8 = config4_million_tri(8)
        front_glue_phases({}, Renderer(scene8, st8, device=dev), cams8[0])
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2, 27 "
            "and 28 alone)")
        return 0
    if args.tile_h4:
        heads = []
        for n, g in ((5, "headline_config4_s5.json"),
                     (8, "headline_config4.json")):
            scene_n, st_n, cams_n = config4_million_tri(n)
            heads.append((scene_n, st_n, cams_n[0], golden(g)))
        scene3, st3, cams3 = config3_blinn_phong()
        tile_h4_phase({}, *heads, (scene3, st3, cams3[0]),
                      Renderer(heads[1][0], heads[1][1], device=dev))
        say(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2 and "
            "24 alone)")
        return 0

    errs: dict = {}
    with Phase("3 kernels vs plain (subdiv 5)"):
        scene5, st5, cams5 = config4_million_tri(5)
        # "off" named: phase 4's subdiv-5 frame is K3's counted run ("auto"
        # takes K3F on the card)
        r5 = Renderer(scene5, dataclasses.replace(
            st5, fused_surface_shade="off"), device=dev)
        compare_kernels(r5, cams5[0], "static", errs)
        compare_flyby(r5, "fly-by", errs)
        compare_k2_edges(dev, errs)
        rfp, camfp = fine_padding_renderer(dev)
        stats = compare_kernels(rfp, camfp, "fine padding 150x64", errs)[0]
        require(stats["fine_slots"] >= 3, "fine padding: no fine rows")
        compare_k3f(rfp, camfp, "fine padding 150x64", errs)
        del rfp
        torch.cuda.synchronize()

    with Phase("4 frames through Renderer"):
        t0 = time.perf_counter()
        scene8, st8, cams8 = config4_million_tri(8)
        r8 = Renderer(scene8, st8, device=dev)
        torch.cuda.synchronize()
        say(f"subdiv-8 scene set-up (mesh, meshlets, upload): "
            f"{time.perf_counter() - t0:.1f} s")
        f5, counts5, _, _ = run_counted(lambda: r5.read_frame(
            r5.render_frame(cams5[0])[0]))
        g5 = golden("headline_config4_s5.json")
        require(sha(f5) == g5["sha256"],
                f"subdiv-5 frame sha256 {sha(f5)} != golden {g5['sha256']}")
        say(f"subdiv-5 frame {f5.shape[1]}x{f5.shape[0]} (off): golden sha256 "
            "EXACT")
        _build.launches.clear()
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
        counts8 = dict(_build.launches)
        counts = {k: counts5.get(k, 0) + counts8.get(k, 0)
                  for k in {**counts5, **counts8}}

    with Phase("5 launch counts"):
        say(json.dumps(counts, sort_keys=True))
        # the subdiv-5 frame on "off" (K3), the headline's on the route
        # "auto" takes on the card
        say("phase 4 routes: subdiv 5 " + require_route(
            "phase 4 subdiv 5", counts5, r5) + ", subdiv 8 "
            + require_route("phase 4 subdiv 8", counts8, r8))
        # one launch of K6 and of K9 a front, as of K8
        from ash_renderer_tpu_torch.ops import (clip_tail, front_meta,
                                                vertex_transform)
        for label, c in (("subdiv 5", counts5), ("subdiv 8", counts8)):
            n_fronts = c.get(vertex_transform.KERNEL, 0)
            require(n_fronts > 0 and c.get(clip_tail.KERNEL, 0) == n_fronts
                    and c.get(front_meta.KERNEL, 0) == n_fronts,
                    f"phase 4 {label}: K6 and K9 do not launch once a "
                    f"front: {c}")
        say("phase 4: K6 and K9 launched once a front ("
            f"{counts5[vertex_transform.KERNEL]} + "
            f"{counts8[vertex_transform.KERNEL]} fronts)")

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
        say_timing(card, timing)
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
        r8u = Renderer(scene8, dataclasses.replace(
            st8, fused_surface_shade="off", **nocache), device=dev)
        r8u_on = Renderer(scene8, dataclasses.replace(on, **nocache), device=dev)
        turns(card, "config4 subdiv 8 static uncached", [("off", r8u), ("on", r8u_on)],
              [cams8[0]] * N_FRAMES)
        stage_ms(r8u_on, cams8[0])  # warm-up
        say(f"[{card}] stage ms (subdiv 8 on, static, uncached): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stage_ms(r8u_on, cams8[0]).items()))
        del r8u, r8u_on

    with Phase("11 K4 and K5 vs plain (classic frame, config4 meshlets)"):
        compare_k5_edges(dev, errs)
        compare_classic(r5, cams5[0], "classic static subdiv 5", errs)
        stats = compare_classic(r5, flyby_camera(FLYBY_FRAME, N_FRAMES),
                                "classic fly-by subdiv 5", errs)[0]
        require(stats["n_clipped"] > 0, "classic fly-by frame does not clip")
        _, timing_c = compare_classic(r8, cams8[0], "classic static subdiv 8",
                                      errs, timed=True)
        timing.update(timing_c)
        say_timing(card, timing_c)
        torch.cuda.synchronize()

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.benchmarks import (GOLDEN_SCENES, GOLDEN_SHA,
                                                   config2_multi_mesh)
    from ash_renderer_tpu_torch.camera import Camera
    from ash_renderer_tpu_torch.config import RendererSettings

    with Phase("12 classic frames"):
        _build.launches.clear()
        golden_rs = {}
        classic = dict(pipeline="classic")
        for name, build in GOLDEN_SCENES.items():
            scene_g, st_g = build()
            rg = golden_rs[name] = Renderer(
                scene_g, dataclasses.replace(st_g, **classic), device=dev)
            fg = rg.read_frame(rg.render_frame(Camera())[0])
            require(sha(fg) == GOLDEN_SHA[name], f"{name}: frame != golden")
            say(f"{name} {fg.shape[1]}x{fg.shape[0]} (classic): "
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
        r2 = Renderer(scene2, dataclasses.replace(st2, **classic), device=dev)
        f2 = r2.read_frame(r2.render_frame(cams2[0])[0])
        r2cpu = Renderer(scene2, dataclasses.replace(st2, **classic),
                         device="cpu")
        f2cpu = r2cpu.read_frame(r2cpu.render_frame(cams2[0])[0])
        require((f2 == f2cpu).all(), "config2: card frame != CPU frame")
        require(int(f2[..., :3].max()) > 0, "config2: the frame is black")
        say(f"config2 {f2.shape[1]}x{f2.shape[0]} (classic): card "
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
        # outside the counted run: K4 against its plain version on the
        # records of each frame above
        for name, rg in golden_rs.items():
            compare_classic(rg, Camera(), f"{name} (classic)", errs)
        compare_classic(r2, cams2[0], "config2 (classic)", errs)
        del golden_rs

    with Phase("13 classic timings"):
        from ash_renderer_tpu_torch.scene import reference_two_triangle_scene

        # the Renderer's own classic route at the headline size (plain
        # packing, the frames timed below): K4 against its plain version,
        # timed
        r8c = Renderer(scene8, dataclasses.replace(st8, pipeline="classic"),
                       device=dev)
        stats, timing_r = compare_classic(r8c, cams8[0],
                                          "Renderer classic subdiv 8", errs,
                                          timed=True)
        require(stats["pairs_overflow"] == 0 and stats["clip_overflow"] == 0,
                "Renderer classic subdiv 8: pairs or clip candidates overflow")
        say_timing(card, timing_r, " (Renderer classic subdiv 8)")

        rref = Renderer(reference_two_triangle_scene(), RendererSettings(
            **classic), device=dev)
        for label, r, cam in (("reference 800x600", rref, Camera()),
                              ("config2 800x600", r2, cams2[0])):
            med, mean, worst = frames_ms(r, [cam] * N_FRAMES)
            say(f"[{card}] frame ms, {label} (classic): median {med:.3f}, mean "
                f"{mean:.3f}, max {worst:.3f} ({N_FRAMES} frames)")
            # the same scene on the fused route (phase 22 times both for
            # the auto rule)
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

    with Phase("14 the non-meshlet fused fallback (render_frame_fused)"):
        counts_fb, aux_fb8, fb8 = fallback_checks(
            dev, card, errs, (scene5, st5, cams5[0], g5),
            (scene8, st8, cams8[0], g8))

    with Phase("15 build_comb_table through K5 at F = 12 (config4 subdiv 8)"):
        counts_k5, timing_k5 = comb_k5_check(r8, cams8[0], errs, timed=True)
        timing.update(timing_k5)
        say_timing(card, timing_k5, " (build_comb_table, subdiv 8)")
        torch.cuda.synchronize()

    with Phase("16 the oracle, debug and profiling layer"):
        from ash_renderer_tpu_torch.scene import reference_two_triangle_scene

        debug_checks(dev, card, (
            ("reference 800x600 (classic)",
             Renderer(reference_two_triangle_scene(), RendererSettings(
                 **classic), device=dev), Camera()),
            ("config3 800x600 (fused, K3F)", r3, cams3[0]),
            ("config4 subdiv 5 (fused, textured, "
             f"{r5.settings.fused_surface_shade})", r5, cams5[0])),
            (("staged", aux8), ("fallback", aux_fb8)), fb8, cams8[0])
        del fb8
        say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with Phase("17 the app, asset loaders and serialization on the card"):
        torch.cuda.reset_peak_memory_stats()
        app_checks(dev, card, GOLDEN_SHA["reference"])
        say(f"peak device memory (phase 17): "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with Phase("18 diffrender on the card"):
        diffrender_checks(dev, card)

    with Phase("19 row slabs on the card"):
        counts_slab = slab_checks(dev, card, errs, (scene5, st5, cams5[0], g5),
                                  (scene8, st8, cams8[0], g8))

    with Phase("20 examples and host helpers on the card"):
        examples_checks(dev, card, (scene5, st5, cams5[0], g5), r8,
                        GOLDEN_SHA["reference"])

    with Phase("21 bench_torch on the card"):
        bench_checks(card)

    auto_rules_phase(dev, card, (scene8, st8, cams8[0]))
    bench_cells_phase(card)

    timing_t4, counts_t4 = tile_h4_phase(
        errs, (scene5, st5, cams5[0], g5), (scene8, st8, cams8[0], g8),
        (scene3, st3, cams3[0]), r8)
    timing.update(timing_t4)
    timing.update(clip_tail_phase(errs, r8))
    timing.update(shade_pack_phase(errs, r8, cams8[0]))
    timing.update(front_glue_phases(errs, r8, cams8[0]))
    timing_g, counts_g = classic_glue_phase(errs, (scene5, st5, cams5[0], g5))
    timing.update(timing_g)

    meta = {
        "K1": ("K1_setup", "ash_renderer_tpu_torch/csrc/setup.cu",
               "ash_renderer_tpu/ops/setup_kernel.py:351", counts),
        "K2": ("K2_run_bounds", "ash_renderer_tpu_torch/csrc/bincount.cu",
               "ash_renderer_tpu/ops/bincount.py:129", counts),
        "K3": ("K3_raster", "ash_renderer_tpu_torch/csrc/raster.cu",
               "ash_renderer_tpu/ops/fused_kernel.py:1087", counts),
        "K3F": ("K3F_raster_shade", "ash_renderer_tpu_torch/csrc/raster.cu",
                "ash_renderer_tpu/ops/fused_kernel.py:128", counts_f),
        "K3_t4": ("K3_raster_t4", "ash_renderer_tpu_torch/csrc/raster.cu",
                  "ash_renderer_tpu/ops/fused_kernel.py:1087", counts_t4),
        "K3F_t4": ("K3F_raster_shade_t4", "ash_renderer_tpu_torch/csrc/raster.cu",
                   "ash_renderer_tpu/ops/fused_kernel.py:128", counts_t4),
        "K4": ("K4_raster_classic", "ash_renderer_tpu_torch/csrc/raster_classic.cu",
               "ash_renderer_tpu/ops/raster_pallas.py:203", counts_c),
        "K5": ("K5_gather_rows", "ash_renderer_tpu_torch/csrc/gather.cu",
               "ash_renderer_tpu/ops/meshlet_gather.py:97", counts_c),
        "K5_F12": ("K5_gather_rows_F12", "ash_renderer_tpu_torch/csrc/gather.cu",
                   "ash_renderer_tpu/ops/meshlet_gather.py:97", counts_k5),
        # no Pallas kernel: the reference's clip tail is XLA glue under one
        # jit (_clip_tail_into)
        "K6": ("K6_clip_tail", "ash_renderer_tpu_torch/csrc/clip_tail.cu",
               "none (ash_renderer_tpu/pipeline.py:416, XLA glue)", counts),
        # no Pallas kernel: the reference's shade + pack after the fused
        # kernel is XLA glue (_shade_from_planes, phase F branch)
        "K7": ("K7_shade_pack", "ash_renderer_tpu_torch/csrc/shade_pack.cu",
               "none (ash_renderer_tpu/pipeline.py:239, XLA glue)", counts),
        # no Pallas kernel: the reference's vertex transform and its
        # expansion + range meta are XLA glue (_fstage_transform,
        # sort_expand_table)
        "K8": ("K8_vertex_transform", "ash_renderer_tpu_torch/csrc/transform.cu",
               "none (ash_renderer_tpu/pipeline.py:413, XLA glue)", counts),
        "K9": ("K9_front_meta", "ash_renderer_tpu_torch/csrc/front_meta.cu",
               "none (ash_renderer_tpu/pipeline.py:458, XLA glue)", counts),
        # no Pallas kernel: the classic route's transform and setup, and its
        # shade + pack, are XLA glue (_stage_geometry, _stage_shade); K8C's
        # transform is folded into K10, so no frame path launches K8C
        "K8C": ("K8C_vertex_transform_rows",
                "ash_renderer_tpu_torch/csrc/transform.cu",
                "none (ash_renderer_tpu/pipeline.py:680, XLA glue)", counts_g),
        "K10": ("K10_geometry", "ash_renderer_tpu_torch/csrc/geometry.cu",
                "none (ash_renderer_tpu/pipeline.py:680, XLA glue)", counts_g),
        "K11": ("K11_shade_pack_classic",
                "ash_renderer_tpu_torch/csrc/shade_pack.cu",
                "none (ash_renderer_tpu/pipeline.py:698, XLA glue)", counts_g),
        # no Pallas kernel: the classic route's binning is XLA glue
        # (ops/binning.py:bin_triangles under _stage_raster's jit)
        "K12": ("K12_binning", "ash_renderer_tpu_torch/csrc/binning.cu",
                "none (ash_renderer_tpu/pipeline.py:694, XLA glue)", counts_g),
    }
    kernels = []
    for k, (name, src, rep, n) in meta.items():
        if k == "K8C":
            require(n.get(name, 0) == 0, f"{name}: launched on a frame path")
        else:
            require(n.get(name, 0) > 0, f"{name}: no launch in its counted run")
        kt, pt, lt, (bt, by) = timing[k]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n.get(name, 0), "max_abs_err": errs[k], "ms": kt,
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
