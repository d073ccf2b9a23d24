#!/usr/bin/env python3
"""Whether ``torch.profiler`` windows lose kernel records as a process
ages, and with what: the number of windows taken before, the kernels
launched before, or the time alone.  One process renders the classic gate
frame (``chip_smoke.gate_scene`` at 800x600, orbit frame 3, the frame
``chip_smoke.py`` phase 29 counts) and takes
``chip_smoke.classic_launches_per_frame`` windows in four steps:

  a. three windows of 4 frames in the new process;
  b. 2,000 frames with no profiler (8,000 of the port's launches), then
     three windows;
  c. 30 s with no profiler and no launch, then three windows;
  d. ``--windows`` windows back to back, 4 and 32 frames in turns.

Each window prints the device kernels a frame, the port's among them
against its launches (``_build.launches``), and the port's by kernel.
Kineto's own log goes to standard error at ``KINETO_LOG_LEVEL`` 1 (its
records dropped, its buffers) unless the variable is set.

    python3 experiments/torch_profiler_loss.py [--windows 40]

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("KINETO_LOG_LEVEL", "1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profiler_loss: no CUDA device")
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.config import RendererSettings
    from ash_renderer_tpu_torch.renderer import Renderer

    t0 = time.perf_counter()
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    rg = Renderer(cs.gate_scene()[0], RendererSettings(), device=dev)
    cam = orbit_path(cs.N_FRAMES, radius=6.0,
                     center=[0.0, 0.0, 3.5])[cs.GATE_PROFILED_FRAME]
    count = [0]

    def window(step: str, n: int = 4) -> None:
        n_dev, n_port, seen, others, port = cs.classic_launches_per_frame(
            rg, cam, n)
        count[0] += 1
        print(f"{step} window {count[0]} at {time.perf_counter() - t0:.1f} s,"
              f" {n} frames: {n_dev:.2f} device kernels a frame, {seen:.2f} "
              f"of the port's {n_port:.2f}: {json.dumps(port, sort_keys=True)};"
              f" not the port's {sum(others.values()):.2f}", flush=True)

    for _ in range(3):
        window("a")
    for _ in range(2000):
        rg.render_frame(cam)
    torch.cuda.synchronize()
    for _ in range(3):
        window("b (after 2,000 unprofiled frames)")
    time.sleep(30)
    for _ in range(3):
        window("c (after 30 s idle)")
    for w in range(args.windows):
        window("d", 4 if w % 2 == 0 else 32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
