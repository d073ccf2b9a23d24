"""Profile the PyTorch/CUDA port's frame on one CUDA card at the config4
headline (subdiv 8, 1,310,720 triangles, 1920x1080), front cache off.

    python3 experiments/torch_profile_frame.py [--frames N]

Prints, for a static camera and an orbit, in one process:
- the untraced wall time per frame (host clock, device synced at the end);
- under ``torch.profiler``: the traced wall per frame, the device kernel
  time per frame, their ratio (the traced busy share), device kernel
  launches per frame, and the kernels that take the most device time;
- K3's streamed slots per range and the front's counters at the static
  camera.
Imports nothing of JAX.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_frame: no CUDA device")

    import dataclasses

    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.benchmarks import config4_million_tri
    from ash_renderer_tpu_torch.camera import orbit_path
    from ash_renderer_tpu_torch.ops import fused_kernel
    from ash_renderer_tpu_torch.renderer import Renderer, compose_mvp

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    dev = torch.device("cuda", 0)
    scene, st, cams = config4_million_tri(8)
    r = Renderer(scene, dataclasses.replace(st, front_coherence=False),
                 device=dev)
    for _ in range(3):
        r.render_frame(cams[0])
    torch.cuda.synchronize()

    mm = np.ascontiguousarray(scene.model_matrices(), np.float32)
    mvp = compose_mvp(mm, cams[0].view_matrix(), cams[0].projection_matrix(
        st.render_width / st.render_height))
    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        r.statics, r.state, torch.from_numpy(mm).to(dev),
        torch.from_numpy(np.ascontiguousarray(mvp)).to(dev),
    )
    m = rmeta.reshape(-1, fused_kernel.N_RANGES, 2).long()
    lens = (m[..., 1] - m[..., 0]).sum(0)
    print("K3 streamed slots per range:", lens.tolist(), "total",
          int(lens.sum()), "slot-pixel evaluations",
          int(lens.sum()) * fused_kernel.N_PIX)
    print("front counters:", {k: int(v) for k, v in stats.items()})
    print("records: tbl_sorted", int(stats["live_rows"]), "live of",
          tbl_sorted.shape[0], "tbl_ext", int(stats["wide_pairs_n"]), "live of",
          tbl_ext.shape[0], "comb rows", comb.shape[0])
    del rmeta, tbl_sorted, tbl_ext, comb

    n = args.frames
    for label, camlist in (
        ("static uncached", [cams[0]] * n),
        ("orbit", orbit_path(n, radius=2.0, center=[0.0, 0.0, 2.0])),
    ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in camlist:
            r.render_frame(c)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for c in camlist:
                r.render_frame(c)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) / n
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e6 / n
        print(f"== {label}: untraced wall {untraced * 1e3:.3f} ms/frame; "
              f"traced wall {traced * 1e3:.3f} ms/frame, device kernels "
              f"{busy * 1e3:.3f} ms/frame, traced busy share "
              f"{busy / traced:.3f}; device kernel launches per frame "
              f"{sum(e.count for e in kern) / n:.1f}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
            if e.self_device_time_total > 0:
                print(f"  {e.self_device_time_total / n / 1e3:8.3f} ms/frame"
                      f"  n={e.count // n:5d}  {e.key[:110]}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
