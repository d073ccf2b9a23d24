#!/usr/bin/env python3
"""Wall-clock time to build the port's native libraries three ways:

* "together": one compiler process per source, all started at once (what
  ``ash_renderer_tpu_torch._build.build`` does);
* "in turn": the same processes, one after another;
* "one nvcc": a single nvcc call compiling every ``.cu`` source into one
  library, then the host library.

    python3 experiments/torch_build_time.py [--reps 2]

Needs ``nvcc`` and a host C++ compiler.  Builds into a temporary directory
under ``build/`` (the library cache in ``build/kernels/`` is neither read
nor written), runs the ways in turns (a, b, c, c, b, a for two reps) and
prints each build's seconds, then the machine's card line from nvidia-smi.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ash_renderer_tpu_torch import _build  # noqa: E402

SOURCES = tuple(_build.KERNELS) + _build.HOST_SOURCES


def _run_all(cmds, together: bool) -> None:
    if together:
        procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE) for c in cmds]
        errs = [(p.communicate()[1], p.returncode) for p in procs]
    else:
        errs = []
        for c in cmds:
            p = subprocess.run(c, stdout=subprocess.DEVNULL,
                               stderr=subprocess.PIPE)
            errs.append((p.stderr, p.returncode))
    for err, rc in errs:
        if rc != 0:
            raise RuntimeError(err.decode())


def build_once(way: str, out_dir: str) -> float:
    os.makedirs(out_dir)
    if way == "one nvcc":
        cus = [s for s in SOURCES if s not in _build.HOST_SOURCES]
        nvcc = _build._command(cus[0], os.path.join(out_dir, "libk.so"))
        nvcc = nvcc[:-1] + [os.path.join(_build.CSRC, s) for s in cus]
        cmds = [nvcc] + [_build._command(s, os.path.join(out_dir, s + ".so"))
                         for s in _build.HOST_SOURCES]
    else:
        cmds = [_build._command(s, os.path.join(out_dir, s + ".so"))
                for s in SOURCES]
    t0 = time.perf_counter()
    _run_all(cmds, together=(way == "together"))
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    ways = ["together", "in turn", "one nvcc"]
    order = []
    for i in range(args.reps):
        order += ways if i % 2 == 0 else ways[::-1]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build_time_", dir=os.path.join(ROOT, "build"))
    times = {w: [] for w in ways}
    try:
        for i, way in enumerate(order):
            times[way].append(build_once(way, os.path.join(tmp, str(i))))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"build seconds, {len(SOURCES)} sources ({', '.join(SOURCES)}), "
          f"{os.cpu_count()} CPU cores:")
    for way in ways:
        print(f"  {way}: " + ", ".join(f"{t:.2f}" for t in times[way]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or "no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
