#!/usr/bin/env python3
"""Hold the machine code of K3 and K3F on 8-row tiles (``csrc/raster.cu``)
to that of another ``raster.cu``, instruction for instruction.

    python3 experiments/torch_k3_sass_diff.py --source NAME=PATH

Builds ``csrc/raster.cu`` and the source at PATH (for example the
parent's, with one ``raster_kernel`` template argument fewer) with the
port's nvcc flags and ptxas's report, both compilers started together,
dumps each library's SASS with ``cuobjdump -sass`` and compares, for K3
(``SHADE`` false) and K3F, the 8-row instantiation's instruction stream
with the other source's: the same opcodes and operands in the same order,
addresses and encodings set aside.  Prints ptxas's lines, the instruction
counts and the verdict; exits 1 if either pair differs.  Needs ``nvcc``
and ``cuobjdump`` (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ash_renderer_tpu_torch import _build  # noqa: E402

SOURCE = "raster.cu"


def build(sources: dict) -> dict:
    """{name: library path} for {name: source path}, one nvcc each, all
    started together; prints ptxas's register and spill lines."""
    out_dir = os.path.join(ROOT, "build", "raster_sass")
    os.makedirs(out_dir, exist_ok=True)
    procs, outs = {}, {}
    for name, src in sources.items():
        outs[name] = os.path.join(out_dir, f"{name}.so")
        cmd = _build._command(SOURCE, outs[name], ptxas_report=True)
        cmd = cmd[:1] + ["-I", _build.CSRC] + cmd[1:-1] + [src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "stack frame" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return outs


def sass(lib: str) -> dict:
    """{(tile_h, shade): [instruction, ...]} of every raster_kernel in the
    library; an instantiation without a tile-height argument is 8 rows."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = None
            if "raster_kernel" in name:
                th = re.search(r"ILi(\d+)E", name)
                shade = re.search(r"Lb([01])E", name)
                cur = funcs.setdefault(
                    (int(th.group(1)) if th else 8, shade.group(1) == "1"), [])
            continue
        # "        /*0040*/   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;   /* 0x... */"
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            cur.append(" ".join(m.group(1).split()))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="NAME=PATH of the raster.cu to compare with")
    args = ap.parse_args()
    name, path = args.source.split("=", 1)
    libs = build({"csrc": os.path.join(_build.CSRC, SOURCE),
                  name: os.path.abspath(path)})
    mine, other = sass(libs["csrc"]), sass(libs[name])
    print(f"raster_kernel instantiations: csrc {sorted(mine)}, "
          f"{name} {sorted(other)}")
    same = True
    for shade, label in ((False, "K3"), (True, "K3F")):
        a, b = mine.get((8, shade)), other.get((8, shade))
        if not a or not b:
            print(f"{label}, 8 rows: missing (csrc {bool(a)}, {name} {bool(b)})")
            same = False
            continue
        diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None if len(a) == len(b) else min(len(a), len(b)))
        if diff is None:
            print(f"{label}, 8 rows: SASS identical to {name}'s "
                  f"({len(a)} instructions)")
        else:
            same = False
            print(f"{label}, 8 rows: SASS differs from {name}'s at instruction "
                  f"{diff} of {len(a)} / {len(b)}: "
                  f"{a[diff] if diff < len(a) else '-'} | "
                  f"{b[diff] if diff < len(b) else '-'}")
    for key in sorted(k for k in mine if k[0] != 8):
        print(f"{'K3F' if key[1] else 'K3'}, {key[0]} rows: "
              f"{len(mine[key])} instructions")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
