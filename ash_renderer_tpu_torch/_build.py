"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the repo root, named by a hash of the sources and the
flags, so an edited source or flag rebuilds and an unchanged one reuses.

Flags: ``--fmad=false`` because the spec forbids mul+add contraction into
FMA; never ``--use_fast_math`` or ``-ftz=true`` (subnormals stay IEEE, the
spec flushes them only where it says so).

``launches`` counts kernel launches by kernel name; ``launch``, which each
wrapper calls to launch its kernel and nowhere else, adds one per launch.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("setup.cu", "bincount.cu", "raster.cu")
HEADERS = ("specmath.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every function returns cudaError_t)
_SIGNATURES = {
    # tblT, ltT, matT, comb, keys, flags, extx, exty, n_meshlets, n_verts,
    # width, height, min_c, max_cx, max_cy, ss, gx, gy, grid_w, tile_h,
    # n_tiles, stream
    "ash_triangle_setup": [_P] * 8 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P],
    # key_sorted, bounds, n_keys, n_bins, stream
    "ash_run_bounds": [_P, _P, _I, _I, _P],
    # rmeta, tbl_sorted, tbl_ext, comb, vis_d, vis_t, planes, n_tiles,
    # grid_w, min_c, ss, stream
    "ash_rasterize_distribute": [_P] * 7 + [_I] * 4 + [_P],
}

_LIB = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if no library for these sources and flags exists;
    returns the library's path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libash_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp] + [
        os.path.join(CSRC, s) for s in SOURCES
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def launch(kernel: str, entry: str, device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and ``device``'s
    current stream, with ``device`` made current; raise if it reports a CUDA
    error, else count one launch of ``kernel``."""
    import torch

    with torch.cuda.device(device):
        rc = getattr(lib(), entry)(
            *args, torch.cuda.current_stream(device).cuda_stream
        )
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    launches[kernel] += 1
