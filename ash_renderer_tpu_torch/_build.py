"""Build and load the port's native code from ``csrc/``.

Each source is compiled at first use into its own shared library with a
plain C interface, loaded with ``ctypes``:

* the CUDA kernels (``*.cu``) with ``nvcc`` for ``sm_90a``;
* the host meshlet builder (``meshlets.cpp``) with the host C++ compiler.

Libraries land in ``build/kernels/`` at the repo root, named by a hash of
the source, the shared headers and the flags, so an edited source or flag
rebuilds and an unchanged one reuses.  ``build`` starts one compiler
process per missing library, all together, and waits for all of them
(``experiments/torch_build_time.py`` times that against one compile after
another).

Kernel flags: ``--fmad=false`` because the spec forbids mul+add contraction
into FMA; never ``--use_fast_math`` or ``-ftz=true`` (subnormals stay IEEE,
the spec flushes them only where it says so).

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
HEADERS = ("specmath.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
# ptxas's per-kernel registers, shared memory and spills: changes the
# compiler's report, not the code, so it does not key the library
PTXAS_REPORT = ("-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_SOURCES = ("meshlets.cpp",)
HOST_CXX = ("c++", "g++")

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernel source -> its C entry points: name -> argtypes (each returns
# cudaError_t)
KERNELS = {
    "setup.cu": {
        # tblT, ltT, matT, comb, keys, flags, extx, exty, n_meshlets,
        # n_verts, width, height, min_c, max_cx, max_cy, ss, gx, gy, grid_w,
        # tile_h, n_tiles, stream
        "ash_triangle_setup": [_P] * 8 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P],
    },
    "bincount.cu": {
        # key_sorted, bounds, n_keys, n_bins, stream
        "ash_run_bounds": [_P, _P, _I, _I, _P],
    },
    "raster.cu": {
        # rmeta, tbl_sorted, tbl_ext, comb, vis_d, vis_t, planes, n_tiles,
        # grid_w, min_c, ss, stream
        "ash_rasterize_distribute": [_P] * 7 + [_I] * 4 + [_P],
        # ... as above, then consts, n_consts, m_n, t_n, has_m, has_a,
        # has_l, stream
        "ash_rasterize_shade": [_P] * 7 + [_I] * 4 + [_P] + [_I] * 6 + [_P],
    },
    "raster_classic.cu": {
        # rec_i, rec_f, tile_start, tile_count, vis_d, vis_t, n_rec,
        # n_tiles, grid_w, ss, stream
        "ash_rasterize_visibility": [_P] * 6 + [_I] * 4 + [_P],
    },
    "gather.cu": {
        # tbl, local_tri, out, n_tris, n_cols, stream
        "ash_gather_tri_rows": [_P] * 3 + [_I] * 2 + [_P],
    },
}
_ENTRY_SOURCE = {e: s for s, entries in KERNELS.items() for e in entries}
_LIBS: dict = {}


def _tool(names, default=None) -> str:
    for n in names:
        found = shutil.which(n)
        if found:
            return found
    if default and os.path.exists(default):
        return default
    raise RuntimeError(f"{names[0]} not found: {'/'.join(names)} is needed "
                       "to build the port's native code")


def _command(source: str, out: str, ptxas_report: bool = False) -> list:
    src = os.path.join(CSRC, source)
    if source in HOST_SOURCES:
        return [_tool(HOST_CXX), *HOST_FLAGS, "-o", out, src]
    report = PTXAS_REPORT if ptxas_report else ()
    return [_tool(("nvcc",), "/usr/local/cuda/bin/nvcc"), *NVCC_FLAGS,
            *report, "-o", out, src]


def _path(source: str) -> str:
    h = hashlib.sha256()
    deps = (source,) if source in HOST_SOURCES else (source,) + HEADERS
    for name in deps:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    flags = HOST_FLAGS if source in HOST_SOURCES else NVCC_FLAGS
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libash_{stem}_{h.hexdigest()[:16]}.so")


def build(sources=tuple(KERNELS), ptxas_report: bool = False):
    """Compile each library of ``sources`` that does not exist yet, one
    compiler process per source, all started together; with
    ``ptxas_report``, nvcc also prints ptxas's per-kernel resource report.
    Raises if any fails.  Returns ({source: library path}, {source: the
    compiler's output} for the sources this call compiled)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: _path(s) for s in sources}
    procs = {}
    for s, out in paths.items():
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[s] = (tmp, subprocess.Popen(
                _command(s, tmp, ptxas_report), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    failed, logs = [], {}
    for s, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{s} ({proc.returncode}):\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, paths[s])
            logs[s] = stdout + stderr
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return paths, logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first call); a kernel
    library comes with its entry points' argtypes set."""
    if source not in _LIBS:
        handle = ctypes.CDLL(build((source,))[0][source])
        for name, argtypes in KERNELS.get(source, {}).items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = handle
    return _LIBS[source]


def launch(kernel: str, entry: str, device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and ``device``'s
    current stream, with ``device`` made current; raise if it reports a CUDA
    error, else count one launch of ``kernel``."""
    import torch

    fn = getattr(load(_ENTRY_SOURCE[entry]), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    launches[kernel] += 1
