"""Build and load the port's native code from ``csrc/``.

Each source is compiled at first use into its own shared library with a
plain C interface, loaded with ``ctypes``:

* the CUDA kernels (``*.cu``) with ``nvcc`` for ``sm_90a``;
* the host meshlet builder (``meshlets.cpp``) and OBJ parser
  (``objparse.cpp``) with the host C++ compiler.

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
HEADERS = ("specmath.cuh", "binsort.cuh", "coop.cuh", "clip.cuh",
           "shade.cuh", "vertex.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
# ptxas's per-kernel registers, shared memory and spills: changes the
# compiler's report, not the code, so it does not key the library
PTXAS_REPORT = ("-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_SOURCES = ("meshlets.cpp", "objparse.cpp")
HOST_CXX = ("c++", "g++")

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
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
        # grid_w, min_c, ss, row0 (the window's first tile row), tile_h,
        # stream
        "ash_rasterize_distribute": [_P] * 7 + [_I] * 6 + [_P],
        # ... as above up to tile_h, then consts, n_consts, m_n, t_n,
        # has_m, has_a, has_l, stream
        "ash_rasterize_shade": [_P] * 7 + [_I] * 6 + [_P] + [_I] * 6 + [_P],
    },
    "raster_classic.cu": {
        # rec_i, rec_f, rec_box, tile_start, tile_count, vis_d, vis_t,
        # n_rec, n_tiles, grid_w, ss, stream
        "ash_rasterize_visibility": [_P] * 7 + [_I] * 4 + [_P],
    },
    "clip_tail.cu": {
        # flags, tblT, tri_v, tri_mat, scratch (counters, per-chunk counts,
        # sel), comb_tail, keys, n_verts, n_tris, budget, width, height,
        # min_c, max_cx, max_cy, ss, gx, gy, row0, py_lo, py_hi, tile_h,
        # grid_w, n_tiles (the key window), stream
        "ash_clip_tail": [_P] * 7 + [_I] * 9 + [_F, _F] + [_I] * 6 + [_P],
    },
    "shade_pack.cu": {
        # planes, quads (or NULL), n_quads, light colour (or NULL), sRGB
        # LUT (or NULL), out, grid_w, tile_h, out_h, out_w, ss, inv_ss2,
        # has_m, clear rgba, stream
        "ash_shade_pack": [_P, _P, _I, _P, _P, _P] + [_I] * 5 + [_F, _I]
                          + [_F] * 4 + [_P],
        # vis_tri, setup rows, attrs, consts, n_consts, m_n, t_n, has_m,
        # has_a, has_l, quads (or NULL), n_quads, light colour (or NULL),
        # sRGB LUT (or NULL), out, n_setup, n_attrs, vis row pitch, out_h,
        # out_w, ss, subpixel scale, py_offset, inv_ss2, clear rgba, stream
        "ash_shade_pack_classic": [_P] * 4 + [_I] * 6 + [_P, _I] + [_P] * 3
                                  + [_I] * 8 + [_F] * 5 + [_P],
    },
    "transform.cu": {
        # positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats,
        # out, n_verts, n_obj, stream
        "ash_vertex_transform": [_P] * 8 + [_I] * 2 + [_P],
        # ... as above, with clip and attrs in place of out
        "ash_vertex_transform_rows": [_P] * 9 + [_I] * 2 + [_P],
    },
    "geometry.cu": {
        # clip, attrs, vtx, attrs_full, n_verts, width, height, min_c,
        # max_cx, max_cy, ss, gx, gy, stream
        "ash_geometry_vertices": [_P] * 4 + [_I] * 7 + [_F, _F] + [_P],
        # corners (K5's rows, or NULL: the launch snaps them), clip,
        # attrs, tri_v, tri_mat, scratch (counters, per-chunk counts, sel,
        # flags), setup rows, valid, attrs_full, n_verts, n_tris, budget,
        # width, height, min_c, max_cx, max_cy, ss, gx, gy, cluster (the
        # design), stream
        "ash_geometry_tris": [_P] * 9 + [_I] * 9 + [_F, _F, _I] + [_P],
        # the two above on the scene's vertices, transformed in the launch:
        # positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats,
        # n_obj in place of clip and attrs
        "ash_geometry_vertices_scene": [_P] * 7 + [_I] + [_P] * 2 + [_I] * 7
                                       + [_F, _F] + [_P],
        "ash_geometry_tris_scene": [_P] * 8 + [_I] + [_P] * 6 + [_I] * 9
                                   + [_F, _F, _I] + [_P],
    },
    "front_meta.cu": {
        # comb, order, bounds, rects, wrow, wrec, tile_cnt, row_cnt,
        # chunk_sums, work, meta, pair_rows, pair_starts, rmeta, rec_sorted,
        # rec_ext, n_tiles, grid_w, tile_h, row0, py_lo, py_hi, width,
        # height, ss, min_c, wide_rows, wide_pairs, s_rows, stream
        "ash_front_meta": [_P] * 16 + [_I] * 13 + [_P],
    },
    "binning.cu": {
        # rows, valid, crect, cmeta, chunk_sums (scratch), rec, tile_start,
        # tile_count, stats, s_rows, max_pairs, n_tiles, grid_w, tile_w,
        # tile_h, row0, py_lo, py_hi (the tile-row window), width, height,
        # ss, stream
        "ash_bin_triangles": [_P] * 9 + [_I] * 12 + [_P],
    },
    "gather.cu": {
        # tbl, local_tri, out, n_tris, n_cols, stream
        "ash_gather_tri_rows": [_P] * 3 + [_I] * 2 + [_P],
        # n_cols, blocks (out): the persistent grid on the current device
        "ash_gather_tri_rows_wave": [_I, _IP],
    },
}
_ENTRY_SOURCE = {e: s for s, entries in KERNELS.items() for e in entries}
# route -> the kernel sources its frames launch on a card, which
# ``Renderer.warmup`` builds: the classic route's K10 (the vertex transform
# folded in), K12, K4 and K11 (the Renderer packs it plainly, so K5's
# gather.cu is not among them); the fused route's front (K8, K1, K6, K2,
# K9), K3 / K3F and K7
ROUTE_SOURCES = {
    "classic": ("geometry.cu", "binning.cu", "raster_classic.cu",
                "shade_pack.cu"),
    "fused": ("transform.cu", "setup.cu", "clip_tail.cu", "bincount.cu",
              "front_meta.cu", "raster.cu", "shade_pack.cu"),
}
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
    ``ptxas_report``, every source is compiled, existing or not, and nvcc
    also prints ptxas's per-kernel resource report.  Raises if any fails.
    Returns ({source: library path}, {source: the compiler's output} for
    the sources this call compiled)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: _path(s) for s in sources}
    procs = {}
    for s, out in paths.items():
        if ptxas_report or not os.path.exists(out):
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


def launch(kernel: str, entry: str, device, *args, count: int = 1) -> None:
    """Call the C entry point ``entry`` with ``args`` and ``device``'s
    current stream, with ``device`` made current; raise if it reports a CUDA
    error, else count ``count`` launches of ``kernel`` (the kernels the
    entry point launches)."""
    import torch

    fn = getattr(load(_ENTRY_SOURCE[entry]), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    launches[kernel] += count
