"""ctypes bindings of the native host helpers: the meshlet builder
(``csrc/meshlets.cpp``) and the OBJ parser (``csrc/objparse.cpp``).

Each host library is built at first use by ``_build`` with the host C++
compiler.  The JAX package's PNG encoder (``native/pngwrite.cpp``) has no
counterpart: ``present.encode_png`` writes PNGs with the standard library.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np

from . import _build

SOURCE = "meshlets.cpp"
OBJ_SOURCE = "objparse.cpp"
_BOUND = None
_OBJ_BOUND = None


def available() -> bool:
    """Whether a host C++ compiler can build the host libraries here."""
    return any(shutil.which(n) for n in _build.HOST_CXX)


def lib() -> ctypes.CDLL:
    """The meshlet library, built and bound on first call (raises if it
    cannot be built)."""
    global _BOUND
    if _BOUND is None:
        h = _build.load(SOURCE)
        v, i64 = ctypes.c_void_p, ctypes.c_int64
        h.ash_build_meshlets.restype = v
        h.ash_build_meshlets.argtypes = [v, i64, v, i64, i64]
        h.ash_meshlets_counts.restype = None
        h.ash_meshlets_counts.argtypes = [v, ctypes.POINTER(i64)]
        h.ash_meshlets_fill.restype = None
        h.ash_meshlets_fill.argtypes = [v, v, v, v]
        h.ash_meshlets_free.restype = None
        h.ash_meshlets_free.argtypes = [v]
        _BOUND = h
    return _BOUND


def build_meshlets(tri_v: np.ndarray, order: np.ndarray, num_vertices: int):
    """Greedy meshlet clustering in C++ (bit-identical to
    ``scene.build_meshlets``' Python loop).  tri_v: (T, 3) i32; order: (R,)
    i32 walk order (Morton-ordered real triangle ids).  Returns
    (vertex_src, local_tri, tri_perm)."""
    h = lib()
    tv = np.ascontiguousarray(tri_v, dtype=np.int32)
    od = np.ascontiguousarray(order, dtype=np.int32)
    handle = h.ash_build_meshlets(
        tv.ctypes.data, tv.shape[0], od.ctypes.data, od.shape[0],
        int(num_vertices),
    )
    if not handle:
        raise RuntimeError("ash_build_meshlets rejected its arguments")
    try:
        nm = ctypes.c_int64()
        h.ash_meshlets_counts(handle, ctypes.byref(nm))
        n = nm.value
        vertex_src = np.empty(n * 128, dtype=np.int32)
        local_tri = np.empty((n * 128, 3), dtype=np.int32)
        tri_perm = np.empty(n * 128, dtype=np.int32)
        h.ash_meshlets_fill(handle, vertex_src.ctypes.data,
                            local_tri.ctypes.data, tri_perm.ctypes.data)
        return vertex_src, local_tri, tri_perm
    finally:
        h.ash_meshlets_free(handle)


def obj_lib() -> ctypes.CDLL:
    """The OBJ parser library, built and bound on first call (raises if it
    cannot be built)."""
    global _OBJ_BOUND
    if _OBJ_BOUND is None:
        h = _build.load(OBJ_SOURCE)
        v, i64 = ctypes.c_void_p, ctypes.c_int64
        h.ash_parse_obj.restype = v
        h.ash_parse_obj.argtypes = [ctypes.c_char_p]
        h.ash_obj_counts.restype = None
        h.ash_obj_counts.argtypes = [v, ctypes.POINTER(i64), ctypes.POINTER(i64)]
        h.ash_obj_fill.restype = None
        h.ash_obj_fill.argtypes = [v, v, v, v, v]
        h.ash_obj_free.restype = None
        h.ash_obj_free.argtypes = [v]
        _OBJ_BOUND = h
    return _OBJ_BOUND


def parse_obj(path: str):
    """Parse an OBJ file in C++ (the same arrays as
    ``models.obj.load_obj_python``).  Returns (pos (V, 3) f32, uv (V, 2)
    f32, nrm (V, 3) f32, faces (T, 3) i32), or None when the file cannot
    be read."""
    h = obj_lib()
    handle = h.ash_parse_obj(path.encode())
    if not handle:
        return None
    try:
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        h.ash_obj_counts(handle, ctypes.byref(nv), ctypes.byref(nf))
        pos = np.empty((nv.value, 3), dtype=np.float32)
        uv = np.empty((nv.value, 2), dtype=np.float32)
        nrm = np.empty((nv.value, 3), dtype=np.float32)
        faces = np.empty((nf.value, 3), dtype=np.int32)
        h.ash_obj_fill(handle, pos.ctypes.data, uv.ctypes.data,
                       nrm.ctypes.data, faces.ctypes.data)
        return pos, uv, nrm, faces
    finally:
        h.ash_obj_free(handle)
