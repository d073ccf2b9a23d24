"""ctypes binding of the native meshlet builder (``csrc/meshlets.cpp``).

The host library is built at first use by ``_build`` with the host C++
compiler.  Only the four meshlet entry points are bound.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np

from . import _build

SOURCE = "meshlets.cpp"
_BOUND = None


def available() -> bool:
    """Whether a host C++ compiler can build the library here."""
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
