"""Wavefront OBJ loader and writer: the port's copy of
``ash_renderer_tpu/models/obj.py``, which gives the same meshes bit for bit.

Supports v / vt / vn / f (polygons fan-triangulated, negative indices,
v//vn and v/vt/vn forms).  Vertices are deduplicated on the full
(v, vt, vn) triple so indexed rendering stays compact.  ``load_obj`` takes
the C++ parser (``csrc/objparse.cpp``, ``native.parse_obj``) when a host
compiler is found, as the reference takes its native one when built; the
pure-Python ``load_obj_python`` is the other path and the semantics
reference.
"""

from __future__ import annotations

import numpy as np

from ..scene import Mesh

F32 = np.float32
I32 = np.int32


def load_obj(path: str, compute_normals_if_missing: bool = True) -> Mesh:
    from .. import native

    if native.available():
        parsed = native.parse_obj(path)
        if parsed is not None:
            return _mesh_from_arrays(*parsed, compute_normals_if_missing)
    return load_obj_python(path, compute_normals_if_missing)


def load_obj_python(path: str, compute_normals_if_missing: bool = True) -> Mesh:
    positions: list = []
    uvs: list = []
    normals: list = []
    corner_map: dict = {}
    out_pos: list = []
    out_uv: list = []
    out_nrm: list = []
    faces: list = []

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    def corner(spec: str) -> int:
        parts = spec.split("/")
        vi = resolve(int(parts[0]), len(positions))
        ti = (
            resolve(int(parts[1]), len(uvs))
            if len(parts) > 1 and parts[1]
            else -1
        )
        ni = (
            resolve(int(parts[2]), len(normals))
            if len(parts) > 2 and parts[2]
            else -1
        )
        key = (vi, ti, ni)  # dedup on the resolved triple (negative and
        # positive index spellings of the same corner must unify)
        if key in corner_map:
            return corner_map[key]
        out_pos.append(positions[vi])
        out_uv.append(uvs[ti] if ti >= 0 else (0.0, 0.0))
        out_nrm.append(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        idx = len(out_pos) - 1
        corner_map[key] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                uvs.append((u, 1.0 - v))  # OBJ uv origin bottom-left
            elif tag == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "f":
                ids = [corner(p) for p in parts[1:]]
                for k in range(1, len(ids) - 1):
                    faces.append((ids[0], ids[k], ids[k + 1]))

    return _mesh_from_arrays(
        np.array(out_pos, F32).reshape(-1, 3),
        np.array(out_uv, F32).reshape(-1, 2),
        np.array(out_nrm, F32).reshape(-1, 3),
        np.array(faces, I32).reshape(-1, 3),
        compute_normals_if_missing,
    )


def _mesh_from_arrays(pos, uv, nrm, faces, compute_normals_if_missing):
    mesh = Mesh(positions=pos, indices=faces, uvs=uv, normals=nrm)
    if compute_normals_if_missing and not np.any(nrm):
        mesh.compute_normals()
    return mesh


def save_obj(path: str, mesh: Mesh) -> None:
    """Minimal OBJ writer (round-trip tests, asset export)."""
    with open(path, "w") as f:
        f.write("# ash_renderer_tpu export\n")
        for p in mesh.positions:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in mesh.uvs:
            f.write(f"vt {t[0]} {1.0 - t[1]}\n")
        for n in mesh.normals:
            f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for a, b, c in mesh.indices + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
