"""Procedural meshes for the port's configurations (host numpy, seeded and
pure): the same generator as ``ash_renderer_tpu.models.procedural``."""

from __future__ import annotations

import numpy as np

from ..scene import Mesh

F32 = np.float32
I32 = np.int32


def cube(size: float = 1.0) -> Mesh:
    """Cube of 12 triangles, outward CCW-front winding, per-face normals and
    uvs."""
    s = size / 2.0
    faces = [
        ([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s], [1, 0, 0]),
        ([-s, -s, s], [-s, s, s], [-s, s, -s], [-s, -s, -s], [-1, 0, 0]),
        ([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s], [0, 1, 0]),
        ([-s, -s, s], [-s, -s, -s], [s, -s, -s], [s, -s, s], [0, -1, 0]),
        ([s, -s, s], [s, s, s], [-s, s, s], [-s, -s, s], [0, 0, 1]),
        ([-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s], [0, 0, -1]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (a, b, c, d, n) in enumerate(faces):
        base = 4 * f
        pos += [a, b, c, d]
        nrm += [n] * 4
        uv += [[0, 0], [0, 1], [1, 1], [1, 0]]
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return Mesh(
        positions=np.array(pos, F32),
        indices=np.array(idx, I32),
        normals=np.array(nrm, F32),
        uvs=np.array(uv, F32),
    )


def uv_sphere(n_lat: int = 32, n_lon: int = 64, radius: float = 1.0) -> Mesh:
    """Latitude/longitude sphere with smooth normals and spherical uvs."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    x = radius * np.sin(th) * np.cos(ph)
    y = radius * np.cos(th)
    z = radius * np.sin(th) * np.sin(ph)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(F32)
    nrm = (pos / radius).astype(F32)
    u = (ph / (2 * np.pi)).reshape(-1)
    v = (th / np.pi).reshape(-1)
    uv = np.stack([u, v], axis=-1).astype(F32)
    idx = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                idx.append([a, c, b])
            if i < n_lat - 1:
                idx.append([b, c, d])
    return Mesh(positions=pos, indices=np.array(idx, I32), normals=nrm, uvs=uv)


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Mesh:
    """Subdivided icosahedron: 20 * 4**subdivisions uniform triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts[0])
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        # 4:1 subdivision; the 4 children of a parent stay adjacent
        e = np.sort(
            np.stack(
                [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=1
            ),
            axis=-1,
        ).reshape(-1, 2)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_id = len(verts) + inv.reshape(-1, 3)  # (F, 3): ab, bc, ca
        verts = np.concatenate([verts, mids])
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
        faces = np.stack(
            [
                np.stack([a, ab, ca], 1),
                np.stack([b, bc, ab], 1),
                np.stack([c, ca, bc], 1),
                np.stack([ab, bc, ca], 1),
            ],
            axis=1,
        ).reshape(-1, 3).astype(np.int64)
    pos = (verts * radius).astype(F32)
    nrm = verts.astype(F32)
    u = (np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi) + 0.5).astype(F32)
    v = (np.arccos(np.clip(verts[:, 1], -1, 1)) / np.pi).astype(F32)
    return Mesh(
        positions=pos,
        indices=faces.astype(I32),
        normals=nrm,
        uvs=np.stack([u, v], axis=-1).astype(F32),
    )
