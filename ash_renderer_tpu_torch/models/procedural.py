"""Procedural meshes for the port's configurations (host numpy, seeded and
pure): the same generators as ``ash_renderer_tpu.models.procedural``,
expression for expression, so both packages build the same arrays."""

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


def grid_sheet(nx: int, nz: int, extent: float = 2.0, y: float = 0.0) -> Mesh:
    """Flat grid in the xz plane at height ``y``, normal (0, -1, 0) (up:
    the camera's up is -y); 2*nx*nz triangles."""
    xs = np.linspace(-extent, extent, nx + 1)
    zs = np.linspace(-extent, extent, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([gx, np.full_like(gx, y), gz], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [(gx / (2 * extent) + 0.5), (gz / (2 * extent) + 0.5)], axis=-1
    ).reshape(-1, 2)
    idx = []
    stride = nz + 1
    for i in range(nx):
        for j in range(nz):
            a = i * stride + j
            idx += [[a, a + 1, a + stride], [a + stride, a + 1, a + stride + 1]]
    return Mesh(
        positions=pos.astype(F32),
        indices=np.array(idx, I32),
        normals=np.tile(np.array([[0, -1, 0]], F32), (len(pos), 1)),
        uvs=uv.astype(F32),
    )


def terrain(n: int = 512, extent: float = 8.0, height: float = 1.2,
            seed: int = 0) -> Mesh:
    """Heightfield terrain: 2*n^2 triangles (n=708 ~ 1M tris), value-noise
    heights, smooth normals, tiled uvs.  The 1M-triangle benchmark scene
    (BASELINE config 4)."""
    rng = np.random.default_rng(seed)
    # value noise: sum of bilinearly-upsampled random octaves
    h = np.zeros((n + 1, n + 1), dtype=np.float64)
    for octave in range(6):
        k = 4 * (2 ** octave)
        if k > n:
            break
        coarse = rng.standard_normal((k + 1, k + 1))
        ii = np.linspace(0, k, n + 1)
        i0 = np.clip(ii.astype(np.int64), 0, k - 1)
        fi = ii - i0
        top = coarse[i0] * (1 - fi)[:, None] + coarse[i0 + 1] * fi[:, None]
        row = top[:, i0] * (1 - fi)[None, :] + top[:, i0 + 1] * fi[None, :]
        h += row * (0.6 ** octave)
    h *= height / max(np.abs(h).max(), 1e-9)

    xs = np.linspace(-extent, extent, n + 1)
    zs = np.linspace(-extent, extent, n + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    # y is DOWN-ish in the reference's world (camera up = -y): put terrain
    # below the camera by using positive y for valleys
    pos = np.stack([gx, -h, gz], axis=-1).reshape(-1, 3).astype(F32)
    uv = np.stack(
        [gx / extent * 4.0, gz / extent * 4.0], axis=-1
    ).reshape(-1, 2).astype(F32)

    idx = np.empty((n, n, 2, 3), dtype=I32)
    a = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    idx[..., 0, 0] = a
    idx[..., 0, 1] = a + 1
    idx[..., 0, 2] = a + n + 1
    idx[..., 1, 0] = a + n + 1
    idx[..., 1, 1] = a + 1
    idx[..., 1, 2] = a + n + 2
    mesh = Mesh(
        positions=pos,
        indices=idx.reshape(-1, 3),
        uvs=uv,
    )
    return mesh.compute_normals()


def tri_soup(n_tris: int, seed: int = 0, span: float = 3.0,
             z_center: float = 4.0, tri_size: float = 0.08) -> Mesh:
    """n random small triangles in a box — worst-case unstructured load."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-span, span, (n_tris, 1, 3))
    centers[..., 2] = centers[..., 2] * 0.5 + z_center
    offsets = rng.uniform(-tri_size, tri_size, (n_tris, 3, 3))
    pos = (centers + offsets).reshape(-1, 3).astype(F32)
    idx = np.arange(3 * n_tris, dtype=I32).reshape(-1, 3)
    colors = np.repeat(
        rng.uniform(0.1, 1.0, (n_tris, 1, 4)), 3, axis=1
    ).reshape(-1, 4).astype(F32)
    return Mesh(positions=pos, indices=idx, colors=colors)
