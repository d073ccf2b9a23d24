"""Scene containers: meshes, objects, materials, lights, and host packing.

The port's own copy of ``ash_renderer_tpu/scene.py``, function for function
and with the same numpy expressions, so ``Scene.pack`` gives the same arrays
bit for bit in both packages.  A scene is a list of meshes instanced by
objects with per-object model matrices, packed into padded
structure-of-arrays buffers for the device.

``scene_from_reference`` carries a scene built with the JAX package across
into this package's types (the tests build each case once and run both
packages on it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import mathx
from . import native as native_mod

_F32 = np.float32
_I32 = np.int32

VERTEX_PAD = 128  # pad vertex counts to lane multiples
TRI_PAD = 128


def _as2d(a, n, width, fill=0.0, dtype=_F32):
    if a is None:
        out = np.full((n, width), fill, dtype=dtype)
    else:
        out = np.asarray(a, dtype=dtype).reshape(n, width).copy()
    return out


@dataclasses.dataclass
class Mesh:
    """A triangle mesh with optional per-vertex attributes."""

    positions: np.ndarray  # (N, 3) f32
    indices: np.ndarray  # (T, 3) i32, CCW-front per reference convention
    colors: Optional[np.ndarray] = None  # (N, 4) f32, default white
    normals: Optional[np.ndarray] = None  # (N, 3) f32, default +0 (unlit)
    uvs: Optional[np.ndarray] = None  # (N, 2) f32

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=_F32).reshape(-1, 3)
        n = len(self.positions)
        self.indices = np.asarray(self.indices, dtype=_I32).reshape(-1, 3)
        self.colors = _as2d(self.colors, n, 4, 1.0)
        self.normals = _as2d(self.normals, n, 3, 0.0)
        self.uvs = _as2d(self.uvs, n, 2, 0.0)
        if self.indices.size and (
            self.indices.min() < 0 or self.indices.max() >= n
        ):
            raise ValueError("mesh indices out of range")

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    def compute_normals(self) -> "Mesh":
        """Area-weighted smooth vertex normals (for meshes loaded without)."""
        p = self.positions.astype(np.float64)
        i0, i1, i2 = self.indices.T
        fn = np.cross(p[i1] - p[i0], p[i2] - p[i0])
        vn = np.zeros_like(p)
        for k, idx in enumerate((i0, i1, i2)):
            np.add.at(vn, idx, fn)
        ln = np.linalg.norm(vn, axis=1, keepdims=True)
        vn = np.where(ln > 1e-20, vn / np.maximum(ln, 1e-20), 0.0)
        self.normals = vn.astype(_F32)
        return self


@dataclasses.dataclass
class Material:
    base_color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    texture_id: int = -1  # index into the scene's TextureAtlas, -1 = none
    specular: float = 0.0  # specular strength (0 disables)
    shininess: int = 32  # integer exponent (evaluated by squaring: exact)


@dataclasses.dataclass
class DirectionalLight:
    direction: tuple[float, float, float] = (0.0, 0.0, 1.0)  # world space
    color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient: float = 0.1


@dataclasses.dataclass
class SceneObject:
    mesh: int  # index into Scene.meshes
    model: np.ndarray = dataclasses.field(default_factory=lambda: mathx.IDENTITY)
    material: int = 0

    def __post_init__(self):
        self.model = np.asarray(self.model, dtype=_F32).reshape(4, 4)


@dataclasses.dataclass
class Scene:
    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    objects: list[SceneObject] = dataclasses.field(default_factory=list)
    materials: list[Material] = dataclasses.field(
        default_factory=lambda: [Material()]
    )
    light: Optional[DirectionalLight] = None
    atlas: Optional["object"] = None  # textures.TextureAtlas

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_object(self, obj: SceneObject) -> int:
        self.objects.append(obj)
        return len(self.objects) - 1

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def model_matrices(self) -> np.ndarray:
        return np.stack([o.model for o in self.objects]).astype(_F32)

    def pack(self, meshlets: bool = False) -> "PackedScene":
        """meshlets=True reorders packing into 128-triangle meshlets with
        duplicated local vertex windows (the Renderer's layout: the setup
        kernel loads corners by meshlet-local index)."""
        return PackedScene.from_scene(self, meshlets=meshlets)


MESHLET_TRIS = 128
MESHLET_VERTS = 128


def _morton_order(tris: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Argsort triangle rows by the 30-bit Morton code of their centroid
    (quantized to 1024^3 over the position AABB) — vectorized numpy."""
    c = positions[tris].mean(axis=1)  # (T, 3) f32 centroids
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip((c - lo) / span * 1023.0, 0, 1023).astype(np.uint32)

    def part1by2(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (
        part1by2(q[:, 0]) | (part1by2(q[:, 1]) << 1) | (part1by2(q[:, 2]) << 2)
    )
    return np.argsort(code, kind="stable")


def build_meshlets(tri_v: np.ndarray, num_vertices: int,
                   positions: np.ndarray | None = None):
    """Greedy meshlet clustering: group triangles so each group references
    <= MESHLET_VERTS distinct vertices, emitting per-meshlet local corner
    indices and a duplicated, meshlet-contiguous vertex remap.

    The C++ builder (``native.py``, built at first use) runs where a host
    C++ compiler is found, else the Python loop (``greedy_meshlets``); both
    give the same arrays (the C++ one ~200x faster at 1M triangles).

    Returns (vertex_src (Vm,), local_tri (Tm, 3) int32, tri_perm (Tm,))
    where Vm = n_meshlets * MESHLET_VERTS (entries index the ORIGINAL
    vertex buffer; padding rows repeat index 0), Tm = n_meshlets *
    MESHLET_TRIS (tri_perm = -1 on padding rows, else the original
    triangle id).
    """
    t_real = np.nonzero(tri_v[:, 0] >= 0)[0].astype(_I32)
    if positions is not None and len(t_real):
        # Spatial (Morton) triangle order before the greedy grouping: many
        # generators emit interleaved orders (e.g. icosphere subdivision
        # touches the whole surface each pass), which destroys meshlet
        # vertex reuse and the id locality of the sorted streams.
        morton = _morton_order(tri_v[t_real], positions)
        t_real = t_real[morton]
    if native_mod.available():
        return native_mod.build_meshlets(tri_v, t_real, num_vertices)
    return greedy_meshlets(tri_v, t_real)


def greedy_meshlets(tri_v: np.ndarray, order: np.ndarray):
    """``build_meshlets``' greedy grouping as a Python loop, walking the
    real triangle ids in ``order``; ``csrc/meshlets.cpp`` gives the same
    arrays."""
    t_real = [int(t) for t in order]
    vertex_src: list[int] = []
    local_tri = []
    tri_perm = []

    cur_map: dict[int, int] = {}
    cur_tris: list[tuple[int, list[int]]] = []

    def flush():
        nonlocal cur_map, cur_tris
        if not cur_tris:
            return
        inv = [0] * MESHLET_VERTS
        for g, l in cur_map.items():
            inv[l] = g
        used = len(cur_map)
        vertex_src.extend(inv[:used])
        vertex_src.extend([0] * (MESHLET_VERTS - used))
        for orig_t, loc in cur_tris:
            local_tri.append(loc)
            tri_perm.append(orig_t)
        pad = MESHLET_TRIS - len(cur_tris)
        local_tri.extend([[0, 0, 0]] * pad)
        tri_perm.extend([-1] * pad)
        cur_map = {}
        cur_tris = []

    def fresh(corners, ref):
        # distinct new vertices in FIRST-OCCURRENCE corner order: local id
        # assignment is spec'd order-stable (the C++ fast path reproduces
        # it exactly); flush decisions depend only on the COUNT, so any
        # dedup order yields identical meshlet boundaries / triangle order
        out = []
        for v in corners:
            if v not in ref and v not in out:
                out.append(v)
        return out

    for t in t_real:
        corners = [int(v) for v in tri_v[t]]
        new = fresh(corners, cur_map)
        if (
            len(cur_map) + len(new) > MESHLET_VERTS
            or len(cur_tris) >= MESHLET_TRIS
        ):
            flush()
            new = fresh(corners, cur_map)
        for v in new:
            cur_map[v] = len(cur_map)
        cur_tris.append((t, [cur_map[v] for v in corners]))
    flush()
    if not tri_perm:  # degenerate empty scene: one padding meshlet
        vertex_src = [0] * MESHLET_VERTS
        local_tri = [[0, 0, 0]] * MESHLET_TRIS
        tri_perm = [-1] * MESHLET_TRIS
    return (
        np.asarray(vertex_src, dtype=_I32),
        np.asarray(local_tri, dtype=_I32).reshape(-1, 3),
        np.asarray(tri_perm, dtype=_I32),
    )


@dataclasses.dataclass
class PackedScene:
    """Flattened, padded SoA buffers ready for device upload.

    Geometry is concatenated per object instance: each object gets its own
    copy of its mesh's vertex range, and every packed vertex carries the
    owning object id so the vertex stage can apply per-object model matrices
    with a single gathered matrix lookup (no per-triangle indirection).
    """

    positions: np.ndarray  # (V, 3) f32, padded
    colors: np.ndarray  # (V, 4)
    normals: np.ndarray  # (V, 3)
    uvs: np.ndarray  # (V, 2)
    vert_obj: np.ndarray  # (V,) i32 — owning object per packed vertex copy
    tri_v: np.ndarray  # (T, 3) i32 global vertex ids (-1 rows = padding)
    tri_obj: np.ndarray  # (T,) i32
    local_tri: "np.ndarray | None"  # (T,3) i32 meshlet-local ids, or None
    obj_material: np.ndarray  # (O,) i32
    num_vertices: int
    num_triangles: int
    has_normals: bool

    @property
    def n_meshlets(self) -> int:
        return self.tri_v.shape[0] // MESHLET_TRIS

    @staticmethod
    def from_scene(scene: Scene, meshlets: bool = False) -> "PackedScene":
        pos, col, nrm, uv, vobj = [], [], [], [], []
        tri, tobj = [], []
        vtx_base = 0
        for oi, obj in enumerate(scene.objects):
            m = scene.meshes[obj.mesh]
            pos.append(m.positions)
            col.append(m.colors)
            nrm.append(m.normals)
            uv.append(m.uvs)
            vobj.append(np.full(m.num_vertices, oi, dtype=_I32))
            tri.append(m.indices + vtx_base)
            tobj.append(np.full(m.num_triangles, oi, dtype=_I32))
            vtx_base += m.num_vertices
        if not pos:
            raise ValueError("empty scene")
        positions0 = np.concatenate(pos)
        colors0 = np.concatenate(col)
        normals0 = np.concatenate(nrm)
        uvs0 = np.concatenate(uv)
        vert_obj0 = np.concatenate(vobj)
        tri_v0 = np.concatenate(tri).astype(_I32)
        tri_obj0 = np.concatenate(tobj).astype(_I32)
        nt = len(tri_v0)
        has_normals = any(
            np.any(scene.meshes[o.mesh].normals != 0) for o in scene.objects
        )
        obj_material = np.array([o.material for o in scene.objects], dtype=_I32)

        if not meshlets:
            nv = len(positions0)
            vpad = -nv % VERTEX_PAD
            tpad = -nt % TRI_PAD

            def padv(a, w):
                return np.concatenate([a, np.zeros((vpad, w), dtype=_F32)])

            return PackedScene(
                positions=padv(positions0, 3),
                colors=padv(colors0, 4),
                normals=padv(normals0, 3),
                uvs=padv(uvs0, 2),
                vert_obj=np.concatenate(
                    [vert_obj0, np.zeros(vpad, dtype=_I32)]
                ),
                tri_v=np.concatenate(
                    [tri_v0, np.full((tpad, 3), -1, dtype=_I32)]
                ).astype(_I32),
                tri_obj=np.concatenate(
                    [tri_obj0, np.zeros(tpad, dtype=_I32)]
                ).astype(_I32),
                local_tri=None,
                obj_material=obj_material,
                num_vertices=nv,
                num_triangles=nt,
                has_normals=has_normals,
            )

        # Meshletize: the canonical packed order is meshlet order, with
        # vertices duplicated meshlet-contiguously; the oracle consumes the
        # same layout, so draw-order semantics agree by construction.
        vertex_src, local_tri, tri_perm = build_meshlets(
            tri_v0, len(positions0), positions=positions0
        )
        tm = len(tri_perm)
        vm = len(vertex_src)
        base = (
            np.repeat(np.arange(tm // MESHLET_TRIS, dtype=_I32), MESHLET_TRIS)[
                :, None
            ]
            * MESHLET_VERTS
        )
        tri_v = np.where(tri_perm[:, None] >= 0, base + local_tri, -1).astype(
            _I32
        )
        tri_obj = np.where(
            tri_perm >= 0, tri_obj0[np.clip(tri_perm, 0, max(nt - 1, 0))], 0
        ).astype(_I32)

        return PackedScene(
            positions=positions0[vertex_src],
            colors=colors0[vertex_src],
            normals=normals0[vertex_src],
            uvs=uvs0[vertex_src],
            vert_obj=vert_obj0[vertex_src],
            tri_v=tri_v,
            tri_obj=tri_obj,
            local_tri=local_tri,
            obj_material=obj_material,
            num_vertices=vm,
            num_triangles=nt,
            has_normals=has_normals,
        )


def reference_two_triangle_scene() -> Scene:
    """The reference's hard-coded scene: 6 vertices, 2 triangles at z=2 and
    z=3 with per-vertex colours and indices [0..5].  Under CCW-front + back
    culling only the z=2 triangle is front-facing."""
    positions = [
        [-1.0, 1.0, 2.0], [1.0, 1.0, 2.0], [0.0, -1.0, 2.0],
        [-1.0, -1.0, 3.0], [1.0, -1.0, 3.0], [0.0, 1.0, 3.0],
    ]
    colors = [
        [1.0, 1.0, 0.0, 1.0], [1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0],
        [0.0, 1.0, 0.5, 1.0], [0.5, 0.0, 1.0, 1.0], [1.0, 0.5, 0.0, 1.0],
    ]
    mesh = Mesh(
        positions=np.array(positions, dtype=_F32),
        indices=np.array([[0, 1, 2], [3, 4, 5]], dtype=_I32),
        colors=np.array(colors, dtype=_F32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh), model=mathx.IDENTITY))
    return scene


def scene_from_reference(ref) -> Scene:
    """The port's ``Scene`` holding the same meshes, objects, materials,
    light and atlas images as ``ref``, a scene built with the JAX package.
    Reads attributes and numpy arrays only (the weights carried across, in
    a model port's terms); the arrays are copied."""
    from .textures import TextureAtlas

    scene = Scene(
        materials=[Material(base_color=tuple(m.base_color),
                            texture_id=int(m.texture_id),
                            specular=float(m.specular),
                            shininess=int(m.shininess))
                   for m in ref.materials],
        light=None if ref.light is None else DirectionalLight(
            direction=tuple(ref.light.direction),
            color=tuple(ref.light.color), ambient=float(ref.light.ambient)),
    )
    for m in ref.meshes:
        scene.add_mesh(Mesh(positions=np.array(m.positions),
                            indices=np.array(m.indices),
                            colors=np.array(m.colors),
                            normals=np.array(m.normals),
                            uvs=np.array(m.uvs)))
    for o in ref.objects:
        scene.add_object(SceneObject(mesh=int(o.mesh), model=np.array(o.model),
                                     material=int(o.material)))
    if ref.atlas is not None:
        scene.atlas = TextureAtlas(**{
            f.name: np.array(getattr(ref.atlas, f.name))
            for f in dataclasses.fields(TextureAtlas)
        })
    return scene
