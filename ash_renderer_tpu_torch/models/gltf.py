"""glTF 2.0 loader (pure Python, .gltf and .glb): the port's copy of
``ash_renderer_tpu/models/gltf.py``, which gives the same scene bit for bit.

Supported subset (the standard static-mesh path): JSON + external/embedded
(base64) buffers, GLB container, node hierarchy with TRS or matrix
transforms, mesh primitives with POSITION / NORMAL / TEXCOORD_0 / COLOR_0 and
u16/u32 indices, materials with baseColorFactor + baseColorTexture, images
decoded with PIL (``textures.load_image`` / ``decode_image``, which raise
where PIL is absent).  Returns a populated Scene (meshes, per-node objects
with composed world matrices, materials, texture atlas).

One difference: an accessor whose buffer view has a ``byteStride`` wider
than its element (interleaved vertex data) is read here, where the
reference raises ``ValueError``.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .. import mathx
from ..scene import Material, Mesh, Scene, SceneObject
from ..textures import TextureAtlas, decode_image, load_image

F32 = np.float32
I32 = np.int32

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_WIDTHS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None):
    bufs = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _read_accessor(doc: dict, bufs: list, idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    width = _TYPE_WIDTHS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype().itemsize * width
    raw = bufs[view["buffer"]]
    itemsize = dtype().itemsize
    if stride == itemsize * width:
        arr = np.frombuffer(
            raw, dtype=dtype, count=count * width, offset=offset
        ).reshape(count, width)
    else:
        # interleaved: each element's bytes start ``stride`` bytes apart
        span = itemsize * width
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(raw, dtype=np.uint8,
                          count=(count - 1) * stride + span, offset=offset),
            shape=(count, span), strides=(stride, 1),
        )
        arr = np.ascontiguousarray(rows).view(dtype).reshape(count, width)
    if acc.get("normalized") and dtype in (np.uint8, np.uint16):
        arr = arr.astype(F32) / np.float32(np.iinfo(dtype).max)
    return np.ascontiguousarray(arr)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], F32).reshape(4, 4).T  # column-major
    m = mathx.IDENTITY
    if "translation" in node:
        m = mathx.compose(m, mathx.translation(node["translation"]))
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            dtype=F32,
        )
        m = mathx.compose(m, rot)
    if "scale" in node:
        m = mathx.compose(m, mathx.scaling(node["scale"]))
    return m


def load_gltf(path: str) -> Scene:
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            data = f.read()
        magic, _version, _length = struct.unpack_from("<III", data, 0)
        if magic != 0x46546C67:
            raise ValueError("not a GLB file")
        offset = 12
        doc = None
        while offset < len(data):
            chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8 : offset + 8 + chunk_len]
            if chunk_type == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif chunk_type == 0x004E4942:  # BIN
                glb_bin = chunk
            offset += 8 + chunk_len
        if doc is None:
            raise ValueError("GLB missing JSON chunk")
    else:
        with open(path, "r") as f:
            doc = json.load(f)

    bufs = _load_buffers(doc, base_dir, glb_bin)

    # images -> atlas
    images = []
    for img in doc.get("images", []):
        if "uri" in img and not img["uri"].startswith("data:"):
            images.append(load_image(os.path.join(base_dir, img["uri"])))
        else:
            if "uri" in img:
                raw = base64.b64decode(img["uri"].split(",", 1)[1])
            else:
                view = doc["bufferViews"][img["bufferView"]]
                off = view.get("byteOffset", 0)
                raw = bufs[view["buffer"]][off : off + view["byteLength"]]
            images.append(decode_image(raw))
    atlas = TextureAtlas.build(images) if images else None

    def texture_image(tex_idx: int) -> int:
        return doc["textures"][tex_idx].get("source", -1)

    materials = []
    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        base = tuple(pbr.get("baseColorFactor", [1, 1, 1, 1]))
        tex = pbr.get("baseColorTexture")
        materials.append(
            Material(
                base_color=base,
                texture_id=texture_image(tex["index"]) if tex else -1,
                specular=0.0,
            )
        )
    if not materials:
        materials = [Material()]

    scene = Scene(materials=materials, atlas=atlas)

    mesh_prims: list[list[tuple[int, int]]] = []  # per gltf mesh: (mesh_id, mat)
    for m in doc.get("meshes", []):
        prims = []
        for prim in m.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, bufs, attrs["POSITION"]).astype(F32)
            nrm = (
                _read_accessor(doc, bufs, attrs["NORMAL"]).astype(F32)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                _read_accessor(doc, bufs, attrs["TEXCOORD_0"]).astype(F32)
                if "TEXCOORD_0" in attrs
                else None
            )
            col = None
            if "COLOR_0" in attrs:
                c = _read_accessor(doc, bufs, attrs["COLOR_0"]).astype(F32)
                if c.shape[1] == 3:
                    c = np.concatenate(
                        [c, np.ones((len(c), 1), F32)], axis=1
                    )
                col = c
            if "indices" in prim:
                idx = _read_accessor(doc, bufs, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=I32)
            mesh = Mesh(
                positions=pos,
                indices=idx.astype(I32).reshape(-1, 3),
                normals=nrm,
                uvs=uv,
                colors=col,
            )
            if nrm is None:
                mesh.compute_normals()
            prims.append(
                (scene.add_mesh(mesh), prim.get("material", 0))
            )
        mesh_prims.append(prims)

    # node hierarchy -> objects with composed world matrices
    nodes = doc.get("nodes", [])
    scene_nodes = doc.get("scenes", [{}])[doc.get("scene", 0)].get("nodes", [])

    def visit(node_idx: int, parent: np.ndarray):
        node = nodes[node_idx]
        world = mathx.compose(parent, _node_matrix(node))
        if "mesh" in node:
            for mesh_id, mat_id in mesh_prims[node["mesh"]]:
                scene.add_object(
                    SceneObject(mesh=mesh_id, model=world, material=mat_id)
                )
        for child in node.get("children", []):
            visit(child, world)

    for root in scene_nodes:
        visit(root, mathx.IDENTITY)
    if not scene.objects:  # no scene graph: instance every mesh at origin
        for prims in mesh_prims:
            for mesh_id, mat_id in prims:
                scene.add_object(
                    SceneObject(mesh=mesh_id, material=mat_id)
                )
    return scene
