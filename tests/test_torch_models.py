"""The port's mesh sources against the JAX package's, bit for bit: the
procedural generators, the OBJ loader and writer (Python and C++ parsers),
the glTF / GLB loader, ``textures.load_image`` and the forked benchmark
scenes (``benchmarks.ALL_CONFIGS``)."""

import base64
import io
import json
import os
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import benchmarks as ref_bench  # noqa: E402
from ash_renderer_tpu import models as ref_models  # noqa: E402
from ash_renderer_tpu import textures as ref_textures  # noqa: E402
from ash_renderer_tpu.models import obj as ref_obj  # noqa: E402
from ash_renderer_tpu_torch import benchmarks, models, native, textures  # noqa: E402
from ash_renderer_tpu_torch.models import gltf, obj  # noqa: E402
from ash_renderer_tpu_torch.scene import scene_from_reference  # noqa: E402

PACKED_FIELDS = ("positions", "colors", "normals", "uvs", "vert_obj", "tri_v",
                 "tri_obj", "local_tri", "obj_material")
_same, _same_mesh, _same_scene = tp.same_bits, tp.same_mesh, tp.same_scene


# ---------------------------------------------------------------------------
# procedural meshes
# ---------------------------------------------------------------------------

PROCEDURAL = {
    "terrain_16": lambda m: m.terrain(16),
    "terrain_33_seeded": lambda m: m.terrain(33, extent=6.0, height=0.8,
                                             seed=3),
    "terrain_128": lambda m: m.terrain(128, extent=6.0, height=0.8),
    "grid_sheet_4x6": lambda m: m.grid_sheet(4, 6),
    "grid_sheet_offset": lambda m: m.grid_sheet(7, 3, extent=1.5, y=0.25),
    "tri_soup_50": lambda m: m.tri_soup(50),
    "tri_soup_seeded": lambda m: m.tri_soup(333, seed=9, span=2.0,
                                            z_center=3.0, tri_size=0.2),
}


@pytest.mark.parametrize("name", sorted(PROCEDURAL))
def test_procedural_matches_reference(name):
    """terrain, grid_sheet and tri_soup: every array bit-equal."""
    _same_mesh(PROCEDURAL[name](models), PROCEDURAL[name](ref_models))


def test_terrain_triangle_count():
    assert models.terrain(16).num_triangles == 2 * 16 * 16


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

POLY_OBJ = """# quad fan, negative indices, v//vn and v/vt forms
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0.25 0.75
vt 0.5
vn 0 0 -1
f 1 2 3 4
f -4 -3 -2
f 1/1 2/2 3/1
f 1//1 3//1 4//1
f -4/-2/-1 -2/-1/-1 -1/-2/-1
"""


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


def test_save_obj_bytes_match_reference(tmp_path):
    """The port's writer gives the reference's bytes."""
    mesh = ref_models.uv_sphere(6, 12)
    a, b = str(tmp_path / "port.obj"), str(tmp_path / "ref.obj")
    obj.save_obj(a, models.uv_sphere(6, 12))
    ref_obj.save_obj(b, mesh)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("src", ["uv_sphere", "icosphere", "poly"])
def test_obj_parsers_match_reference(tmp_path, src):
    """native.parse_obj (C++) == load_obj_python == the reference's
    load_obj, bit for bit, on a round-tripped sphere and icosphere and on
    polygons with negative indices and every corner form."""
    path = str(tmp_path / f"{src}.obj")
    if src == "poly":
        _write(path, POLY_OBJ)
    else:
        obj.save_obj(path, getattr(models, src)(*(
            (6, 12) if src == "uv_sphere" else (2,))))
    want = ref_obj.load_obj(path)
    py = obj.load_obj_python(path)
    _same_mesh(py, want)
    assert native.available()
    pos, uv, nrm, faces = native.parse_obj(path)
    raw = obj.load_obj_python(path, compute_normals_if_missing=False)
    for got, k in ((pos, "positions"), (uv, "uvs"), (nrm, "normals"),
                   (faces, "indices")):
        _same(got, getattr(raw, k))
    _same_mesh(obj.load_obj(path), want)


def test_obj_polygons_and_negative_indices(tmp_path):
    mesh = obj.load_obj_python(_write(str(tmp_path / "p.obj"), POLY_OBJ),
                               compute_normals_if_missing=False)
    assert mesh.num_triangles == 2 + 1 + 1 + 1 + 1
    # (v), (v, vt), (v, vn) and (v, vt, vn) corners are distinct vertices
    assert mesh.num_vertices == 4 + 3 + 3 + 3
    np.testing.assert_array_equal(mesh.indices[:3],
                                  [[0, 1, 2], [0, 2, 3], [0, 1, 2]])


def test_obj_roundtrip_geometry(tmp_path):
    """save_obj -> load_obj keeps each face's corner positions."""
    mesh = models.uv_sphere(6, 12)
    path = str(tmp_path / "rt.obj")
    obj.save_obj(path, mesh)
    back = obj.load_obj(path)
    assert back.num_triangles == mesh.num_triangles
    a = np.sort(mesh.positions[mesh.indices].reshape(-1, 9), axis=0)
    b = np.sort(back.positions[back.indices].reshape(-1, 9), axis=0)
    np.testing.assert_array_equal(a, b)


def test_load_obj_takes_the_native_parser(tmp_path, monkeypatch):
    """load_obj parses in C++ when a host compiler is found and in Python
    when none is."""
    path = str(tmp_path / "s.obj")
    obj.save_obj(path, models.icosphere(1))
    calls = []
    real = native.parse_obj
    monkeypatch.setattr(native, "parse_obj",
                        lambda p: calls.append(p) or real(p))
    obj.load_obj(path)
    assert calls == [path]
    monkeypatch.setattr(native, "available", lambda: False)
    obj.load_obj(path)
    assert calls == [path]


# ---------------------------------------------------------------------------
# glTF / GLB
# ---------------------------------------------------------------------------

def _png_bytes(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode="RGBA").save(buf, format="PNG")
    return buf.getvalue()


def _gltf_doc(tmpdir, image_mode):
    """A two-primitive glTF (tests/test_models_and_assets.py's helper,
    grown): positions, normals, uvs, colours (VEC3 and normalized u8
    VEC4), u16 and u32 indices, a node tree with TRS and matrix transforms,
    two materials, one of them textured by an image given as an external
    file, a data URI or a buffer view (``image_mode``).  Returns (doc,
    binary buffer)."""
    rng = np.random.default_rng(11)
    pos0 = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    nrm0 = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    uv0 = rng.uniform(0, 1, (4, 2)).astype(np.float32)
    col0 = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    idx0 = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    pos1 = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    col1 = rng.integers(0, 256, (5, 4)).astype(np.uint8)
    idx1 = np.array([0, 1, 2, 2, 3, 4, 4, 1, 0], np.uint32)
    img = rng.integers(0, 256, (8, 8, 4)).astype(np.uint8)
    png = _png_bytes(img)
    blobs = [pos0, nrm0, uv0, col0, idx0, pos1, col1, idx1]
    if image_mode == "view":
        blobs.append(np.frombuffer(png, np.uint8))
    data, views = b"", []
    for b in blobs:
        raw = b.tobytes()
        data += b"\0" * (-len(data) % 4)
        views.append({"buffer": 0, "byteOffset": len(data),
                      "byteLength": len(raw)})
        data += raw
    acc = [
        {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
        {"bufferView": 3, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 4, "componentType": 5123, "count": 6,
         "type": "SCALAR"},
        {"bufferView": 5, "componentType": 5126, "count": 5, "type": "VEC3"},
        {"bufferView": 6, "componentType": 5121, "count": 5, "type": "VEC4",
         "normalized": True},
        {"bufferView": 7, "componentType": 5125, "count": 9,
         "type": "SCALAR"},
    ]
    if image_mode == "file":
        with open(os.path.join(tmpdir, "tex.png"), "wb") as f:
            f.write(png)
        image = {"uri": "tex.png"}
    elif image_mode == "data":
        image = {"uri": "data:image/png;base64,"
                 + base64.b64encode(png).decode()}
    else:
        image = {"bufferView": 8, "mimeType": "image/png"}
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 3]}],
        "nodes": [
            {"mesh": 0, "translation": [0.5, -0.25, 3.0],
             "rotation": [0.0, 0.38268343, 0.0, 0.92387953],
             "scale": [1.5, 1.0, 0.5], "children": [1]},
            {"mesh": 1, "translation": [0.0, 1.0, 0.0], "children": [2]},
            {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 0.8, 0.6, 0, 0, -0.6, 0.8,
                                   0, 0.1, 0.2, 0.3, 1]},
            {"mesh": 1},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                            "TEXCOORD_0": 2, "COLOR_0": 3},
                             "indices": 4, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": 5, "COLOR_0": 6},
                             "indices": 7},
                            {"attributes": {"POSITION": 5}, "mode": 1}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.5, 0.25,
                                                          1.0]}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}},
        ],
        "textures": [{"source": 0}],
        "images": [image],
        "accessors": acc,
        "bufferViews": views,
        "buffers": [{"byteLength": len(data)}],
    }
    return doc, data


def _write_gltf(tmpdir, image_mode, buffer_mode):
    """The glTF of ``_gltf_doc`` with its buffer as an external file, a
    data URI, or the BIN chunk of a GLB (``buffer_mode``)."""
    doc, data = _gltf_doc(tmpdir, image_mode)
    if buffer_mode == "glb":
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        bd = data + b"\0" * (-len(data) % 4)
        path = os.path.join(tmpdir, "scene.glb")
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2,
                                12 + 8 + len(js) + 8 + len(bd))
                    + struct.pack("<II", len(js), 0x4E4F534A) + js
                    + struct.pack("<II", len(bd), 0x004E4942) + bd)
        return path
    if buffer_mode == "file":
        with open(os.path.join(tmpdir, "geom.bin"), "wb") as f:
            f.write(data)
        doc["buffers"][0]["uri"] = "geom.bin"
    else:
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(data).decode())
    path = os.path.join(tmpdir, "scene.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.mark.parametrize("image_mode,buffer_mode", [
    ("file", "file"), ("data", "data"), ("view", "glb"), ("file", "glb")])
def test_gltf_matches_reference(tmp_path, image_mode, buffer_mode):
    """load_gltf, .gltf and .glb, with each image and buffer source: the
    same meshes, model matrices, materials and atlas as the reference's."""
    path = _write_gltf(str(tmp_path), image_mode, buffer_mode)
    got, want = gltf.load_gltf(path), ref_models.load_gltf(path)
    _same_scene(got, want)
    assert len(got.meshes) == 2 and len(got.objects) == 4
    assert got.materials[1].texture_id == 0 and got.atlas is not None


def test_gltf_minimal_and_no_scene_graph(tmp_path):
    """The reference test's minimal glTF, then the same without nodes (every
    mesh instanced at the origin)."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    data = pos.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, 3]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "buffers": [{"uri": "geom.bin", "byteLength": len(data)}],
    }
    with open(tmp_path / "geom.bin", "wb") as f:
        f.write(data)
    for nodes in (True, False):
        if not nodes:
            del doc["nodes"], doc["scenes"], doc["scene"]
        path = str(tmp_path / f"tri{int(nodes)}.gltf")
        with open(path, "w") as f:
            json.dump(doc, f)
        got = gltf.load_gltf(path)
        _same_scene(got, ref_models.load_gltf(path))
        assert got.objects[0].model[2, 3] == (3.0 if nodes else 0.0)


def test_gltf_interleaved_accessor(tmp_path):
    """An accessor in a buffer view with a byteStride (interleaved position
    and normal) reads each element's own bytes; the reference raises
    ValueError on it (ROADMAP queue 3)."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    nrm = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    data = np.concatenate([pos, nrm], axis=1).tobytes()
    doc = {"accessors": [
        {"bufferView": 0, "componentType": 5126, "count": 5, "type": "VEC3"},
        {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
         "count": 5, "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(data), "byteStride": 24}]}
    _same(gltf._read_accessor(doc, [data], 0), pos)
    _same(gltf._read_accessor(doc, [data], 1), nrm)
    from ash_renderer_tpu.models.gltf import _read_accessor as ref_read

    with pytest.raises(ValueError):
        ref_read(doc, [data], 0)


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_load_image_matches_reference(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (12, 10, 4), dtype=np.uint8)
    path = str(tmp_path / f"img_{mode}.png")
    Image.fromarray(img, mode="RGBA").convert(mode).save(path)
    _same(textures.load_image(path), ref_textures.load_image(path))
    with open(path, "rb") as f:
        _same(textures.decode_image(f.read()), ref_textures.load_image(path))


def _block_pil(monkeypatch):
    """Make ``import PIL`` fail, as where Pillow is not installed."""
    for name in list(sys.modules):
        if name == "PIL" or name.startswith("PIL."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_load_image_without_pil_raises(tmp_path, monkeypatch):
    """Without PIL, load_image and decode_image raise ImportError naming
    themselves; nothing substitutes an image."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(np.zeros((2, 2, 4), np.uint8)))
    _block_pil(monkeypatch)
    with pytest.raises(ImportError, match="textures.load_image"):
        textures.load_image(path)
    with pytest.raises(ImportError, match="textures.decode_image"):
        textures.decode_image(b"")


# ---------------------------------------------------------------------------
# benchmark scenes
# ---------------------------------------------------------------------------

def _same_pack(got, want, meshlets):
    a, b = got.pack(meshlets=meshlets), want.pack(meshlets=meshlets)
    for k in PACKED_FIELDS:
        if getattr(b, k) is None:
            assert getattr(a, k) is None, k
        else:
            _same(getattr(a, k), getattr(b, k))


SCENE_BUILDERS = {
    "reference": lambda b: b.reference_scene_config(),
    "config1_textured_obj": lambda b: b.config1_textured_obj(),
    "config4_terrain_n24": lambda b: b.config4_terrain(24),
    "config5_flythrough": lambda b: b.config5_flythrough(6),
}


@pytest.mark.parametrize("name", sorted(SCENE_BUILDERS))
def test_forked_scene_matches_reference(name, tmp_path, monkeypatch):
    """Each scene forked into ALL_CONFIGS: its scene, settings and cameras
    equal the reference's, and pack() (meshlet and plain layouts) gives the
    same arrays.  Terrain at n = 24 (its 1080p frame is checked on the
    card).  config1's OBJ files go to this test's own directory."""
    import tempfile

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    got, st, cams = SCENE_BUILDERS[name](benchmarks)
    want, rst, rcams = SCENE_BUILDERS[name](ref_bench)
    _same_scene(got, want)
    for meshlets in (True, False):
        _same_pack(got, want, meshlets)
    assert tp.port_settings(rst) == st
    assert len(cams) == len(rcams)
    for c, rc in zip(cams, rcams):
        _same(c.view_matrix(), rc.view_matrix())
        assert (c.phi, c.theta, c.fovy) == (rc.phi, rc.theta, rc.fovy)


def test_all_configs_names():
    assert list(benchmarks.ALL_CONFIGS) == list(ref_bench.ALL_CONFIGS)


def test_config1_obj_goes_through_the_ports_loader(tmp_path, monkeypatch):
    """config1 writes its sphere with the port's save_obj into its own file
    of the temporary directory and reads it back with the port's
    load_obj."""
    import tempfile

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    saved, loaded = [], []
    monkeypatch.setattr(benchmarks, "save_obj",
                        lambda p, m: saved.append(p) or obj.save_obj(p, m))
    monkeypatch.setattr(benchmarks, "load_obj",
                        lambda p: loaded.append(p) or obj.load_obj(p))
    scene = benchmarks.config1_textured_obj()[0]
    assert len(saved) == 1 and loaded == [
        str(tmp_path / "ash_torch_bench_sphere.obj")]
    _same_mesh(scene.meshes[0], ref_bench.config1_textured_obj(
        loaded[0])[0].meshes[0])


def test_reference_texture_rule(tmp_path, monkeypatch):
    """_reference_texture: checkerboard(512) without the asset; the asset's
    pixels when its path is given and it is square with a power-of-two
    side; the checkerboard again for a non-power-of-two image."""
    from PIL import Image

    monkeypatch.delenv(benchmarks.REFERENCE_TEXTURE_ENV, raising=False)
    _same(benchmarks._reference_texture(), textures.checkerboard(512))
    rng = np.random.default_rng(8)
    for side, want_asset in ((64, True), (48, False)):
        img = rng.integers(0, 256, (side, side, 4), dtype=np.uint8)
        path = str(tmp_path / f"texture_{side}.png")
        Image.fromarray(img, mode="RGBA").save(path)
        monkeypatch.setenv(benchmarks.REFERENCE_TEXTURE_ENV, path)
        _same(benchmarks._reference_texture(),
              img if want_asset else textures.checkerboard(512))


def test_scene_from_reference_keeps_loaded_scene(tmp_path):
    """A glTF scene loaded by the reference and carried across equals the
    port's own load."""
    path = _write_gltf(str(tmp_path), "file", "glb")
    _same_scene(scene_from_reference(ref_models.load_gltf(path)),
                gltf.load_gltf(path))
