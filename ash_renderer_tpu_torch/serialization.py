"""Scene and camera-path serialization for reproducible runs: the port's
copy of ``ash_renderer_tpu/serialization.py``.

Meshes, objects, materials, light, texture atlas and camera path go into
one ``.npz`` with the reference's layout (the same array names, dtypes and
``__meta__`` JSON), so a file saved by either package loads in the other
into equal arrays.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .camera import Camera
from .scene import DirectionalLight, Material, Mesh, Scene, SceneObject
from .textures import TextureAtlas


def save_scene(path: str, scene: Scene, cameras: list[Camera] | None = None):
    """Write ``scene`` and ``cameras`` to ``path`` (``np.savez_compressed``;
    a Material's base_color tuple goes to JSON as a list)."""
    arrays = {}
    meta = {
        "n_meshes": len(scene.meshes),
        "n_objects": len(scene.objects),
        "materials": [dataclasses.asdict(m) for m in scene.materials],
        "light": dataclasses.asdict(scene.light) if scene.light else None,
        "has_atlas": scene.atlas is not None,
        "n_cameras": len(cameras) if cameras else 0,
    }
    for i, m in enumerate(scene.meshes):
        arrays[f"mesh{i}_pos"] = m.positions
        arrays[f"mesh{i}_idx"] = m.indices
        arrays[f"mesh{i}_col"] = m.colors
        arrays[f"mesh{i}_nrm"] = m.normals
        arrays[f"mesh{i}_uv"] = m.uvs
    arrays["obj_mesh"] = np.array([o.mesh for o in scene.objects], np.int32)
    arrays["obj_mat"] = np.array([o.material for o in scene.objects], np.int32)
    arrays["obj_model"] = np.stack([o.model for o in scene.objects])
    if scene.atlas is not None:
        for k in ("texels", "level_offset", "level_w", "level_h", "n_levels"):
            arrays[f"atlas_{k}"] = np.asarray(getattr(scene.atlas, k))
    if cameras:
        arrays["cam_pos"] = np.stack([c.position for c in cameras])
        arrays["cam_angles"] = np.array(
            [[c.phi, c.theta, c.fovy, c.znear, c.zfar] for c in cameras],
            np.float32,
        )
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_scene(path: str) -> tuple[Scene, list[Camera]]:
    """Read a file of ``save_scene`` (either package's): (scene, cameras).
    The atlas's bilinear quads are derived data and rebuilt here."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    scene = Scene(
        materials=[Material(**m) for m in meta["materials"]]
        or [Material()],
    )
    if meta["light"]:
        light = meta["light"]
        scene.light = DirectionalLight(
            direction=tuple(light["direction"]),
            color=tuple(light["color"]),
            ambient=light["ambient"],
        )
    for i in range(meta["n_meshes"]):
        scene.add_mesh(
            Mesh(
                positions=data[f"mesh{i}_pos"],
                indices=data[f"mesh{i}_idx"],
                colors=data[f"mesh{i}_col"],
                normals=data[f"mesh{i}_nrm"],
                uvs=data[f"mesh{i}_uv"],
            )
        )
    for mi, mat, model in zip(
        data["obj_mesh"], data["obj_mat"], data["obj_model"]
    ):
        scene.add_object(
            SceneObject(mesh=int(mi), material=int(mat), model=model)
        )
    if meta["has_atlas"]:
        from .textures import build_quads

        # quads are derived data: rebuild on load (keeps the .npz format
        # stable and 4x smaller than persisting them)
        scene.atlas = TextureAtlas(
            texels=data["atlas_texels"],
            quads=build_quads(
                data["atlas_texels"],
                data["atlas_level_offset"],
                data["atlas_level_w"],
                data["atlas_level_h"],
                data["atlas_n_levels"],
            ),
            level_offset=data["atlas_level_offset"],
            level_w=data["atlas_level_w"],
            level_h=data["atlas_level_h"],
            n_levels=data["atlas_n_levels"],
        )
    cameras = []
    for i in range(meta["n_cameras"]):
        phi, theta, fovy, znear, zfar = data["cam_angles"][i]
        cameras.append(
            Camera(
                position=data["cam_pos"][i].copy(),
                phi=float(phi),
                theta=float(theta),
                fovy=float(fovy),
                znear=float(znear),
                zfar=float(zfar),
            )
        )
    return scene, cameras
