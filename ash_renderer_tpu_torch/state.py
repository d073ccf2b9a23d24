"""Scene state on the device: the buffer set the JAX Renderer uploads
(``ash_renderer_tpu/renderer.py:135-190``), built from the same host
arrays, so both renderers see bit-identical inputs."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .ops import setup_kernel
from .rtypes import LightPack, MaterialsPack
from .scene import PackedScene
from .textures import TextureAtlas

F32 = np.float32
I32 = np.int32


@dataclasses.dataclass
class SceneState:
    positions: torch.Tensor  # (V, 3) f32
    vert_obj: torch.Tensor  # (V,) i32
    normals: torch.Tensor  # (V, 3) f32
    colors: torch.Tensor  # (V, 4) f32
    uvs: torch.Tensor  # (V, 2) f32
    tri_v: torch.Tensor  # (T, 3) i32, -1 rows = padding
    tri_mat: torch.Tensor  # (T,) i32 per-triangle material ids
    # meshlet-packed scenes only (None otherwise): the setup kernel's
    # transposed meshlet-local corner ids (M, 384) and materials (M, 128)
    ltT: Optional[torch.Tensor]
    matT: Optional[torch.Tensor]
    materials: Optional[MaterialsPack]
    atlas: Optional[TextureAtlas]  # fields as tensors
    light: Optional[LightPack]


def upload(packed: PackedScene, materials, atlas, light,
           device: torch.device) -> SceneState:
    """The scene's device state on ``device``, from the same host
    expressions the JAX Renderer uses.  ``materials`` is a list of
    scene.Material, ``light`` a scene.DirectionalLight or None, ``atlas``
    a TextureAtlas or None.  The per-triangle materials are computed here,
    on the host, once per scene."""
    tri_mat = packed.obj_material[
        np.clip(packed.tri_obj, 0, len(packed.obj_material) - 1)
    ]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ltT = matT = None
    if packed.local_tri is not None:
        ltT, matT = (put(a) for a in setup_kernel.prep_static(
            packed.local_tri, tri_mat, packed.tri_v[:, 0] >= 0))

    mats = {
        "base_color": np.array([m.base_color for m in materials], F32),
        "tex_id": np.array([m.texture_id for m in materials], I32),
        "specular": np.array([m.specular for m in materials], F32),
        "shininess": np.array([m.shininess for m in materials], I32),
    }
    return SceneState(
        positions=put(packed.positions), vert_obj=put(packed.vert_obj),
        normals=put(packed.normals), colors=put(packed.colors),
        uvs=put(packed.uvs), tri_v=put(packed.tri_v), tri_mat=put(tri_mat),
        ltT=ltT, matT=matT,
        materials=MaterialsPack(**{k: put(v) for k, v in mats.items()}),
        atlas=None if atlas is None else TextureAtlas(**{
            f.name: put(np.asarray(getattr(atlas, f.name)))
            for f in dataclasses.fields(TextureAtlas)
        }),
        light=None if light is None else LightPack(
            direction=put(np.asarray(light.direction, F32)),
            color=put(np.asarray(light.color, F32)),
            ambient=put(np.asarray(light.ambient, F32)),
        ),
    )
