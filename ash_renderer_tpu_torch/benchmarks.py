"""The port's configurations and golden scenes, built identically to their
builders in ``ash_renderer_tpu/benchmarks.py`` and ``tests/golden_scenes.py``.
Each configuration returns (scene, settings, [camera]); each golden scene
(scene, settings), rendered from the default ``Camera()``, and ``GOLDEN_SHA``
holds the sha256 of its pinned RGBA8 frame (``tests/test_golden_frames.py``).
"""

from __future__ import annotations

import math

import numpy as np

from . import mathx
from .camera import Camera
from .config import RendererSettings
from .models import cube, icosphere, uv_sphere
from .scene import (DirectionalLight, Material, Scene, SceneObject,
                    reference_two_triangle_scene)
from .textures import TextureAtlas, checkerboard


def config2_multi_mesh():
    """Multi-mesh scene with per-object model matrices and depth overlap:
    12 objects over 3 meshes (3,500 triangles) at 800x600."""
    scene = Scene(materials=[Material()])
    meshes = [cube(1.2), uv_sphere(24, 48, 0.7), icosphere(3, 0.6)]
    ids = [scene.add_mesh(m) for m in meshes]
    for i in range(12):
        scene.add_object(
            SceneObject(
                mesh=ids[i % 3],
                model=mathx.compose(
                    mathx.translation(
                        [
                            1.6 * math.cos(i * 0.7) * (1 + 0.2 * (i % 3)),
                            1.1 * math.sin(i * 1.1),
                            4.0 + 0.8 * math.sin(i * 2.1),
                        ]
                    ),
                    mathx.rotation_y(i * 0.6),
                    mathx.rotation_x(i * 0.3),
                ),
            )
        )
    for m in scene.meshes:
        n = m.num_vertices
        m.colors = np.stack(
            [
                0.5 + 0.5 * np.sin(np.arange(n) * 0.1),
                0.5 + 0.5 * np.cos(np.arange(n) * 0.13),
                np.linspace(0.3, 1.0, n),
                np.ones(n),
            ],
            axis=1,
        ).astype(np.float32)
    return scene, RendererSettings(width=800, height=600), [Camera()]


def config3_blinn_phong():
    """Blinn-Phong directional lighting with interpolated normals and
    specular: an untextured icosphere of 5,120 triangles at 800x600, one
    material, one light (the scene the "auto" shade rule sends to phase F)."""
    scene = Scene(
        materials=[Material(base_color=(0.8, 0.3, 0.25, 1.0), specular=0.8,
                            shininess=64)],
        light=DirectionalLight(
            direction=(0.4, -0.5, 0.75), color=(1.0, 0.95, 0.9), ambient=0.12
        ),
    )
    mesh = icosphere(4)
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 3]))
    )
    return scene, RendererSettings(width=800, height=600), [Camera()]


def config4_million_tri(subdiv: int = 8):
    """1M+-triangle scene at 1080p: an icosphere (20 * 4**subdiv triangles;
    subdiv=8 -> 1,310,720) filling the frame, with one checkerboard-512
    texture, a Blinn-Phong material and one directional light."""
    mesh = icosphere(subdiv)
    scene = Scene(
        materials=[Material(texture_id=0, specular=0.4, shininess=32)],
        light=DirectionalLight(direction=(0.3, -0.7, 0.5), ambient=0.25),
    )
    scene.atlas = TextureAtlas.build([checkerboard(512)])
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 2.0]))
    )
    return (
        scene,
        RendererSettings(width=1920, height=1080, max_pairs=1 << 20),
        [Camera()],
    )


# ---------------------------------------------------------------------------
# Golden scenes: the reference scene and the four feature scenes, whose
# frames are pinned by sha256
# ---------------------------------------------------------------------------

def _reference_golden():
    return reference_two_triangle_scene(), RendererSettings(width=320, height=240)


def _textured_mipmap():
    """Textured sphere with strong uv perspective: bilinear taps and several
    mip levels in one frame."""
    scene = Scene(materials=[Material(texture_id=0)])
    scene.atlas = TextureAtlas.build([checkerboard(256, cells=16)])
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(uv_sphere(24, 48, 1.4)),
            model=mathx.translation([0.2, 0.1, 2.2]),
        )
    )
    return scene, RendererSettings(width=200, height=150)


def _blinn_phong_specular():
    """Lit icosphere with a bright specular highlight."""
    scene = Scene(
        materials=[
            Material(base_color=(0.75, 0.3, 0.2, 1.0), specular=0.9,
                     shininess=64)
        ],
        light=DirectionalLight(
            direction=(0.4, -0.5, 0.75), color=(1.0, 0.95, 0.9), ambient=0.12
        ),
    )
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(icosphere(3)),
            model=mathx.translation([0, 0, 2.6]),
        )
    )
    return scene, RendererSettings(width=200, height=150)


def _multi_material():
    """Three objects, three materials: textured, tinted untextured, and a
    second texture."""
    scene = Scene(
        materials=[
            Material(texture_id=0, base_color=(1, 1, 1, 1)),
            Material(base_color=(0.2, 0.9, 0.4, 1.0)),
            Material(texture_id=1, base_color=(1.0, 0.8, 0.8, 1.0)),
        ],
        light=DirectionalLight(direction=(0.2, -0.6, 0.75), ambient=0.3),
    )
    scene.atlas = TextureAtlas.build(
        [checkerboard(64, cells=8), checkerboard(32, cells=4)]
    )
    m_sphere = scene.add_mesh(uv_sphere(16, 32, 0.7))
    m_cube = scene.add_mesh(cube(0.9))
    scene.add_object(
        SceneObject(mesh=m_sphere, material=0,
                    model=mathx.translation([-1.0, 0, 2.6]))
    )
    scene.add_object(
        SceneObject(
            mesh=m_cube, material=1,
            model=mathx.compose(
                mathx.translation([0.9, 0.2, 3.2]), mathx.rotation_y(0.6)
            ),
        )
    )
    scene.add_object(
        SceneObject(mesh=m_sphere, material=2,
                    model=mathx.translation([0.1, -0.8, 2.1]))
    )
    return scene, RendererSettings(width=200, height=150)


def _ssaa_srgb():
    """4x supersampling + sRGB encode over a textured, lit scene."""
    scene = Scene(
        materials=[Material(texture_id=0, specular=0.3, shininess=16)],
        light=DirectionalLight(direction=(0.2, -0.6, 0.75), ambient=0.2),
    )
    scene.atlas = TextureAtlas.build([checkerboard(128)])
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(icosphere(2, 1.0)),
            model=mathx.translation([0, 0, 2.4]),
        )
    )
    return scene, RendererSettings(
        width=160, height=120, supersample=2, srgb_output=True
    )


GOLDEN_SCENES = {
    "reference": _reference_golden,
    "textured_mipmap": _textured_mipmap,
    "blinn_phong_specular": _blinn_phong_specular,
    "multi_material": _multi_material,
    "ssaa_srgb": _ssaa_srgb,
}

GOLDEN_SHA = {
    "reference": "39b86430fefc451ba3762f44f61f7d44ed29bdd07e85e190745edbd1cee4235e",
    "textured_mipmap": "dda4c11de0f579f92b7dbe275631a25e86def6a74bdf51e03dd1d3b72d24627b",
    "blinn_phong_specular": "df9b5911b5aeaf36a76fe5ce8dcb29b03a48e5932d27a33962d5bfea842c7da3",
    "multi_material": "03fe7564304b3fe9d55354f6395660fb07ce0d6465e692345c6b4f0d1e2d7185",
    "ssaa_srgb": "e9a8816147fa7aeb5649d52c816d8b489325ce81e38eccfcfa8ced25fdd02ddd",
}
