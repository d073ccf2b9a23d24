"""The port's configurations, built identically to their builders in
``ash_renderer_tpu/benchmarks.py``: each returns (scene, settings,
[camera])."""

from __future__ import annotations

from . import mathx
from .camera import Camera
from .config import RendererSettings
from .models import icosphere
from .scene import DirectionalLight, Material, Scene, SceneObject
from .textures import TextureAtlas, checkerboard


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
