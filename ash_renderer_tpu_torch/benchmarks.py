"""The port's configurations: the headline scene of
``ash_renderer_tpu.benchmarks.config4_million_tri``, built identically."""

from __future__ import annotations

from ash_renderer_tpu import mathx
from ash_renderer_tpu.camera import Camera
from ash_renderer_tpu.config import RendererSettings
from ash_renderer_tpu.scene import DirectionalLight, Material, Scene, SceneObject

from .models import icosphere
from .textures import TextureAtlas, checkerboard


def config4_million_tri(subdiv: int = 8):
    """1M+-triangle scene at 1080p: an icosphere (20 * 4**subdiv triangles;
    subdiv=8 -> 1,310,720) filling the frame, with one checkerboard-512
    texture, a Blinn-Phong material and one directional light.  Returns
    (scene, settings, [camera])."""
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
