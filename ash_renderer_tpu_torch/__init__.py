"""ash_renderer_tpu_torch: the renderer in PyTorch, with CUDA kernels
written for Hopper (sm_90a).

The JAX package ``ash_renderer_tpu`` is the reference; this package keeps
its module and function names and is checked against it bit for bit.  It
imports neither jax nor the JAX package: ``mathx``, ``camera``, ``config``,
``scene`` (with ``scene_from_reference``), ``native`` (the meshlet builder
and OBJ parser), ``models`` (procedural meshes, OBJ and glTF loaders),
``serialization``, ``present``, ``profiling`` and ``textures`` are its own
copies.

    from ash_renderer_tpu_torch import Renderer
    r = Renderer(scene, settings, device=torch.device("cuda", 0))
    rgba8, aux = r.render_frame(camera)

    python -m ash_renderer_tpu_torch.app config4_terrain --out frames

``App`` (the frame loop with camera control), ``app.render_to_images`` and
``app.main`` (the CLI) render on the CUDA card unless given
``device="cpu"``; ``diffrender`` fits shading parameters with torch
autograd.  On a CUDA device the kernels (triangle setup, run bounds, raster
+ distribute with or without phase F shading, classic raster, corner
gather) are built from ``csrc/`` at first use; on the CPU each runs as its
plain torch version.

``Renderer(..., mesh=make_render_mesh([...]))`` or
``RendererSettings(n_devices=N)`` renders each frame in row slabs, one per
mesh device (``parallel``: ``make_render_mesh``, ``render_frame_sharded``,
``render_frame_sharded_fused``); a mesh may repeat a device.
``RendererSettings(preferred_device_index=i)`` names ``cuda:i`` when no
device is given (``renderer.resolve_device``).

The top-level names are the reference's: the host types below are imported
eagerly (they need neither torch nor a card), ``Renderer``, ``App`` and the
``parallel`` names on first use.  ``utils.debugging`` and
``utils.profiling`` are the top-level ``debugging`` and ``profiling``
modules under the reference's paths.
"""

from .camera import Camera, CameraController, orbit_path  # noqa: F401
from .config import RendererSettings, RasterConfig, derive_raster_config  # noqa: F401
from .scene import (  # noqa: F401
    DirectionalLight,
    Material,
    Mesh,
    PackedScene,
    Scene,
    SceneObject,
    reference_two_triangle_scene,
)

__version__ = "0.1.0"

_PARALLEL = ("make_render_mesh", "render_frame_sharded",
             "render_frame_sharded_fused")


def __getattr__(name):
    if name == "Renderer":
        from .renderer import Renderer

        return Renderer
    if name == "App":
        from .app import App

        return App
    if name in _PARALLEL:
        from . import parallel

        return getattr(parallel, name)
    raise AttributeError(
        f"module 'ash_renderer_tpu_torch' has no attribute {name!r}"
    )
