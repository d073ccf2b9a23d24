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
"""

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
