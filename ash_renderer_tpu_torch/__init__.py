"""ash_renderer_tpu_torch: the renderer's main path in PyTorch, with CUDA
kernels written for Hopper (sm_90a).

The JAX package ``ash_renderer_tpu`` is the reference; this package keeps
its module and function names and is checked against it bit for bit.  It
imports neither jax nor the JAX package: ``mathx``, ``camera``, ``config``,
``scene`` (with ``scene_from_reference``), ``native`` (the meshlet
builder), ``profiling`` and ``textures`` are its own copies.

    from ash_renderer_tpu_torch import Renderer
    r = Renderer(scene, settings, device=torch.device("cuda", 0))
    rgba8, aux = r.render_frame(camera)

On a CUDA device the kernels (triangle setup, run bounds, raster +
distribute with or without phase F shading) are built from ``csrc/`` at
first use; on the CPU each runs as its plain torch version.
"""


def __getattr__(name):
    if name == "Renderer":
        from .renderer import Renderer

        return Renderer
    raise AttributeError(
        f"module 'ash_renderer_tpu_torch' has no attribute {name!r}"
    )
