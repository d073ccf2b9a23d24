"""Multi-device rendering over framebuffer row slabs (``sharding``)."""

from .sharding import (  # noqa: F401
    make_render_mesh,
    render_frame_sharded,
    render_frame_sharded_fused,
    slab_rows,
)
