"""Procedural meshes used by the port's configurations."""

from .procedural import cube, icosphere, uv_sphere  # noqa: F401
