"""Procedural meshes used by the port's configurations."""

from .procedural import icosphere  # noqa: F401
