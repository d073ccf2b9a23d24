"""Mesh sources: procedural generators and the OBJ and glTF loaders."""

from .obj import load_obj  # noqa: F401
from .gltf import load_gltf  # noqa: F401
from .procedural import (  # noqa: F401
    cube,
    grid_sheet,
    icosphere,
    terrain,
    tri_soup,
    uv_sphere,
)
