"""Pipeline data types as plain dataclasses of tensors (the counterparts of
``ash_renderer_tpu.rtypes``' pytrees)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TriangleSetup:
    """Rasterizer-ready triangles, one row per setup slot (row index = draw
    index for depth ties): the classic pipeline's setup buffer."""

    valid: torch.Tensor  # (S,) bool
    x0: torch.Tensor  # (S,) i32 snapped subpixel coords, winding normalized
    y0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    area2: torch.Tensor  # (S,) i32 > 0 where valid
    inv_area2: torch.Tensor  # (S,) f32 = recip_spec(f32(area2))
    zq0: torch.Tensor  # (S,) i32 D16 vertex depths
    zq1: torch.Tensor
    zq2: torch.Tensor
    iw0: torch.Tensor  # (S,) f32 per-corner 1/w_clip
    iw1: torch.Tensor
    iw2: torch.Tensor
    v0: torch.Tensor  # (S,) i32 rows of the combined attribute table
    v1: torch.Tensor
    v2: torch.Tensor
    mat: torch.Tensor  # (S,) i32 material ids


# The classic setup as one (S, SETUP_COLS) int32 table, floats as bits, as
# kernel K10 writes it (``geometry.geometry_rows``): the fields shading
# reads first (kernel K11 reads a winner's SETUP_SHADE_COLS words), then
# the rest binning reads, then two zero words (80-byte rows).  ``valid``
# is no column: it is a (S,) bool array beside the table.
SETUP_ROW_FIELDS = ("x0 y0 x1 y1 x2 y2 inv_area2 iw0 iw1 iw2 v0 v1 v2 mat "
                    "area2 zq0 zq1 zq2").split()
SETUP_SHADE_COLS = 14
SETUP_COLS = 20
# the float32 fields of TriangleSetup ("valid" is bool, the rest int32)
SETUP_F32_FIELDS = frozenset({"inv_area2", "iw0", "iw1", "iw2"})


@dataclasses.dataclass
class MaterialsPack:
    base_color: torch.Tensor  # (M, 4) f32
    tex_id: torch.Tensor  # (M,) i32, -1 = untextured
    specular: torch.Tensor  # (M,) f32
    shininess: torch.Tensor  # (M,) i32 (< 256; specular exponent)


@dataclasses.dataclass
class LightPack:
    direction: torch.Tensor  # (3,) f32 world space, need not be normalized
    color: torch.Tensor  # (3,) f32
    ambient: torch.Tensor  # () f32
