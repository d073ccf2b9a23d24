"""Shading tables as plain dataclasses of tensors (the counterparts of
``ash_renderer_tpu.rtypes``' pytrees)."""

from __future__ import annotations

import dataclasses

import torch


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
