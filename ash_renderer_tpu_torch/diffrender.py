"""Differentiable shading: gradients through the deferred shading stage, on
torch autograd (the port of ``ash_renderer_tpu/diffrender.py``).

With visibility held fixed (the rasterizer is integer and discrete), the
deferred shading stage is a differentiable function of vertex colours,
material parameters and light parameters.  ``shade_params_fn`` closes over
a visibility buffer and a setup table and returns that function, built on
the port's ``ops.shade.shade``: the same ops, in the same order, as every
frame's shade stage, so its forward image is bit-equal to the reference's.
The float tables reach autograd through ``shade.pack_shade_consts_f32``.
No kernel is differentiated: this stage is plain torch on every device.

The discrete pack/resolve steps are bypassed: losses are computed on the
float RGBA image.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import specmath as sm
from .config import RasterConfig
from .ops import shade as shade_mod
from .rtypes import LightPack, MaterialsPack

F32 = torch.float32


def shade_params_fn(
    vis_tri,
    su,
    attrs,
    cfg: RasterConfig,
    materials: MaterialsPack,
    atlas=None,
    light: Optional[LightPack] = None,
    camera_pos=None,
    clear_color=(0.0, 0.0, 0.0, 1.0),
):
    """Returns f(params) -> (H, W, 4) float RGBA image, differentiable in
    params.

    params is a dict with any of:
      "vertex_colors": (VA, 4) overrides attrs[:, :4]
      "materials": MaterialsPack
      "light": LightPack
    Visibility (vis_tri) and geometry (su) are constants of the closure.
    atlas: a ``TextureAtlas`` with tensor fields (``state.upload``'s).
    Without ``camera_pos`` there is no specular term, as in the reference.
    """
    has_a = atlas is not None
    t_n = atlas.level_offset.shape[0] if has_a else 0
    cam = (torch.zeros(3, dtype=F32, device=attrs.device)
           if camera_pos is None
           else torch.as_tensor(camera_pos, dtype=F32, device=attrs.device))

    def fn(params):
        a = attrs
        if "vertex_colors" in params:
            a = torch.cat([params["vertex_colors"], attrs[:, 4:]], dim=1)
        mats = params.get("materials", materials)
        lt = params.get("light", light)
        mode = (mats.base_color.shape[0], t_n, True, has_a, lt is not None)
        cf = shade_mod.pack_shade_consts_f32(mode, mats, atlas, lt, cam)
        consts = sm.bitcast_i32(cf.detach())  # pack_shade_consts' words
        return shade_mod.shade(
            vis_tri, su, a, mode, consts, atlas=atlas, light=lt, cfg=cfg,
            clear_color=clear_color, cf=cf, specular=camera_pos is not None,
        )

    return fn


def _map_floats(params: dict, f) -> dict:
    """params with ``f`` applied to each float tensor: its own values and
    the float fields of its MaterialsPack / LightPack values.  Integer
    fields are carried as they are."""
    def one(x):
        return f(x) if torch.is_tensor(x) and x.is_floating_point() else x

    return {k: dataclasses.replace(v, **{
                fl.name: one(getattr(v, fl.name))
                for fl in dataclasses.fields(v)})
            if dataclasses.is_dataclass(v) else one(v)
            for k, v in params.items()}


def fit_to_image(
    target_rgba,
    shade_fn: Callable,
    params0: dict,
    steps: int = 200,
    lr: float = 0.05,
):
    """Adam-fit shading parameters to a target image (inverse rendering),
    on the device of ``shade_fn``'s image: ``torch.optim.Adam(lr)`` with
    optax's defaults (betas 0.9 / 0.999, eps 1e-8), the loss the mean
    squared RGB error.  Gradients pass through ``nan_to_num`` first, as in
    the reference.  Only float tensors are fitted; integer fields of a
    MaterialsPack stay as they are.

    Returns (params, losses): params detached, losses as Python floats."""
    leaves = []

    def leaf(x):
        leaves.append(x.detach().clone().requires_grad_(True))
        return leaves[-1]

    params = _map_floats(params0, leaf)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    target = None
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        img = shade_fn(params)
        if target is None:
            target = torch.as_tensor(target_rgba, dtype=F32, device=img.device)
        loss = torch.mean((img[..., :3] - target[..., :3]) ** 2)
        loss.backward()
        # pixels on masked or degenerate branches can send NaN cotangents
        # through torch.where; zero them so other parameters are not
        # corrupted
        for p in leaves:
            if p.grad is not None:
                p.grad = torch.nan_to_num(p.grad)
        opt.step()
        losses.append(float(loss.detach()))
    return _map_floats(params, torch.Tensor.detach), losses
