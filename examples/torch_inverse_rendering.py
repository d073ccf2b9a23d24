#!/usr/bin/env python
"""Inverse rendering demo on the PyTorch/CUDA port: recover vertex colors
from a target image by gradient descent through the shading stage (torch
autograd), on the CUDA card unless ``--device`` names another.

  python examples/torch_inverse_rendering.py
  python examples/torch_inverse_rendering.py --device cpu --steps 20 --out frames
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ash_renderer_tpu_torch import (  # noqa: E402
    Camera,
    Mesh,
    Scene,
    SceneObject,
    derive_raster_config,
)
from ash_renderer_tpu_torch.app import require_device  # noqa: E402
from ash_renderer_tpu_torch.diffrender import fit_to_image, shade_params_fn  # noqa: E402
from ash_renderer_tpu_torch.models import icosphere  # noqa: E402
from ash_renderer_tpu_torch.oracle import geometry_oracle, visibility_oracle  # noqa: E402
from ash_renderer_tpu_torch.present import write_png  # noqa: E402
from ash_renderer_tpu_torch.rtypes import MaterialsPack, TriangleSetup  # noqa: E402
from ash_renderer_tpu_torch import mathx  # noqa: E402


def to_rgba8(img):
    return (torch.round(torch.clamp(img.detach(), 0, 1) * 255)
            .to(torch.uint8).cpu().numpy())


def main(argv=None):
    """Runs the demo; returns the fit's losses."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU only when named)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--out", default="/tmp", help="directory of the two PNGs")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    rng = np.random.default_rng(0)
    mesh = icosphere(3)
    true_colors = rng.uniform(0.1, 1.0, (mesh.num_vertices, 4)).astype(
        np.float32
    )
    true_colors[:, 3] = 1.0
    mesh.colors = true_colors
    scene = Scene()
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 3]))
    )

    cfg = derive_raster_config(128, 128)
    cam = Camera()
    su, attrs = geometry_oracle(
        scene.pack(),
        scene.model_matrices(),
        cam.view_matrix(),
        cam.projection_matrix(1.0),
        cfg,
        64,
    )
    _, vis_t = visibility_oracle(su, cfg)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    mats = MaterialsPack(
        base_color=t(np.ones((1, 4), np.float32)),
        tex_id=t(np.full(1, -1, np.int32)),
        specular=t(np.zeros(1, np.float32)),
        shininess=t(np.full(1, 8, np.int32)),
    )
    su_t = TriangleSetup(**{f.name: t(getattr(su, f.name))
                            for f in dataclasses.fields(TriangleSetup)})
    attrs_t = t(attrs)
    fn = shade_params_fn(t(vis_t), su_t, attrs_t, cfg, mats)

    target = fn({"vertex_colors": attrs_t[:, :4]}).detach()
    os.makedirs(args.out, exist_ok=True)
    target_png = os.path.join(args.out, "inv_target.png")
    recovered_png = os.path.join(args.out, "inv_recovered.png")
    write_png(target_png, to_rgba8(target))

    p0 = {"vertex_colors": torch.full_like(attrs_t[:, :4], 0.5)}
    params, losses = fit_to_image(target, fn, p0, steps=args.steps, lr=0.1)
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.6f}")
    recovered = fn(params)
    write_png(recovered_png, to_rgba8(recovered))
    err = np.abs(
        params["vertex_colors"].cpu().numpy()[: mesh.num_vertices, :3]
        - true_colors[:, :3]
    )
    # report error only over vertices that are actually visible
    # (occluded vertices keep their init — no gradient reaches them)
    finite = np.isfinite(err).all(axis=1)
    print(f"median vertex-color error (finite): {np.median(err[finite]):.4f}")
    print(f"wrote {target_png} and {recovered_png}")
    return losses


if __name__ == "__main__":
    main()
