"""Renderer facade with the reference's three-tier lifecycle, on one
explicit torch device.

* Settings-independent tier (``__init__``): the device, given by the caller
  and never chosen here.
* Settings-dependent tier (``_build_settings_dependent``): scene tensors,
  materials, atlas and light on the device; rebuilt by ``update_settings``.
* Resize-dependent tier (``_build_resize_dependent``): the RasterConfig,
  the frame ring and the front cache; rebuilt by ``resize``.

``settings.pipeline`` picks the frame pipeline: "fused" (meshlet packing,
8x128 tiles, kernels K1-K3/K3F), "classic" (plain packing, 16x128 tiles,
kernel K4) or "auto", the reference's rule: fused from 4096 triangles,
classic below.

Per frame the host composes the per-object MVP matrices (numpy, the same
bits the oracle uses), and the pipeline runs on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import state as state_mod
from .camera import Camera
from .config import RendererSettings, derive_raster_config
from .profiling import FrameStats
from .scene import Scene
from .ops import raster_visibility
from .pipeline import (FrameStatics, FrontCache, _no_stage, render_frame,
                       render_frame_fused_staged)
from .present import FrameRing

F32 = np.float32
AUTO_FUSED_TRIS = 4096  # "auto" takes the fused pipeline from this many


def compose_mvp(model_mats: np.ndarray, view: np.ndarray, proj: np.ndarray):
    """Per-object MVP = P @ V @ M in float32 on the host: the same numpy
    expression as the reference oracle's, so frames start from its bits."""
    vp = (np.asarray(proj, dtype=F32) @ np.asarray(view, dtype=F32)).astype(F32)
    return np.einsum("ij,ojk->oik", vp, np.asarray(model_mats, F32)).astype(F32)


def frame_statics(settings: RendererSettings, n_tris: int, has_atlas: bool,
                  has_light: bool) -> FrameStatics:
    """The statics of ``settings.pipeline`` ("fused" or "classic") for a
    scene packed into ``n_tris`` triangle rows.  Classic takes 16-row tiles
    and caps the binner's pair budget by the triangle count (8x headroom,
    floor 16k) as the reference caps it, so an overflowing frame drops the
    same pairs."""
    classic = settings.pipeline == "classic"
    if classic:
        settings = dataclasses.replace(settings, max_pairs=min(
            settings.max_pairs, max(1 << 14, -(-8 * n_tris // 128) * 128)))
    cfg = derive_raster_config(
        settings.render_width, settings.render_height,
        tile_h=raster_visibility.TILE_H if classic else settings.fused_tile_h,
    )
    return FrameStatics(cfg=cfg, settings=settings, has_atlas=has_atlas,
                        has_light=has_light)


class Renderer:
    def __init__(self, scene: Scene, settings: Optional[RendererSettings] = None,
                 *, device):
        """device: the torch device every tensor of this renderer lives on
        (for example ``torch.device("cuda", 0)``).  Required: the renderer
        never picks one itself."""
        self.device = torch.device(device)
        self.stats = FrameStats()
        self._build_settings_dependent(scene, settings or RendererSettings())

    # ----- settings-dependent world -------------------------------------
    def _build_settings_dependent(self, scene: Scene, settings: RendererSettings):
        if settings.pipeline not in ("auto", "fused", "classic"):
            raise ValueError(f"unknown pipeline {settings.pipeline!r}")
        if settings.n_devices is not None:
            raise NotImplementedError(
                "multi-device rendering is not ported yet (ROADMAP queue 1 "
                "item 16)"
            )
        if settings.pipeline == "auto":
            # the reference's rule, with the card in the TPU's place: fused
            # from 4096 triangles (counted over the meshes), else classic
            n_tris = sum(m.num_triangles for m in scene.meshes)
            settings = dataclasses.replace(
                settings, pipeline="fused" if n_tris >= AUTO_FUSED_TRIS else "classic"
            )
        if settings.pipeline == "fused" and settings.fused_tile_h != 8:
            raise ValueError("the port's raster kernel uses 8-row tiles")
        self.scene = scene
        self.settings = settings
        # the fused pipeline's setup kernel loads corners by meshlet-local
        # index; the classic one takes the plain packing
        self.packed = scene.pack(meshlets=settings.pipeline == "fused")
        self.state = state_mod.upload(
            self.packed, scene.materials, scene.atlas, scene.light, self.device
        )
        self._build_resize_dependent()

    # ----- resize-dependent tier ----------------------------------------
    def _build_resize_dependent(self):
        st = self.settings
        self.statics = frame_statics(
            st, self.packed.tri_v.shape[0],
            has_atlas=self.state.atlas is not None,
            has_light=self.state.light is not None,
        )
        self.cfg = self.statics.cfg
        self.ring = FrameRing(st.frames_in_flight)
        # lives in this tier so any settings or resize rebuild drops it; the
        # classic pipeline has no front to reuse
        self._front_cache = (
            FrontCache() if st.front_coherence and st.pipeline != "classic"
            else None)

    # ----- public API ----------------------------------------------------
    def update_settings(self, settings: RendererSettings, scene: Scene = None):
        """Rebuild the whole settings-dependent world."""
        self.ring.drain()
        self._build_settings_dependent(scene or self.scene, settings)

    def resize(self, width: int, height: int):
        """Rebuild the resolution-keyed state."""
        self.ring.drain()
        self.settings = dataclasses.replace(
            self.settings, width=width, height=height
        )
        self._build_resize_dependent()

    def render_frame(self, camera: Camera, model_mats: np.ndarray = None,
                     on_stage=_no_stage):
        """Render one frame; returns (rgba8 (H, W, 4) uint8 tensor on the
        device, aux).  Does not wait for the device.  ``on_stage(name)`` is
        called as each stage has been issued (``pipeline.render_front``)."""
        t0 = time.perf_counter()
        st = self.settings
        if model_mats is None:
            model_mats = self.scene.model_matrices()
        model_mats = np.ascontiguousarray(model_mats, dtype=F32)
        view = camera.view_matrix()
        proj = camera.projection_matrix(st.render_width / st.render_height)
        mvp = np.ascontiguousarray(compose_mvp(model_mats, view, proj))
        dev = self.device
        mm_t = torch.from_numpy(model_mats).to(dev)
        mvp_t = torch.from_numpy(mvp).to(dev)
        cam_t = torch.from_numpy(camera.position.astype(F32)).to(dev)
        on_stage("mvp_upload")
        if st.pipeline == "classic":
            rgba8, aux = render_frame(self.statics, self.state, mm_t, mvp_t,
                                      cam_t, on_stage=on_stage)
        else:
            rgba8, aux = render_frame_fused_staged(
                self.statics, self.state, mm_t, mvp_t, cam_t,
                front_cache=self._front_cache,
                front_key=model_mats.tobytes() + mvp.tobytes(),
                on_stage=on_stage,
            )
        self.stats.record_dispatch(time.perf_counter() - t0)
        return rgba8, aux

    def draw_frame(self, camera: Camera, model_mats=None, on_present=None):
        """Frame-loop step: render and submit to the present ring.  Returns
        the host RGBA8 of the frame completed frames_in_flight ago, or
        None."""
        t0 = time.perf_counter()
        rgba8, aux = self.render_frame(camera, model_mats)
        presented = self.ring.push(rgba8, on_present)
        self.stats.record_frame(time.perf_counter() - t0, aux)
        return presented

    def finish(self):
        """Drain the in-flight frames."""
        return self.ring.drain()

    def read_frame(self, rgba8: torch.Tensor) -> np.ndarray:
        """Blocking readback of one frame."""
        return rgba8.cpu().numpy()
