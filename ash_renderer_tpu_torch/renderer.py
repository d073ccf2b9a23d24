"""Renderer facade with the reference's three-tier lifecycle, on one
explicit torch device.

* Settings-independent tier (``__init__``): the device, given by the caller
  and never chosen here.
* Settings-dependent tier (``_build_settings_dependent``): scene tensors,
  materials, atlas and light on the device; rebuilt by ``update_settings``.
* Resize-dependent tier (``_build_resize_dependent``): the RasterConfig,
  the frame ring and the front cache; rebuilt by ``resize``.

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
from .pipeline import FrameStatics, FrontCache, _no_stage, render_frame_fused_staged
from .present import FrameRing

F32 = np.float32


def compose_mvp(model_mats: np.ndarray, view: np.ndarray, proj: np.ndarray):
    """Per-object MVP = P @ V @ M in float32 on the host: the same numpy
    expression as the reference oracle's, so frames start from its bits."""
    vp = (np.asarray(proj, dtype=F32) @ np.asarray(view, dtype=F32)).astype(F32)
    return np.einsum("ij,ojk->oik", vp, np.asarray(model_mats, F32)).astype(F32)


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
        if settings.pipeline == "classic":
            raise NotImplementedError(
                "the classic pipeline is not ported yet (ROADMAP queue 1 "
                "item 12)"
            )
        if settings.pipeline not in ("auto", "fused"):
            raise ValueError(f"unknown pipeline {settings.pipeline!r}")
        if settings.n_devices is not None:
            raise NotImplementedError(
                "multi-device rendering is not ported yet (ROADMAP queue 1 "
                "item 16)"
            )
        if settings.fused_tile_h != 8:
            raise ValueError("the port's raster kernel uses 8-row tiles")
        settings = dataclasses.replace(settings, pipeline="fused")
        self.scene = scene
        self.settings = settings
        self.packed = scene.pack(meshlets=True)
        self.state = state_mod.upload(
            self.packed, scene.materials, scene.atlas, scene.light, self.device
        )
        self._build_resize_dependent()

    # ----- resize-dependent tier ----------------------------------------
    def _build_resize_dependent(self):
        st = self.settings
        self.cfg = derive_raster_config(
            st.render_width, st.render_height, tile_h=st.fused_tile_h
        )
        self.statics = FrameStatics(
            cfg=self.cfg,
            settings=st,
            has_atlas=self.state.atlas is not None,
            has_light=self.state.light is not None,
        )
        self.ring = FrameRing(st.frames_in_flight)
        # lives in this tier so any settings or resize rebuild drops it
        self._front_cache = FrontCache() if st.front_coherence else None

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
