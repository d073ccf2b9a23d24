"""Renderer facade with the reference's three-tier lifecycle, on one
explicit torch device.

* Settings-independent tier (``__init__``): the device, named by the
  caller (``device``, ``mesh`` or ``settings.preferred_device_index``, see
  ``resolve_device``), else the current CUDA card; never the CPU unless
  named.
* Settings-dependent tier (``_build_settings_dependent``): scene tensors,
  materials, atlas and light on the device; rebuilt by ``update_settings``.
* Resize-dependent tier (``_build_resize_dependent``): the RasterConfig,
  the frame ring and the front cache; rebuilt by ``resize``, or inside
  ``draw_frame`` when the extent it is given no longer matches.

``settings.pipeline`` picks the frame pipeline: "fused" (meshlet packing,
``fused_tile_h`` x 128 tiles, 8 rows by default or 4, kernels K1-K3/K3F), "classic" (plain packing, 16x128 tiles,
kernel K4) or "auto"; ``settings.fused_surface_shade`` picks the fused
raster's shading, K3F ("on") or K3 ("off").  ``auto_route`` resolves
"auto" per device, and the resolved values are what ``Renderer.settings``
holds.  On the CPU it keeps the reference's TPU rule (fused from 4096
triangles; the shade knob left to ``pipeline.shade_mode_for``); on a CUDA
device it takes the rule measured on an H100 (fused from 320 triangles,
"on").

Per frame the host composes the per-object MVP matrices with the oracle's
``compose_mvp`` (numpy, so both start from the same bits), and the
pipeline runs on the device.

Under a mesh (``Renderer(..., mesh=parallel.make_render_mesh([...]))``, or
``settings.n_devices``) the frame is rendered in row slabs, one per mesh
entry (``parallel/sharding.py``): the scene state is uploaded once per
distinct device, and there is no front cache, as in the reference.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import _build
from . import state as state_mod
from .camera import Camera
from .config import RendererSettings, derive_raster_config
from .profiling import FrameStats
from .scene import Scene
from .ops import fused_kernel, raster_visibility
from .parallel import (make_render_mesh, render_frame_sharded,
                       render_frame_sharded_fused)
from .oracle.raster_cpu import compose_mvp
from .pipeline import (FrameStatics, FrontCache, _no_stage, render_frame,
                       render_frame_fused_staged)
from .present import FrameRing
from .rtypes import LightPack, MaterialsPack  # noqa: F401  (the reference's re-exports)

F32 = np.float32
AUTO_FUSED_TRIS = 4096  # on the CPU "auto" takes fused from this many
# The CUDA branch of "auto", set by the decision rule of PERF.md §6 on the
# interleaved A/B frame times of chip_smoke.py phase 22 on an H100: fused
# from this many triangles (below it, fused won too few pairs of rounds
# on the 160-triangle gate scene's orbit in the run that set it), and the
# raster kernel's phase F (K3F) on every scene, textured or not.
CUDA_AUTO_FUSED_TRIS = 320
CUDA_SURFACE_SHADE = "on"


def auto_route(settings: RendererSettings, device,
               n_tris: int) -> RendererSettings:
    """``settings`` with "auto" resolved for a scene of ``n_tris``
    triangles (counted over the meshes) on ``device``; "fused", "classic",
    "on" and "off" are kept as given.

    * CPU (and any device but CUDA): the reference's rule, which encodes
      TPU measurements: fused from ``AUTO_FUSED_TRIS``, else classic; the
      shade knob stays "auto", so ``pipeline.shade_mode_for`` applies the
      reference's meaning (phase F only on an untextured scene).  The CPU
      is the parity harness: its frames follow the JAX package's "auto".
    * CUDA: fused from ``CUDA_AUTO_FUSED_TRIS``, else classic; the shade
      knob ``CUDA_SURFACE_SHADE``.  Under "on" the table caps of
      ``shade_mode_for`` still send a scene over them to phase E."""
    cuda = torch.device(device).type == "cuda"
    if settings.pipeline == "auto":
        floor = CUDA_AUTO_FUSED_TRIS if cuda else AUTO_FUSED_TRIS
        settings = dataclasses.replace(
            settings, pipeline="fused" if n_tris >= floor else "classic")
    if cuda and settings.fused_surface_shade == "auto":
        settings = dataclasses.replace(settings,
                                       fused_surface_shade=CUDA_SURFACE_SHADE)
    return settings


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


def resolve_mesh(settings: RendererSettings, device, mesh=None):
    """The slab mesh of a renderer on ``device``: an explicit ``mesh`` wins;
    else ``settings.n_devices`` takes cuda:0 .. n-1 on a CUDA device
    (raising if fewer cards exist) or n slabs of the CPU; else None (one
    device, no slabs)."""
    if mesh is not None:
        return make_render_mesh(mesh)
    n = settings.n_devices
    if n is None:
        return None
    if n < 1:
        raise ValueError(f"n_devices={n}")
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"n_devices={n} but only {have} CUDA devices "
                             "exist")
        return make_render_mesh(torch.device("cuda", i) for i in range(n))
    if device.type == "cpu":
        return make_render_mesh([device] * n)
    raise ValueError(f"n_devices on an unsupported device {device}")


def resolve_device(settings: RendererSettings, device=None, mesh=None):
    """The torch device of a renderer, as its caller names it; the port
    never picks one and never falls back to another.

    * a ``mesh`` wins: its first device (``device``, if also given, must be
      that device);
    * else an explicit ``device``.  If ``settings.preferred_device_index``
      is also set, the device must be ``cuda:<index>``; a bare ``"cuda"``
      takes the index as its ordinal;
    * else ``settings.preferred_device_index`` names ``cuda:<index>``;
    * else the current CUDA card, as every entry point of the port renders
      on the card unless the caller names another device; ``RuntimeError``
      when there is none (the CPU only when named: ``device="cpu"``)."""
    if mesh is not None:
        mesh = make_render_mesh(mesh)
        if device is not None and torch.device(device) != mesh[0]:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh[0]}")
        return mesh[0]
    index = settings.preferred_device_index
    if device is not None:
        dev = torch.device(device)
        if index is None:
            return dev
        want = torch.device("cuda", index)
        if dev.type == "cuda" and dev.index in (None, index):
            return want
        raise ValueError(f"device {dev} disagrees with "
                         f"preferred_device_index={index} ({want})")
    if index is not None:
        return torch.device("cuda", index)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the Renderer renders on the card "
                           "unless given a device, a mesh or settings."
                           "preferred_device_index; pass device='cpu' to "
                           "render on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Renderer:
    def __init__(self, scene: Scene, settings: Optional[RendererSettings] = None,
                 *, device=None, mesh=None):
        """device: the torch device every tensor of this renderer lives on
        (for example ``torch.device("cuda", 0)``).  mesh: the devices of a
        frame rendered in row slabs (``parallel.make_render_mesh``); it
        wins over ``settings.n_devices``, and its first device is the
        renderer's.  Without either, ``settings.preferred_device_index``
        names the CUDA card, else the current CUDA card renders
        (``resolve_device``); without a card it raises, and it never falls
        back to the CPU."""
        settings = settings or RendererSettings()
        self._mesh_arg = None if mesh is None else make_render_mesh(mesh)
        self.device = resolve_device(settings, device, self._mesh_arg)
        self.stats = FrameStats()
        self._build_settings_dependent(scene, settings)

    # ----- settings-dependent world -------------------------------------
    def _build_settings_dependent(self, scene: Scene, settings: RendererSettings):
        if settings.pipeline not in ("auto", "fused", "classic"):
            raise ValueError(f"unknown pipeline {settings.pipeline!r}")
        settings = auto_route(settings, self.device,
                              sum(m.num_triangles for m in scene.meshes))
        if (settings.pipeline == "fused"
                and settings.fused_tile_h not in fused_kernel.TILE_HEIGHTS):
            raise ValueError(f"fused_tile_h={settings.fused_tile_h}: the "
                             "raster kernel takes 4- or 8-row tiles")
        self.scene = scene
        self.settings = settings
        self.mesh = resolve_mesh(settings, self.device, self._mesh_arg)
        # the fused pipeline's setup kernel loads corners by meshlet-local
        # index; the classic one takes the plain packing
        self.packed = scene.pack(meshlets=settings.pipeline == "fused")
        self.states = {
            d: state_mod.upload(self.packed, scene.materials, scene.atlas,
                                scene.light, d)
            for d in dict.fromkeys(self.mesh or (self.device,))
        }
        self.state = self.states[self.mesh[0] if self.mesh else self.device]
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
        # classic pipeline and the slabs have no front to reuse
        self._front_cache = (
            FrontCache() if st.front_coherence and st.pipeline != "classic"
            and self.mesh is None else None)

    # ----- public API ----------------------------------------------------
    def update_settings(self, settings: RendererSettings, scene: Scene = None):
        """Rebuild the whole settings-dependent world, on the card that a
        changed ``preferred_device_index`` names (the reference re-selects
        its device there); the scene state is uploaded to it anew."""
        self.ring.drain()
        index = settings.preferred_device_index
        if (self._mesh_arg is None and index is not None
                and index != self.settings.preferred_device_index):
            self.device = resolve_device(settings)
        self._build_settings_dependent(scene or self.scene, settings)

    def resize(self, width: int, height: int):
        """Rebuild the resolution-keyed state."""
        self.ring.drain()
        self.settings = dataclasses.replace(
            self.settings, width=width, height=height
        )
        self._build_resize_dependent()

    def update_mesh(self, mesh_index: int, mesh):
        """Re-upload geometry after a mesh edit (update_vertices analogue,
        vertex_buffer_components.rs:71-87): the settings-dependent tier is
        rebuilt with ``mesh`` in place of ``scene.meshes[mesh_index]``."""
        self.scene.meshes[mesh_index] = mesh
        self.update_settings(self.settings, self.scene)

    def warmup(self, parallel: bool = True, execute: bool = True,
               verbose: bool = False) -> float:
        """Pay the first-use costs before the first frame, as the
        reference's ``warmup`` does; returns seconds spent.

        On a CUDA device, build (where no library is built yet) and load
        the kernel libraries this renderer's route launches, in row slabs
        too: ``_build.ROUTE_SOURCES``' entry for its pipeline (the classic
        route's K10, K12, K4 and K11, plain-packed, so no K5; the fused
        route's front, K8, K1, K6, K2, K9, with K3 / K3F and K7).  One nvcc
        process per source, all started together, or one after another
        with ``parallel=False``.
        A CPU renderer builds nothing: its wrappers run the plain versions.
        Then, with ``execute``, render one frame at the default ``Camera()``
        and wait for the device.  ``verbose`` prints a line per stage on
        stderr.

        Later frames keep their bits: the warm-up frame's front-cache entry
        is keyed on its matrices, so it serves only a frame of the same
        camera, which the front would compute bit for bit."""
        t0 = time.perf_counter()

        def say(msg):
            if verbose:
                print(f"warmup: {msg} [{time.perf_counter() - t0:.1f}s]",
                      file=sys.stderr, flush=True)

        if self.device.type == "cuda":
            sources = _build.ROUTE_SOURCES[self.settings.pipeline]
            for group in ((sources,) if parallel
                          else tuple((s,) for s in sources)):
                _build.build(group)
            for s in sources:
                _build.load(s)
            say(f"kernel libraries built and loaded: {', '.join(sources)}")
        if execute:
            rgba8, _ = self.render_frame(Camera())
            if rgba8.is_cuda:
                torch.cuda.synchronize(rgba8.device)
            say("real frame done")
        return time.perf_counter() - t0

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
        if self.mesh is not None:
            frame_fn = (render_frame_sharded if st.pipeline == "classic"
                        else render_frame_sharded_fused)
            rgba8, aux = frame_fn(self.statics, self.mesh, self.states, mm_t,
                                  mvp_t, cam_t, on_stage=on_stage)
        elif st.pipeline == "classic":
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

    def draw_frame(self, camera: Camera, model_mats=None, on_present=None,
                   extent=None):
        """Frame-loop step: render and submit to the present ring.  Returns
        the host RGBA8 of the frame completed frames_in_flight ago, or
        None.

        extent: the present target's current (width, height), when the
        caller has one (``App`` passes its window extent).  If it no longer
        matches the settings, the renderer rebuilds its resize-dependent
        tier here, without the caller's help: the reference's in-draw
        OUT_OF_DATE / SUBOPTIMAL swapchain recovery (renderer.rs:416-428,
        587-596)."""
        t0 = time.perf_counter()
        if extent is not None and tuple(extent) != (self.settings.width,
                                                    self.settings.height):
            self.resize(*extent)
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
