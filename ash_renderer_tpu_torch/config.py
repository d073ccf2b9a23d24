"""Renderer settings and the derived rasterizer configuration.

The port's own copy of ``ash_renderer_tpu/config.py``: every field and every
default of ``RendererSettings`` is kept, so one settings object means the same
thing in both packages (the tests compare ``dataclasses.asdict`` of both).
Fields that only the JAX package reads (its jit, TPU-tile and multi-chip
knobs) are carried unread; the port's Renderer refuses the settings it
cannot honour yet (``renderer.py``).

The three-tier contract is the reference's (``src/renderer.rs:34-44,
601-627``): changing a setting rebuilds the settings-dependent world,
resizing rebuilds only the resolution-dependent one.  ``RasterConfig`` holds
the derived fixed-point and tiling parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RendererSettings", "RasterConfig", "derive_raster_config"]


@dataclasses.dataclass(frozen=True)
class RendererSettings:
    """User-facing settings (analogue of UserSettings, renderer.rs:34-44)."""

    # Device preference of the JAX package; the port takes an explicit
    # torch device instead (Renderer(..., device=...)).
    preferred_device_index: Optional[int] = None

    width: int = 800
    height: int = 600
    # Supersampling factor per axis: 1 = off, 2 = 4x SSAA (BASELINE config 5).
    supersample: int = 1
    # Clear values (renderer.rs:441-457: color clear + depth cleared to 1.0).
    clear_color: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    # Encode the framebuffer to sRGB on the RGBA8 pack.
    srgb_output: bool = False
    # Debug mode: NaN/inf guards + overflow counters.
    debug: bool = False
    # Cap on triangles needing polygon clipping per frame (overflow is
    # counted and dropped).
    clip_budget: int = 4096
    # Cap on (triangle, tile) pairs for the classic binner.
    max_pairs: int = 1 << 21
    # Number of frame ring slots (swapchain image-count analogue).
    frames_in_flight: int = 2
    # Wide-triangle expansion budgets (fused pipeline): triangles whose AABB
    # spans >2 tiles in either axis are expanded into exact per-tile pair
    # runs up to these caps; the overflow stays in the global wide run
    # (streamed by every tile), so the caps trade speed, never correctness.
    wide_rows: int = 1 << 15
    wide_pairs: int = 1 << 17
    # JAX package only: per-stage jits instead of one frame function.
    staged_pipeline: bool = False
    # JAX package only: the four XLA-front stages as one jitted program.
    fused_front_merge: bool = True
    # Pipeline implementation: "fused" = setup kernel + sort-binned
    # raster/distribute kernel; "classic" = the pair-record pipeline;
    # "auto" = the Renderer's rule (fused from 4096 triangles, else classic).
    pipeline: str = "auto"
    # In-kernel surface shading (phase F: material modulation, mip select,
    # tap addressing, Blinn-Phong inside the raster kernel).  "auto" = in
    # the kernel only for UNTEXTURED scenes; "on"/"off" force it (within the
    # M <= 16 / T <= 2 table caps of pipeline.shade_mode_for).
    fused_surface_shade: str = "auto"
    # JAX package only: the raster kernel's range streaming form.
    kernel_range_loop: bool = False
    # Raster-kernel tile height (the port's kernel takes 8 only).
    fused_tile_h: int = 8
    # JAX package only: live-row band gating of the texture quad gather.
    shade_row_band: bool = True
    # Frame-coherence reuse of the front (pipeline.FrontCache): while the
    # model + MVP matrix bytes repeat, the front's outputs are reused.
    front_coherence: bool = True
    # Multi-device rendering over framebuffer-row slabs; None = one device.
    n_devices: Optional[int] = None

    @property
    def render_width(self) -> int:
        return self.width * self.supersample

    @property
    def render_height(self) -> int:
        return self.height * self.supersample


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Derived static rasterizer parameters.

    Fixed-point contract: vertex positions are snapped to a grid of
    ``1 / (1 << subpixel_bits)`` pixels and clamped to a guard rect extending
    ``guard_px`` beyond the screen.  With the rect's total extent bounded by
    ``2**15 - 16`` subpixel units, every edge-function value and the signed
    area fit in int32 (|E| <= 2 * extent^2 < 2^31), making coverage and depth
    bit-exact and platform-independent.
    """

    width: int
    height: int
    subpixel_bits: int
    guard_px: int
    tile_h: int
    tile_w: int
    # JAX package only: records per DMA block of its classic visibility
    # kernel (the port's K4 stages its own chunks) and the loop unroll.
    tri_block: int = 128
    tri_unroll: int = 1

    @property
    def subpixel_scale(self) -> int:
        return 1 << self.subpixel_bits

    @property
    def grid_h(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def grid_w(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def n_tiles(self) -> int:
        return self.grid_h * self.grid_w

    # Guard-rect bounds in snapped subpixel units (inclusive).
    @property
    def min_coord(self) -> int:
        return -self.guard_px * self.subpixel_scale

    @property
    def max_coord_x(self) -> int:
        return (self.width + self.guard_px) * self.subpixel_scale

    @property
    def max_coord_y(self) -> int:
        return (self.height + self.guard_px) * self.subpixel_scale


_MAX_EXTENT_SUBPIX = (1 << 15) - 16  # keeps 2*extent^2 < 2^31 with headroom


def derive_raster_config(
    width: int,
    height: int,
    tile_h: int = 16,
    tile_w: int = 128,
    guard_px: int = 32,
    tri_block: int = 128,
) -> RasterConfig:
    """Pick the largest subpixel precision that keeps int32 edge functions safe.

    The extent bound covers the tile-padded framebuffer (edge tiles extend
    past the screen, and the raster kernel evaluates edge functions at those
    samples too)."""
    pad_w = -(-width // tile_w) * tile_w
    pad_h = -(-height // tile_h) * tile_h
    extent_px = max(pad_w, pad_h, width, height) + 2 * guard_px
    subpixel_bits = 4
    while subpixel_bits > 0 and extent_px * (1 << subpixel_bits) > _MAX_EXTENT_SUBPIX:
        subpixel_bits -= 1
    if extent_px * (1 << subpixel_bits) > _MAX_EXTENT_SUBPIX:
        raise ValueError(
            f"resolution {width}x{height} too large for int32 fixed-point raster"
        )
    return RasterConfig(
        width=width,
        height=height,
        subpixel_bits=subpixel_bits,
        guard_px=guard_px,
        tile_h=tile_h,
        tile_w=tile_w,
        tri_block=tri_block,
    )
