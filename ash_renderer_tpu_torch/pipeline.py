"""The frame pipelines: scene tensors + camera matrices -> RGBA8 frame.

The counterpart of ``ash_renderer_tpu/pipeline.py``'s two pipelines.  The
classic one (``render_frame``, which the Renderer takes for scenes under
4096 triangles): vertex transform, triangle setup (``geometry_device``,
with kernel K5 on a meshlet-packed scene), tile binning
(``binning.bin_triangles``), visibility raster (kernel K4,
``raster_visibility.rasterize_visibility``), per-pixel winner gather and
shading (``shade.shade``), resolve + pack.

The fused one (``render_frame_fused_staged``, meshlet-packed scenes).
Stages, each a plain call on tensors of one device:

1. vertex transform (``setup_kernel.transform_vertices_T``);
2. triangle setup, kernel K1 (``setup_kernel.triangle_setup``);
3. clip tail (``_clip_tail_into``);
4. key sort + run bounds, kernel K2 (``binsort.sort_and_bounds``);
5. wide-pair expansion, range metadata and table gathers
   (``expand_table``);
6. raster + distribute, kernel K3 (``fused_kernel.rasterize_distribute``),
   or K3F, which also runs the surface half of shading (phase F) when
   ``shade_mode_for`` gives a shade mode;
7. shade + pack (``_shade_from_planes``): the surface half of shading
   from the phase E planes (``shade.surface_prelight``, the torch
   definition phase F follows), then the texture tap and the combine.

Stages 1-5 (the front) depend only on the scene and the model + MVP
matrices, so ``FrontCache`` reuses them while those bytes stay the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import RasterConfig, RendererSettings
from .ops import (binning, binsort, fused_kernel, geometry, raster_visibility,
                  setup_kernel, shade, tritables)


@dataclasses.dataclass(frozen=True)
class FrameStatics:
    """Static configuration of one settings/resize world."""

    cfg: RasterConfig
    settings: RendererSettings
    has_atlas: bool
    has_light: bool


def _clip_tail_into(statics, tblT, tri_v, tri_mat, flags, comb):
    """Clip tail + stats; tail comb rows are written in place into the rows
    reserved after the main block (comb row T onward).  Returns (comb,
    keys_tail, gstats)."""
    cfg = statics.cfg
    st = statics.settings
    t = tri_v.shape[0]
    needs_clip = ((flags >> 1) & 1).bool()
    tail_f, (ta0, ta1, ta2), cstats = geometry.clip_tail_fused(
        tblT, tri_v, tri_mat, needs_clip, cfg, st.clip_budget
    )
    comb[t:] = tritables.comb_rows(tail_f, ta0, ta1, ta2, cfg, id_base=t)
    keys_tail = binsort.stream_keys(
        tail_f["valid"], tail_f["x0"], tail_f["y0"], tail_f["x1"],
        tail_f["y1"], tail_f["x2"], tail_f["y2"], cfg,
    )
    gstats = {
        "clip_overflow": cstats["clip_overflow"],
        "n_fast": ((flags >> 2) & 1).sum(),
        "n_clipped": cstats["n_clipped"],
        "n_valid": (flags & 1).sum() + tail_f["valid"].sum(),
        "n_setup": comb.shape[0],
    }
    return comb, keys_tail, gstats


def expand_table(statics, comb, order, bounds):
    """Wide-pair expansion + range metadata + the live-prefix table gathers
    on the sorted order.  Returns (rmeta, tbl_sorted, tbl_ext, sstats)."""
    cfg = statics.cfg
    st = statics.settings
    n_tiles = cfg.n_tiles
    pair_rows, pair_starts, new_ws = binsort.expand_wide_pairs(
        comb, order, bounds, cfg, st.wide_rows, st.wide_pairs
    )
    rmeta = fused_kernel.build_range_meta(
        bounds, n_tiles, cfg.grid_w, pair_starts, new_ws
    )
    edges = bounds[n_tiles * binsort.KEYS_PER_TILE :][:2].tolist()
    ws, live_end = edges
    n_pairs = int(pair_starts[-1])
    tbl_sorted = tritables.sorted_table(comb, order.long(), live_end)
    tbl_ext = tritables.sorted_table(comb, pair_rows.long(), n_pairs)
    sstats = {
        "n_wide": live_end - ws,
        "wide_pairs_n": n_pairs,
        "wide_leftover": live_end - new_ws,
        "live_rows": live_end,
    }
    return rmeta, tbl_sorted, tbl_ext, sstats


def _no_stage(name):
    pass


def render_frame(statics: FrameStatics, state, model_mats, mvp_mats,
                 camera_pos, local_tri=None, on_stage=_no_stage):
    """One classic-pipeline frame on ``state``'s device (16x128 tiles).
    ``local_tri``: the meshlet-local corner ids of a meshlet-packed scene,
    which take the corner gather through kernel K5.  Returns (rgba8 (H, W,
    4) uint8, aux dict with vis_d16, vis_tri and the geometry and binning
    counters).  ``on_stage(name)`` is called as each stage has been
    issued."""
    cfg = statics.cfg
    st = statics.settings
    clip, attrs = geometry.transform_vertices(
        state.positions, state.vert_obj, state.normals, state.colors,
        state.uvs, model_mats, mvp_mats,
    )
    on_stage("transform")
    su, attrs_full, gstats = geometry.geometry_device(
        clip, attrs, state.tri_v, state.tri_mat, cfg, st.clip_budget,
        local_tri=local_tri,
    )
    on_stage("geometry")
    rec_i, rec_f, tile_start, tile_count, bstats = binning.bin_triangles(
        su, cfg, st.max_pairs
    )
    on_stage("binning")
    vis_d, vis_t = raster_visibility.rasterize_visibility(
        rec_i, rec_f, tile_start, tile_count, cfg
    )
    on_stage("raster_K4")
    atlas = state.atlas if statics.has_atlas else None
    light = state.light if statics.has_light else None
    mode = surface_mode(statics, state.materials, atlas, light)
    consts = shade.pack_shade_consts(mode, state.materials, atlas, light,
                                     camera_pos)
    rgba = shade.shade(vis_t, su, attrs_full, mode, consts, atlas=atlas,
                       light=light, cfg=cfg, clear_color=st.clear_color)
    rgba8 = shade.resolve_and_pack(rgba, st.supersample, st.srgb_output)
    on_stage("shade_pack")
    return rgba8, {"vis_d16": vis_d, "vis_tri": vis_t, **gstats, **bstats}


def render_front(statics, state, model_mats, mvp_mats, on_stage=_no_stage):
    """Stages 1-5.  Returns (rmeta, tbl_sorted, tbl_ext, comb, stats).
    ``on_stage(name)`` is called as each stage has been issued (a timing
    probe records a CUDA event there)."""
    st = statics.settings
    tblT = setup_kernel.transform_vertices_T(
        state.positions, state.vert_obj, state.normals, state.colors,
        state.uvs, model_mats, mvp_mats,
    )
    on_stage("transform")
    comb, keys_main, flags, _, _ = setup_kernel.triangle_setup(
        tblT, state.ltT, state.matT, statics.cfg,
        tail_rows=st.clip_budget * geometry.MAX_CLIP_TRIS,
    )
    on_stage("setup_K1")
    comb, keys_tail, gstats = _clip_tail_into(
        statics, tblT, state.tri_v, state.tri_mat, flags, comb
    )
    on_stage("clip_tail")
    order, bounds = binsort.sort_and_bounds(
        torch.cat([keys_main, keys_tail]), statics.cfg
    )
    on_stage("sort_bounds_K2")
    rmeta, tbl_sorted, tbl_ext, sstats = expand_table(
        statics, comb, order, bounds
    )
    on_stage("expand_meta_gather")
    return rmeta, tbl_sorted, tbl_ext, comb, {**gstats, **sstats}


def surface_mode(statics, materials, atlas, light):
    """The scene's shading configuration (M, T, has_materials, has_atlas,
    has_light), as the reference's ``shade_mode_for`` derives it.  The
    port's scene state always holds its materials, as the reference
    Renderer's ``has_materials=True`` does."""
    has_m = materials is not None
    has_a = has_m and statics.has_atlas and atlas is not None
    has_l = statics.has_light and light is not None
    m_n = materials.base_color.shape[0] if has_m else 0
    t_n = atlas.level_offset.shape[0] if has_a else 0
    return (m_n, t_n, has_m, has_a, has_l)


def shade_mode_for(statics, materials, atlas, light):
    """The phase F shading configuration (``surface_mode``), or None for the
    phase E planes: the reference's routing (``pipeline.py:123-144``).  None
    when the knob is "off", when the tables are over the kernel's caps
    (M > 16 or T > 2), and under "auto" for a textured scene."""
    knob = statics.settings.fused_surface_shade
    if knob == "off":
        return None
    mode = surface_mode(statics, materials, atlas, light)
    m_n, t_n, has_m, has_a, _ = mode
    if ((has_m and m_n > fused_kernel.MAX_SHADE_M)
            or (has_a and t_n > fused_kernel.MAX_SHADE_T)):
        return None
    if knob == "auto" and has_a:
        return None
    return mode


def _shade_from_planes(statics, planes, mode, consts, phase_f, atlas, light):
    """Shade the (n_tiles, 24, 1024) planes tile-flat, then lay the RGBA out
    as the (height, width) image.  ``mode`` and ``consts``: the scene's
    ``surface_mode`` and its packed tables; ``phase_f``: whether the planes
    hold the phase F layout (the surface half is done) or phase E's (it is
    run here, ``shade.surface_prelight``).  ``atlas`` and ``light`` are None
    where the scene has none."""
    cfg = statics.cfg
    st = statics.settings
    th, tw = cfg.tile_h, fused_kernel.TILE_W
    gw, gh = cfg.grid_w, cfg.grid_h
    _, _, has_m, has_a, has_l = mode
    pf = planes.view(torch.float32)
    if phase_f:
        fk = fused_kernel
        pre = (pf[:, fk.F_P : fk.F_P + 4], pf[:, fk.F_DIFF : fk.F_DIFF + 3],
               pf[:, fk.F_SPEC], planes[:, fk.F_LIT], planes[:, fk.F_TAP],
               pf[:, fk.F_FU], pf[:, fk.F_FV], planes[:, fk.F_TEXMASK])
    else:
        pre = shade.surface_prelight(
            pf[:, 0:12], tuple(pf[:, 12 + k] for k in range(4)), planes[:, 16],
            mode, consts)
    rgba = shade.combine_from_prelight(
        planes[:, fused_kernel.VIS_ROW] >= 0, *pre,
        atlas=atlas if has_a else None, light=light if has_l else None,
        has_materials=has_m, clear_color=st.clear_color,
    )

    def to_image(x):
        return (
            x.reshape(gh, gw, th, tw, 4).permute(0, 2, 1, 3, 4)
            .reshape(gh * th, gw * tw, 4)[: cfg.height, : cfg.width]
        )

    if st.supersample == 1:
        return to_image(shade.resolve_and_pack(rgba, 1, st.srgb_output))
    return shade.resolve_and_pack(to_image(rgba), st.supersample, st.srgb_output)


class FrontCache:
    """Frame-coherence memo for the front (stages 1-5).

    The front is a pure function of the scene tensors and the model + MVP
    matrices (camera_pos feeds only shading), so under a static camera its
    outputs can be reused bit for bit.  ``key`` is the raw bytes of those
    two matrices and nothing else; any motion misses and recomputes.  The
    value holds comb too: phase D gathers winners from it."""

    __slots__ = ("key", "value")

    def __init__(self):
        self.key = None
        self.value = None


def render_frame_fused_staged(statics: FrameStatics, state, model_mats,
                              mvp_mats, camera_pos,
                              front_cache: Optional[FrontCache] = None,
                              front_key: Optional[bytes] = None,
                              on_stage=_no_stage):
    """One frame on ``state``'s device.  Returns (rgba8 (H, W, 4) uint8,
    aux dict with vis_d16, vis_tri and the pipeline counters).  ``on_stage``
    as in ``render_front``."""
    use_cache = front_cache is not None and front_key is not None
    if use_cache and front_cache.key == front_key:
        front = front_cache.value
    else:
        if use_cache:
            # drop the stale entry first so its ~1.4 GB of tables can be
            # freed before the new ones are allocated
            front_cache.key = front_cache.value = None
        front = render_front(statics, state, model_mats, mvp_mats, on_stage)
        if use_cache:
            front_cache.key, front_cache.value = front_key, front
    rmeta, tbl_sorted, tbl_ext, comb, stats = front
    atlas = state.atlas if statics.has_atlas else None
    light = state.light if statics.has_light else None
    mode = surface_mode(statics, state.materials, atlas, light)
    consts = shade.pack_shade_consts(mode, state.materials, atlas, light,
                                     camera_pos)
    smode = shade_mode_for(statics, state.materials, atlas, light)
    vis_d, vis_t, planes = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, statics.cfg, smode,
        None if smode is None else consts,
    )
    on_stage("raster_K3")
    rgba8 = _shade_from_planes(statics, planes, mode, consts,
                               smode is not None, atlas, light)
    on_stage("shade_pack")
    return rgba8, {"vis_d16": vis_d, "vis_tri": vis_t, **stats}
