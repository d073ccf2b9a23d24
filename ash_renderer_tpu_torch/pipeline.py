"""The frame pipelines: scene tensors + camera matrices -> RGBA8 frame.

The counterpart of ``ash_renderer_tpu/pipeline.py``'s two pipelines.  The
classic one (``render_frame``, which the Renderer takes for small scenes):
vertex transform and triangle setup as one table of rows, the reference's
``_stage_geometry`` (kernel K10 with the transform folded in,
``geometry.stage_geometry_rows``, with kernel K5 on a meshlet-packed
scene), tile binning from that table (kernel K12, ``binning.bin_rows``),
visibility raster (kernel K4, ``raster_visibility.rasterize_visibility``),
per-pixel winner gather, shading, resolve + pack (kernel K11,
``shade.shade_pack_classic``).

The fused one (``render_frame_fused_staged``, meshlet-packed scenes).
Stages, each a plain call on tensors of one device:

1. vertex transform (``setup_kernel.transform_vertices_T``, kernel K8);
2. triangle setup, kernel K1 (``setup_kernel.triangle_setup``);
3. clip tail (``_clip_tail_into``, kernel K6);
4. key sort + run bounds, kernel K2 (``binsort.sort_and_bounds``);
5. wide-pair expansion, range metadata and the sorted tables' records
   (kernel K9, ``expand_table``), with no host read;
6. raster + distribute, kernel K3 (``fused_kernel.rasterize_distribute``),
   or K3F, which also runs the surface half of shading (phase F) when
   ``shade_mode_for`` gives a shade mode;
7. shade + pack (``_shade_from_planes``): after K3F, kernel K7
   (``shade_pack.shade_pack``: texture tap, combine, clear, resolve,
   sRGB, RGBA8 in one launch); after K3, the surface half of shading
   from the phase E planes (``shade.surface_prelight``, the torch
   definition phase F follows), then the texture tap, the combine and
   the pack in torch.

Stages 1-5 (the front) depend only on the scene and the model + MVP
matrices, so ``FrontCache`` reuses them while those bytes stay the same.

The non-meshlet fused fallback (``render_frame_fused``, plain-packed
scenes) replaces stages 1-3 with the classic setup
(``geometry.stage_geometry_rows``: K10 with the transform folded in), the
streaming keys of its setup rows and
``tritables.build_comb_table`` (``render_front_fallback``), then runs
stages 4-7 as above.

``render_frame``, ``render_front`` and ``_raster_shade`` also render one
slab of a multi-device frame (``parallel/sharding.py``): the tile-row
window ``[tile_row0, tile_row0 + tile_rows)``.  Geometry and K1 run whole;
keys, bounds, the wide expansion, binning and the rasters take the window,
and the slab's frame rows come back uncropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import RasterConfig, RendererSettings
from .ops import (binning, binsort, clip_tail, front_meta, fused_kernel,
                  geometry, raster_visibility, setup_kernel, shade,
                  shade_pack, tritables)


@dataclasses.dataclass(frozen=True)
class FrameStatics:
    """Static configuration of one settings/resize world."""

    cfg: RasterConfig
    settings: RendererSettings
    has_atlas: bool
    has_light: bool


def _clip_tail_into(statics, tblT, tri_v, tri_mat, flags, comb,
                    tile_row0: int = 0, tile_rows=None):
    """Clip tail + stats (``clip_tail.clip_tail``, kernel K6 on a card);
    tail comb rows are written in place into the rows reserved after the
    main block (comb row T onward), and keyed for the tile-row window (the
    whole grid by default).  Returns (comb, keys_tail, gstats); the
    counters are 0-dim device tensors, read after the frame."""
    keys_tail, counters = clip_tail.clip_tail(
        tblT, tri_v, tri_mat, flags, comb, statics.cfg,
        statics.settings.clip_budget, tile_row0, tile_rows)
    return comb, keys_tail, {**counters, "n_setup": comb.shape[0]}


def expand_table(statics, comb, order, bounds, tile_row0: int = 0,
                 tile_rows=None):
    """Wide-pair expansion + range metadata + the sorted tables' records
    (``front_meta.front_meta``, kernel K9 on a card) on the sorted order of
    the tile-row window (the whole grid by default).  Nothing is read back
    to the host on a card: the counters are 0-dim device tensors, read
    after the frame.  Returns (rmeta, tbl_sorted, tbl_ext, sstats)."""
    st = statics.settings
    _, _, rmeta, counts, tbl_sorted, tbl_ext = front_meta.front_meta(
        comb, order, bounds, statics.cfg, st.wide_rows, st.wide_pairs,
        tile_row0, tile_rows)
    return rmeta, tbl_sorted, tbl_ext, front_meta.front_stats(counts)


def _no_stage(name):
    pass


def render_frame(statics: FrameStatics, state, model_mats, mvp_mats,
                 camera_pos, local_tri=None, on_stage=_no_stage,
                 tile_row0: int = 0, tile_rows=None):
    """One classic-pipeline frame on ``state``'s device (16x128 tiles), or
    with ``tile_rows`` the slab of that many tile rows from ``tile_row0``
    (its rows uncropped).  ``local_tri``: the meshlet-local corner ids of a
    meshlet-packed scene, which take the corner gather through kernel K5.
    Returns (rgba8 (H, W, 4) uint8, aux dict with vis_d16, vis_tri and the
    geometry and binning counters).  ``on_stage(name)`` is called as each
    stage has been issued."""
    cfg = statics.cfg
    st = statics.settings
    rows, valid, attrs_full, gstats = geometry.stage_geometry_rows(
        state.positions, state.vert_obj, state.normals, state.colors,
        state.uvs, model_mats, mvp_mats, state.tri_v, state.tri_mat, cfg,
        st.clip_budget, local_tri=local_tri,
    )
    on_stage("geometry")
    rec_i, rec_f, rec_box, tile_start, tile_count, bstats = binning.bin_rows(
        rows, valid, cfg, st.max_pairs, tile_row0, tile_rows)
    on_stage("binning")
    vis_d, vis_t = raster_visibility.rasterize_visibility(
        rec_i, rec_f, tile_start, tile_count, cfg, rec_box=rec_box,
        tile_rows=tile_rows
    )
    on_stage("raster_K4")
    atlas = state.atlas if statics.has_atlas else None
    light = state.light if statics.has_light else None
    mode = surface_mode(statics, state.materials, atlas, light)
    consts = shade.pack_shade_consts(mode, state.materials, atlas, light,
                                     camera_pos)
    rgba8 = shade.shade_pack_classic(
        vis_t, rows, attrs_full, mode, consts, atlas=atlas, light=light,
        cfg=cfg, clear_color=st.clear_color, supersample=st.supersample,
        srgb=st.srgb_output, py_offset=tile_row0 * cfg.tile_h)
    on_stage("shade_pack")
    return rgba8, {"vis_d16": vis_d, "vis_tri": vis_t, **gstats, **bstats}


def render_front(statics, state, model_mats, mvp_mats, on_stage=_no_stage,
                 tile_row0: int = 0, tile_rows=None):
    """Stages 1-5, for the whole grid or, with ``tile_rows``, the slab of
    that many tile rows from ``tile_row0``: the slab keys K1's rows from
    its packed pixel AABBs (``binsort.stream_keys_from_aabb``), as K1's own
    keys are the whole grid's.  Returns (rmeta, tbl_sorted, tbl_ext, comb,
    stats).  ``on_stage(name)`` is called as each stage has been issued (a
    timing probe records a CUDA event there)."""
    st = statics.settings
    cfg = statics.cfg
    tblT = setup_kernel.transform_vertices_T(
        state.positions, state.vert_obj, state.normals, state.colors,
        state.uvs, model_mats, mvp_mats,
    )
    on_stage("transform")
    comb, keys_main, flags, extx, exty = setup_kernel.triangle_setup(
        tblT, state.ltT, state.matT, cfg,
        tail_rows=st.clip_budget * geometry.MAX_CLIP_TRIS,
    )
    if tile_rows is not None:
        keys_main = binsort.stream_keys_from_aabb(
            (flags & 1).bool(), extx, exty, cfg, tile_row0, tile_rows)
    on_stage("setup_K1")
    comb, keys_tail, gstats = _clip_tail_into(
        statics, tblT, state.tri_v, state.tri_mat, flags, comb, tile_row0,
        tile_rows
    )
    on_stage("clip_tail")
    order, bounds = binsort.sort_and_bounds(
        torch.cat([keys_main, keys_tail]), cfg, tile_rows
    )
    on_stage("sort_bounds_K2")
    rmeta, tbl_sorted, tbl_ext, sstats = expand_table(
        statics, comb, order, bounds, tile_row0, tile_rows
    )
    on_stage("expand_meta_gather")
    return rmeta, tbl_sorted, tbl_ext, comb, {**gstats, **sstats}


def render_front_fallback(statics, state, model_mats, mvp_mats,
                          on_stage=_no_stage):
    """The non-meshlet fallback's front: transform and setup
    (``geometry.stage_geometry_rows``, S = T + 7 * clip_budget setup rows),
    their streaming keys,
    ``build_comb_table``, sort + K2 and ``expand_table``.  Returns (rmeta,
    tbl_sorted, tbl_ext, comb, stats), as ``render_front`` does."""
    cfg = statics.cfg
    rows, valid, attrs_full, gstats = geometry.stage_geometry_rows(
        state.positions, state.vert_obj, state.normals, state.colors,
        state.uvs, model_mats, mvp_mats, state.tri_v, state.tri_mat, cfg,
        statics.settings.clip_budget)
    su = geometry.setup_from_rows(rows, valid)
    on_stage("geometry")
    keys = binsort.stream_keys(su.valid, su.x0, su.y0, su.x1, su.y1, su.x2,
                               su.y2, cfg)
    comb = tritables.build_comb_table(su, attrs_full, cfg)
    on_stage("keys_comb")
    order, bounds = binsort.sort_and_bounds(keys, cfg)
    on_stage("sort_bounds_K2")
    rmeta, tbl_sorted, tbl_ext, sstats = expand_table(statics, comb, order,
                                                      bounds)
    on_stage("expand_meta_gather")
    return rmeta, tbl_sorted, tbl_ext, comb, {**gstats, **sstats}


def render_frame_fused(statics: FrameStatics, state, model_mats, mvp_mats,
                       camera_pos, on_stage=_no_stage):
    """One fused-pipeline frame of a plain-packed ``state`` (``state.ltT``
    is None) on its device: the reference's non-meshlet fallback
    (``render_frame_fused`` without ``local_tri``).  The front is
    ``render_front_fallback``; raster (K3, or K3F) and shade are the staged
    pipeline's.  Returns (rgba8 (H, W, 4) uint8, aux with vis_d16, vis_tri
    and the geometry and sort counters).  ``on_stage`` as in
    ``render_front``."""
    if state.ltT is not None:
        raise ValueError("render_frame_fused takes a plain-packed scene; a "
                         "meshlet-packed one goes to render_frame_fused_staged")
    front = render_front_fallback(statics, state, model_mats, mvp_mats,
                                  on_stage)
    return _raster_shade(statics, state, front[:4], camera_pos, front[4],
                         on_stage)


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


def _shade_from_planes(statics, planes, mode, consts, phase_f, atlas, light,
                       full_frame: bool = True):
    """Shade the (n_tiles, 24, tile_h * 128) planes tile-flat into the
    RGBA8 image of their n_tiles / grid_w tile rows, cropped to the width,
    and to the height only for the ``full_frame`` (a slab's rows stay
    whole).  ``mode`` and ``consts``: the scene's ``surface_mode`` and its
    packed tables; ``phase_f``: whether the planes hold the phase F layout
    (the surface half is done: ``shade_pack.shade_pack``, kernel K7 on a
    card) or phase E's (the surface half runs here,
    ``shade.surface_prelight``, then the combine and
    ``shade_pack.pack_tiles``).  ``atlas`` and ``light`` are None where
    the scene has none."""
    cfg = statics.cfg
    st = statics.settings
    _, _, has_m, has_a, has_l = mode
    atlas = atlas if has_a else None
    light = light if has_l else None
    if phase_f:
        return shade_pack.shade_pack(
            planes, cfg, st.supersample, st.srgb_output, st.clear_color,
            atlas=atlas, light=light, has_materials=has_m,
            full_frame=full_frame)
    pf = planes.view(torch.float32)
    pre = shade.surface_prelight(
        pf[:, 0:12], tuple(pf[:, 12 + k] for k in range(4)), planes[:, 16],
        mode, consts)
    rgba = shade.combine_from_prelight(
        planes[:, fused_kernel.VIS_ROW] >= 0, *pre, atlas=atlas, light=light,
        has_materials=has_m, clear_color=st.clear_color,
    )
    return shade_pack.pack_tiles(rgba, cfg, st.supersample, st.srgb_output,
                                 full_frame)


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
    return _raster_shade(statics, state, front[:4], camera_pos, front[4],
                         on_stage)


def _raster_shade(statics, state, tables, camera_pos, stats, on_stage,
                  tile_row0: int = 0, tile_rows=None):
    """Stages 6-7 of a fused frame: K3 (or K3F when ``shade_mode_for``
    gives a mode) on the front's ``tables`` (rmeta, tbl_sorted, tbl_ext,
    comb), then shade + pack; for the whole grid or the slab of
    ``tile_rows`` tile rows from ``tile_row0`` the tables were built for.
    Returns (rgba8, aux with vis_d16, vis_tri and ``stats``)."""
    atlas = state.atlas if statics.has_atlas else None
    light = state.light if statics.has_light else None
    mode = surface_mode(statics, state.materials, atlas, light)
    consts = shade.pack_shade_consts(mode, state.materials, atlas, light,
                                     camera_pos)
    smode = shade_mode_for(statics, state.materials, atlas, light)
    vis_d, vis_t, planes = fused_kernel.rasterize_distribute(
        *tables, statics.cfg, smode, None if smode is None else consts,
        tile_row0=tile_row0, tile_rows=tile_rows,
    )
    on_stage("raster_K3")
    rgba8 = _shade_from_planes(statics, planes, mode, consts,
                               smode is not None, atlas, light,
                               full_frame=tile_rows is None)
    on_stage("shade_pack")
    return rgba8, {"vis_d16": vis_d, "vis_tri": vis_t, **stats}
