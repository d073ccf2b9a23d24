"""The port's last host helpers and its package names against the JAX
package's, on the CPU: ``binsort.bin_sort`` (full frame and slab windows),
``binsort.stream_ranges_host``, ``tritables.unpack_coord_planes``,
the oracle's ``fill_bias``, the reference's top-level names, the
``utils.debugging`` / ``utils.profiling`` paths and the renderer's
re-exports.

The two sorts may order equal keys differently, so sorted positions are
never compared one by one: bounds, and the set of rows in each run."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_renderer_tpu as ref_pkg
from ash_renderer_tpu import specmath as ref_sm
from ash_renderer_tpu.config import derive_raster_config as ref_cfg
from ash_renderer_tpu.ops import binsort as ref_binsort
from ash_renderer_tpu.ops import tritables as ref_tritables
import ash_renderer_tpu_torch as pkg
from ash_renderer_tpu_torch.config import derive_raster_config
from ash_renderer_tpu_torch.ops import binsort, fused_kernel, tritables
from ash_renderer_tpu_torch.oracle import specmath_np
from ash_renderer_tpu_torch.rtypes import TriangleSetup

torch.set_num_threads(1)
# tests/test_fused.py's scenes: (seed, spread) of 300 random triangles
SEEDS = [(7, 2.0), (8, 0.4), (9, 6.0)]
# tile-row windows of the 32-row grid: the whole grid, a middle slab, and
# a slab that runs past the grid's last row
WINDOWS = [(0, None), (5, 9), (24, 9)]
W, H = 512, 256


def _reference_setup(seed, spread, nv=120, nt=300):
    """tests/test_fused.py's ``_setup``: the JAX package's geometry of a
    random scene (Pallas kernels in interpret mode), as numpy arrays."""
    from ash_renderer_tpu import Camera, Mesh, Scene, SceneObject
    from ash_renderer_tpu.ops import geometry
    from ash_renderer_tpu.oracle.raster_cpu import compose_mvp

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    mesh = Mesh(positions=pos,
                indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
                colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32))
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    packed = sc.pack()
    cfg = ref_cfg(W, H, tile_h=8)
    cam = Camera()
    mm = sc.model_matrices()
    mvp = compose_mvp(mm, cam.view_matrix(), cam.projection_matrix(W / H))
    clip, attrs = geometry.transform_vertices(
        *map(jnp.asarray, (packed.positions, packed.vert_obj, packed.normals,
                           packed.colors, packed.uvs, mm, mvp)))
    su, attrs_full, _ = geometry.geometry_device(
        clip, attrs, jnp.asarray(packed.tri_v), jnp.asarray(packed.tri_obj),
        jnp.asarray(packed.obj_material), cfg, 128, interpret=True)
    su = type(su)(**{f.name: np.asarray(getattr(su, f.name))
                     for f in dataclasses.fields(su)})
    return su, np.asarray(attrs_full), cfg


_SETUPS = {}


def setup(seed, spread):
    if (seed, spread) not in _SETUPS:
        _SETUPS[seed, spread] = _reference_setup(seed, spread)
    return _SETUPS[seed, spread]


def port_setup(su):
    return TriangleSetup(**{f.name: torch.from_numpy(np.array(getattr(su, f.name)))
                            for f in dataclasses.fields(TriangleSetup)})


def jnp_setup(su):
    return type(su)(**{f.name: jnp.asarray(getattr(su, f.name))
                       for f in dataclasses.fields(su)})


def run_sets(order, bounds):
    """Per run of ``bounds``, the sorted rows ``order`` holds there."""
    order, bounds = np.asarray(order), np.asarray(bounds)
    run = np.searchsorted(bounds, np.arange(order.shape[0]), side="right") - 1
    return np.lexsort((order, run)), run


def same_runs(got, want):
    """Equal bounds, and each run holding the same set of rows."""
    (o_g, b_g), (o_w, b_w) = got, want
    np.testing.assert_array_equal(np.asarray(b_g), np.asarray(b_w))
    o_g, o_w = np.asarray(o_g), np.asarray(o_w)
    assert sorted(o_g.tolist()) == list(range(o_g.shape[0]))
    i_g, run = run_sets(o_g, b_g)
    i_w, _ = run_sets(o_w, b_w)
    np.testing.assert_array_equal(o_g[i_g], o_w[i_w])
    np.testing.assert_array_equal(run[i_g], run[i_w])


@pytest.mark.parametrize("window", WINDOWS, ids=["full", "mid", "past_end"])
@pytest.mark.parametrize("seed,spread", SEEDS)
def test_bin_sort_matches_reference(seed, spread, window):
    su, _, rcfg = setup(seed, spread)
    cfg = derive_raster_config(W, H, tile_h=8)
    row0, rows = window
    got = binsort.bin_sort(port_setup(su), cfg, row0, rows)
    want = ref_binsort.bin_sort(jnp_setup(su), rcfg, row0, rows,
                                interpret=True)
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.int32
    n_tiles = (rows or cfg.grid_h) * cfg.grid_w
    assert got[1].shape == (n_tiles * binsort.KEYS_PER_TILE + 3,)
    same_runs(got, want)


@pytest.mark.parametrize("seed,spread", SEEDS)
def test_stream_ranges_host_matches_reference(seed, spread):
    """Every tile's six ranges, on the reference's bounds and on the port's
    (tensor) bounds, equal the reference's."""
    su, _, rcfg = setup(seed, spread)
    cfg = derive_raster_config(W, H, tile_h=8)
    _, bounds = ref_binsort.bin_sort(jnp_setup(su), rcfg, interpret=True)
    bounds = np.asarray(bounds)
    _, port_bounds = binsort.bin_sort(port_setup(su), cfg)
    for tile in range(cfg.n_tiles):
        want = ref_binsort.stream_ranges_host(bounds, tile, cfg.grid_w,
                                              cfg.n_tiles)
        assert binsort.stream_ranges_host(bounds, tile, cfg.grid_w,
                                          cfg.n_tiles) == want
        assert binsort.stream_ranges_host(port_bounds, tile, cfg.grid_w,
                                          cfg.n_tiles) == want


def _aabb_tiles(su, cfg):
    """Brute-force {(tri, tile)} overlap set (the coverage contract)."""
    ss = cfg.subpixel_scale
    half = ss // 2
    x = np.stack([su.x0, su.x1, su.x2])
    y = np.stack([su.y0, su.y1, su.y2])
    pxmin = np.maximum(0, (x.min(0) - half + ss - 1) // ss)
    pxmax = np.minimum(cfg.width - 1, (x.max(0) - half) // ss)
    pymin = np.maximum(0, (y.min(0) - half + ss - 1) // ss)
    pymax = np.minimum(cfg.height - 1, (y.max(0) - half) // ss)
    live = su.valid & (pxmax >= pxmin) & (pymax >= pymin)
    want = set()
    for t in np.nonzero(live)[0]:
        for ty in range(pymin[t] // cfg.tile_h, pymax[t] // cfg.tile_h + 1):
            for tx in range(pxmin[t] // cfg.tile_w, pxmax[t] // cfg.tile_w + 1):
                want.add((int(t), ty * cfg.grid_w + tx))
    return want


@pytest.mark.parametrize("seed,spread", SEEDS)
def test_binsort_streams_cover_all_overlaps(seed, spread):
    """tests/test_fused.py's coverage test on the port: every (triangle,
    tile) AABB overlap is streamed by the tile, and no tile streams a row
    twice."""
    su, _, _ = setup(seed, spread)
    cfg = derive_raster_config(W, H, tile_h=8)
    order, bounds = binsort.bin_sort(port_setup(su), cfg)
    order = order.numpy()
    streamed = {}
    for tile in range(cfg.n_tiles):
        items = []
        for rs, re in binsort.stream_ranges_host(bounds, tile, cfg.grid_w,
                                                 cfg.n_tiles):
            items.extend(order[rs:re].tolist())
        assert len(items) == len(set(items)), f"dup stream items, tile {tile}"
        streamed[tile] = set(items)
    want = _aabb_tiles(su, cfg)
    assert want
    for t, tile in want:
        assert t in streamed[tile], f"overlap (tri {t}, tile {tile}) not streamed"


@pytest.mark.parametrize("seed,spread", SEEDS)
def test_stream_ranges_host_is_the_kernels_range_meta(seed, spread):
    """With no wide pair expanded, the six host ranges are the raster
    kernel's ranges 0-4 and 6 (``build_range_meta``); its range 5, the
    wide-pair run, is empty."""
    su, _, _ = setup(seed, spread)
    cfg = derive_raster_config(W, H, tile_h=8)
    _, bounds = binsort.bin_sort(port_setup(su), cfg)
    n = cfg.n_tiles
    wide_start = int(bounds[n * binsort.KEYS_PER_TILE])
    rmeta = fused_kernel.build_range_meta(
        bounds, n, cfg.grid_w, torch.zeros(n + 1, dtype=torch.int32),
        wide_start).reshape(n, fused_kernel.N_RANGES, 2).numpy()
    for tile in range(n):
        meta = [tuple(map(int, r)) for r in rmeta[tile]]
        assert meta[5][0] == meta[5][1]
        assert binsort.stream_ranges_host(bounds, tile, cfg.grid_w, n) == (
            meta[:5] + meta[6:])


def test_unpack_coord_planes_matches_reference():
    """Words whose coordinates lie anywhere in the guard rect, negative
    ones included, unpack as the reference unpacks them."""
    cfg = derive_raster_config(W, H)
    rcfg = ref_cfg(W, H)
    rng = np.random.default_rng(3)
    xy = rng.integers(cfg.min_coord, cfg.min_coord + 65536, (2, 4096))
    xy[:, :4] = [[cfg.min_coord, -1, 0, cfg.min_coord + 65535]] * 2
    assert (xy < 0).any()
    off = -cfg.min_coord
    words = ((xy[0] + off) | ((xy[1] + off) << 16)).astype(np.uint32).view(
        np.int32)
    want = ref_tritables.unpack_coord_planes(jnp.asarray(words), rcfg)
    got = tritables.unpack_coord_planes(torch.from_numpy(words), cfg)
    got_np = tritables.unpack_coord_planes(words, cfg)
    for g, g_np, w, v in zip(got, got_np, want, xy):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g_np, np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), v)


def test_unpack_coord_planes_round_trips_comb_table():
    """Comb columns 0-2 of ``build_comb_table`` unpack to the setup's
    corner coordinates."""
    su, attrs, _ = setup(*SEEDS[2])
    cfg = derive_raster_config(W, H, tile_h=8)
    comb = tritables.build_comb_table(port_setup(su), torch.from_numpy(np.array(attrs)),
                                      cfg)
    for c in range(3):
        x, y = tritables.unpack_coord_planes(comb[:, c], cfg)
        np.testing.assert_array_equal(x.numpy(), getattr(su, f"x{c}"))
        np.testing.assert_array_equal(y.numpy(), getattr(su, f"y{c}"))


def test_oracle_fill_bias_matches_reference():
    """The reference's ``specmath.fill_bias`` lives in the port's oracle
    (``test_torch_coverage.NOT_PORTED``)."""
    tl = np.array([True, False, True, False])
    got = specmath_np.fill_bias(tl)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_sm.fill_bias(tl, np))


TOP_LEVEL = ("Camera", "CameraController", "orbit_path", "RendererSettings",
             "RasterConfig", "derive_raster_config", "DirectionalLight",
             "Material", "Mesh", "PackedScene", "Scene", "SceneObject",
             "reference_two_triangle_scene")


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_name_is_the_ports_own(name):
    """Each of the reference's top-level names resolves on the port, to the
    port's own object of the same module."""
    assert hasattr(ref_pkg, name)
    got = getattr(pkg, name)
    mod = getattr(ref_pkg, name).__module__.rsplit(".", 1)[1]
    assert got.__module__ == f"ash_renderer_tpu_torch.{mod}"
    assert got is getattr(importlib.import_module(got.__module__), name)


def test_version_and_lazy_names():
    assert pkg.__version__ == ref_pkg.__version__ == "0.1.0"
    from ash_renderer_tpu_torch.app import App
    from ash_renderer_tpu_torch.renderer import Renderer

    assert pkg.Renderer is Renderer and pkg.App is App
    with pytest.raises(AttributeError):
        pkg.no_such_name  # noqa: B018


@pytest.mark.parametrize("name", ["debugging", "profiling"])
def test_utils_paths_are_the_top_level_modules(name):
    top = importlib.import_module(f"ash_renderer_tpu_torch.{name}")
    assert importlib.import_module(f"ash_renderer_tpu_torch.utils.{name}") is top
    utils = importlib.import_module("ash_renderer_tpu_torch.utils")
    assert getattr(utils, name) is top


def test_renderer_reexports_packs():
    from ash_renderer_tpu_torch import renderer, rtypes

    assert renderer.LightPack is rtypes.LightPack
    assert renderer.MaterialsPack is rtypes.MaterialsPack
