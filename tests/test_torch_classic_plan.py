"""The classic route's K10 plan on the CPU, and K10's and K12's plain
versions against the JAX package at the shapes ``chip_smoke.py`` phase 29
holds the kernels on.

* The pure function that chooses K10's design from the triangle count
  (``geometry.k10_design``: one thread block cluster up to the crossover,
  one cooperative grid past it) at its boundaries, and the device scratch
  its wrapper allocates (``geometry.scratch_words``).
* ``geometry_device_plain`` against the JAX package's ``geometry_device``
  on the gate frame (bench.py's 160-triangle scene at 800x600, orbit
  frames 0, 7 and 15, the default clip budget).
* ``bin_triangles_plain`` against the JAX package's ``bin_triangles`` on
  the gate frame's setup: the three orbit frames, slabs of tile rows (from
  its middle one, its first and last alone, three inside), pair budgets
  that end on a triangle's last pair or split its rectangle, the table
  padded with dead rows to one row either side of a chunk edge of K12's
  row steps and a chunk past it, and zero triangles (S = 0 and the
  budget's 28,672 dead rows).  The records of a tile are compared as a
  set (the reference's sort is not stable); starts, counts, counters and
  dead columns exactly.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_torch_classic import _jax_geometry, _same  # noqa: E402

from ash_renderer_tpu.rtypes import TriangleSetup as JaxSetup  # noqa: E402
from ash_renderer_tpu_torch.camera import orbit_path  # noqa: E402
from ash_renderer_tpu_torch.ops import binning, geometry  # noqa: E402
from ash_renderer_tpu_torch.renderer import frame_statics  # noqa: E402
from ash_renderer_tpu_torch.rtypes import TriangleSetup  # noqa: E402

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(TriangleSetup)]
K10_X = geometry.K10_CLUSTER_MAX_TRIS


# ---------------------------------------------------------------------------
# K10's design and scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tris, want", [
    (0, "cluster"), (256, "cluster"), (K10_X - geometry.K10_CHUNK, "cluster"),
    (K10_X - 1, "cluster"), (K10_X, "cluster"), (K10_X + 1, "grid"),
    (K10_X + geometry.K10_CHUNK, "grid"), (1_310_720, "grid")])
def test_k10_design_at_its_boundaries(n_tris, want):
    """The cluster up to ``K10_CLUSTER_MAX_TRIS`` triangles, the grid past
    it (the gate frame's 256: cluster; config4 subdiv 5's 20,480: grid)."""
    assert geometry.k10_design(n_tris) == want
    assert 256 <= K10_X < 20_480


@pytest.mark.parametrize("meshlets", [False, True])
@pytest.mark.parametrize("v, t, b", [(1, 0, 0), (200, 256, 4096),
                                     (20_480, 20_480, 4096),
                                     (5, 1025, 16)])
def test_k10_scratch(v, t, b, meshlets):
    """Beside the setup table: the snapped vertex rows on a
    meshlet-packed scene only (K5 gathers from them; a plain-packed launch
    snaps its corners itself), the 4 counters, 3 counts a chunk of
    K10_CHUNK triangles, the budget's selection and a flag a triangle."""
    chunks = -(-t // geometry.K10_CHUNK)
    want = (v * geometry.VTX_COLS if meshlets else 0) + 4 + 3 * chunks + b + t
    assert geometry.scratch_words(v, t, b, meshlets) == want
    src = open(os.path.join(os.path.dirname(geometry.__file__), os.pardir,
                            "csrc", "geometry.cu")).read()
    assert (f"constexpr int ITERS = {geometry.K10_CHUNK // 256};" in src
            and "constexpr int THREADS = 256;" in src)


def test_build_tables_take_the_design():
    """K10's C entry point takes the design (an int before the stream) and
    no vertex rows (the launch snaps its corners, or reads K5's rows)."""
    from ash_renderer_tpu_torch import _build

    P, I, F = (_build.ctypes.c_void_p, _build.ctypes.c_int,
               _build.ctypes.c_float)
    assert _build.KERNELS["geometry.cu"]["ash_geometry_tris"] == (
        [P] * 9 + [I] * 9 + [F, F, I] + [P])


# ---------------------------------------------------------------------------
# K10's and K12's plain versions against the JAX package at phase 29's
# shapes
# ---------------------------------------------------------------------------

GATE_FRAMES = (0, 7, 15)  # phase 29's orbit frames of the gate scene


@functools.lru_cache(maxsize=None)
def _gate_full(frame=0):
    """(classic case, the port's plain (setup, combined attributes,
    counters)) of the gate frame at 800x600, orbit frame ``frame``
    (``chip_smoke.py`` phase 29's frames); the case's ``max_pairs`` is the
    Renderer's (``renderer.frame_statics`` caps it by the triangles: 16,384
    here)."""
    scene, settings = tp.jax_gate_scene()
    cam = orbit_path(24, radius=6.0, center=[0.0, 0.0, 3.5])[frame]
    from ash_renderer_tpu.camera import Camera

    case = tp.classic_case(scene, settings, cam=Camera(**{
        f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}))
    case.settings = frame_statics(
        dataclasses.replace(case.settings, pipeline="classic"),
        case.packed.tri_v.shape[0], False, False).settings
    st = tp.port_state(case)
    clip, attrs = geometry.transform_vertices(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp))
    return case, geometry.geometry_device(
        clip, attrs, st.tri_v, st.tri_mat, case.cfg,
        case.settings.clip_budget)


def _gate(frame=0):
    """(classic case, the port's plain setup) of ``_gate_full(frame)``."""
    case, (su, _, _) = _gate_full(frame)
    return case, su


@pytest.mark.parametrize("frame", GATE_FRAMES)
def test_gate_frame_geometry_matches_jax(frame):
    """K10's plain version on the gate frame (256 triangles, the default
    clip budget of 4096: 28,928 setup rows and 28,928 attribute rows + V):
    every TriangleSetup field, the combined attributes and the counters
    equal the JAX package's ``geometry_device``."""
    case, (su, attrs_full, stats) = _gate_full(frame)
    _, jsu, jattrs_full, jstats = _jax_geometry(case)
    for k in FIELDS:
        _same(getattr(su, k).numpy(), np.asarray(getattr(jsu, k)))
    _same(attrs_full.numpy(), np.asarray(jattrs_full))
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in jstats.items()}
    assert stats["n_setup"] == 256 + 7 * 4096
    assert int(stats["n_valid"]) > 0


def _padded(su, s_rows):
    """``su`` cut or padded with dead rows (every field 0, not valid) to
    ``s_rows`` rows."""
    out = {}
    for k in FIELDS:
        x = getattr(su, k)[:s_rows]
        pad = torch.zeros(s_rows - x.shape[0], dtype=x.dtype)
        out[k] = torch.cat([x, pad])
    return TriangleSetup(**out)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_bin(jsu, cfg, max_pairs, tile_row0, tile_rows):
    from ash_renderer_tpu.ops import binning as jbin

    return jbin.bin_triangles(jsu, cfg, max_pairs, tile_row0, tile_rows)


def _check_against_jax(su, case, max_pairs, tile_row0=0, tile_rows=None):
    """bin_triangles_plain on ``su`` against the JAX package's
    bin_triangles on the same fields; returns the port's outputs."""
    jsu = JaxSetup(**{k: jnp.asarray(getattr(su, k).numpy()) for k in FIELDS})
    w_i, w_f, w_start, w_count, w_stats = (
        np.asarray(x) if not isinstance(x, dict) else x
        for x in _jax_bin(jsu, case.ref_cfg, max_pairs, tile_row0,
                          tile_rows))
    got = binning.bin_triangles_plain(su, case.cfg, max_pairs, tile_row0,
                                      tile_rows)
    rec_i, rec_f, rec_box, start, count, stats = got
    np.testing.assert_array_equal(start.numpy(), w_start)
    np.testing.assert_array_equal(count.numpy(), w_count)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in w_stats.items()}
    assert rec_i.shape == (14, max_pairs) and rec_box.shape == (1, max_pairs)
    assert not w_i[14:].any()
    w_i, w_f = w_i[:14, :max_pairs], w_f[:, :max_pairs]
    got_i, got_f = rec_i.numpy(), rec_f.numpy().view(np.int32)
    w_f = w_f.view(np.int32)
    for s, c in zip(start.numpy(), count.numpy()):
        cols = slice(s, s + c)
        og, ow = np.argsort(got_i[12, cols]), np.argsort(w_i[12, cols])
        np.testing.assert_array_equal(got_i[:, cols][:, og],
                                      w_i[:, cols][:, ow])
        np.testing.assert_array_equal(got_f[:, cols][:, og],
                                      w_f[:, cols][:, ow])
    n_live = int(count.sum())
    assert not got_i[:, n_live:].any() and not w_i[:, n_live:].any()
    assert not got_f[:, n_live:].any() and not rec_box[:, n_live:].any()
    return got


def test_gate_frame_matches_jax():
    """The gate frame: 28,928 setup rows, 73 valid, 2,527 pairs at its
    16,384-column budget."""
    case, su = _gate()
    p = case.settings.max_pairs
    assert p == 16_384
    got = _check_against_jax(su, case, p)
    assert su.valid.shape[0] == 28_928 and int(su.valid.sum()) == 73
    assert int(got[5]["pairs_total"]) == 2_527


@pytest.mark.parametrize("frame", GATE_FRAMES[1:])
def test_gate_orbit_frames_match_jax(frame):
    """Phase 29's other two gate frames, at the Renderer's pair budget."""
    case, su = _gate(frame)
    got = _check_against_jax(su, case, case.settings.max_pairs)
    assert int(su.valid.sum()) > 0 and int(got[5]["pairs_total"]) > 0


def test_gate_slab_from_its_middle_row_matches_jax():
    """The slab of tile rows from the gate frame's middle one to its last
    (``tile_row0`` > 0): rows clamped to the window, tiles counted from
    its first row."""
    case, su = _gate()
    rows = case.cfg.grid_h
    got = _check_against_jax(su, case, case.settings.max_pairs, rows // 2,
                             rows - rows // 2)
    assert got[3].shape == ((rows - rows // 2) * case.cfg.grid_w,)
    assert int(got[4].sum()) > 500


@pytest.mark.parametrize("budget, split", [(128, False), (100, True)])
def test_gate_budget_cuts(budget, split):
    """Phase 29's two cuts of the gate frame's pairs: 128 ends on the last
    pair of the third triangle with pairs (46 + 42 + 40), 100 splits that
    triangle's rectangle after 12 of its 40 pairs, row-major."""
    case, su = _gate()
    full = binning.bin_triangles_plain(su, case.cfg, 1 << 14)
    got = _check_against_jax(su, case, budget)
    assert int(got[5]["pairs_overflow"]) == (int(full[5]["pairs_total"])
                                             - budget)
    ids = got[0][12].numpy()[:budget]
    last = int(ids.max())
    n_last = int((full[0][12].numpy()[: int(full[4].sum())] == last).sum())
    assert (int((ids == last).sum()) < n_last) == split
    assert n_last == 40 and int((ids == last).sum()) == (12 if split else 40)


@pytest.mark.parametrize("tile_row0, tile_rows", [(0, 1), (37, 1), (5, 3)])
def test_gate_slabs_match_jax(tile_row0, tile_rows):
    """Slabs of the gate frame's 38 tile rows: its first and last alone
    and three inside."""
    case, su = _gate()
    assert case.cfg.grid_h == 38
    got = _check_against_jax(su, case, case.settings.max_pairs, tile_row0,
                             tile_rows)
    assert got[3].shape == (tile_rows * case.cfg.grid_w,)


@pytest.mark.parametrize("budget", [1, 46, 47, 87, 88, 89, 2_526, 2_527])
def test_gate_budget_cut_edges(budget):
    """The budget cut at a rectangle's edges: a row keeps its first
    min(max(budget - offset, 0), count) pairs, row-major, where offset
    is the pairs of the rows before it (46 + 42 + ... at orbit frame 0:
    1, 47 and 89 cut a rectangle after its first pair, 46 and 88 end on
    one, 87 one pair short of it, 2,526 drops the last of the frame's
    2,527 and 2,527 cuts nothing)."""
    case, su = _gate()
    full = binning.bin_triangles_plain(su, case.cfg, 1 << 14)
    got = _check_against_jax(su, case, budget)
    all_ids = full[0][12].numpy()[: int(full[4].sum())]
    rows, counts = np.unique(all_ids, return_counts=True)
    offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want = np.minimum(np.maximum(budget - offset, 0), counts)
    ids = got[0][12].numpy()[:budget]
    kept = np.array([(ids == r).sum() for r in rows])
    np.testing.assert_array_equal(kept, want)
    assert int(got[5]["pairs_overflow"]) == 2_527 - budget
    assert list(counts[:2]) == [46, 42]


@pytest.mark.parametrize("delta", [-1, 0, 1, binning.ROWS_PER_CHUNK])
def test_table_at_a_k12_chunk_edge_matches_jax(delta):
    """The gate frame's table padded with dead rows to one row either
    side of a chunk edge of K12's row steps (57 chunks of 512: 29,184
    rows) and a chunk past it; the same records."""
    case, su = _gate()
    s_rows = 57 * binning.ROWS_PER_CHUNK + delta
    assert s_rows > su.valid.shape[0]
    got = _check_against_jax(_padded(su, s_rows), case,
                             case.settings.max_pairs)
    assert int(got[5]["pairs_total"]) == 2_527


@pytest.mark.parametrize("s_rows", [0, 7 * 4096])
def test_zero_triangles(s_rows):
    """Zero triangles: S = 0 (a clip budget of 0) and 28,672 dead clip
    rows (the default budget); no pair, every column zero.  The JAX
    package's bin_triangles gathers from the rows, so S = 0 is held to the
    plain version's own all-zero outputs."""
    case, su = _gate()
    dead = _padded(_padded(su, 0), s_rows)
    p = case.settings.max_pairs
    if s_rows:
        got = _check_against_jax(dead, case, p)
    else:
        got = binning.bin_triangles_plain(dead, case.cfg, p)
    rec_i, rec_f, rec_box, start, count, stats = got
    assert (int(stats["pairs_total"]), int(stats["pairs_overflow"])) == (0, 0)
    assert not rec_i.any() and not rec_box.any() and not count.any()
    assert not start.any() and not rec_f.numpy().view(np.int32).any()
