"""K3's plain version (rasterize_distribute: phases V, D, E) against the
reference's Pallas raster/distribute kernel (interpret mode, shade_mode
None) on the same range metadata and tables: visibility bit for bit, planes
bit for bit on covered pixels and in the material / id / pad rows
everywhere (background attribute rows hold NaNs whose payload is the
device's)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch import pipeline  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel  # noqa: E402

torch.set_num_threads(1)


def jax_rmeta(rmeta):
    """The port's range metadata in the reference's layout, which ends in
    the first tile row of a mesh-sharded slab (0: the whole frame)."""
    return jnp.asarray(np.concatenate([rmeta.numpy(), np.zeros(1, np.int32)]))


@pytest.mark.parametrize("name", ["random", "graze"])
def test_raster_matches_reference_kernel(name):
    from ash_renderer_tpu.ops import fused_kernel as jfk

    case = tp.make_case(name)
    rmeta, tbl_sorted, tbl_ext, comb, stats = pipeline.render_front(
        tp.port_statics(case), tp.port_state(case), tp.t(case.mm),
        tp.t(case.mvp),
    )
    if name == "graze":
        assert stats["n_clipped"] > 0 and stats["wide_pairs_n"] > 0

    def padded(x):  # the reference's DMA windows read up to 256 rows past
        return jnp.asarray(np.concatenate(
            [x.numpy(), np.zeros((256, x.shape[1]), np.int32)]))

    want_d, want_t, want_p = (np.asarray(a) for a in jfk.rasterize_distribute(
        jax_rmeta(rmeta), padded(tbl_sorted), padded(tbl_ext),
        case.ref_cfg, interpret=True,
    ))
    vis_d, vis_t, planes = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, case.cfg
    )
    assert int((want_t >= 0).sum()) > 500
    np.testing.assert_array_equal(vis_t.numpy(), want_t)
    np.testing.assert_array_equal(vis_d.numpy(), want_d)
    planes = planes.numpy()
    assert planes.shape == want_p.shape
    valid = want_p[:, fused_kernel.VIS_ROW, :] >= 0
    for row in range(fused_kernel.VIS_ROW - 1):
        np.testing.assert_array_equal(planes[:, row][valid],
                                      want_p[:, row][valid], err_msg=str(row))
    np.testing.assert_array_equal(planes[:, 16:], want_p[:, 16:])


def _pixel_triangles(tris_px, w, h, depth=3.0):
    """A mesh whose triangles land on the given (x, y) pixel corners (y
    down) under the default camera, each in both windings."""
    from ash_renderer_tpu import Camera, Mesh, Scene, SceneObject

    cam = Camera()
    vp = (cam.projection_matrix(w / h).astype(np.float64)
          @ cam.view_matrix().astype(np.float64))
    c0 = vp @ np.array([0.0, 0.0, depth, 1.0])
    inv = np.linalg.inv(vp)
    pos = []
    for tri in tris_px:
        for (x, y) in tri:
            clip = np.array([(2 * x / w - 1) * c0[3], (2 * y / h - 1) * c0[3],
                             c0[2], c0[3]])
            p = inv @ clip
            pos.append(p[:3] / p[3])
    n = len(tris_px)
    idx = np.arange(3 * n).reshape(n, 3)
    idx = np.concatenate([idx, idx[:, ::-1]])
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=np.array(pos, np.float32), indices=idx.astype(np.int32)))))
    return sc


def test_fine_rows_only_touch_their_window():
    """A frame 150 px wide: the last tile's columns 150-255 are padding.
    Triangles whose clamped pixel box fits one 16-px window (fine keys) but
    whose true extent runs on into the padding are evaluated only inside
    their window, as the reference's packed fine path does, so even the
    padded planes agree."""
    from ash_renderer_tpu import RendererSettings
    from ash_renderer_tpu.ops import fused_kernel as jfk

    tris = [((145.3, 17.2), (162.6, 18.4), (149.1, 22.7)),
            ((146.8, 9.1), (171.2, 11.3), (147.5, 14.6)),
            ((144.6, 1.4), (158.9, 6.2), (148.2, 6.9))]
    case = tp.case_from(_pixel_triangles(tris, 150, 64),
                        RendererSettings(width=150, height=64, clip_budget=64))
    rmeta, tbl_sorted, tbl_ext, comb, _ = pipeline.render_front(
        tp.port_statics(case), tp.port_state(case), tp.t(case.mm),
        tp.t(case.mvp),
    )
    m = rmeta.reshape(-1, fused_kernel.N_RANGES, 2)
    fine = m[:, fused_kernel.FINE_RANGE]
    assert int((fine[:, 1] - fine[:, 0]).sum()) >= 3, "want fine rows"
    pad = np.zeros((256, 128), np.int32)
    want = jfk.rasterize_distribute(
        jax_rmeta(rmeta),
        jnp.asarray(np.concatenate([tbl_sorted.numpy(), pad])),
        jnp.asarray(np.concatenate([tbl_ext.numpy(), pad])),
        case.ref_cfg, interpret=True,
    )
    got = fused_kernel.rasterize_distribute(
        rmeta, tbl_sorted, tbl_ext, comb, case.cfg
    )
    assert int((got[1] >= 0).sum()) > 30
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy()[:, 16:],
                                  np.asarray(want[2])[:, 16:])
