"""The port's vertex stage and triangle setup (K1's plain version) against
the reference's transform_vertices_T and Pallas setup kernel (interpret
mode), bit for bit; and the port's device state against the JAX
Renderer's buffers."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch.ops import geometry, setup_kernel  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["random", "near_plane", "graze", "textured"])
def test_setup_matches_reference(name):
    case = tp.make_case(name)
    ref = tp.jax_front(case, setup_only=True)
    st = tp.port_state(case)
    tblT = setup_kernel.transform_vertices_T(
        st.positions, st.vert_obj, st.normals, st.colors, st.uvs,
        tp.t(case.mm), tp.t(case.mvp),
    )
    np.testing.assert_array_equal(tblT.numpy(), ref["tblT"])
    ntail = case.settings.clip_budget * geometry.MAX_CLIP_TRIS
    comb, keys, flags, extx, exty = setup_kernel.triangle_setup(
        tblT, st.ltT, st.matT, case.cfg, tail_rows=ntail
    )
    t = st.ltT.shape[0] * 128
    assert comb.shape == ref["comb_main"].shape
    np.testing.assert_array_equal(comb[:t].numpy(), ref["comb_main"][:t])
    np.testing.assert_array_equal(keys.numpy(), ref["keys_main"])
    np.testing.assert_array_equal(flags.numpy(), ref["flags"])
    np.testing.assert_array_equal(extx.numpy(), ref["extx"])
    np.testing.assert_array_equal(exty.numpy(), ref["exty"])
    assert int(((flags & 3) != 0).sum()) > 3, "want a live scene"
    if name in ("near_plane", "graze"):
        assert int(((flags >> 1) & 1).sum()) > 0, "want clip candidates"


def test_setup_wrapper_takes_the_kernel_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    case = tp.make_case("random")
    st = tp.port_state(case)
    meta = torch.empty((16, st.ltT.shape[0] * 128), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        setup_kernel.triangle_setup(meta, st.ltT, st.matT, case.cfg)


def test_state_matches_jax_renderer_buffers():
    """state.upload hands the port the same bits the JAX Renderer uploads."""
    import dataclasses

    from ash_renderer_tpu.renderer import Renderer as JaxRenderer

    from ash_renderer_tpu.textures import TextureAtlas

    case = tp.make_case("textured")
    assert isinstance(case.ref_scene.atlas, TextureAtlas)  # JAX pytree
    settings = dataclasses.replace(case.ref_settings, pipeline="fused")
    jr = JaxRenderer(case.ref_scene, settings, interpret=True)
    st = tp.port_state(case)
    for k in ("positions", "vert_obj", "normals", "colors", "uvs", "tri_v",
              "tri_mat", "ltT", "matT"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(jr._buffers[k]), err_msg=k)
        assert getattr(st, k).dtype == tp.t(np.asarray(jr._buffers[k])).dtype
    for group, jax_group in ((st.materials, jr.materials),
                             (st.atlas, jr.atlas), (st.light, jr.light)):
        for f in dataclasses.fields(group):
            np.testing.assert_array_equal(
                getattr(group, f.name).numpy(),
                np.asarray(getattr(jax_group, f.name)), err_msg=f.name,
            )
