"""The port's classic pipeline as a whole on the CPU: frames of the
``Renderer`` ("auto" routes these scenes to classic) and of
``pipeline.render_frame`` with meshlet-local corner ids, against the numpy
oracle on the scenes of tests/test_pipeline_parity.py, config2 at a reduced
size, and the five pinned golden hashes; and the port's copies of the
golden scenes and hashes against the test suite's."""

import dataclasses
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu_torch import benchmarks  # noqa: E402
from ash_renderer_tpu_torch.renderer import Renderer  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(tp.CLASSIC_SCENES))
def test_classic_frame_matches_oracle(name):
    case = tp.classic_parity_case(name)
    got, aux = tp.port_classic_frame(case)
    o = tp.classic_oracle(case)
    assert int((o["vis_tri"] >= 0).sum()) > 100
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), o["vis_tri"])
    np.testing.assert_array_equal(aux["vis_d16"].numpy(), o["vis_d16"])
    np.testing.assert_array_equal(got, o["rgba8"])
    if name == "clip_heavy":
        assert aux["n_clipped"] > 0


@pytest.mark.parametrize("name", sorted(benchmarks.GOLDEN_SCENES))
def test_golden_frame_hash(name):
    """The reference scene and the four feature scenes through the
    Renderer: "auto" routes each to classic, and the frame's sha256 is the
    pinned one."""
    from ash_renderer_tpu_torch.camera import Camera

    scene, settings = benchmarks.GOLDEN_SCENES[name]()
    r = Renderer(scene, settings, device="cpu")
    assert r.settings.pipeline == "classic"
    rgba8, aux = r.render_frame(Camera())
    frame = r.read_frame(rgba8)
    assert frame.shape == (settings.height, settings.width, 4)
    covered = int((aux["vis_tri"] >= 0).sum())
    assert covered == 23328 if name == "reference" else covered > 5000
    assert hashlib.sha256(frame.tobytes()).hexdigest() == benchmarks.GOLDEN_SHA[name]


def test_config2_matches_oracle():
    """config2 (3,500 triangles over 3 meshes, 12 objects) at 200x150:
    "auto" takes classic, and the frame equals the oracle's."""
    from ash_renderer_tpu.benchmarks import config2_multi_mesh

    ref_scene, ref_settings, _ = config2_multi_mesh()
    case = tp.classic_case(ref_scene, dataclasses.replace(
        ref_settings, width=200, height=150))
    got, aux = tp.port_classic_frame(case)
    o = tp.classic_oracle(case)
    assert len(np.unique(o["vis_tri"][o["vis_tri"] >= 0])) > 500
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), o["vis_tri"])
    np.testing.assert_array_equal(got, o["rgba8"])


def _same_scene(port, ref):
    from ash_renderer_tpu_torch.scene import scene_from_reference

    want = scene_from_reference(ref)
    assert [dataclasses.asdict(m) for m in port.materials] == [
        dataclasses.asdict(m) for m in want.materials]
    assert (port.light is None) == (want.light is None)
    if port.light is not None:
        assert dataclasses.asdict(port.light) == dataclasses.asdict(want.light)
    assert (port.atlas is None) == (want.atlas is None)
    if port.atlas is not None:
        for f in dataclasses.fields(port.atlas):
            np.testing.assert_array_equal(getattr(port.atlas, f.name),
                                          getattr(want.atlas, f.name))
    assert len(port.meshes) == len(want.meshes)
    for pm, wm in zip(port.meshes, want.meshes):
        for k in ("positions", "indices", "colors", "normals", "uvs"):
            a, b = getattr(pm, k), getattr(wm, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert [(o.mesh, o.material) for o in port.objects] == [
        (o.mesh, o.material) for o in want.objects]
    np.testing.assert_array_equal(port.model_matrices().view(np.uint8),
                                  want.model_matrices().view(np.uint8))


def test_golden_copies_match_the_suite():
    """benchmarks.GOLDEN_SCENES / GOLDEN_SHA are the suite's golden scenes
    (tests/golden_scenes.py, the reference scene at 320x240) and pinned
    hashes (tests/test_golden_frames.py); config2_multi_mesh is the JAX
    package's."""
    import golden_scenes
    import test_golden_frames

    from ash_renderer_tpu import reference_two_triangle_scene
    from ash_renderer_tpu.benchmarks import config2_multi_mesh

    assert benchmarks.GOLDEN_SHA == {
        "reference": test_golden_frames.GOLDEN_SHA,
        **test_golden_frames.FEATURE_GOLDEN_SHA}
    refs = {"reference": lambda: (reference_two_triangle_scene(),
                                  tp.RendererSettings(width=320, height=240)),
            **golden_scenes.GOLDEN_SCENES}
    assert sorted(refs) == sorted(benchmarks.GOLDEN_SCENES)
    for name, build in refs.items():
        ref_scene, ref_settings = build()
        scene, settings = benchmarks.GOLDEN_SCENES[name]()
        _same_scene(scene, ref_scene)
        assert dataclasses.asdict(settings) == dataclasses.asdict(ref_settings)
    ref_scene, ref_settings, _ = config2_multi_mesh()
    scene, settings, _ = benchmarks.config2_multi_mesh()
    _same_scene(scene, ref_scene)
    assert dataclasses.asdict(settings) == dataclasses.asdict(ref_settings)
    assert sum(m.num_triangles for m in scene.meshes) == 3500
