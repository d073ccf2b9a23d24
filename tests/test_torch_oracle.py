"""The port's numpy oracle (``ash_renderer_tpu_torch/oracle``) against the
JAX package's, bit for bit: every ``geometry_oracle`` field and the
combined attributes, ``visibility_oracle``, ``render_oracle`` (float RGBA
bits and RGBA8) and, on the tiny scenes, ``visibility_scalar``.  Scenes:
those of tests/test_oracle.py (reference scene, single triangle, shared
edge, depth tie, near clip, guard band) and the textured, lit and
SSAA + sRGB parity cases.  The huge-uv case is held to the JAX oracle
(whose casts are numpy's), not to the device.  An AST check keeps the
oracle free of jax and of the port's torch code."""

import ast
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import (Camera, Mesh, RendererSettings, Scene,  # noqa: E402
                              SceneObject, reference_two_triangle_scene)
from ash_renderer_tpu_torch.config import derive_raster_config  # noqa: E402
from ash_renderer_tpu_torch.oracle import raster_cpu, scalar_ref  # noqa: E402
from ash_renderer_tpu_torch.scene import scene_from_reference  # noqa: E402

torch.set_num_threads(1)

EYE = np.eye(4, dtype=np.float32)


def _ndc_scene(pts2d, w, h, depth=0.5):
    """tests/test_oracle.py's one-triangle scene at exact NDC coords."""
    pts = np.asarray(pts2d, dtype=np.float32)
    ndc = np.stack([pts[:, 0] / w * 2.0 - 1.0, pts[:, 1] / h * 2.0 - 1.0,
                    np.full(len(pts), depth, np.float32)], axis=1)
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=ndc, indices=np.arange(len(pts), dtype=np.int32).reshape(-1, 3)))))
    return sc


def _shared_edge():
    pts = [(8, 8), (8, 40), (40, 8), (40, 40)]
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=np.array([[p[0] / 64 * 2 - 1, p[1] / 64 * 2 - 1, 0.5]
                            for p in pts], np.float32),
        indices=np.array([[0, 1, 2], [2, 1, 3]], np.int32)))))
    return sc


def _depth_tie():
    sc = Scene()
    for _ in range(2):
        sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
            positions=np.array([[-0.5, -0.5, 0.5], [-0.5, 0.5, 0.5],
                                [0.5, -0.5, 0.5]], np.float32),
            indices=np.array([[0, 1, 2]], np.int32)))))
    return sc


def _near_clip():
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=np.array([[-1.0, 1.0, 2.0], [1.0, 1.0, 2.0],
                            [0.0, -1.0, -1.0]], np.float32),
        indices=np.array([[0, 1, 2]], np.int32)))))
    return sc


# name -> (scene builder, width, height, camera or None for identity
# view / projection, run the scalar reference too)
SIMPLE = {
    "reference": (reference_two_triangle_scene, 800, 600, Camera(), False),
    "single_triangle": (lambda: _ndc_scene([(10, 10), (10, 50), (50, 10)], 64, 64),
                        64, 64, None, True),
    "shared_edge": (_shared_edge, 64, 64, None, True),
    "depth_tie": (_depth_tie, 64, 64, None, True),
    "near_clip": (_near_clip, 128, 128, Camera(), False),
    "guard_band": (lambda: _ndc_scene([(-10, 10), (-10, 50), (30, 10)], 64, 64),
                   64, 64, None, True),
}


def _check_oracles(packed, ref_packed, mm, view, proj, settings, ref_settings,
                   cfg, ref_cfg, shading=(None, None, None), cam_pos=None,
                   scalar=False):
    from ash_renderer_tpu.oracle import render_oracle as ref_render
    from ash_renderer_tpu.oracle.scalar_ref import visibility_scalar as ref_scalar

    mats, atlas, light = shading
    got = raster_cpu.render_oracle(packed, mm, view, proj, settings,
                                   materials=mats, atlas=atlas, light=light,
                                   camera_pos=cam_pos, cfg=cfg)
    want = ref_render(ref_packed, mm, view, proj, ref_settings,
                      materials=mats, atlas=atlas, light=light,
                      camera_pos=cam_pos, cfg=ref_cfg)
    for f in dataclasses.fields(got["setup"]):
        a, b = getattr(got["setup"], f.name), getattr(want["setup"], f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(got["attrs"].view(np.int32),
                                  want["attrs"].view(np.int32))
    vd, vt = raster_cpu.visibility_oracle(got["setup"], cfg)
    np.testing.assert_array_equal(vd, want["vis_d16"])
    np.testing.assert_array_equal(vt, want["vis_tri"])
    np.testing.assert_array_equal(got["vis_d16"], want["vis_d16"])
    np.testing.assert_array_equal(got["vis_tri"], want["vis_tri"])
    np.testing.assert_array_equal(got["rgba"].view(np.int32),
                                  want["rgba"].view(np.int32))
    np.testing.assert_array_equal(got["rgba8"], want["rgba8"])
    if scalar:
        sd, st = scalar_ref.visibility_scalar(got["setup"], cfg)
        wd, wt = ref_scalar(want["setup"], ref_cfg)
        np.testing.assert_array_equal(sd, wd)
        np.testing.assert_array_equal(st, wt)
        np.testing.assert_array_equal(st, got["vis_tri"])
    return got


@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_oracle_matches_jax_on_oracle_scenes(name):
    from ash_renderer_tpu import derive_raster_config as ref_cfg_of

    build, w, h, cam, scalar = SIMPLE[name]
    ref_scene = build()
    scene = scene_from_reference(ref_scene)
    view = EYE if cam is None else cam.view_matrix()
    proj = EYE if cam is None else cam.projection_matrix(w / h)
    ref_settings = RendererSettings(width=w, height=h)
    got = _check_oracles(
        scene.pack(), ref_scene.pack(), ref_scene.model_matrices(), view, proj,
        tp.port_settings(ref_settings), ref_settings,
        derive_raster_config(w, h), ref_cfg_of(w, h), scalar=scalar)
    assert (got["vis_tri"] >= 0).any()


@pytest.mark.parametrize("name", ["textured", "config3", "ssaa_srgb",
                                  "huge_uv_on"])
def test_oracle_matches_jax_on_parity_cases(name):
    case = tp.make_case(name)
    with np.errstate(invalid="ignore"):  # huge_uv: numpy's out-of-range cast
        got = _check_oracles(
            case.packed, case.ref_packed, case.mm, case.view, case.proj,
            case.settings, case.ref_settings, case.cfg, case.ref_cfg,
            shading=tp.jax_shading(case),
            cam_pos=case.cam.position.astype(np.float32))
    assert int((got["vis_tri"] >= 0).sum()) > 500


def test_compose_mvp_is_the_oracles():
    """The Renderer composes MVPs with the oracle's one function."""
    from ash_renderer_tpu.oracle.raster_cpu import compose_mvp as ref_mvp
    from ash_renderer_tpu_torch import renderer

    assert renderer.compose_mvp is raster_cpu.compose_mvp
    cam = Camera()
    mm = np.stack([np.eye(4, dtype=np.float32) * 1.5, EYE])
    np.testing.assert_array_equal(
        raster_cpu.compose_mvp(mm, cam.view_matrix(), cam.projection_matrix(1.5)),
        ref_mvp(mm, cam.view_matrix(), cam.projection_matrix(1.5)))


# the port modules the oracle may import: host data types and tables; the
# port's torch arithmetic (ops/, specmath, pipeline, renderer, state) is
# what it checks, so it must not use it
ORACLE_MAY_IMPORT = {"config", "rtypes", "scene", "textures"}


def test_oracle_imports_neither_jax_nor_the_ports_torch_code():
    pkg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "ash_renderer_tpu_torch", "oracle")
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert {"raster_cpu.py", "scalar_ref.py", "shade_np.py",
            "specmath_np.py", "__init__.py"} <= set(files)
    bad = []
    for f in files:
        with open(os.path.join(pkg, f)) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
                bad += [f"{f}: import {n}" for n in names
                        if n.split(".")[0] not in ("numpy",)]
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level == 0:
                    if mod.split(".")[0] not in ("numpy", "__future__"):
                        bad.append(f"{f}: from {mod}")
                elif node.level == 2:  # the port package
                    if mod.split(".")[0] not in ORACLE_MAY_IMPORT:
                        bad.append(f"{f}: from ..{mod}")
                elif node.level == 1:  # inside oracle/
                    names = [mod] if mod else [a.name for a in node.names]
                    bad += [f"{f}: from .{n}" for n in names if n not in (
                        "raster_cpu", "scalar_ref", "shade_np", "specmath_np")]
                else:
                    bad.append(f"{f}: relative import level {node.level}")
    assert not bad, bad
