"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py):
small seeded scenes, and the JAX reference's front stages run on them
(Pallas kernels in interpret mode), returned as numpy arrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from ash_renderer_tpu import (
    Camera,
    Mesh,
    RendererSettings,
    Scene,
    SceneObject,
    derive_raster_config,
    mathx,
)
from ash_renderer_tpu.oracle.raster_cpu import compose_mvp

F32 = np.float32


def rand_scene(seed, nv, nt, spread, zoff=3.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(F32)
    pos[:, 2] += zoff
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(F32),
    )
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    return sc


def graze_scene():
    """A unit icosphere just in front of the camera: live clip fans, wide
    keys with pair expansion, and fine runs in one frame."""
    from ash_renderer_tpu_torch.models import icosphere

    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(icosphere(2)),
                              model=mathx.translation([0, 0, 1.02])))
    return sc


def textured_scene():
    """Textured, lit, specular icosphere (the headline's shading chain)."""
    from ash_renderer_tpu import DirectionalLight, Material
    from ash_renderer_tpu_torch.models import icosphere
    from ash_renderer_tpu_torch.textures import TextureAtlas, checkerboard

    sc = Scene(
        materials=[Material(texture_id=0, specular=0.4, shininess=32)],
        light=DirectionalLight(direction=(0.3, -0.6, 0.74), ambient=0.15),
    )
    sc.atlas = TextureAtlas.build([checkerboard(64)])
    sc.add_object(SceneObject(mesh=sc.add_mesh(icosphere(2)),
                              model=mathx.translation([0, 0, 3])))
    return sc


# name -> (scene builder, settings)
SCENES = {
    "random": (lambda: rand_scene(13, 150, 220, 2.0),
               RendererSettings(width=192, height=128, clip_budget=128)),
    "near_plane": (lambda: rand_scene(2, 170, 300, 8.0, zoff=2.5),
                   RendererSettings(width=192, height=128, clip_budget=128)),
    "graze": (graze_scene, RendererSettings(
        width=192, height=128, clip_budget=512,
        wide_rows=1 << 10, wide_pairs=1 << 13)),
    # both budgets overflow: clip candidates past clip_budget are dropped,
    # wide rows past wide_rows / wide_pairs stay in the global wide run
    "overflow": (graze_scene, RendererSettings(
        width=192, height=128, clip_budget=8, wide_rows=2, wide_pairs=16)),
    "textured": (textured_scene,
                 RendererSettings(width=192, height=128, clip_budget=128)),
    # 4x SSAA resolve + the sRGB LUT on the pack
    "ssaa_srgb": (textured_scene, RendererSettings(
        width=96, height=64, supersample=2, srgb_output=True,
        clip_budget=128)),
}


@dataclasses.dataclass
class Case:
    scene: object
    settings: object
    packed: object
    cfg: object
    cam: object
    mm: np.ndarray
    mvp: np.ndarray
    view: np.ndarray
    proj: np.ndarray


def make_case(name, cam=None):
    build, settings = SCENES[name]
    return case_from(build(), settings, cam)


def case_from(scene, settings, cam=None):
    cam = cam or Camera()
    w, h = settings.render_width, settings.render_height
    view = cam.view_matrix()
    proj = cam.projection_matrix(w / h)
    mm = scene.model_matrices()
    return Case(
        scene=scene, settings=settings, packed=scene.pack(meshlets=True),
        cfg=derive_raster_config(w, h, tile_h=8), cam=cam, mm=mm,
        mvp=compose_mvp(mm, view, proj), view=view, proj=proj,
    )


def jax_statics(case):
    from ash_renderer_tpu.pipeline import FrameStatics

    return FrameStatics(
        cfg=case.cfg, settings=case.settings, has_materials=True,
        has_atlas=case.scene.atlas is not None,
        has_light=case.scene.light is not None, interpret=True,
    )


def jax_front(case, setup_only=False):
    """The reference's front stages on ``case`` (numpy outputs); with
    setup_only, just the vertex transform and the setup kernel."""
    from ash_renderer_tpu import pipeline
    from ash_renderer_tpu.ops import geometry, setup_kernel

    p = case.packed
    statics = jax_statics(case)
    tri_mat = p.obj_material[np.clip(p.tri_obj, 0, len(p.obj_material) - 1)]
    ltT, matT = setup_kernel.prep_static(p.local_tri, tri_mat, p.tri_v[:, 0] >= 0)
    tblT = setup_kernel.transform_vertices_T(
        jnp.asarray(p.positions), jnp.asarray(p.vert_obj),
        jnp.asarray(p.normals), jnp.asarray(p.colors), jnp.asarray(p.uvs),
        jnp.asarray(case.mm), jnp.asarray(case.mvp),
    )
    ntail = case.settings.clip_budget * geometry.MAX_CLIP_TRIS
    comb, keys_main, flags, extx, exty = setup_kernel.triangle_setup(
        tblT, jnp.asarray(ltT), jnp.asarray(matT), case.cfg, interpret=True,
        tail_rows=ntail,
    )
    out = dict(tblT=tblT, comb_main=comb, keys_main=keys_main, flags=flags,
               extx=extx, exty=exty)
    out = {k: np.asarray(v) for k, v in out.items()}
    if setup_only:
        return out
    # the reference's own stage jits (the tail one donates comb)
    comb, keys_tail, gstats = pipeline._fstage_tail(
        statics, tblT, jnp.asarray(p.tri_v), jnp.asarray(tri_mat), flags, comb
    )
    rmeta, tbl_sorted, tbl_ext, sstats = pipeline._fstage_sort(
        statics, comb, keys_main, keys_tail
    )
    keys = jnp.concatenate([keys_main, keys_tail])
    out.update({k: np.asarray(v) for k, v in dict(
        comb=comb, keys_tail=keys_tail, keys=keys, rmeta=rmeta,
        tbl_sorted=tbl_sorted, tbl_ext=tbl_ext).items()})
    out["stats"] = {k: int(v) for k, v in {**gstats, **sstats}.items()}
    return out


def t(a, dtype=None):
    """numpy -> CPU tensor (copy)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def port_state(case):
    from ash_renderer_tpu_torch import state

    sc = case.scene
    return state.upload(case.packed, sc.materials, sc.atlas, sc.light,
                        torch.device("cpu"))


def port_statics(case):
    from ash_renderer_tpu_torch.pipeline import FrameStatics

    return FrameStatics(
        cfg=case.cfg, settings=case.settings,
        has_atlas=case.scene.atlas is not None,
        has_light=case.scene.light is not None,
    )
