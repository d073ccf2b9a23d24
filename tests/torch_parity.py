"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py):
small seeded scenes, and the JAX reference's front stages run on them
(Pallas kernels in interpret mode), returned as numpy arrays.

Each case is built once with the JAX package and carried across into the
port's own types (``scene_from_reference`` and friends): ``Case.scene``,
``settings``, ``cam``, ``packed`` and ``cfg`` are the port's, ``ref_*`` the
JAX package's, and the matrices are numpy arrays both take."""

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
    from ash_renderer_tpu.models import icosphere

    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(icosphere(2)),
                              model=mathx.translation([0, 0, 1.02])))
    return sc


def textured_scene():
    """Textured, lit, specular icosphere (the headline's shading chain)."""
    from ash_renderer_tpu import DirectionalLight, Material
    from ash_renderer_tpu.models import icosphere
    from ash_renderer_tpu.textures import TextureAtlas, checkerboard

    sc = Scene(
        materials=[Material(texture_id=0, specular=0.4, shininess=32)],
        light=DirectionalLight(direction=(0.3, -0.6, 0.74), ambient=0.15),
    )
    sc.atlas = TextureAtlas.build([checkerboard(64)])
    sc.add_object(SceneObject(mesh=sc.add_mesh(icosphere(2)),
                              model=mathx.translation([0, 0, 3])))
    return sc


def config3_scene():
    """config3_blinn_phong's scene (ash_renderer_tpu/benchmarks.py): an
    untextured, lit, specular icosphere of 5,120 triangles."""
    from ash_renderer_tpu.benchmarks import config3_blinn_phong

    return config3_blinn_phong()[0]


def two_texture_scene(uv_scale=2.0):
    """Two textured materials on two instances of one random lit mesh (the
    T=2 phase F case of tests/test_fused.py), uvs in [0, uv_scale)."""
    from ash_renderer_tpu import DirectionalLight, Material
    from ash_renderer_tpu.textures import TextureAtlas, checkerboard

    rng = np.random.default_rng(17)
    nv, nt = 90, 70
    pos = rng.uniform(-1.5, 1.5, (nv, 3)).astype(F32)
    pos[:, 2] += 3.0
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0.2, 1, (nv, 4)).astype(F32),
        uvs=rng.uniform(0, uv_scale, (nv, 2)).astype(F32),
    ).compute_normals()
    sc = Scene(
        materials=[Material(texture_id=0, specular=0.5, shininess=32),
                   Material(texture_id=1, specular=0.2, shininess=8)],
        light=DirectionalLight(direction=(0.4, -0.6, 0.7), ambient=0.2),
    )
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh), material=0))
    sc.add_object(SceneObject(mesh=0, material=1,
                              model=mathx.rotation_y(0.3)))
    sc.atlas = TextureAtlas.build([checkerboard(64), checkerboard(32)])
    return sc


def huge_uv_scene():
    """A textured, lit icosphere whose uvs are the constants (3e9, -5e9):
    u * w and v * h are past 2**31 at every mip level, so the float ->
    int32 tap casts saturate."""
    from ash_renderer_tpu import DirectionalLight, Material
    from ash_renderer_tpu.models import icosphere
    from ash_renderer_tpu.textures import TextureAtlas, checkerboard

    mesh = icosphere(2)
    mesh.uvs = np.tile(np.array([[3e9, -5e9]], F32), (mesh.num_vertices, 1))
    sc = Scene(
        materials=[Material(texture_id=0, specular=0.4, shininess=32)],
        light=DirectionalLight(direction=(0.3, -0.6, 0.74), ambient=0.15),
    )
    sc.atlas = TextureAtlas.build([checkerboard(512)])
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh),
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
    # phase F cases: "auto" sends the untextured config3 scene to phase F,
    # "on" the textured ones
    "config3": (config3_scene, RendererSettings(
        width=192, height=128, clip_budget=128)),
    "textured_on": (textured_scene, RendererSettings(
        width=192, height=128, clip_budget=128, fused_surface_shade="on")),
    "two_textures_on": (two_texture_scene, RendererSettings(
        width=96, height=64, supersample=2, clip_budget=64,
        fused_surface_shade="on")),
    "huge_uv_on": (huge_uv_scene, RendererSettings(
        width=128, height=96, clip_budget=64, fused_surface_shade="on")),
}


def _random_mesh(seed, nv, nt, spread, zoff):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(F32)
    pos[:, 2] += zoff
    return rng, pos, rng.integers(0, nv, (nt, 3)).astype(np.int32)


def _parity_random(seed, nv, nt, spread, zoff):
    rng, pos, idx = _random_mesh(seed, nv, nt, spread, zoff)
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(Mesh(
        positions=pos, indices=idx,
        colors=rng.uniform(0, 1, (nv, 4)).astype(F32)))))
    return sc


def _parity_lit_textured():
    from ash_renderer_tpu import DirectionalLight, Material
    from ash_renderer_tpu.textures import TextureAtlas, checkerboard

    rng, pos, idx = _random_mesh(8, 64, 48, 1.5, 3.0)
    mesh = Mesh(positions=pos, indices=idx,
                colors=rng.uniform(0.2, 1, (64, 4)).astype(F32),
                uvs=rng.uniform(0, 2, (64, 2)).astype(F32)).compute_normals()
    sc = Scene(materials=[Material(texture_id=0, specular=0.5, shininess=32)],
               light=DirectionalLight(direction=(0.4, -0.6, 0.7), ambient=0.2))
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    sc.atlas = TextureAtlas.build([checkerboard(64)])
    return sc


def _parity_multi_object():
    rng = np.random.default_rng(10)
    quad = Mesh(
        positions=np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], F32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        colors=rng.uniform(0, 1, (4, 4)).astype(F32),
    )
    sc = Scene()
    mi = sc.add_mesh(quad)
    for i in range(5):
        sc.add_object(SceneObject(mesh=mi, model=mathx.compose(
            mathx.translation([0.3 * i - 0.6, 0.2 * i - 0.4, 2.5 + 0.5 * i]),
            mathx.rotation_z(0.3 * i))))
    return sc


def _reference_scene():
    from ash_renderer_tpu import reference_two_triangle_scene

    return reference_two_triangle_scene()


# The scenes of tests/test_pipeline_parity.py (the same seeds and sizes),
# for the classic pipeline: name -> (scene builder, settings, meshlets)
CLASSIC_SCENES = {
    "reference": (_reference_scene, RendererSettings(width=256, height=192),
                  False),
    "random": (lambda: _parity_random(5, 100, 80, 2.0, 3.5),
               RendererSettings(width=160, height=96), False),
    "clip_heavy": (lambda: _parity_random(6, 60, 50, 4.0, 0.8),
                   RendererSettings(width=128, height=64), False),
    "lit_textured_ssaa": (_parity_lit_textured,
                          RendererSettings(width=96, height=64, supersample=2),
                          False),
    "multi_object": (_parity_multi_object,
                     RendererSettings(width=144, height=112), False),
    "meshlets": (lambda: _parity_random(77, 120, 200, 2.0, 3.0),
                 RendererSettings(width=160, height=96), True),
}


@dataclasses.dataclass
class Case:
    scene: object  # the port's, carried across from ref_scene
    settings: object
    packed: object
    cfg: object
    cam: object
    mm: np.ndarray
    mvp: np.ndarray
    view: np.ndarray
    proj: np.ndarray
    ref_scene: object  # the JAX package's
    ref_settings: object
    ref_packed: object
    ref_cfg: object
    ref_cam: object


def make_case(name, cam=None):
    build, settings = SCENES[name]
    return case_from(build(), settings, cam)


def port_settings(settings):
    """The port's RendererSettings with the same fields as ``settings``."""
    from ash_renderer_tpu_torch.config import RendererSettings as PortSettings

    return PortSettings(**dataclasses.asdict(settings))


def port_camera(cam):
    from ash_renderer_tpu_torch.camera import Camera as PortCamera

    return PortCamera(**{f.name: getattr(cam, f.name)
                         for f in dataclasses.fields(cam)})


def case_from(scene, settings, cam=None, meshlets=True, tile_h=8):
    """A case from a JAX-package scene, settings and camera, carried across
    into the port's types.  The defaults are the fused pipeline's packing
    and tiles; the classic pipeline's are ``meshlets=False, tile_h=16``
    (``classic_case``)."""
    from ash_renderer_tpu_torch.config import derive_raster_config as port_cfg
    from ash_renderer_tpu_torch.scene import scene_from_reference

    cam = cam or Camera()
    w, h = settings.render_width, settings.render_height
    view = cam.view_matrix()
    proj = cam.projection_matrix(w / h)
    mm = scene.model_matrices()
    pscene = scene_from_reference(scene)
    return Case(
        scene=pscene, settings=port_settings(settings),
        packed=pscene.pack(meshlets=meshlets), cfg=port_cfg(w, h, tile_h=tile_h),
        cam=port_camera(cam), mm=mm, mvp=compose_mvp(mm, view, proj),
        view=view, proj=proj, ref_scene=scene, ref_settings=settings,
        ref_packed=scene.pack(meshlets=meshlets),
        ref_cfg=derive_raster_config(w, h, tile_h=tile_h), ref_cam=cam,
    )


def classic_case(scene, settings, cam=None, meshlets=False):
    """case_from with the classic pipeline's 16-row tiles; plain packing
    unless ``meshlets`` (the classic frame of a meshlet-packed scene, whose
    corner gather takes kernel K5)."""
    from ash_renderer_tpu_torch.ops.raster_visibility import TILE_H

    return case_from(scene, settings, cam, meshlets=meshlets, tile_h=TILE_H)


def fused(settings):
    """``settings`` with the fused pipeline named: the tests of the fused
    route use it on scenes that "auto" sends to the classic pipeline."""
    return dataclasses.replace(settings, pipeline="fused")


def jax_statics(case):
    from ash_renderer_tpu.pipeline import FrameStatics

    return FrameStatics(
        cfg=case.ref_cfg, settings=case.ref_settings, has_materials=True,
        has_atlas=case.ref_scene.atlas is not None,
        has_light=case.ref_scene.light is not None, interpret=True,
    )


def jax_shading(case):
    """The JAX package's (materials, atlas, light) packs of the case, as
    its Renderer builds them (numpy fields)."""
    from ash_renderer_tpu.rtypes import LightPack, MaterialsPack
    from ash_renderer_tpu.textures import TextureAtlas

    sc = case.ref_scene
    mats = MaterialsPack(
        base_color=np.array([m.base_color for m in sc.materials], np.float32),
        tex_id=np.array([m.texture_id for m in sc.materials], np.int32),
        specular=np.array([m.specular for m in sc.materials], np.float32),
        shininess=np.array([m.shininess for m in sc.materials], np.int32),
    )
    atlas = None if sc.atlas is None else TextureAtlas(**{
        f.name: np.asarray(getattr(sc.atlas, f.name))
        for f in dataclasses.fields(TextureAtlas)
    })
    light = None if sc.light is None else LightPack(
        direction=np.asarray(sc.light.direction, np.float32),
        color=np.asarray(sc.light.color, np.float32),
        ambient=np.float32(sc.light.ambient),
    )
    return mats, atlas, light


def jax_front(case, setup_only=False):
    """The reference's front stages on ``case`` (numpy outputs); with
    setup_only, just the vertex transform and the setup kernel."""
    from ash_renderer_tpu import pipeline
    from ash_renderer_tpu.ops import geometry, setup_kernel

    p = case.ref_packed
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
        tblT, jnp.asarray(ltT), jnp.asarray(matT), case.ref_cfg,
        interpret=True, tail_rows=ntail,
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


def shade_inputs(case):
    """(port shade mode, port consts, JAX shade kwargs) for the case; the
    two packages' shade_mode_for must agree."""
    from ash_renderer_tpu.pipeline import shade_mode_for as ref_mode_for
    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.ops import shade

    st = port_state(case)
    statics = port_statics(case)
    atlas = st.atlas if statics.has_atlas else None
    light = st.light if statics.has_light else None
    smode = pipeline.shade_mode_for(statics, st.materials, atlas, light)
    mats, ratlas, rlight = jax_shading(case)
    want_mode = ref_mode_for(jax_statics(case), mats, ratlas, rlight)
    assert smode == want_mode
    cam_pos = case.cam.position.astype(np.float32)
    consts = shade.pack_shade_consts(smode, st.materials, atlas, light,
                                     torch.from_numpy(cam_pos))
    ref_kw = dict(shade_mode=want_mode, materials=mats, atlas=ratlas,
                  light=rlight, camera_pos=jnp.asarray(cam_pos))
    return smode, consts, ref_kw


def _flush(bits):
    """int32 float bits with each subnormal (exponent bits 0, mantissa not
    0) mapped to the zero of its sign; every other value, -0 and +0
    included, keeps its bits."""
    sub = ((bits & 0x7F800000) == 0) & ((bits & 0x007FFFFF) != 0)
    return np.where(sub, bits & np.int32(-2 ** 31), bits)


def compare_f_planes(got, want):
    """Raster outputs with phase F planes against the reference kernel's:
    visibility exactly; rows 0-12 under the validity mask, float rows after
    mapping subnormals to the zero of their sign (XLA on the CPU flushes
    subnormal results such as powi(...) * specular to zero, torch and the
    CUDA kernels keep them, as the numpy oracle does); the zero, id and pad
    rows everywhere.  Returns (planes, valid)."""
    from ash_renderer_tpu_torch.ops import fused_kernel as fk

    float_rows = list(range(fk.F_P, fk.F_SPEC + 1)) + [fk.F_FU, fk.F_FV]
    vis_d, vis_t, planes = (np.asarray(x) for x in got)
    want_d, want_t, want_p = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(vis_t, want_t)
    np.testing.assert_array_equal(vis_d, want_d)
    assert planes.shape == want_p.shape
    valid = want_p[:, fk.VIS_ROW, :] >= 0
    for row in range(fk.F_TEXMASK + 1):
        a, b = planes[:, row][valid], want_p[:, row][valid]
        if row in float_rows:
            a, b = _flush(a), _flush(b)
        np.testing.assert_array_equal(a, b, err_msg=str(row))
    np.testing.assert_array_equal(planes[:, fk.F_TEXMASK + 1:],
                                  want_p[:, fk.F_TEXMASK + 1:])
    return planes, valid


# ---------------------------------------------------------------------------
# Classic frames: the port's, the numpy oracle's and the JAX package's
# ---------------------------------------------------------------------------

CLASSIC_STATS = ("clip_overflow", "n_fast", "n_clipped", "n_valid", "n_setup",
                 "pairs_total", "pairs_overflow")


def classic_parity_case(name):
    build, settings, meshlets = CLASSIC_SCENES[name]
    return classic_case(build(), settings, meshlets=meshlets)


def classic_oracle(case):
    """The numpy oracle's frame of the case's JAX-package scene."""
    from ash_renderer_tpu.oracle import render_oracle

    mats, atlas, light = jax_shading(case)
    return render_oracle(
        case.ref_packed, case.mm, case.view, case.proj, case.ref_settings,
        materials=mats, atlas=atlas, light=light,
        camera_pos=case.ref_cam.position.astype(np.float32), cfg=case.ref_cfg,
    )


def port_classic_frame(case):
    """The port's classic frame of the case, (rgba8 numpy, aux): through
    the Renderer ("auto") for a plainly packed case; through
    pipeline.render_frame with the meshlet-local ids (kernel K5's path) for
    a meshlet-packed one."""
    from ash_renderer_tpu_torch import pipeline
    from ash_renderer_tpu_torch.renderer import Renderer

    if case.packed.local_tri is None:
        r = Renderer(case.scene, case.settings, device="cpu")
        assert r.settings.pipeline == "classic" and r.cfg == case.cfg
        rgba8, aux = r.render_frame(case.cam)
        return r.read_frame(rgba8), aux
    statics = pipeline.FrameStatics(
        cfg=case.cfg, settings=case.settings,
        has_atlas=case.scene.atlas is not None,
        has_light=case.scene.light is not None)
    rgba8, aux = pipeline.render_frame(
        statics, port_state(case), t(case.mm), t(case.mvp),
        torch.from_numpy(case.cam.position.astype(np.float32)),
        local_tri=t(case.packed.local_tri))
    return rgba8.numpy(), aux


def jax_classic_frame(case):
    """The JAX package's classic frame of the case (render_frame_jit, the
    Pallas kernels in interpret mode): (rgba8, aux) as numpy."""
    from ash_renderer_tpu.pipeline import FrameStatics, render_frame_jit

    p = case.ref_packed
    mats, atlas, light = jax_shading(case)
    statics = FrameStatics(
        cfg=case.ref_cfg, settings=case.ref_settings, has_materials=True,
        has_atlas=atlas is not None, has_light=light is not None,
        interpret=True,
    )
    rgba8, aux = render_frame_jit(
        statics,
        jnp.asarray(p.positions), jnp.asarray(p.vert_obj),
        jnp.asarray(p.normals), jnp.asarray(p.colors), jnp.asarray(p.uvs),
        jnp.asarray(p.tri_v), jnp.asarray(p.tri_obj),
        jnp.asarray(p.obj_material), jnp.asarray(case.mm),
        jnp.asarray(case.mvp),
        jnp.asarray(case.ref_cam.position.astype(np.float32)),
        mats, atlas, light,
        None if p.local_tri is None else jnp.asarray(p.local_tri),
    )
    return np.asarray(rgba8), {k: np.asarray(v) for k, v in aux.items()}


def check_classic_frame_against_jax(name):
    """The port's classic frame of CLASSIC_SCENES[name] equals the JAX
    package's: RGBA8, vis_tri, vis_d16 and every counter."""
    case = classic_parity_case(name)
    got, aux = port_classic_frame(case)
    want, jaux = jax_classic_frame(case)
    assert int((jaux["vis_tri"] >= 0).sum()) > 100
    np.testing.assert_array_equal(aux["vis_tri"].numpy(), jaux["vis_tri"])
    np.testing.assert_array_equal(aux["vis_d16"].numpy(), jaux["vis_d16"])
    np.testing.assert_array_equal(got, want)
    for k in CLASSIC_STATS:
        assert int(aux[k]) == int(jaux[k]), k
