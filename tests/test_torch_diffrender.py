"""Differentiable shading (``diffrender``) against the JAX package's, on the
CPU: the forward image bit for bit, gradients against ``jax.grad`` within
rtol 1e-4 / atol 1e-6 (the two frameworks sum the cotangents of gathered
rows in different orders), the inverse-rendering fit, and the float shade
tables (``shade.pack_shade_consts_f32``) giving phase F the same bits as
the int32 constants alone."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import diffrender as ref_diff  # noqa: E402
from ash_renderer_tpu import specmath as ref_sm  # noqa: E402
from ash_renderer_tpu.config import derive_raster_config as ref_cfg  # noqa: E402
from ash_renderer_tpu.rtypes import LightPack as RefLight  # noqa: E402
from ash_renderer_tpu.rtypes import MaterialsPack as RefMats  # noqa: E402
from ash_renderer_tpu.textures import TextureAtlas as RefAtlas  # noqa: E402
from ash_renderer_tpu_torch import diffrender, mathx, specmath  # noqa: E402
from ash_renderer_tpu_torch.camera import Camera  # noqa: E402
from ash_renderer_tpu_torch.config import derive_raster_config  # noqa: E402
from ash_renderer_tpu_torch.models import icosphere  # noqa: E402
from ash_renderer_tpu_torch.oracle import geometry_oracle, visibility_oracle  # noqa: E402
from ash_renderer_tpu_torch.ops import fused_kernel, shade  # noqa: E402
from ash_renderer_tpu_torch.rtypes import (  # noqa: E402
    LightPack, MaterialsPack, TriangleSetup)
from ash_renderer_tpu_torch.scene import Mesh, Scene, SceneObject  # noqa: E402
from ash_renderer_tpu_torch.textures import TextureAtlas, checkerboard  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-6  # gradients: summation order differs
F32 = np.float32


@dataclasses.dataclass
class DiffCase:
    """One shading problem as numpy arrays, for both packages."""

    su: object  # the port's TriangleSetup of numpy arrays
    attrs: np.ndarray  # (VA, 12) f32
    vis_t: np.ndarray  # (H, W) i32
    size: tuple  # (W, H)
    base: np.ndarray  # (M, 4) f32
    tex_id: np.ndarray  # (M,) i32
    spec: np.ndarray  # (M,) f32
    shin: np.ndarray  # (M,) i32
    light: tuple = None  # (direction, color, ambient) f32 arrays
    camera_pos: np.ndarray = None
    atlas: object = None  # the port's TextureAtlas of numpy arrays


def _geometry(scene, w, h, view, proj, clip_budget):
    cfg = derive_raster_config(w, h)
    su, attrs = geometry_oracle(scene.pack(), scene.model_matrices(), view,
                                proj, cfg, clip_budget)
    _, vis_t = visibility_oracle(su, cfg)
    return su, attrs, vis_t


def _triangle_case(lit=False, textured=False, camera=True):
    """tests/test_diffrender.py's scene (one triangle, 64x64, identity
    view and projection); lit: normals toward the camera, a light, a
    camera position (unless not ``camera``: then no specular term) and a
    specular material; textured: uvs and a checkerboard on the
    material."""
    mesh = Mesh(
        positions=np.array([[-0.8, -0.8, 0.5], [-0.8, 0.8, 0.5],
                            [0.8, -0.8, 0.5]], F32),
        indices=np.array([[0, 1, 2]], np.int32),
        colors=np.array([[0.9, 0.2, 0.1, 1], [0.1, 0.8, 0.3, 1],
                         [0.2, 0.3, 0.9, 1]], F32),
        uvs=np.array([[0.0, 0.0], [0.0, 1.5], [2.0, 0.0]], F32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    eye = np.eye(4, dtype=F32)
    su, attrs, vis_t = _geometry(scene, 64, 64, eye, eye, 16)
    case = DiffCase(su=su, attrs=attrs, vis_t=vis_t, size=(64, 64),
                    base=np.ones((1, 4), F32), tex_id=np.full(1, -1, np.int32),
                    spec=np.zeros(1, F32), shin=np.full(1, 8, np.int32))
    if lit:
        case.attrs = attrs.copy()
        case.attrs[:, 4:7] = [0.1, -0.2, -1.0]
        case.base = np.array([[0.8, 0.7, 0.6, 1.0]], F32)
        case.spec = np.array([0.5], F32)
        case.light = (np.array([0.2, -0.3, 0.9], F32),
                      np.array([1.0, 0.9, 0.8], F32), np.array(0.1, F32))
        if camera:
            case.camera_pos = np.array([0.05, -0.1, -0.5], F32)
    if textured:
        case.tex_id = np.zeros(1, np.int32)
        atlas = RefAtlas.build([checkerboard(16, cells=4)])
        case.atlas = TextureAtlas(**{f.name: np.asarray(getattr(atlas, f.name))
                                     for f in dataclasses.fields(TextureAtlas)})
    return case


def example_case():
    """examples/inverse_rendering.py's scene: an icosphere (subdiv 3) with
    seeded random vertex colours at z = 3, 128x128, the default camera."""
    rng = np.random.default_rng(0)
    mesh = icosphere(3)
    colors = rng.uniform(0.1, 1.0, (mesh.num_vertices, 4)).astype(F32)
    colors[:, 3] = 1.0
    mesh.colors = colors
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh),
                                 model=mathx.translation([0, 0, 3])))
    cam = Camera()
    su, attrs, vis_t = _geometry(scene, 128, 128, cam.view_matrix(),
                                 cam.projection_matrix(1.0), 64)
    return DiffCase(su=su, attrs=attrs, vis_t=vis_t, size=(128, 128),
                    base=np.ones((1, 4), F32), tex_id=np.full(1, -1, np.int32),
                    spec=np.zeros(1, F32), shin=np.full(1, 8, np.int32))


CASES = {
    "triangle": lambda: _triangle_case(),
    "triangle_lit": lambda: _triangle_case(lit=True),
    "triangle_lit_textured": lambda: _triangle_case(lit=True, textured=True),
    "triangle_lit_no_camera": lambda: _triangle_case(lit=True, camera=False),
    "icosphere": example_case,
}


def port_fn(case, device="cpu"):
    """(the port's shade_params_fn for the case, its float inputs as
    tensors on ``device``)."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    su = TriangleSetup(**{f.name: t(getattr(case.su, f.name))
                          for f in dataclasses.fields(TriangleSetup)})
    atlas = None if case.atlas is None else TextureAtlas(**{
        f.name: t(getattr(case.atlas, f.name))
        for f in dataclasses.fields(TextureAtlas)})
    light = None if case.light is None else LightPack(*map(t, case.light))
    mats = MaterialsPack(t(case.base), t(case.tex_id), t(case.spec),
                         t(case.shin))
    w, h = case.size
    fn = diffrender.shade_params_fn(
        t(case.vis_t), su, t(case.attrs), derive_raster_config(w, h), mats,
        atlas=atlas, light=light, camera_pos=case.camera_pos)
    return fn, mats, light, t(case.attrs)


def jax_fn(case):
    from ash_renderer_tpu.rtypes import TriangleSetup as RefSetup

    su = RefSetup(**{f.name: jnp.asarray(getattr(case.su, f.name))
                     for f in dataclasses.fields(RefSetup)})
    atlas = None if case.atlas is None else RefAtlas(**{
        f.name: jnp.asarray(getattr(case.atlas, f.name))
        for f in dataclasses.fields(RefAtlas)})
    light = None if case.light is None else RefLight(*map(jnp.asarray,
                                                          case.light))
    mats = RefMats(*map(jnp.asarray, (case.base, case.tex_id, case.spec,
                                      case.shin)))
    w, h = case.size
    fn = ref_diff.shade_params_fn(
        jnp.asarray(case.vis_t), su, jnp.asarray(case.attrs), ref_cfg(w, h),
        mats, atlas=atlas, light=light,
        camera_pos=None if case.camera_pos is None
        else jnp.asarray(case.camera_pos))
    return fn, mats, light


def _float_inputs(case):
    """The differentiated inputs: vertex colours, base colour, specular,
    and the light's direction, colour and ambient where lit."""
    ins = {"vertex_colors": case.attrs[:, :4], "base": case.base,
           "spec": case.spec}
    if case.light is not None:
        ins.update(ldir=case.light[0], lcol=case.light[1], amb=case.light[2])
    return ins


def _weights(case):
    w, h = case.size
    return np.random.default_rng(1).uniform(0.5, 1.5, (h, w, 3)).astype(F32)


def test_forward_is_bit_equal_to_reference():
    """shade_params_fn's image, for each case and for params overriding
    vertex colours, materials and light, equals the reference's bit for
    bit."""
    for name, build in CASES.items():
        case = build()
        fn, mats, light, attrs = port_fn(case)
        rfn, rmats, rlight = jax_fn(case)
        rng = np.random.default_rng(5)
        vc = rng.uniform(0, 1, case.attrs[:, :4].shape).astype(F32)
        params = [({}, {}), ({"vertex_colors": torch.from_numpy(vc)},
                             {"vertex_colors": jnp.asarray(vc)})]
        base2 = case.base * F32(0.75)
        params.append(({"materials": dataclasses.replace(
            mats, base_color=torch.from_numpy(base2))},
            {"materials": RefMats(jnp.asarray(base2), rmats.tex_id,
                                  rmats.specular, rmats.shininess)}))
        if light is not None:
            amb = np.array(0.3, F32)
            params.append(({"light": dataclasses.replace(
                light, ambient=torch.from_numpy(amb))},
                {"light": RefLight(rlight.direction, rlight.color,
                                   jnp.asarray(amb))}))
        for p, rp in params:
            got = fn(p).numpy()
            want = np.asarray(rfn(rp))
            assert got.shape == (case.size[1], case.size[0], 4)
            tp.same_bits(got, want)
        assert (case.vis_t >= 0).sum() > 100, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax_grad(name):
    """d(sum(img[..., :3] * W) / N) with respect to the vertex colours, base
    colour, specular and, where lit, the light's direction, colour and
    ambient: torch autograd against jax.grad within rtol 1e-4, atol 1e-6;
    every input gets a gradient that is not all zero where it reaches the
    image (specular only with a camera position, as in the reference).
    NaN entries (the NaN cotangents fit_to_image zeroes) must sit in the
    same places in both."""
    case = CASES[name]()
    fn, mats, light, attrs = port_fn(case)
    rfn, rmats, rlight = jax_fn(case)
    ins = _float_inputs(case)
    keys = sorted(ins)
    wts = _weights(case)

    def assemble(v, m, lt, mk_mats, mk_light):
        p = {"vertex_colors": v["vertex_colors"],
             "materials": mk_mats(v["base"], v["spec"])}
        if lt is not None:
            p["light"] = mk_light(v["ldir"], v["lcol"], v["amb"])
        return p

    def jloss(*vals):
        v = dict(zip(keys, vals))
        img = rfn(assemble(v, rmats, rlight,
                           lambda b, s: RefMats(b, rmats.tex_id, s,
                                                rmats.shininess),
                           RefLight))
        return jnp.mean(img[..., :3] * wts)

    want = jax.grad(jloss, argnums=tuple(range(len(keys))))(
        *(jnp.asarray(ins[k]) for k in keys))
    tv = {k: torch.from_numpy(np.array(ins[k])).requires_grad_(True)
          for k in keys}
    img = fn(assemble(tv, mats, light,
                      lambda b, s: MaterialsPack(b, mats.tex_id, s,
                                                 mats.shininess),
                      LightPack))
    torch.mean(img[..., :3] * torch.from_numpy(wts)).backward()
    for k, w in zip(keys, want):
        got = tv[k].grad
        assert got is not None, k
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        reaches = not (k == "spec" and (case.camera_pos is None
                                        or case.light is None))
        # NaN counts as reached: background pixels shade NaN attributes, and
        # both frameworks send NaN through torch.where / jnp.where alike
        assert bool((got.numpy() != 0).any()) == reaches, k


def test_light_gradients_signs():
    """More ambient -> brighter; the lit triangle's light gradients are
    finite (tests/test_diffrender.py::test_gradients_flow_through_lighting)."""
    case = _triangle_case(lit=True)
    fn, mats, light, _ = port_fn(case)
    amb = torch.tensor(0.1, requires_grad=True)
    ldir = light.direction.clone().requires_grad_(True)
    img = fn({"light": LightPack(ldir, light.color, amb)})
    img[..., :3].mean().backward()
    assert float(amb.grad) > 0
    assert torch.isfinite(ldir.grad).all() and ldir.grad.abs().max() > 0


def test_recip_spec_cuts_the_cotangent_on_both_sides():
    """recip_spec's sign and seed go through int bits: no gradient passes
    through it, in torch (no graph) as under jax.grad (a zero cotangent);
    rsqrt_spec passes one through its Newton steps, the same in both."""
    x = np.array([0.3, 1.7, 4.0, 123.5], F32)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    assert not specmath.recip_spec(xt).requires_grad
    g = jax.grad(lambda v: jnp.sum(ref_sm.recip_spec(v, jnp)))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(g), np.zeros_like(x))
    (specmath.rsqrt_spec(xt).sum()).backward()
    g = jax.grad(lambda v: jnp.sum(ref_sm.rsqrt_spec(v, jnp)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=RTOL,
                               atol=ATOL)
    assert (xt.grad.numpy() < 0).all()


def test_fit_recovers_vertex_colors():
    """tests/test_diffrender.py::test_recover_vertex_colors on the port:
    from grey, 150 Adam steps at lr 0.1 reach loss < 1e-4 and recover the
    three vertices' colours within 0.06."""
    case = _triangle_case()
    fn, _, _, attrs = port_fn(case)
    target = fn({"vertex_colors": attrs[:, :4]})
    p0 = {"vertex_colors": torch.full_like(attrs[:, :4], 0.5)}
    params, losses = diffrender.fit_to_image(target.detach(), fn, p0,
                                             steps=150, lr=0.1)
    assert losses[-1] < 1e-4, losses[-1]
    rec = params["vertex_colors"].numpy()[:3, :3]
    assert np.abs(rec - case.attrs[:3, :3]).max() < 0.06
    assert not params["vertex_colors"].requires_grad
    assert torch.equal(p0["vertex_colors"], torch.full_like(attrs[:, :4], 0.5))


def test_fit_moves_materials_and_light():
    """fit_to_image over vertex colours, a MaterialsPack and a LightPack:
    every float field receives gradient steps, integer fields stay, and
    the loss falls."""
    case = _triangle_case(lit=True)
    fn, mats, light, attrs = port_fn(case)
    target = fn({}).detach()
    p0 = {"vertex_colors": attrs[:, :4] * 0.8,
          "materials": dataclasses.replace(mats, base_color=mats.base_color
                                           * 0.5, specular=mats.specular * 0.5),
          "light": dataclasses.replace(light, ambient=light.ambient * 3.0)}
    params, losses = diffrender.fit_to_image(target, fn, p0, steps=30,
                                             lr=0.02)
    assert losses[-1] < 0.5 * losses[0]
    for k in ("base_color", "specular"):
        assert not torch.equal(getattr(params["materials"], k),
                               getattr(p0["materials"], k)), k
    for k in ("tex_id", "shininess"):
        assert torch.equal(getattr(params["materials"], k),
                           getattr(mats, k)), k
    for k in ("direction", "color", "ambient"):
        assert not torch.equal(getattr(params["light"], k),
                               getattr(p0["light"], k)), k


@pytest.mark.parametrize("name", ["config3", "textured_on", "two_textures_on",
                                  "random"])
def test_float_tables_give_phase_f_the_same_bits(name, monkeypatch):
    """On the phase F test scenes (tests/test_torch_phase_f.py), through the
    port's own front, every call of surface_prelight made by K3F's plain
    version gives the same bits
    with cf = pack_shade_consts_f32(...) as with the int32 constants
    alone, and pack_shade_consts_f32 equals bitcast_f32 of
    pack_shade_consts."""
    from ash_renderer_tpu_torch import pipeline

    case = tp.make_case(name)
    smode, consts, _ = tp.shade_inputs(case)
    st = tp.port_state(case)
    statics = tp.port_statics(case)
    rmeta, tbl_sorted, tbl_ext, comb, _ = pipeline.render_front(
        statics, st, tp.t(case.mm), tp.t(case.mvp))
    cf = shade.pack_shade_consts_f32(
        smode, st.materials, st.atlas if statics.has_atlas else None,
        st.light if statics.has_light else None,
        torch.from_numpy(case.cam.position.astype(F32)))
    tp.same_bits(cf.numpy(), specmath.bitcast_f32(consts).numpy())
    calls = []
    real = fused_kernel.surface_prelight

    def both(attr, duv, mat_row, mode, c):
        a = real(attr, duv, mat_row, mode, c)
        b = real(attr, duv, mat_row, mode, c, cf=cf)
        for x, y in zip(a, b):
            tp.same_bits(x.numpy(), y.numpy())
        calls.append(1)
        return a

    monkeypatch.setattr(fused_kernel, "surface_prelight", both)
    fused_kernel.rasterize_distribute(rmeta, tbl_sorted, tbl_ext, comb,
                                      case.cfg, smode, consts)
    assert calls


def test_fit_takes_a_materials_pack_where_the_reference_raises():
    """A "materials" param (a MaterialsPack, whose tex_id and shininess are
    int32): the reference's fit_to_image raises TypeError under jax.grad
    (ROADMAP queue 3); the port fits the float fields and keeps the
    integer ones."""
    case = _triangle_case()
    fn, mats, _, _ = port_fn(case)
    rfn, rmats, _ = jax_fn(case)
    half = case.base * F32(0.5)
    with pytest.raises(TypeError, match="int32"):
        ref_diff.fit_to_image(np.asarray(rfn({})), rfn, {"materials": RefMats(
            jnp.asarray(half), rmats.tex_id, rmats.specular, rmats.shininess)},
            steps=2, lr=0.1)
    params, losses = diffrender.fit_to_image(
        fn({}).detach(), fn, {"materials": dataclasses.replace(
            mats, base_color=torch.from_numpy(half))}, steps=20, lr=0.05)
    assert losses[-1] < losses[0]
    assert torch.equal(params["materials"].tex_id, mats.tex_id)
