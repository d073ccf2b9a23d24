"""``RendererSettings.preferred_device_index`` on the port
(``renderer.resolve_device``), against the reference's ``select_device``
where both apply.  The index is a CUDA ordinal: it names the card when no
device is given, an explicit device must agree with it, a mesh wins over
both, and nothing falls back to the CPU.  Without a card the checks stop
at the resolved device and the error that the upload to it raises."""

import dataclasses

import pytest
import torch

from ash_renderer_tpu import RendererSettings as RefSettings
from ash_renderer_tpu.renderer import select_device
from ash_renderer_tpu_torch import RendererSettings, reference_two_triangle_scene
from ash_renderer_tpu_torch import renderer as renderer_mod
from ash_renderer_tpu_torch.camera import Camera
from ash_renderer_tpu_torch.renderer import Renderer, resolve_device

torch.set_num_threads(1)
CUDA = torch.device("cuda", 0)
needs_no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="checks the refusal without CUDA")


def settings(index=None):
    return RendererSettings(width=64, height=48, clip_budget=32,
                            preferred_device_index=index)


@pytest.mark.parametrize("index", [0, 1, 7])
def test_index_names_the_card_as_the_reference_names_its_device(index):
    """The reference takes ``jax.devices()[index]``; the port takes the
    card of that ordinal."""
    assert select_device(RefSettings(preferred_device_index=index)).id == index
    assert resolve_device(settings(index)) == torch.device("cuda", index)


@pytest.mark.parametrize("device,index,want", [
    ("cpu", None, "cpu"),
    ("cuda:1", None, "cuda:1"),
    ("cuda:1", 1, "cuda:1"),
    ("cuda", 2, "cuda:2"),  # a bare "cuda" takes the index as its ordinal
    (torch.device("cuda", 0), 0, "cuda:0"),
])
def test_explicit_device_wins_when_it_agrees(device, index, want):
    assert resolve_device(settings(index), device) == torch.device(want)


@pytest.mark.parametrize("device,index", [("cpu", 0), ("cuda:0", 1),
                                          ("cuda:3", 0)])
def test_disagreeing_device_raises_and_names_both(device, index):
    with pytest.raises(ValueError) as e:
        resolve_device(settings(index), device)
    assert str(torch.device(device)) in str(e.value)
    assert f"preferred_device_index={index}" in str(e.value)
    with pytest.raises(ValueError):
        Renderer(reference_two_triangle_scene(), settings(index), device=device)


@pytest.mark.parametrize("index", [None, 0, 5])
def test_mesh_wins(index):
    mesh = ("cpu", "cpu")
    assert resolve_device(settings(index), mesh=mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        resolve_device(settings(index), "cuda:0", mesh=mesh)
    r = Renderer(reference_two_triangle_scene(), settings(index), mesh=mesh)
    assert r.device == torch.device("cpu") and r.mesh == (torch.device("cpu"),) * 2


def test_nothing_named_raises():
    with pytest.raises(TypeError, match="preferred_device_index"):
        resolve_device(settings())
    with pytest.raises(TypeError):
        Renderer(reference_two_triangle_scene(), settings())


@needs_no_cuda
def test_index_without_a_device_renders_on_the_card_or_raises():
    """With no device, the index sends the renderer to its card: without
    CUDA the upload there raises, and nothing carries on on the CPU."""
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Renderer(reference_two_triangle_scene(), settings(0))


@pytest.fixture
def uploads(monkeypatch):
    """Records the device of each scene upload and uploads to the CPU
    instead, so a renderer bound to a card can be built without one."""
    seen = []
    real = renderer_mod.state_mod.upload

    def upload(packed, materials, atlas, light, device):
        seen.append(torch.device(device))
        return real(packed, materials, atlas, light, "cpu")

    monkeypatch.setattr(renderer_mod.state_mod, "upload", upload)
    return seen


def test_update_settings_reresolves_and_reuploads(uploads):
    """A changed index re-resolves the device and uploads the scene state
    there (the reference re-selects its device); an unchanged or cleared
    index keeps the device."""
    r = Renderer(reference_two_triangle_scene(), settings(0))
    assert r.device == CUDA and uploads == [CUDA]
    r.update_settings(dataclasses.replace(r.settings, width=32))
    assert r.device == CUDA and uploads == [CUDA] * 2
    r.update_settings(dataclasses.replace(r.settings, preferred_device_index=1))
    assert r.device == torch.device("cuda", 1)
    assert uploads[-1] == torch.device("cuda", 1) and len(uploads) == 3
    assert r.settings.preferred_device_index == 1
    r.update_settings(dataclasses.replace(r.settings, preferred_device_index=None))
    assert r.device == torch.device("cuda", 1) and uploads[-1] == r.device


def test_update_settings_moves_a_cpu_renderer_to_the_named_card(uploads):
    r = Renderer(reference_two_triangle_scene(), settings(), device="cpu")
    assert uploads == [torch.device("cpu")]
    r.update_settings(dataclasses.replace(r.settings, preferred_device_index=0))
    assert r.device == CUDA and uploads[-1] == CUDA


def test_update_settings_keeps_the_mesh(uploads):
    r = Renderer(reference_two_triangle_scene(), settings(), mesh=("cpu",) * 2)
    r.update_settings(dataclasses.replace(r.settings, preferred_device_index=0))
    assert r.device == torch.device("cpu") and set(uploads) == {r.device}


@needs_no_cuda
def test_update_settings_to_a_card_raises_without_one():
    r = Renderer(reference_two_triangle_scene(), settings(), device="cpu")
    frame = r.read_frame(r.render_frame(Camera())[0])
    assert frame.shape == (48, 64, 4)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        r.update_settings(dataclasses.replace(r.settings,
                                              preferred_device_index=0))

