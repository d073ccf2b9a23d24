"""The port's examples (``examples/torch_*.py``) on the CPU at small sizes,
each in a fresh interpreter where importing jax, jaxlib or the JAX package
raises: the render example against the reference scene's PNG golden, the
inverse-rendering example's target against the JAX package's own target,
and the interactive example run unattended."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
torch.set_num_threads(1)

# the finder of tests/test_torch_frame.py::test_port_never_imports_jax
_NO_JAX = textwrap.dedent("""
    import runpy, sys

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ash_renderer_tpu"):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, NoJax())
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ash_renderer_tpu")]
""")


def run_example(name, *args, cwd=ROOT):
    """Runs ``examples/<name>`` with ``args`` and stdin not a tty; returns
    its stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)  # the example puts the repo on sys.path
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, os.path.join(EXAMPLES, name), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
        stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_render_scene_reference_equals_golden(tmp_path):
    out = str(tmp_path / "frames")
    stdout = run_example("torch_render_scene.py", "reference", "--size",
                         "320x240", "--device", "cpu", "--out", out,
                         cwd=str(tmp_path))
    assert "rendered 1 frame(s) at 320x240" in stdout
    assert os.listdir(out) == ["frame_0000.png"]
    got = np.asarray(Image.open(os.path.join(out, "frame_0000.png")))
    want = np.asarray(Image.open(os.path.join(ROOT, "tests", "golden",
                                              "reference_320x240.png")))
    assert got.shape == want.shape == (240, 320, 4)
    np.testing.assert_array_equal(got, want)


def reference_target():
    """examples/inverse_rendering.py's target image, made with the same
    calls in the JAX package (not by running that script)."""
    import jax
    import jax.numpy as jnp

    from ash_renderer_tpu import (Camera, Scene, SceneObject,
                                  derive_raster_config, mathx)
    from ash_renderer_tpu.diffrender import shade_params_fn
    from ash_renderer_tpu.models import icosphere
    from ash_renderer_tpu.oracle import geometry_oracle, visibility_oracle
    from ash_renderer_tpu.rtypes import MaterialsPack

    rng = np.random.default_rng(0)
    mesh = icosphere(3)
    true_colors = rng.uniform(0.1, 1.0, (mesh.num_vertices, 4)).astype(
        np.float32)
    true_colors[:, 3] = 1.0
    mesh.colors = true_colors
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh),
                                 model=mathx.translation([0, 0, 3])))
    cfg = derive_raster_config(128, 128)
    cam = Camera()
    su, attrs = geometry_oracle(scene.pack(), scene.model_matrices(),
                                cam.view_matrix(), cam.projection_matrix(1.0),
                                cfg, 64)
    _, vis_t = visibility_oracle(su, cfg)
    mats = MaterialsPack(base_color=np.ones((1, 4), np.float32),
                         tex_id=np.full(1, -1, np.int32),
                         specular=np.zeros(1, np.float32),
                         shininess=np.full(1, 8, np.int32))
    su_j = jax.tree.map(jnp.asarray, su)
    fn = shade_params_fn(jnp.asarray(vis_t), su_j, jnp.asarray(attrs), cfg,
                         mats)
    target = fn({"vertex_colors": jnp.asarray(attrs[:, :4])})
    return np.asarray(jnp.round(jnp.clip(target, 0, 1) * 255).astype(jnp.uint8))


def test_inverse_rendering_target_equals_reference_and_loss_falls(tmp_path):
    out = str(tmp_path / "inv")
    stdout = run_example("torch_inverse_rendering.py", "--device", "cpu",
                         "--steps", "5", "--out", out)
    first, last = map(float, re.search(r"loss: (\S+) -> (\S+)", stdout).groups())
    assert last < first
    assert "median vertex-color error (finite): " in stdout
    assert sorted(os.listdir(out)) == ["inv_recovered.png", "inv_target.png"]
    got = np.asarray(Image.open(os.path.join(out, "inv_target.png")))
    want = reference_target()
    assert got.shape == want.shape == (128, 128, 4)
    np.testing.assert_array_equal(got, want)
    assert int(got[..., :3].max()) > 0


def test_interactive_runs_unattended(tmp_path):
    stdout = run_example("torch_interactive.py", "--frames", "2", "--size",
                         "64x48", "--device", "cpu")
    assert "W/A/S/D move, arrows look, Q quits." in stdout
    m = re.search(r"\n(\d+) frames, ([0-9.]+) FPS\n", stdout)
    assert m is not None and m.group(1) == "2" and float(m.group(2)) > 0
    assert "\x1b[38;2;" in stdout  # the terminal viewer drew frames
