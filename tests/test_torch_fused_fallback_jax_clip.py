"""``test_torch_fused_fallback_jax.py``'s check on a scene that clips
(random triangles across the near plane, more clip candidates than the
clip budget), in a file of its own: each JAX frame compiles for ~15 s."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fused_fallback_jax import check_fallback_against_jax  # noqa: E402

torch.set_num_threads(1)


def test_clipping_fallback_frame_matches_jax():
    aux = check_fallback_against_jax("near_plane")
    assert int(aux["n_clipped"]) > 0 and int(aux["clip_overflow"]) > 0
