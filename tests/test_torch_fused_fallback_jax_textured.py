"""``test_torch_fused_fallback_jax.py``'s check on the textured, lit,
specular scene, which "auto" sends to phase E (K3), in a file of its own:
each JAX frame compiles for ~15 s."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fused_fallback_jax import check_fallback_against_jax  # noqa: E402

torch.set_num_threads(1)


def test_textured_fallback_frame_matches_jax():
    check_fallback_against_jax("textured")
