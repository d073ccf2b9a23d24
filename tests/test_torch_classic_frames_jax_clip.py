"""The port's classic frames against the JAX package's classic frame
(``render_frame_jit``, the Pallas kernels in interpret mode), bit for bit:
RGBA8, vis_d16, vis_tri and every geometry and binning counter, on the
clip-heavy scene and the five overlapping objects, scenes of
tests/test_pipeline_parity.py.  The six scenes are spread over three
files: each JAX frame compiles for ~20 s on one core."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["clip_heavy", "multi_object"])
def test_classic_frame_matches_jax(name):
    tp.check_classic_frame_against_jax(name)
