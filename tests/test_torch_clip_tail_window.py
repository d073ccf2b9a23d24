"""The clip tail against the JAX package's stage, as
``test_torch_clip_tail.py`` holds it, on a slab's tile-row window (tile
rows 6-11 of 16: the tail keys clamped to the window and counted from its
first row), on 4-row tiles and with a budget of 17 (no multiple of the
kernel's 16 slots a block; more candidates than that: overflow)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_clip_tail as ct  # noqa: E402

CASES = ("slab_window", "tile_h4", "budget_17")


@pytest.mark.parametrize("name", CASES)
def test_clip_tail_matches_the_reference(name):
    ct.check_against_the_reference(name)


def test_the_cases_hold_what_they_name():
    """Both cases have live fan rows; the window keys some tail row
    otherwise than the whole grid does; the 4-row case has 4-row tiles."""
    for name in CASES:
        assert ct.has_live_fan_rows(name), name
    assert ct.CASES["slab_window"][3][0] > 0
    # the whole grid's keys of the same tail: the port's, which
    # test_torch_clip_tail.py holds to the reference's
    assert not np.array_equal(ct._jax_tail("slab_window")[1],
                              ct._port_tail("candidates")[1].numpy())
    assert ct._setup("tile_h4")[0].cfg.tile_h == 4
    budget = ct.CASES["budget_17"][1].clip_budget
    assert budget % 16 and ct._jax_tail("budget_17")[2]["clip_overflow"] > 0
