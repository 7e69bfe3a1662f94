"""A whole run at a tiny size on the CPU with the timed path broken
underneath: `correct` has to come out false for each fault a cell can
have (one card, so no exchange between cards to leave out)."""

from __future__ import annotations

import time

import pytest
import torch

from vctbench import harness
from vctbench.program import Program


class Unchanged(Program):
    """A step that returns its state unchanged: the build keeps the first
    state whatever the sun, the frame the first image whatever the
    camera."""

    def build(self, light=None):
        if not hasattr(self, "_first"):
            self._first = super().build(light)
        return self._first

    def frame(self, state, origins, dirs, position):
        if not hasattr(self, "_image"):
            self._image = super().frame(state, origins, dirs, position)
        return self._image


class HalfLeftOut(Program):
    """Half of the image left out: only its top rows are shaded."""

    def frame(self, state, origins, dirs, position):
        img = super().frame(state, origins, dirs, position).clone()
        img[img.shape[0] // 2:] = 0.0
        return img


class Altered(Program):
    """One answer altered where it is produced: a pixel of each image."""

    def frame(self, state, origins, dirs, position):
        img = super().frame(state, origins, dirs, position).clone()
        img[img.shape[0] // 3, img.shape[1] // 3, 1] += 0.25
        return img


@pytest.mark.parametrize("cell", ["sponza256.walk", "sponza256.relight",
                                  "sponza256_exact_specular.walk"])
@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, Altered])
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    res = harness.run_cell(tiny_root, cell, 77, 0.5, False,
                           time.perf_counter(), device="cpu",
                           make_program=fault)
    assert res["correct"] is False and res["failed"] >= 1


def test_the_sound_program_is_correct(tiny_root):
    res = harness.run_cell(tiny_root, "sponza256.relight", 77, 0.5, False,
                           time.perf_counter(), device="cpu")
    assert res["correct"] is True
    assert torch.isfinite(torch.tensor(
        [v["value"] for v in res["checks"].values()])).all()


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sponza256.walk", "sponza256.relight",
                                  "sponza256_exact_specular.walk"])
def test_tiny_run_on_the_card(card, tiny_root, cell):
    """The kernels at 16^3 / 96x64 against the plain reference."""
    res = harness.run_cell(tiny_root, cell, 78, 0.5, True,
                           time.perf_counter(), device=card)
    assert res["correct"] is True and res["device"]["busy_s"] > 0
