"""A stand-in reference for the benchmark's own tests: a configuration
file names it (`"reference": "vctbench.tests.standin_reference"`) to show
that the harness and the calibration take the reference the
configuration names.  It keeps each construction and call and answers
with a black image; it is not a reference of any route."""

from __future__ import annotations

from types import SimpleNamespace

import torch


class Reference:
    calls: list = []          # (what, arguments), every instance's

    def __init__(self, config, scene_base, scene_frame, device,
                 lower_precision=False):
        self.config = config
        self.device = torch.device(device)
        self.calls.append(("init", lower_precision))

    def build(self, light=None, works=None):
        self.calls.append(("build", light))
        return SimpleNamespace(cfg=self.config, voxels=SimpleNamespace())

    def frame(self, built, origins, dirs, position):
        self.calls.append(("frame", tuple(origins.shape)))
        return torch.zeros(origins.shape, device=self.device)

    def march_work(self, light):
        self.calls.append(("march_work", light))
        return []
