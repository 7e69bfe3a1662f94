"""The one traffic generator: a traffic mix's parameters and the seed give
the camera path, the sun's path and each step's primary rays.

A mix (vctbench/traffic/<name>.json) is closed-loop: one viewer, the next
step starts when the last image has been synchronised.  Its `camera`
block gives the region the viewer walks (x and z ranges, a fixed eye
height), the largest pitch, and the period in steps of each coordinate;
its `light` block, where present, the sun's elevation range, the period
of its elevation and its azimuth step.  Every coordinate is a sinusoid
(yaw a ramp) of the step index whose phase the seed draws, so every seed
visits the same set of positions, headings and sun elevations, in
another order.

Nothing here imports the program: the rays are the benchmark's input,
made on the device from the pose (the math of the port's
core/camera.primary_rays, in float64), and handed alike to the program
and to the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Paths:
    """Per step: eye position (n, 3), yaw and pitch in degrees (n,), the
    sun direction toward the light (n, 3) or None, and the steps after
    which the sun moves (every step of a relight mix)."""

    position: np.ndarray
    yaw: np.ndarray
    pitch: np.ndarray
    light: Optional[np.ndarray]
    rebuild_every: int

    def __len__(self) -> int:
        return self.position.shape[0]

    def rebuilds(self, i: int) -> bool:
        """Does step i rebuild the voxel state under its own sun?"""
        return self.rebuild_every > 0 and i % self.rebuild_every == 0


def _phase(rng: np.random.Generator) -> float:
    return float(rng.uniform(0.0, 2.0 * math.pi))


def make_paths(mix: dict, seed: int, n: int) -> Paths:
    """The first n steps of the mix's paths under this seed."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    cam = mix["camera"]
    per = cam["periods"]
    i = np.arange(n, dtype=np.float64)

    def wave(lo, hi, period):
        mid, amp = 0.5 * (lo + hi), 0.5 * (hi - lo)
        return mid + amp * np.sin(2.0 * math.pi * i / period + _phase(rng))

    x = wave(*cam["x"], per["x"])
    z = wave(*cam["z"], per["z"])
    y = np.full(n, float(cam["y"]))
    turn = 1.0 if rng.uniform() < 0.5 else -1.0
    yaw = (rng.uniform(0.0, 360.0) + turn * 360.0 * i / per["yaw"]) % 360.0
    pitch = wave(-cam["pitch_deg"], cam["pitch_deg"], per["pitch"])
    light = None
    lt = mix.get("light")
    if lt:
        lo, hi = lt["elevation_deg"]
        el = np.radians(wave(lo, hi, lt["elevation_period"]))
        az = np.radians(rng.uniform(0.0, 360.0) + lt["azimuth_step_deg"] * i)
        light = np.stack([np.cos(el) * np.cos(az), np.sin(el),
                          np.cos(el) * np.sin(az)], axis=1)
    return Paths(position=np.stack([x, y, z], axis=1), yaw=yaw, pitch=pitch,
                 light=light, rebuild_every=int(mix.get("rebuild_every", 0)))


def camera_frame(yaw, pitch) -> Tuple[np.ndarray, ...]:
    """(front, right, up), float64 (..., 3) for yaw and pitch in degrees
    (...), as the port's core/camera.Camera derives them (world up +y)."""
    yaw, pitch = np.radians(yaw), np.radians(pitch)
    f = np.stack([np.cos(yaw) * np.cos(pitch), np.sin(pitch),
                  np.sin(yaw) * np.cos(pitch)], axis=-1)
    f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    r = np.cross(f, np.array([0.0, 1.0, 0.0]))
    r = r / np.linalg.norm(r, axis=-1, keepdims=True)
    u = np.cross(r, f)
    return f, r, u / np.linalg.norm(u, axis=-1, keepdims=True)


class RayMaker:
    """Primary rays of a pose on the device: per pixel through its centre,
    row 0 the top image row, fov the vertical field of view.  The pixel
    grid lives on the device once; a step's rays are a few elementwise
    kernels in float64, rounded to float32, with no host copy."""

    def __init__(self, width: int, height: int, fov_degrees: float,
                 device):
        dev = torch.device(device)
        tan_half = math.tan(math.radians(fov_degrees) / 2.0)
        aspect = width / height
        x = ((torch.arange(width, dtype=torch.float64, device=dev) + 0.5)
             / width * 2.0 - 1.0) * tan_half * aspect
        y = (1.0 - (torch.arange(height, dtype=torch.float64, device=dev)
                    + 0.5) / height * 2.0) * tan_half
        self.x = x[None, :, None]
        self.y = y[:, None, None]
        self.shape = (height, width)
        self.device = dev

    def basis(self, paths: Paths) -> torch.Tensor:
        """(n, 4, 3) float64 on the device: position, front, right, up of
        every step, in one copy."""
        rows = np.stack([paths.position,
                         *camera_frame(paths.yaw, paths.pitch)], axis=1)
        return torch.as_tensor(rows, dtype=torch.float64, device=self.device)

    def rays(self, basis_i: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(origins (H, W, 3), dirs (H, W, 3), position (3,)) float32 for
        one step's (4, 3) row of `basis`."""
        pos, front, right, up = basis_i
        d = self.x * right + self.y * up + front
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        p32 = pos.to(torch.float32)
        return p32.expand(self.shape + (3,)), d.to(torch.float32), p32
