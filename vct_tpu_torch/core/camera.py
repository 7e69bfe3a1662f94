"""Camera model + primary rays (port of vct_tpu/core/camera.py:22-149).

The ray math runs in numpy float64 on the host, exactly as the reference
does, and only the result moves to the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# Camera.h:31-38 defaults
YAW = -90.0
PITCH = 0.0
SPEED = 10.0
SENSITIVITY = 0.1
ZOOM = 45.0

FORWARD, BACKWARD, LEFT, RIGHT = range(4)   # Camera_Direction, Camera.h:17-24


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Tuple[float, float, float] = (0.0, 4.0, 0.0)
    yaw: float = YAW
    pitch: float = PITCH
    world_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    zoom: float = ZOOM                   # fov degrees
    movement_speed: float = SPEED
    mouse_sensitivity: float = SENSITIVITY

    @property
    def front(self) -> np.ndarray:
        cy, sy = math.cos(math.radians(self.yaw)), math.sin(math.radians(self.yaw))
        cp, sp = math.cos(math.radians(self.pitch)), math.sin(math.radians(self.pitch))
        f = np.array([cy * cp, sp, sy * cp])
        return f / np.linalg.norm(f)

    @property
    def right(self) -> np.ndarray:
        r = np.cross(self.front, np.asarray(self.world_up, np.float64))
        return r / np.linalg.norm(r)

    @property
    def up(self) -> np.ndarray:
        u = np.cross(self.right, self.front)
        return u / np.linalg.norm(u)

    # --- pure control updates (Camera.h:80-129) ---

    def process_keyboard(self, direction: int, delta_time: float) -> "Camera":
        v = self.movement_speed * delta_time
        delta = {
            FORWARD: self.front, BACKWARD: -self.front,
            LEFT: -self.right, RIGHT: self.right,
        }[direction] * v
        return dataclasses.replace(
            self, position=tuple(np.asarray(self.position) + delta))

    def process_mouse_movement(self, dx: float, dy: float,
                               constrain_pitch: bool = True) -> "Camera":
        yaw = self.yaw + dx * self.mouse_sensitivity
        pitch = self.pitch + dy * self.mouse_sensitivity
        if constrain_pitch:
            pitch = min(89.0, max(-89.0, pitch))
        return dataclasses.replace(self, yaw=yaw, pitch=pitch)

    def process_mouse_scroll(self, dy: float) -> "Camera":
        zoom = min(45.0, max(1.0, self.zoom - dy))
        return dataclasses.replace(self, zoom=zoom)


def primary_rays(cam: Camera, width: int, height: int,
                 device="cuda", dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (origin, direction) through pixel centers.

    Returns origins (H, W, 3) (the broadcast position) and unit dirs
    (H, W, 3); row 0 is the top image row."""
    aspect = width / height
    tan_half = math.tan(math.radians(cam.zoom) / 2.0)
    x = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    y = 1.0 - (np.arange(height) + 0.5) / height * 2.0
    xx, yy = np.meshgrid(x, y)
    cam_dirs = np.stack(
        [xx * tan_half * aspect, yy * tan_half, -np.ones_like(xx)], axis=-1)
    rot = np.stack([cam.right, cam.up, -cam.front], axis=-1)
    world = cam_dirs @ rot.T
    world /= np.linalg.norm(world, axis=-1, keepdims=True)
    origins = torch.as_tensor(np.asarray(cam.position, np.float64),
                              dtype=dtype, device=device
                              ).expand(height, width, 3)
    return origins, torch.as_tensor(world, dtype=dtype, device=device)
