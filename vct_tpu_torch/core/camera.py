"""Camera model, view and projection matrices, primary rays (port of
vct_tpu/core/camera.py:22-149).

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


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt, the view matrix (Camera.h:75-78)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def perspective(fov_y_deg: float, aspect: float, z_near: float,
                z_far: float) -> np.ndarray:
    """glm::perspective (Voxel_Cone_Tracing.h:163)."""
    t = math.tan(math.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -2.0 * z_far * z_near / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def ortho(l: float, r: float, b: float, t: float, n: float,
          f: float) -> np.ndarray:
    """glm::ortho: the light frustum (Voxel_Cone_Tracing.h:84) and the
    three voxelization projections (:128-134)."""
    m = np.eye(4)
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    m[2, 2] = -2.0 / (f - n)
    m[0, 3] = -(r + l) / (r - l)
    m[1, 3] = -(t + b) / (t - b)
    m[2, 3] = -(f + n) / (f - n)
    return m


def view_matrix(cam: Camera) -> np.ndarray:
    return look_at(np.asarray(cam.position, np.float64),
                   np.asarray(cam.position, np.float64) + cam.front, cam.up)


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
