"""Cone-set constants and tangent-frame math (port of vct_tpu/core/cones.py).

Ref: Shader/VoxelConeTracing.fs:46-57 (weights/directions), :175-177 (TBN
construction), :198 (world-space rotation at trace time).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# 6-cone diffuse hemisphere: one axial cone + 5 cones at 60 deg elevation
# spaced 72 deg in azimuth; weights sum to 1.  fs:48-57.
CONE_WEIGHTS = np.array([0.25, 0.15, 0.15, 0.15, 0.15, 0.15], dtype=np.float32)
CONE_DIRECTIONS = np.array(
    [
        [0.0, 0.0, 1.0],
        [0.0, 0.866025, 0.5],
        [0.823639, 0.267617, 0.5],
        [0.509037, -0.700629, 0.5],
        [-0.509037, -0.700629, 0.5],
        [-0.823639, 0.267617, 0.5],
    ],
    dtype=np.float32,
)


def normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp_min(n, eps)


