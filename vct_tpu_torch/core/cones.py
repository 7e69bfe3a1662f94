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


def tbn_matrix(tangent: Tensor, bitangent: Tensor, normal: Tensor) -> Tensor:
    """TBN = inverse(transpose(mat3(T, B, N))) — fs:175.  Inputs (..., 3);
    returns (..., 3, 3) applying as out = mat @ v.

    `inv_ex` neither checks nor raises: a singular frame gives non-finite
    entries, as jnp.linalg.inv does, and the card is not synchronized to
    read an error flag."""
    m = torch.stack([tangent, bitangent, normal], dim=-1)   # columns T,B,N
    return torch.linalg.inv_ex(m.transpose(-1, -2)).inverse


def rotate_cones(tbn: Tensor, directions: Tensor) -> Tensor:
    """World-space cone directions: normalize(TBN @ dir) — fs:198.

    tbn (..., 3, 3); directions (K, 3) -> (..., K, 3)."""
    return normalize(torch.einsum("...ij,kj->...ki", tbn, directions))


def orthonormal_frame(normal: Tensor) -> tuple[Tensor, Tensor]:
    """Duff et al. branchless ONB around unit normals (..., 3)."""
    n = normal
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, bt
