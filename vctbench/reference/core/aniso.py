"""Anisotropic (6-direction) voxel mip pyramid (port of
vct_tpu/core/aniso.py:40-231).

Each mip level >= 1 stores six directional pre-integrations of its
children: for travel direction s, the 2x2x2 block is composited
front-to-back along s's axis (the march's emission-absorption composite,
VoxelConeTracing.fs:100-102) and box-averaged over the 4 perpendicular
child pairs.  A cone marching in direction d samples the directional
levels blended by the squared direction components, so thin occluders
seen face-on stay opaque at coarse lods instead of being diluted to alpha
0.5 by the isotropic box filter (the reference's acknowledged missing
piece, Voxel_Cone_Tracing.h:123-125).

Layout, as in the JAX package:
  level 0:      (D, D, D, C)      isotropic, shared with the iso pyramid
  level l >= 1: (d, d, d, 6, C)   direction-minor, so one trilinear gather
                of the level packed to (d, d, d, 6C) reads all six
                directions, and the blend is a weighted sum over the 6-axis
                after it.
Direction order: (+x, -x, +y, -y, +z, -z).

Plain PyTorch on every device, as it is XLA in the JAX package: no Pallas
kernel builds or samples the anisotropic pyramid.  The operations run in
the JAX package's order (four composites summed in loop order, then
x 0.25; the 6-way blend after the gather), so float32 results agree to a
few ulps.
"""

from __future__ import annotations

import numpy as np
import torch


Tensor = torch.Tensor

# direction order (+x, -x, +y, -y, +z, -z)
ANISO_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32)


def is_aniso_level(level: Tensor) -> bool:
    return level.dim() == 5


# ---------------------------------------------------------------------------
# direction weights
# ---------------------------------------------------------------------------


def aniso_weights_static(direction) -> np.ndarray:
    """Static (6,) float32 weights for a direction known on the host (the
    dense passes)."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    w = np.zeros(6)
    for ax in range(3):
        w[2 * ax + (0 if d[ax] >= 0 else 1)] = d[ax] ** 2
    return w.astype(np.float32)


def blend(s: Tensor, w: Tensor) -> Tensor:
    """s (..., 6, C) and weights w (..., 6) or (6,) -> (..., C): the sum
    of w[..., k] * s[..., k, :] in direction order."""
    acc = w[..., 0:1] * s[..., 0, :]
    for k in range(1, 6):
        acc = acc + w[..., k:k + 1] * s[..., k, :]
    return acc


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def packed(level: Tensor) -> Tensor:
    """(d,d,d,6,C) -> (d,d,d,6C), a view: the six directions as channels
    of one gather."""
    d = level.shape[0]
    return level.reshape(d, d, d, -1)


