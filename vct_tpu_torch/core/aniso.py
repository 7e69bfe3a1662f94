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

This module is the plain PyTorch version, as the pyramid is XLA in the
JAX package.  On the card the voxel build builds the pyramid with
ops/aniso.py's kernel (csrc/aniso.cu, one launch a level), which equals
build_aniso_mips here bit for bit; sampling stays plain PyTorch (the
dense-march kernel blends the 6-direction levels itself).  The
operations run in the JAX package's order (four composites summed in
loop order, then x 0.25; the 6-way blend after the gather), so float32
results agree to a few ulps.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.core import grid as G

Tensor = torch.Tensor

# direction order (+x, -x, +y, -y, +z, -z)
ANISO_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32)


def _composite_pair(near: Tensor, far: Tensor) -> Tensor:
    """Front-to-back emission-absorption of two samples along the travel
    direction: out = near + (1 - a_near) * far, color and alpha alike."""
    return near + (1.0 - near[..., -1:]) * far


def _corner(level: Tensor, ox: int, oy: int, oz: int) -> Tensor:
    return level[ox::2, oy::2, oz::2]


def _downsample_directional(level: Tensor, axis: int, positive: bool
                            ) -> Tensor:
    """(d,d,d,...,C) -> (d/2,d/2,d/2,...,C): composite child pairs along
    `axis` (near = the face the cone enters first), box-average the 4
    perpendicular pairs."""
    near_off = 0 if positive else 1
    acc = None
    for p0 in (0, 1):
        for p1 in (0, 1):
            off = [p0, p1]
            off.insert(axis, near_off)
            near = _corner(level, *off)
            off[axis] = 1 - near_off
            far = _corner(level, *off)
            pair = _composite_pair(near, far)
            acc = pair if acc is None else acc + pair
    return acc * 0.25


def downsample_aniso_from_iso(level0: Tensor) -> Tensor:
    """Level 0 (D,D,D,C) -> level 1 (D/2,D/2,D/2,6,C)."""
    return torch.stack([_downsample_directional(level0, axis, positive)
                        for axis in (0, 1, 2) for positive in (True, False)],
                       dim=-2)


def downsample_aniso(level: Tensor) -> Tensor:
    """Level l (d,d,d,6,C) -> level l+1 (d/2,d/2,d/2,6,C): direction s of
    the parent composites direction s of the children along s's axis, so
    the six pyramids are independent chains."""
    return torch.stack([_downsample_directional(level[..., s, :], s // 2,
                                                s % 2 == 0)
                        for s in range(6)], dim=-2)


def build_aniso_mips(grid: Tensor, num_levels: Optional[int] = None
                     ) -> Tuple[Tensor, ...]:
    """The whole pyramid: (iso level 0, aniso level 1, aniso level 2, ...),
    in place of glGenerateMipmap (Voxel_Cone_Tracing.h:248) when
    GridConfig.anisotropic is set."""
    n = G.num_mip_levels(grid.shape[0], num_levels)
    mips = [grid]
    if n > 1:
        mips.append(downsample_aniso_from_iso(grid))
    for _ in range(n - 2):
        mips.append(downsample_aniso(mips[-1]))
    return tuple(mips)


def is_aniso_level(level: Tensor) -> bool:
    return level.dim() == 5


def is_aniso_stack(mips: Sequence[Tensor]) -> bool:
    return len(mips) > 1 and is_aniso_level(mips[1])


# ---------------------------------------------------------------------------
# direction weights
# ---------------------------------------------------------------------------

def aniso_weights(direction: Tensor) -> Tensor:
    """Blend weights (..., 6) over the directional levels for unit travel
    direction(s): w = d_i^2 on the matching sign, 0 on the opposite (a
    partition of unity)."""
    d2 = direction * direction
    pos = direction >= 0.0
    cols = []
    for ax in range(3):
        cols.append(torch.where(pos[..., ax], d2[..., ax], 0.0))
        cols.append(torch.where(pos[..., ax], 0.0, d2[..., ax]))
    return torch.stack(cols, dim=-1)


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


def blend_level_static(level: Tensor, w6) -> Tensor:
    """(d,d,d,6,C) x static (6,) -> (d,d,d,C): the isotropic view of a
    level for one fixed direction."""
    return blend(level, G.constant(np.asarray(w6, np.float32), level.device,
                                   level.dtype))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def packed(level: Tensor) -> Tensor:
    """(d,d,d,6,C) -> (d,d,d,6C), a view: the six directions as channels
    of one gather."""
    d = level.shape[0]
    return level.reshape(d, d, d, -1)


def sample_aniso_level(level: Tensor, uvw: Tensor, direction: Tensor
                       ) -> Tensor:
    """Trilinear sample of one directional level along traced directions:
    level (d,d,d,6,C), uvw (..., 3), direction (..., 3) unit.  One gather
    of 6C channels, then the 6-way weighted sum.  Returns (..., C)."""
    c = level.shape[-1]
    s = G.trilinear_sample(packed(level), uvw)
    s = s.reshape(s.shape[:-1] + (6, c))
    return blend(s, aniso_weights(direction))

