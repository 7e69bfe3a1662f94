"""The anisotropic (6-direction) radiance pyramid in plain PyTorch, and its
work from its level shapes.

A copy of the port's plain pyramid (vct_tpu_torch/core/aniso.py, which
ports vct_tpu/core/aniso.py): the frozen vctbench/reference/core/aniso.py
keeps only the sampling side.

Level l >= 1 of the pyramid stores six directional pre-integrations of
its children, in the order (+x, -x, +y, -y, +z, -z): for travel direction
s, each of the 4 child pairs along s's axis is composited front to back,
near + (1 - alpha_near) * far (the march's emission-absorption
composite), and the 4 pairs are summed in loop order and scaled by 0.25.
Level 1 is made from the isotropic level 0; from level 2 on, direction s
of the parent composites direction s of the children.  Layout: level 0
(D, D, D, C), level l >= 1 (d, d, d, 6, C).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vctbench.reference.core import grid as G

Tensor = torch.Tensor

# float operations an output value: 4 pairs x (a subtract, a multiply,
# an add), 3 adds of the pairs and the multiply by 0.25
OPS_PER_VALUE = 16


def _composite_pair(near: Tensor, far: Tensor) -> Tensor:
    return near + (1.0 - near[..., -1:]) * far


def _corner(level: Tensor, ox: int, oy: int, oz: int) -> Tensor:
    return level[ox::2, oy::2, oz::2]


def _downsample_directional(level: Tensor, axis: int, positive: bool
                            ) -> Tensor:
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
    """Level 0 (D, D, D, C) -> level 1 (D/2, D/2, D/2, 6, C)."""
    return torch.stack([_downsample_directional(level0, axis, positive)
                        for axis in (0, 1, 2) for positive in (True, False)],
                       dim=-2)


def downsample_aniso(level: Tensor) -> Tensor:
    """Level l (d, d, d, 6, C) -> level l+1 (d/2, d/2, d/2, 6, C)."""
    return torch.stack([_downsample_directional(level[..., s, :], s // 2,
                                                s % 2 == 0)
                        for s in range(6)], dim=-2)


def build_aniso_mips(grid: Tensor, num_levels: Optional[int] = None
                     ) -> Tuple[Tensor, ...]:
    """(isotropic level 0, 6-direction level 1, level 2, ...)."""
    n = G.num_mip_levels(grid.shape[0], num_levels)
    mips = [grid]
    if n > 1:
        mips.append(downsample_aniso_from_iso(grid))
    for _ in range(n - 2):
        mips.append(downsample_aniso(mips[-1]))
    return tuple(mips)


def pyramid_shapes(dim: int, channels: int,
                   num_levels: Optional[int]) -> List[Tuple[int, ...]]:
    """The level shapes build_aniso_mips gives a (dim, dim, dim, channels)
    level 0."""
    n = G.num_mip_levels(dim, num_levels)
    return [(dim,) * 3 + (channels,)] + [
        (dim >> l,) * 3 + (6, channels) for l in range(1, n)]


def pyramid_work(shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, int]:
    """(bytes, float operations) of building a pyramid of these level
    shapes, float32: every level but the last read once, every
    6-direction level written once, OPS_PER_VALUE operations a value
    written."""
    def size(s):
        return int(np.prod(s))

    read = sum(size(s) for s in shapes[:-1])
    written = sum(size(s) for s in shapes[1:])
    return 4 * (read + written), OPS_PER_VALUE * written
