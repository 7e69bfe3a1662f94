"""The cone march as an array program (port of vct_tpu/core/march.py).

The reference loop (VoxelConeTracing.fs:82-107) advances by the cone
diameter, and diameter/lod depend only on config constants, so the whole
step schedule is static.  The schedule is pure Python, identical to the
JAX package's (tests/test_torch_host.py pins the equality).  The march
is then a fixed set of quadrilinear gathers at known mip levels, batched
per level, and a front-to-back composite written as an exclusive
cumulative product with the loop's early-out as a monotone mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from vctbench.reference.core import grid as G

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MarchSchedule:
    """Static per-step march parameters for one cone aperture."""

    tan_half_angle: float
    voxel_world_size: float
    max_distance: float
    dists: Tuple[float, ...]        # sample distance along the cone axis
    diameters: Tuple[float, ...]    # cone diameter at the sample
    lods: Tuple[float, ...]         # mip lod = log2(diameter / voxel_size)
    step_factor: float = 1.0        # advance = diameter * step_factor

    @property
    def num_steps(self) -> int:
        return len(self.dists)


def march_schedule(
    tan_half_angle: float,
    voxel_world_size: float,
    max_distance: float,
    max_steps: int | None = None,
    step_factor: float = 1.0,
) -> MarchSchedule:
    """Unroll the reference's dist/diameter recurrence (fs:94-105)."""
    dists: List[float] = []
    diams: List[float] = []
    lods: List[float] = []
    dist = voxel_world_size
    while dist < max_distance:
        diameter = max(voxel_world_size, 2.0 * tan_half_angle * dist)
        dists.append(dist)
        diams.append(diameter)
        lods.append(math.log2(diameter / voxel_world_size))
        dist += diameter * step_factor
        if max_steps is not None and len(dists) >= max_steps:
            break
    return MarchSchedule(
        tan_half_angle=tan_half_angle,
        voxel_world_size=voxel_world_size,
        max_distance=max_distance,
        dists=tuple(dists),
        diameters=tuple(diams),
        lods=tuple(lods),
        step_factor=step_factor,
    )


def _static_lod_plan(lods: Sequence[float], num_levels: int):
    """For each step: (l0, l1, w) with lod clamped into the available stack."""
    return [G.lod_levels(lod, num_levels) for lod in lods]


def composite(colors: Tensor, alphas: Tensor, diameters: Sequence[float],
              max_alpha: float = 0.95, occlusion_falloff: float = 0.03,
              step_factor: float = 1.0) -> Tuple[Tensor, Tensor, Tensor]:
    """Front-to-back composite of colors (..., K, 3) and alphas (..., K)
    matching fs:100-103; step_factor != 1 applies the opacity correction
    a' = 1 - (1 - a)^step_factor.  Returns (color, occlusion, alpha)."""
    if step_factor != 1.0:
        keep = (1.0 - alphas) ** step_factor
        scale = torch.where(
            alphas > 1e-6, (1.0 - keep) / torch.clamp_min(alphas, 1e-6),
            step_factor)
        colors = colors * scale[..., None]
        alphas = 1.0 - keep
    one_m = 1.0 - alphas
    # exclusive cumprod: T_k = prod_{j<k} (1 - a_j); T_0 = 1
    t_incl = torch.cumprod(one_m, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]],
                       dim=-1)
    # loop-top early-out: step k runs iff alpha-so-far < MAX_ALPHA (fs:94)
    active = (1.0 - t_excl) < max_alpha
    w = torch.where(active, t_excl, 0.0)
    color = torch.sum(w[..., None] * colors, dim=-2)
    atten = 1.0 + occlusion_falloff * G.constant(diameters, colors.device,
                                                 colors.dtype)
    occlusion = torch.sum(w * alphas / atten, dim=-1)
    alpha = 1.0 - torch.prod(torch.where(active, one_m, 1.0), dim=-1)
    return color, occlusion, alpha


