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
from typing import Dict, List, Sequence, Tuple

import torch

from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import grid as G

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


def sample_schedule(mips: Sequence[Tensor], points: Tensor,
                    lods: Sequence[float], world_size: float,
                    direction: Tensor | None = None) -> Tensor:
    """Quadrilinear samples of all K steps, points (..., K, 3) in world
    space -> (..., K, C).  Steps that share a mip level are gathered in one
    trilinear_sample call.  An anisotropic stack (core/aniso.py: levels
    >= 1 are 5-D with a 6-direction axis) blends its directional
    pre-integrations by the travel `direction` (..., 3), which it then
    requires."""
    if A.is_aniso_stack(mips) and direction is None:
        raise ValueError("anisotropic mip stack needs a march direction")
    k = points.shape[-2]
    assert k == len(lods)
    plan = _static_lod_plan(lods, len(mips))
    uvw = G.world_to_uvw(points, world_size)

    need: Dict[int, List[int]] = {}
    for step, (l0, l1, w) in enumerate(plan):
        need.setdefault(l0, []).append(step)
        if w > 0.0 and l1 != l0:
            need.setdefault(l1, []).append(step)

    per_level: Dict[int, Dict[int, Tensor]] = {}
    for lvl, steps in need.items():
        pts = torch.stack([uvw[..., s, :] for s in steps], dim=-2)
        if A.is_aniso_level(mips[lvl]):
            res = A.sample_aniso_level(
                mips[lvl], pts, direction[..., None, :].expand(pts.shape))
        else:
            res = G.trilinear_sample(mips[lvl], pts)        # (..., n, C)
        per_level[lvl] = {s: res[..., i, :] for i, s in enumerate(steps)}

    out = []
    for step, (l0, l1, w) in enumerate(plan):
        s0 = per_level[l0][step]
        if w > 0.0 and l1 != l0:
            out.append(s0 * (1.0 - w) + per_level[l1][step] * w)
        else:
            out.append(s0)
    return torch.stack(out, dim=-2)


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


def cone_march(mips: Sequence[Tensor], start: Tensor, direction: Tensor,
               schedule: MarchSchedule, world_size: float,
               max_alpha: float = 0.95, occlusion_falloff: float = 0.03
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Voxel_Cone_Tracing(direction, tanHalfAngle) — fs:82-107.  `start`
    (..., 3) already carries the normal offset (fs:92); direction (..., 3)
    is a unit vector.  Returns (color, occlusion, alpha)."""
    if schedule.num_steps == 0:
        shp = start.shape[:-1]
        z = start.new_zeros(shp)
        return start.new_zeros(shp + (3,)), z, z
    dists = G.constant(schedule.dists, start.device, start.dtype)
    points = start[..., None, :] + dists[:, None] * direction[..., None, :]
    samples = sample_schedule(mips, points, schedule.lods, world_size,
                              direction=direction)
    return composite(samples[..., :3], samples[..., 3], schedule.diameters,
                     max_alpha=max_alpha,
                     occlusion_falloff=occlusion_falloff,
                     step_factor=schedule.step_factor)


def cone_march_multi(mips: Sequence[Tensor], start: Tensor,
                     directions: Tensor, weights: Sequence[float],
                     schedule: MarchSchedule, world_size: float,
                     max_alpha: float = 0.95,
                     occlusion_falloff: float = 0.03
                     ) -> Tuple[Tensor, Tensor]:
    """Weighted multi-cone gather sum_i w_i * ConeTrace(dir_i) — fs:196-199:
    start (..., 3), directions (..., K, 3), K static weights.  Returns
    (color (..., 3), occlusion (...))."""
    color, occ, _ = cone_march(mips, start[..., None, :], directions,
                               schedule, world_size, max_alpha=max_alpha,
                               occlusion_falloff=occlusion_falloff)
    w = G.constant(weights, color.device, color.dtype)
    return (torch.sum(w[:, None] * color, dim=-2),
            torch.sum(w * occ, dim=-1))
