"""Static cone-march schedules (port of vct_tpu/core/march.py:47-113).

The reference loop (VoxelConeTracing.fs:82-107) advances by the cone
diameter, and diameter/lod depend only on config constants, so the whole
step schedule is static.  Pure Python: identical to the JAX package's
schedule (tests/test_torch_host.py pins the equality).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


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
    plan = []
    for lod in lods:
        lod = min(max(lod, 0.0), num_levels - 1)
        l0 = min(int(math.floor(lod)), num_levels - 1)
        l1 = min(l0 + 1, num_levels - 1)
        w = lod - l0
        plan.append((l0, l1, w))
    return plan
