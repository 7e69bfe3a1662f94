"""The per-pixel cone march of the upstream fragment shader, written from
its loop (Shader/VoxelConeTracing.fs:82-107):

    dist = voxelWorldSize;  startPos = P + N * voxelWorldSize
    while dist < MAX_DISTANCE and alpha < MAX_ALPHA:
        diameter = max(voxelWorldSize, 2 * tanHalfAngle * dist)
        lod      = log2(diameter / voxelWorldSize)
        c        = textureLod(VoxelTexture, uvw(startPos + dist * dir), lod)
        color     += (1 - alpha) * c.rgb
        occlusion += (1 - alpha) * c.a / (1 + 0.03 * diameter)
        alpha     += (1 - alpha) * c.a
        dist      += diameter

on the anisotropic pyramid of Crassin et al. 2011 (reference_aniso).
Plain torch, float32, one step of every ray at a time.

Where it departs from the shader:
  * the loop runs over the steps of the distance recurrence for every
    ray, and a ray whose alpha reached MAX_ALPHA keeps its sums (a mask
    in place of the loop's exit);
  * textureLod's level clamp is to the pyramid's levels, which may be
    fewer than log2(D) + 1 (GridConfig.levels);
  * at levels >= 1 the sample blends the six directional values of the
    pyramid by the squared components of the cone's direction (d_i^2 on
    the side the cone travels toward), where the paper interpolates the
    three facing directions linearly; level 0 is isotropic;
  * ConeSetConfig.max_steps, where set, caps the steps (the shader has no
    cap).

`march_work` counts one frame's marches from the same schedules: the
float operations of the least sample and composite at each scheduled
step, and the bytes of a lower bound on their traffic (every pyramid
level a step samples read once, each ray's inputs read once and its
outputs written once).  The least sample reads, at a 6-direction level,
only the three directions the cone faces: the other three carry weight
0, which this module's sample multiplies through.  Given the share of
the scheduled samples still under max_alpha, it counts that many of the
cheapest scheduled samples, since samples past the early-out change
nothing.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from vctbench.reference.core import grid as G

Tensor = torch.Tensor

# float32 values a ray reads (position, vertex normal, tangent,
# bitangent, the reflection axis) and writes (rgb and occlusion of the
# diffuse gather and of the specular cone)
RAY_INPUTS = 15
RAY_OUTPUTS = 8
# float operations of one sample outside its level reads: the point
# start + dist * dir (6) and its uvw (9); the composite: 1 - alpha (1),
# color (6), occlusion (3: a multiply, a divide, an add), alpha (2)
POINT_OPS = 15
COMPOSITE_OPS = 12
# one level read, trilinear, of C channels (grid.trilinear_sample): the
# texel coordinate and fraction (9), the three 1 - f (3), and per
# channel 7 lerps of 3 operations
LEVEL_OPS = 12
CHANNEL_OPS = 21
# a 6-direction level (>= 1) is read for the FACING directions of
# nonzero weight (direction_weights) and blended: per channel 3
# multiplies and 2 adds
FACING = 3
BLEND_OPS = 5
# the lerp between two levels, per channel
LERP_OPS = 3


class Step(NamedTuple):
    dist: float
    diameter: float
    lod: float


def cone_steps(tan_half_angle: float, voxel: float, max_distance: float,
               max_steps: Optional[int] = None) -> List[Step]:
    """The shader's distance recurrence unrolled (fs:89-105)."""
    steps: List[Step] = []
    dist = voxel
    while dist < max_distance:
        diameter = max(voxel, 2.0 * tan_half_angle * dist)
        steps.append(Step(dist, diameter, math.log2(diameter / voxel)))
        dist += diameter
        if max_steps is not None and len(steps) >= max_steps:
            break
    return steps


def level_pair(lod: float, num_levels: int) -> Tuple[int, int, float]:
    """textureLod's two levels around `lod` and the upper one's weight."""
    lod = min(max(lod, 0.0), float(num_levels - 1))
    lo = int(math.floor(lod))
    hi = min(lo + 1, num_levels - 1)
    return lo, hi, lod - lo


def direction_weights(direction: Tensor) -> Tensor:
    """(N, 3) unit directions -> (N, 6) weights over (+x, -x, +y, -y, +z,
    -z): the squared component on the side the cone travels toward."""
    sq = direction * direction
    zero = torch.zeros_like(sq)
    pos = direction >= 0.0
    plus = torch.where(pos, sq, zero)
    minus = torch.where(pos, zero, sq)
    return torch.stack([plus[:, 0], minus[:, 0], plus[:, 1], minus[:, 1],
                        plus[:, 2], minus[:, 2]], dim=-1)


def sample_level(level: Tensor, uvw: Tensor, w6: Tensor) -> Tensor:
    """One level at uvw (N, 3) -> (N, C): trilinear; a 6-direction level
    (d, d, d, 6, C) is read for all six directions at once and blended
    by w6 (N, 6)."""
    if level.dim() == 4:
        return G.trilinear_sample(level, uvw)
    d, c = level.shape[0], level.shape[-1]
    six = G.trilinear_sample(level.reshape(d, d, d, 6 * c), uvw)
    six = six.reshape(-1, 6, c)
    out = w6[:, 0:1] * six[:, 0]
    for k in range(1, 6):
        out = out + w6[:, k:k + 1] * six[:, k]
    return out


def cone_trace(pyramid: Sequence[Tensor], start: Tensor, direction: Tensor,
               steps: Sequence[Step], world_size: float, max_alpha: float,
               falloff: float,
               q: Optional[Callable[[Tensor], Tensor]] = None
               ) -> Tuple[Tensor, Tensor]:
    """Voxel_Cone_Tracing(direction, tanHalfAngle) for N rays: start
    (N, 3) already offset along the normal, direction (N, 3) unit.
    Returns (color (N, 3), occlusion (N,)).  q, where given, rounds each
    sample (the control)."""
    n = start.shape[0]
    color = start.new_zeros((n, 3))
    occlusion = start.new_zeros((n,))
    alpha = start.new_zeros((n,))
    w6 = direction_weights(direction)
    half = G.scalar_like(start, world_size * 0.5)
    for st in steps:
        live = alpha < max_alpha
        uvw = (start + st.dist * direction) / half * 0.5 + 0.5
        lo, hi, w = level_pair(st.lod, len(pyramid))
        c = sample_level(pyramid[lo], uvw, w6)
        if w > 0.0 and hi != lo:
            c = c * (1.0 - w) + sample_level(pyramid[hi], uvw, w6) * w
        if q is not None:
            c = q(c)
        keep = 1.0 - alpha
        a = c[:, 3]
        color = torch.where(live[:, None], color + keep[:, None] * c[:, :3],
                            color)
        occlusion = torch.where(
            live, occlusion + keep * a / (1.0 + falloff * st.diameter),
            occlusion)
        alpha = torch.where(live, alpha + keep * a, alpha)
    return color, occlusion


def sample_ops(steps: Sequence[Step], channels: Sequence[int],
               aniso: Sequence[bool]) -> List[int]:
    """Float operations of each of one ray's least samples over `steps`,
    through levels of these channel counts (a direction's, at a
    6-direction level)."""
    def level(l):
        if aniso[l]:
            return (LEVEL_OPS + (CHANNEL_OPS * FACING + BLEND_OPS)
                    * channels[l])
        return LEVEL_OPS + CHANNEL_OPS * channels[l]

    out = []
    for st in steps:
        lo, hi, w = level_pair(st.lod, len(channels))
        ops = POINT_OPS + COMPOSITE_OPS + level(lo)
        if w > 0.0 and hi != lo:
            ops += level(hi) + LERP_OPS * channels[hi]
        out.append(ops)
    return out


def march_work(rays: int, cones: Sequence[Sequence[Step]],
               level_shapes: Sequence[Tuple[int, ...]], active: float
               ) -> Tuple[int, int]:
    """(bytes, float operations) of `rays` rays each marching one cone of
    every schedule in `cones` through a float32 pyramid of these level
    shapes (level 0 (D, D, D, C), level l >= 1 (d, d, d, 6, C)), where
    the marches run the share `active` of their scheduled samples: the
    operations of that many of the cheapest scheduled samples, a lower
    bound whichever samples they are."""
    n = len(level_shapes)
    aniso = [len(s) == 5 for s in level_shapes]
    touched = set()
    for steps in cones:
        for st in steps:
            lo, hi, w = level_pair(st.lod, n)
            touched.add(lo)
            if w > 0.0 and hi != lo:
                touched.add(hi)
    pyramid = sum(math.prod(level_shapes[l]) for l in touched)
    nbytes = 4 * (pyramid + rays * (RAY_INPUTS + RAY_OUTPUTS))
    costs = sorted(c for steps in cones for c in sample_ops(
        steps, [s[-1] for s in level_shapes], aniso))
    left, ops = active * len(costs), 0.0
    for c in costs:
        take = min(1.0, left)
        if take <= 0.0:
            break
        ops += take * c
        left -= take
    return nbytes, int(rays * ops)
