"""The per-pixel cone march of the per-cone route (render/shading's
"percone" providers) on the card: `csrc/percone.cu`, one launch a call.

What it computes is the upstream shader's loop (VoxelConeTracing.fs:82-107,
as `vctbench/reference_oracle/march.py` cone_trace writes it): per (ray,
cone), front to back over the schedule's steps while alpha < max_alpha,

    c      = quadrilinear sample at start + dist * dir (lerp of two levels)
    color     += (1 - alpha) * c.rgb
    occlusion += (1 - alpha) * c.a / (1 + falloff * diameter)
    alpha     += (1 - alpha) * c.a

and then the K cones' static-weight sum in cone order (fs:196-199).  A
6-direction level (core/aniso.py) is read for the three directions the
cone faces, blended by the squared components in direction order: the
other three carry weight exactly 0 in `aniso_weights`, so skipping them
changes no bit.

  * step_table — per step the distance, the two levels and the lerp
    weights and the occlusion divisor, from the schedule on the host in
    double precision, each rounded once to float32 where it is used, as
    the reference's Python scalars are; built once per schedule, and
    read_levels, the levels it reads (the march's only operands);
  * gather_plain — the kernel's function in plain PyTorch: each level's
    samples gathered in one call by core/grid and core/aniso's samplers,
    the composite in the kernel's order of operations (the kernel's
    twin: chip_smoke holds the kernel to it bit for bit, and
    `_build.Replay` replays it for the backward);
  * gather_cuda — the launch;
  * cone_gather — the entry of render/shading on CUDA tensors, inside
    `_build.Replay`, counting `percone.samples` and `percone.active`
    while stages.counting() holds.

CPU tensors never come here: render/shading keeps core/march's batched
march for them, which the JAX package's tests hold the port to.  The
twin differs from core/march in its composite (a running sum with the
loop's exit, where core/march takes an exclusive cumulative product with
a mask), so the two agree to float32 rounding, and at an alpha that lands
on max_alpha they may stop a step apart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch import stages
from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import _build

Tensor = torch.Tensor

NC = 4               # rgba radiance channels
MAX_CONES = 8        # csrc/percone.cu kMaxCones
MAX_STEPS = 128      # csrc/percone.cu kMaxSteps
MAX_LEVELS = 16      # csrc/percone.cu kMaxLevels
MAX_CELLS = 1 << 31  # csrc/percone.cu addresses a level's texels in 32 bits


class Step(NamedTuple):
    """One scheduled sample: the distance along the axis, the two levels
    around its lod (l1 == l0 where the reference takes no lerp), the upper
    level's weight w, 1 - w, and the occlusion divisor 1 + falloff *
    diameter, each a Python float (double)."""

    dist: float
    l0: int
    l1: int
    w: float
    omw: float
    div: float


@functools.lru_cache(maxsize=16)
def step_table(schedule: M.MarchSchedule, num_levels: int,
               occlusion_falloff: float) -> Tuple[Step, ...]:
    """The schedule's steps on a pyramid of `num_levels` levels, with
    textureLod's level pair (grid.lod_levels).  Refuses a schedule with a
    step factor: the shader's loop has no opacity correction."""
    _build.require(schedule.step_factor == 1.0, "percone kernel: a "
                   "schedule with step factor {}, expected 1",
                   schedule.step_factor)
    steps = []
    for dist, diam, lod in zip(schedule.dists, schedule.diameters,
                               schedule.lods):
        l0, l1, w = G.lod_levels(lod, num_levels)
        if not (w > 0.0 and l1 != l0):
            l1 = l0
        steps.append(Step(dist, l0, l1, w, 1.0 - w,
                          1.0 + occlusion_falloff * diam))
    return tuple(steps)


@functools.lru_cache(maxsize=16)
def read_levels(table: Tuple[Step, ...]
                ) -> Tuple[Tuple[Step, ...], Tuple[int, ...]]:
    """The levels a table reads, in order (level 0 where it has no step),
    and the table with its levels renumbered into them.  The march takes
    these levels alone: under autograd a level it took but did not read
    would still get a gradient, zeros, and the mip backward of the levels
    above it would run for nothing."""
    levels = tuple(sorted({lv for st in table for lv in (st.l0, st.l1)}))
    at = {lv: i for i, lv in enumerate(levels)}
    return (tuple(st._replace(l0=at[st.l0], l1=at[st.l1]) for st in table),
            levels or (0,))


@functools.lru_cache(maxsize=16)
def _host_table(table: Tuple[Step, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The launch's copy of a step table: (nsteps, 4) float32 [dist, w,
    1 - w, divisor] and (nsteps, 2) int32 [l0, l1], each value rounded
    once from its double."""
    f = np.array([[s.dist, s.w, s.omw, s.div] for s in table],
                 np.float64).astype(np.float32).reshape(-1, 4)
    i = np.array([[s.l0, s.l1] for s in table], np.int32).reshape(-1, 2)
    return np.ascontiguousarray(f), np.ascontiguousarray(i)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def gather_plain(start: Tensor, dirs: Tensor, *pyramid: Tensor,
                 table: Tuple[Step, ...], weights: Sequence[float],
                 world_size: float, max_alpha: float,
                 walked: Tensor | None = None) -> Tensor:
    """The kernel's function in plain PyTorch: start (N, 3), dirs (N, K, 3)
    unit -> (N, 4) [sum_k w_k rgb_k, sum_k w_k occlusion_k].  Each level's
    samples are gathered in one call, as core/march.sample_schedule
    gathers them (grid.trilinear_sample; aniso.sample_aniso_level, whose
    six-direction blend equals the kernel's three facing directions),
    then the steps composite front to back in the kernel's order.  A
    ray's cone stops at the first step whose alpha so far is not under
    max_alpha (here a mask: the steps after it change nothing).  walked,
    a 0-d int64 tensor where given, gains the steps run."""
    n, k = dirs.shape[:2]
    s = start[:, None, :]
    uvw = [G.world_to_uvw(s + st.dist * dirs, world_size) for st in table]
    smp = {}
    for lv, level in enumerate(pyramid):
        at = [i for i, st in enumerate(table) if lv in (st.l0, st.l1)]
        if not at:
            continue
        # stacked, not indexed by a list: that index would be a host copy
        u = torch.stack([uvw[i] for i in at], dim=2)
        got = (A.sample_aniso_level(level, u, dirs[:, :, None, :]
                                    .expand(u.shape))
               if A.is_aniso_level(level) else G.trilinear_sample(level, u))
        smp.update(((lv, i), got[:, :, j]) for j, i in enumerate(at))
    color = start.new_zeros((n, k, 3))
    occ = start.new_zeros((n, k))
    alpha = start.new_zeros((n, k))
    for i, st in enumerate(table):
        live = alpha < max_alpha
        if walked is not None:
            walked += live.sum()
        c = smp[st.l0, i]
        if st.l1 != st.l0:
            c = c * st.omw + smp[st.l1, i] * st.w
        keep = 1.0 - alpha
        a = c[..., 3]
        color = torch.where(live[..., None],
                            color + keep[..., None] * c[..., :3], color)
        occ = torch.where(live, occ + keep * a / G.scalar_like(a, st.div),
                          occ)
        alpha = torch.where(live, alpha + keep * a, alpha)
    per_cone = torch.cat([color, occ[..., None]], dim=-1)
    out = start.new_zeros((n, NC))
    for i, w in enumerate(weights):
        out = out + w * per_cone[:, i]
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def gather_cuda(start: Tensor, dirs: Tensor, *pyramid: Tensor,
                table: Tuple[Step, ...], weights: Sequence[float],
                world_size: float, max_alpha: float,
                walked: Tensor | None = None) -> Tensor:
    """gather_plain's function in one launch of csrc/percone.cu.  Refuses
    a pyramid whose texels (d**3, times 6 at a 6-direction level) number
    MAX_CELLS or more: the kernel addresses them in 32 bits."""
    n, k = dirs.shape[:2]
    f32 = torch.float32
    _build.operand(start, f32, (n, 3), "percone kernel: start")
    _build.operand(dirs, f32, (n, k, 3), "percone kernel: dirs")
    _build.require(1 <= k <= MAX_CONES and len(weights) == k,
                   "percone kernel: 1 to {} cones with a weight each, got {} "
                   "cones and {} weights", MAX_CONES, k, len(weights))
    _build.require(1 <= len(pyramid) <= MAX_LEVELS and len(table) <= MAX_STEPS,
                   "percone kernel: 1 to {} levels and at most {} steps, got "
                   "{} levels and {} steps", MAX_LEVELS, MAX_STEPS,
                   len(pyramid), len(table))
    for li, m in enumerate(pyramid):
        d = m.shape[0]
        shape = (d, d, d, 6, NC) if m.dim() == 5 else (d, d, d, NC)
        _build.operand(m, f32, shape, f"percone kernel: level {li}")
        _build.require(m.data_ptr() % 16 == 0, "percone kernel: level {} "
                       "must be 16-byte aligned", li)
    cells = sum(m.numel() // NC for m in pyramid)
    _build.require(cells < MAX_CELLS, "percone kernel: a pyramid of {} "
                   "texels; the kernel addresses texels in 32 bits, fewer "
                   "than {}", cells, MAX_CELLS)
    if walked is not None:
        _build.operand(walked, torch.int64, (), "percone kernel: walked")
    out = torch.empty((n, NC), dtype=f32, device=start.device)
    if n == 0:
        return out
    fsteps, isteps = _host_table(table)
    nl = len(pyramid)
    levels = (ctypes.c_longlong * nl)(*(m.data_ptr() for m in pyramid))
    shape = (ctypes.c_int * (2 * nl))(*(
        v for m in pyramid for v in (m.shape[0], 6 if m.dim() == 5 else 1)))
    cw = (ctypes.c_float * k)(*weights)
    _build.launch("vct_percone", start.data_ptr(), dirs.data_ptr(), n, k,
                  ctypes.addressof(levels), ctypes.addressof(shape), nl,
                  fsteps.ctypes.data, isteps.ctypes.data, len(table),
                  ctypes.addressof(cw),
                  float(np.float32(world_size * 0.5)),
                  float(np.float32(max_alpha)), out.data_ptr(),
                  None if walked is None else walked.data_ptr())
    return out


def cone_gather(mips: Sequence[Tensor], start: Tensor, directions: Tensor,
                weights: Sequence[float], schedule: M.MarchSchedule,
                world_size: float, max_alpha: float = 0.95,
                occlusion_falloff: float = 0.03) -> Tuple[Tensor, Tensor]:
    """sum_k w_k ConeTrace(dir_k) on CUDA tensors, one launch: start
    (..., 3) already offset along the normal, directions (..., K, 3) unit,
    K static weights -> (rgb (..., 3), occlusion (...)).  While
    stages.counting() holds, the samples scheduled add to
    `percone.samples` and the steps run to `percone.active`, on the
    device."""
    lead = start.shape[:-1]
    k = directions.shape[-2]
    s = start.reshape(-1, 3).contiguous()
    d = directions.reshape(-1, k, 3).contiguous()
    table, levels = read_levels(step_table(schedule, len(mips),
                                           float(occlusion_falloff)))
    walked = None
    if stages.counting():
        stages.count("percone.samples", torch.full(
            (), s.shape[0] * k * len(table), dtype=torch.int64,
            device=s.device))
        walked = torch.zeros((), dtype=torch.int64, device=s.device)
    kw = dict(table=table, weights=tuple(weights), world_size=world_size,
              max_alpha=max_alpha)
    out = _build.Replay.apply(
        functools.partial(gather_cuda, walked=walked, **kw),
        functools.partial(gather_plain, **kw), (), s, d,
        *(mips[lv] for lv in levels))
    if walked is not None:
        stages.count("percone.active", walked)
    return out[:, :3].reshape(lead + (3,)), out[:, 3].reshape(lead)
