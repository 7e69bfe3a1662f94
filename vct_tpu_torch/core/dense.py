"""Direction-major dense cone marching and the direction basis (port of
vct_tpu/core/dense.py:41-357).

March a cone from EVERY field voxel center along a fixed direction: each
step samples the mip level at (voxel center + dist_k * dir), a constant
world offset, so the sample is a separable shifted-trilinear resample of
the whole level.  The JAX package writes each axis as a (df, dl)
interpolation-matrix contraction because the TPU has no fast gather, and
XLA fuses the scan over steps into one program.  Here a march's
ops/dense.Plan holds the two nonzeros of every such matrix row, for every
direction and tap, in one tap table, and the march is one call of
ops/dense.py: one launch of the hand-written kernel csrc/dense.cu on the
card, the eager gather-and-lerp march (`index_select` and a lerp per
axis) on the CPU.

A Plan has two halves (march_plan).  The direction-free half (each tap's
level, distance and level size and the step table, on the host and on
the device) depends only on the schedule, the level sizes and the
march's constants; `plan_half` builds it once and holds it in a small
memo, so a relight step, which marches the same three schedules under a
new sun, finds all three there.  The direction half,
the tap table, is written on the card by one launch of
csrc/dense.cu's dense_kernel_taps for CUDA levels (ops/dense.taps_cuda),
and on the host by tap_table (`_axis_indices` over every direction, tap
and axis at once) for CPU levels, in the same float64 arithmetic
(tap_rows); parallel/brick.py cuts a rank's x-slab from the same table.

Rounding points follow the reference: in bfloat16 compute the level and
the interpolation weights are bfloat16, each axis accumulates in float32
and is rounded back to bfloat16 before the next axis, and the composite
runs in float32.  Products of two bfloat16 values are exact in float32,
so each axis rounds once, as the matmul with float32 accumulation does.

Anisotropic stacks (core/aniso.py) resample each 5-D level packed to
(d, d, d, 6C) and blend its six directions by the march direction's
static weights after the resample, as the JAX package does: blending the
level first is the same sum in exact arithmetic, but in bfloat16 compute
it would round the blended level, not the six resampled ones.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import dense as OD
from vct_tpu_torch.stages import span

Tensor = torch.Tensor


def _axis_indices(df: int, dl, shift_vox_l, cells=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Field row i (at field res df) sampling a level of size dl shifted
    by shift_vox_l level voxels: t = (i + 0.5) * (dl / df) + shift - 0.5.
    Returns (i0, i1, frac) with clamp-to-edge, length df along the last
    axis; dl and shift_vox_l may be arrays of shape (..., 1), which
    broadcast to (..., df) in the same float64 arithmetic.  `cells`, where
    given, an int64 array of rows i, gives those rows alone."""
    i = np.arange(df) if cells is None else cells
    t = (i + 0.5) * (dl / df) + shift_vox_l - 0.5
    i0 = np.floor(t)
    f = (t - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    i1 = np.clip(i0 + 1, 0, dl - 1)
    i0c = np.clip(i0, 0, dl - 1)
    return i0c.astype(np.int32), i1.astype(np.int32), f


def plan_groups(lods, num_levels):
    """(per-step lod plan, consecutive runs of the same (l0, l1) pair)."""
    plan = M._static_lod_plan(lods, num_levels)
    groups: list = []
    for k, (l0, l1, w) in enumerate(plan):
        l1e = l1 if w > 0.0 and l1 != l0 else l0
        if groups and groups[-1][0] == (l0, l1e):
            groups[-1][1].append(k)
        else:
            groups.append(((l0, l1e), [k]))
    return plan, groups


def tap_order(groups) -> list:
    """(step, level) of each tap, in the order the march consumes them:
    per step its first level, then its second for a two-level step."""
    return [(k, lvl) for (l0, l1), steps in groups for k in steps
            for lvl in ((l0, l1) if l1 != l0 else (l0,))]


def tap_levels(groups) -> list:
    return [lvl for _, lvl in tap_order(groups)]


def tap_geometry(schedule: M.MarchSchedule, groups, dims: Sequence[int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Each tap's distance along the cone (float64) and the size of its
    level (int64), in tap_order."""
    ks, levels = zip(*tap_order(groups))
    return (np.asarray(schedule.dists, np.float64)[list(ks)],
            np.asarray(dims, np.int64)[list(levels)])


def _tap_shift(dirs: np.ndarray, dist: np.ndarray, dl: np.ndarray,
               world_size: float) -> np.ndarray:
    """(B, n, 3): each direction's shift at each tap along each axis, in
    voxels of the tap's level."""
    return (dirs[:, None, :] * dist[None, :, None]
            / (world_size / dl[None, :, None]))


def direction_taps(dirs: np.ndarray, schedule: M.MarchSchedule, groups,
                   dims: Sequence[int], df: int, world_size: float,
                   dtype: torch.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Every axis tap of every direction's march, in the order the march
    consumes them, on the host: idx (B, n, 3, 2, df) int32 and w (B, n, 3,
    2, df) float32, _axis_indices over every (direction, tap, axis) at
    once.  The plain version of csrc/dense.cu's dense_kernel_taps.

    (w0, w1) are the two nonzeros of the reference's interpolation-matrix
    row, rounded to `dtype` as the reference rounds the matrix; where both
    taps clamp to one cell the weights add first and the second tap gets
    weight zero."""
    return tap_table(dirs, *tap_geometry(schedule, groups, dims), df,
                     world_size, dtype)


def tap_table(dirs: np.ndarray, dist: np.ndarray, dl: np.ndarray, df: int,
              world_size: float, dtype: torch.dtype
              ) -> Tuple[np.ndarray, np.ndarray]:
    """direction_taps from each tap's distance and level size
    (tap_geometry)."""
    shift = _tap_shift(dirs, dist, dl, world_size)              # (B, n, 3)
    i0, i1, f = _axis_indices(df, dl[None, :, None, None], shift[..., None])
    one_m = np.float32(1.0) - f
    same = i0 == i1
    idx = np.stack([i0, i1], axis=3)
    w = np.stack([np.where(same, one_m + f, one_m),
                  np.where(same, np.float32(0.0), f)], axis=3)
    w = torch.as_tensor(w).to(dtype).float().numpy()
    return idx, w


def step_table(schedule: M.MarchSchedule, plan, groups,
               occlusion_falloff: float) -> list:
    """Per step, in order: (first tap, its level, second tap or -1, its
    level, w, 1 - w, attenuation), the floats float32 values as Python
    floats (ops/dense.Plan.steps)."""
    steps, j = [], 0
    for (l0, l1), ks in groups:
        for k in ks:
            atten = float(np.float32(
                1.0 + occlusion_falloff * schedule.diameters[k]))
            if l1 != l0:
                w = np.float32(plan[k][2])
                steps.append((j, l0, j + 1, l1, float(w),
                              float(np.float32(1.0) - w), atten))
                j += 2
            else:
                steps.append((j, l0, -1, l0, 0.0, 1.0, atten))
                j += 1
    return steps


def tap_reach(dirs: np.ndarray, half: PlanHalf, last=None) -> np.ndarray:
    """Each tap's highest index + 1 along x, y, z (ntaps, 3) in `dirs`'
    tap table, from the last row along each axis alone (`last`, a row
    each for x, y, z; the field's last by default): t rises with the
    row, so the last row's second index is the axis' highest."""
    df = half.shape[0]
    rows = np.asarray((df - 1,) * 3 if last is None else last, np.int64)
    shift = _tap_shift(dirs, half.dist, half.dl, half.world_size)
    _, i1, _ = _axis_indices(df, half.dl[None, :, None, None],
                             shift[..., None], rows[:, None])
    return i1[..., 0].max(axis=0).astype(np.int64) + 1


def tap_extent(dirs: np.ndarray, half: PlanHalf) -> dict:
    """ops/dense.Plan.extent of `dirs`' tap table (tap_reach per level)."""
    return OD.level_extent(tap_reach(dirs, half), half.levels)


@dataclasses.dataclass(frozen=True)
class PlanHalf:
    """The direction-free half of a march's ops/dense.Plan (march_plan):
    each tap's level (`levels`, tap_levels), the steps (step_table) as a
    tuple and on the device (`step_i`, `step_f`), each tap's distance and
    level size on the host (`dist` float64, `dl` int64, read-only) and on
    the device (`tap_dist` float64, `tap_dl` int32), and the march's
    constants.  Held in plan_half's memo: nothing may write into its
    arrays or tensors."""

    shape: Tuple[int, int, int]
    levels: tuple
    steps: tuple
    step_i: Tensor
    step_f: Tensor
    dist: np.ndarray
    dl: np.ndarray
    tap_dist: Tensor
    tap_dl: Tensor
    world_size: float
    compute: torch.dtype
    step_factor: float
    max_alpha: float
    opacity_gain: float
    transmittance: bool


PLAN_MEMO_SIZE = 8      # a relight step marches 3 schedules


@functools.lru_cache(maxsize=PLAN_MEMO_SIZE)
def plan_half(schedule: M.MarchSchedule, dims: Tuple[int, ...], df: int,
              world_size: float, compute: torch.dtype,
              occlusion_falloff: float, max_alpha: float,
              opacity_gain: float, transmittance: bool,
              device: torch.device) -> PlanHalf:
    """The direction-free half of a march's Plan for these values, built
    at the first call and then held (PLAN_MEMO_SIZE entries, the least
    recently used leaving first; plan_memo_info counts the hits)."""
    lod_plan, groups = plan_groups(schedule.lods, len(dims))
    dist, dl = tap_geometry(schedule, groups, dims)
    tap_dist = G.constant(dist, device, torch.float64)
    tap_dl = G.constant(dl, device, torch.int32)
    dist.flags.writeable = False
    dl.flags.writeable = False
    steps = tuple(step_table(schedule, lod_plan, groups, occlusion_falloff))
    step_i, step_f = OD.step_tables(steps, device)
    return PlanHalf(
        shape=(df, df, df), levels=tuple(tap_levels(groups)), steps=steps,
        step_i=step_i, step_f=step_f, dist=dist, dl=dl, tap_dist=tap_dist,
        tap_dl=tap_dl, world_size=world_size, compute=compute,
        step_factor=float(schedule.step_factor), max_alpha=max_alpha,
        opacity_gain=opacity_gain, transmittance=transmittance)


def plan_memo_info():
    """plan_half's memo: hits, misses, maxsize and size
    (functools.lru_cache's cache_info)."""
    return plan_half.cache_info()


def march_half(mips: Sequence[Tensor], schedule: M.MarchSchedule,
               world_size: float, field_dim: Optional[int] = None,
               max_alpha: float = 0.95, occlusion_falloff: float = 0.03,
               opacity_gain: float = 1.0, transmittance_only: bool = False,
               compute_dtype: Optional[torch.dtype] = None) -> PlanHalf:
    """plan_half for a march over `mips` (march_plan's keywords), on the
    mips' device."""
    return plan_half(schedule, tuple(m.shape[0] for m in mips),
                     field_dim or mips[0].shape[0], float(world_size),
                     compute_dtype or torch.float32, float(occlusion_falloff),
                     float(max_alpha), float(opacity_gain),
                     bool(transmittance_only), mips[0].device)


def tap_rows(dirs: np.ndarray, half: PlanHalf, mips: Sequence[Tensor]
             ) -> Tuple[Tensor, Tensor]:
    """`dirs`' tap table in ops/dense.Plan's layout on the mips' device,
    idx int32 and w float32 (nb, ntaps, 6 df): one dense_kernel_taps
    launch (ops/dense.taps_cuda) for CUDA levels, tap_table on the host
    for CPU levels."""
    df = half.shape[0]
    if _build.uses_kernel(*mips):
        return OD.taps_cuda(dirs, half.tap_dist, half.tap_dl, df,
                            half.world_size, half.compute)
    idx, w = tap_table(dirs, half.dist, half.dl, df, half.world_size,
                       half.compute)
    rows = (dirs.shape[0], len(half.levels), -1)
    return (G.constant(idx.reshape(rows), mips[0].device, torch.int32),
            G.constant(w.reshape(rows), mips[0].device))


def half_plan(half: PlanHalf, dirs: np.ndarray, idx: Tensor, w: Tensor,
              extent: dict, shape: Tuple[int, int, int]) -> OD.Plan:
    """The Plan of `dirs` from its direction-free half and its tap table
    (idx, w, extent) over output cells `shape`."""
    return OD.Plan(shape=tuple(shape), idx=idx, w=w, steps=half.steps,
                   step_i=half.step_i, step_f=half.step_f,
                   w6=G.constant(OD.direction_weights(dirs),
                                 half.step_i.device),
                   extent=extent, compute=half.compute,
                   step_factor=half.step_factor, max_alpha=half.max_alpha,
                   opacity_gain=half.opacity_gain,
                   transmittance=half.transmittance)


def march_plan(
    mips: Sequence[Tensor],
    directions,                          # (B, 3) unit world directions
    schedule: M.MarchSchedule,
    world_size: float,
    field_dim: Optional[int] = None,
    max_alpha: float = 0.95,
    occlusion_falloff: float = 0.03,
    opacity_gain: float = 1.0,
    transmittance_only: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> OD.Plan:
    """directional_march_multi's ops/dense.Plan on the mips' device: the
    direction-free half from plan_half's memo, the tap table of every
    direction from one dense_kernel_taps launch (CUDA levels) or from
    tap_table on the host (CPU levels) (tap_rows), `extent` from each
    row's last cell (tap_extent) and `w6` from the host."""
    dirs = np.asarray(directions, np.float64)
    assert dirs.ndim == 2 and dirs.shape[1] == 3
    half = march_half(mips, schedule, world_size, field_dim, max_alpha,
                      occlusion_falloff, opacity_gain, transmittance_only,
                      compute_dtype)
    idx, w = tap_rows(dirs, half, mips)
    return half_plan(half, dirs, idx, w, tap_extent(dirs, half), half.shape)


def directional_march_multi(mips: Sequence[Tensor], directions,
                            schedule: M.MarchSchedule, world_size: float,
                            **kw) -> Tensor:
    """March the cone schedule from every field voxel center along each of
    B fixed directions (keywords as march_plan).  Returns float32 (df, df,
    df, B*4): per direction (color.rgb, occlusion) in channels
    b*4..b*4+3 — the layout the JAX package's build_cone_field produces —
    or (df, df, df, B) transmittance when transmittance_only.  One call
    of ops/dense.dense_march: one kernel launch on the card.  Levels of
    an anisotropic stack blend by aniso_weights_static of each
    direction."""
    with span("dense.plan", mark=False):
        plan = march_plan(mips, directions, schedule, world_size, **kw)
    return OD.dense_march(mips, plan)


def directional_march(mips: Sequence[Tensor], direction: Sequence[float],
                      schedule: M.MarchSchedule, world_size: float,
                      **kw) -> Tensor:
    """Single-direction directional_march_multi."""
    return directional_march_multi(
        mips, np.asarray(direction, np.float64)[None], schedule, world_size,
        **kw)


def direction_basis(n: int = 26) -> np.ndarray:
    """World-space direction basis: 6 faces, or 6 faces + 12 edges + 8
    corners of the cube (normalized)."""
    if n == 6:
        dirs = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                [0, 0, -1]]
    elif n == 26:
        dirs = [[x, y, z] for x in (-1, 0, 1) for y in (-1, 0, 1)
                for z in (-1, 0, 1) if not x == y == z == 0]
    else:
        raise ValueError(f"unsupported basis size {n}")
    d = np.asarray(dirs, np.float64)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def basis_weights(dirs: Tensor, basis: np.ndarray, power: float = 8.0
                  ) -> Tensor:
    """Spherical interpolation weights of query dirs (..., 3) over the
    basis (B, 3): max(cos, 0)^power normalized to sum 1.  Power-of-two
    exponents (the config's 8 and 32) use repeated squaring, as the
    reference does."""
    cos = dirs @ G.constant(basis, dirs.device, dirs.dtype).T
    w = torch.clamp_min(cos, 0.0)
    p = float(power)
    if p > 0 and p == int(p) and (int(p) & (int(p) - 1)) == 0:
        for _ in range(int(np.log2(int(p)))):
            w = w * w
    else:
        w = w ** power
    return w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-8)
