"""Direction-major dense cone marching and the direction basis (port of
vct_tpu/core/dense.py:41-357).

March a cone from EVERY field voxel center along a fixed direction: each
step samples the mip level at (voxel center + dist_k * dir), a constant
world offset, so the sample is a separable shifted-trilinear resample of
the whole level.  The JAX package writes each axis as a (df, dl)
interpolation-matrix contraction because the TPU has no fast gather, and
XLA fuses the scan over steps into one program.  Here the host builds the
two nonzeros of every such matrix row, for every direction and tap, into
one tap table (direction_taps: `_axis_indices` over every direction,
tap and axis at once), and the march is one call of ops/dense.py: one
launch of the hand-written kernel csrc/dense.cu on the card, the eager
gather-and-lerp march (`index_select` and a lerp per axis) on the CPU.

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

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import dense as OD

Tensor = torch.Tensor


def _axis_indices(df: int, dl, shift_vox_l
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Field row i (at field res df) sampling a level of size dl shifted
    by shift_vox_l level voxels: t = (i + 0.5) * (dl / df) + shift - 0.5.
    Returns (i0, i1, frac) with clamp-to-edge, length df along the last
    axis; dl and shift_vox_l may be arrays of shape (..., 1), which
    broadcast to (..., df) in the same float64 arithmetic."""
    t = (np.arange(df) + 0.5) * (dl / df) + shift_vox_l - 0.5
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


def direction_taps(dirs: np.ndarray, schedule: M.MarchSchedule, groups,
                   dims: Sequence[int], df: int, world_size: float,
                   dtype: torch.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Every axis tap of every direction's march, in the order the march
    consumes them, on the host: idx (B, n, 3, 2, df) int32 and w (B, n, 3,
    2, df) float32, _axis_indices over every (direction, tap, axis) at
    once.

    (w0, w1) are the two nonzeros of the reference's interpolation-matrix
    row, rounded to `dtype` as the reference rounds the matrix; where both
    taps clamp to one cell the weights add first and the second tap gets
    weight zero."""
    ks, levels = zip(*tap_order(groups))
    dl = np.asarray(dims, np.int64)[list(levels)][None, :, None, None]
    dist = np.asarray(schedule.dists, np.float64)[list(ks)]
    shift = (dirs[:, None, :] * dist[None, :, None]
             / (world_size / dl[..., 0]))                       # (B, n, 3)
    i0, i1, f = _axis_indices(df, dl, shift[..., None])
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
    """directional_march_multi's ops/dense.Plan: the tap table of every
    direction, built once on the host, and the step table, on the mips'
    device."""
    df = field_dim or mips[0].shape[0]
    wd = compute_dtype or torch.float32
    dirs = np.asarray(directions, np.float64)
    assert dirs.ndim == 2 and dirs.shape[1] == 3
    dims = [m.shape[0] for m in mips]
    lod_plan, groups = plan_groups(schedule.lods, len(mips))
    idx, w = direction_taps(dirs, schedule, groups, dims, df, world_size, wd)
    return OD.make_plan(
        [(idx[:, :, ax], w[:, :, ax]) for ax in range(3)],
        tap_levels(groups),
        step_table(schedule, lod_plan, groups, occlusion_falloff), dirs,
        (df, df, df), mips[0].device, wd, schedule.step_factor, max_alpha,
        opacity_gain, transmittance_only)


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
    return OD.dense_march(mips, march_plan(mips, directions, schedule,
                                           world_size, **kw))


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
