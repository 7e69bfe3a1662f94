"""Direction-major dense cone marching and the direction basis (port of
vct_tpu/core/dense.py:41-357).

March a cone from EVERY field voxel center along a fixed direction: each
step samples the mip level at (voxel center + dist_k * dir), a constant
world offset, so the sample is a separable shifted-trilinear resample of
the whole level.  The JAX package writes each axis as a (df, dl)
interpolation-matrix contraction because the TPU has no fast gather; here
each axis is two row gathers (`index_select`) and a lerp with the same two
weights per row, which is the same arithmetic: a row of that matrix has
exactly two nonzeros (one where the two taps clamp to the same cell).

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

from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M

Tensor = torch.Tensor


def _axis_indices(df: int, dl: int, shift_vox_l: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Field row i (at field res df) sampling a level of size dl shifted
    by shift_vox_l level voxels: t = (i + 0.5) * (dl / df) + shift - 0.5.
    Returns (i0, i1, frac) with clamp-to-edge, all length df."""
    t = (np.arange(df) + 0.5) * (dl / df) + shift_vox_l - 0.5
    i0 = np.floor(t)
    f = (t - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    i1 = np.clip(i0 + 1, 0, dl - 1)
    i0c = np.clip(i0, 0, dl - 1)
    return i0c.astype(np.int32), i1.astype(np.int32), f


def _direction_taps(direction: np.ndarray, schedule: M.MarchSchedule,
                    plan, groups, dims: Sequence[int], df: int,
                    world_size: float, dtype: torch.dtype, device
                    ) -> Tuple[Tensor, Tensor]:
    """Every axis tap of one direction's march, in the order the march
    consumes them, built on the host and moved in one copy each:
    idx (n, 3, 2, df) int64 and w (n, 3, 2, df) float32.

    (w0, w1) are the two nonzeros of the reference's interpolation-matrix
    row, rounded to `dtype` as the reference rounds the matrix; where both
    taps clamp to one cell the weights add first and the second tap gets
    weight zero."""
    idx, wts = [], []
    for (l0, l1), steps in groups:
        for k in steps:
            for lvl in ((l0, l1) if l1 != l0 else (l0,)):
                dl = dims[lvl]
                shift = direction * schedule.dists[k] / (world_size / dl)
                for ax in range(3):
                    i0, i1, f = _axis_indices(df, dl, float(shift[ax]))
                    one_m = np.float32(1.0) - f
                    same = i0 == i1
                    idx.append(np.stack([i0, i1]))
                    wts.append(np.stack([
                        np.where(same, one_m + f, one_m),
                        np.where(same, np.float32(0.0), f)]))
    n = len(idx) // 3
    idx = torch.as_tensor(np.stack(idx).astype(np.int64).reshape(n, 3, 2, df))
    w = torch.as_tensor(np.stack(wts).astype(np.float32).reshape(n, 3, 2, df))
    return idx.to(device), w.to(dtype).float().to(device)


def _take3(level: Tensor, idx: Tensor, w: Tensor,
           out_dtype: torch.dtype) -> Tensor:
    """Separable shifted resample of level (dl, dl, dl, C) -> float32
    (df, df, df, C); idx/w (3, 2, df) from _direction_taps.  Each axis
    reads `level.dtype` values and accumulates in float32; the
    intermediate between axes is rounded to `out_dtype`."""
    out = level
    for ax in range(3):
        if ax > 0:
            out = out.to(out_dtype)
        shape = [1, 1, 1, 1]
        shape[ax] = -1
        a = out.index_select(ax, idx[ax, 0]).float()
        b = out.index_select(ax, idx[ax, 1]).float()
        out = a * w[ax, 0].view(shape) + b * w[ax, 1].view(shape)
    return out


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


def directional_march_multi(
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
) -> Tensor:
    """March the cone schedule from every field voxel center along each of
    B fixed directions.  Returns float32 (df, df, df, B*4): per direction
    (color.rgb, occlusion) in channels b*4..b*4+3 — the layout the JAX
    package's build_cone_field produces — or (df, df, df, B) transmittance
    when transmittance_only.  Directions run one after another in Python,
    so only one direction's carry is live at a time.  Levels of an
    anisotropic stack blend by aniso_weights_static of each direction."""
    d0 = mips[0].shape[0]
    df = field_dim or d0
    dev = mips[0].device
    wd = compute_dtype or torch.float32
    if transmittance_only:
        mips = [m[..., -1:] for m in mips]
    # directional levels (d, d, d, 6, C) resample packed, c channels each
    chans = [m.shape[-1] if A.is_aniso_level(m) else None for m in mips]
    levels = [(A.packed(m) if c else m).to(wd) for m, c in zip(mips, chans)]
    dirs = np.asarray(directions, np.float64)
    assert dirs.ndim == 2 and dirs.shape[1] == 3
    nb = dirs.shape[0]
    plan, groups = plan_groups(schedule.lods, len(mips))
    cout = 1 if transmittance_only else 4
    out = torch.empty((df, df, df, nb * cout), dtype=torch.float32,
                      device=dev)
    sf = schedule.step_factor
    dims = [m.shape[0] for m in mips]

    for b in range(nb):
        idx, wts = _direction_taps(dirs[b], schedule, plan, groups, dims,
                                   df, world_size, wd, dev)
        w6 = G.constant(A.aniso_weights_static(dirs[b]), dev)

        def take(lvl, j):
            """Resample level lvl with tap j; a directional level's six
            directions blend after the resample."""
            s = _take3(levels[lvl], idx[j], wts[j], wd)
            if chans[lvl] is None:
                return s
            return A.blend(s.reshape(s.shape[:-1] + (6, chans[lvl])), w6)

        j = 0
        t = torch.ones((df, df, df, 1), dtype=torch.float32, device=dev)
        if not transmittance_only:
            color = torch.zeros((df, df, df, 3), dtype=torch.float32,
                                device=dev)
            occ = torch.zeros((df, df, df, 1), dtype=torch.float32,
                              device=dev)
        for (l0, l1), steps in groups:
            for k in steps:
                s = take(l0, j)
                j += 1
                if l1 != l0:
                    w = np.float32(plan[k][2])
                    s1 = take(l1, j)
                    j += 1
                    s = s * float(np.float32(1.0) - w) + s1 * float(w)
                a = s[..., -1:]
                if opacity_gain != 1.0:
                    a = torch.clamp_max(a * opacity_gain, 1.0)
                keep = (1.0 - a) ** sf if sf != 1.0 else 1.0 - a
                if transmittance_only:
                    t = t * keep
                    continue
                rgb = s[..., :3]
                if sf != 1.0:
                    # optical-depth correction (march.composite): one
                    # sample stands in for step_factor steps
                    scale = torch.where(
                        a > 1e-6, (1.0 - keep) / torch.clamp_min(a, 1e-6),
                        sf)
                    rgb = rgb * scale
                    a = 1.0 - keep
                atten = float(np.float32(
                    1.0 + occlusion_falloff * schedule.diameters[k]))
                # loop-top early-out (fs:94): stop once 1-T >= max_alpha
                active = (1.0 - t) < max_alpha
                wgt = torch.where(active, t, 0.0)
                color = color + wgt * rgb
                occ = occ + wgt * a / atten
                t = torch.where(active, t * keep, t)
        if transmittance_only:
            out[..., b:b + 1] = t
        else:
            out[..., 4 * b:4 * b + 3] = color
            out[..., 4 * b + 3:4 * b + 4] = occ
    return out


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
