"""Direction-major dense cone march (kernel 9; replaces the XLA scan of
vct_tpu/core/dense.py:134 directional_march_multi).

`dense_march` launches `csrc/dense.cu` for CUDA tensors, once a call for
every direction and cell, and runs the plain PyTorch version for CPU
tensors.  Both read one `Plan`, built on the host by core/dense.py
`march_plan` (or parallel/brick.py for a brick's x-slab): the tap table
of every direction (int32 indices, float32 weights already rounded to
the compute dtype), copied to the card once, and the step table.

The plain version is the eager march the port ran before the kernel: per
direction, each tap two `index_select`s and a lerp per axis (`_take3`),
then the composite (`march_steps`).  On CUDA tensors the kernel runs
inside `DenseMarch`, an autograd Function whose backward replays the
plain version (`_build.replay_grads`), as the JAX package differentiates
this march by autodiff of the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from vctbench.reference.core import aniso as A
from vctbench.reference.core import grid as G

Tensor = torch.Tensor

MAX_LEVELS = 16    # csrc/dense.cu kMaxLevels
# keep = (1 - a) ** sf as at::pow(Tensor, Scalar) evaluates it
POW_MODES = {1.0: 0, 0.5: 1, 2.0: 2, 3.0: 3}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One march call, built on the host.  Output cells (nx, ny, nz) =
    `shape`; `idx`/`w` (nb, ntaps, 2 (nx + ny + nz)) rows [x i0 | x i1 |
    y i0 | y i1 | z i0 | z i1] on the march's device; `steps` per step
    (tap, level, second tap or -1, its level, w, 1 - w, attenuation), the
    floats float32 values as Python floats; `step_i`/`step_f` the same on
    the device for the kernel (step_f holds the attenuation's float32
    reciprocal); `w6` (nb, 6) each direction's anisotropic blend weights;
    `extent` per level the taps' highest index + 1 along x, y, z."""

    shape: Tuple[int, int, int]
    idx: Tensor
    w: Tensor
    steps: Tuple[tuple, ...]
    step_i: Tensor
    step_f: Tensor
    w6: Tensor
    extent: dict
    compute: torch.dtype
    step_factor: float
    max_alpha: float
    opacity_gain: float
    transmittance: bool

    @property
    def nb(self) -> int:
        return self.idx.shape[0]

    @property
    def channels(self) -> int:
        """Output channels a direction: transmittance, or rgb and
        occlusion."""
        return 1 if self.transmittance else 4


def make_plan(axes, tap_levels: Sequence[int], steps, directions,
              shape, device, compute, step_factor: float, max_alpha: float,
              opacity_gain: float, transmittance: bool) -> Plan:
    """A Plan from per-axis host tap tables, axes = ((idx, w), ...) for x,
    y, z, each (nb, ntaps, 2, n_axis) (int indices, float32 weights; n_axis
    the output's cells along that axis), each tap's level, the steps as
    (tap, level, second tap or -1, its level, w, 1 - w, attenuation) and
    the (nb, 3) directions.  Every table goes to `device` in one copy
    through pinned memory (core/grid.constant)."""
    idx = np.concatenate([np.asarray(i).reshape(i.shape[:2] + (-1,))
                          for i, _ in axes], axis=2).astype(np.int32)
    w = np.concatenate([np.asarray(v).reshape(v.shape[:2] + (-1,))
                        for _, v in axes], axis=2).astype(np.float32)
    # per tap the highest index + 1 along x, y, z; per level their maximum
    reach = np.stack([np.asarray(i).max(axis=(0, 2, 3)) + 1 for i, _ in axes],
                     axis=1)
    extent = {}
    for j, lvl in enumerate(tap_levels):
        extent[lvl] = np.maximum(extent.get(lvl, 0), reach[j])
    step_i = np.array([s[:4] for s in steps], np.int32).reshape(-1, 4)
    step_f = np.array([(s[4], s[5], np.float32(1.0) / np.float32(s[6]))
                       for s in steps], np.float32).reshape(-1, 3)
    w6 = np.stack([A.aniso_weights_static(d) for d in directions])
    return Plan(shape=tuple(shape), idx=G.constant(idx, device, torch.int32),
                w=G.constant(w, device), steps=tuple(steps),
                step_i=G.constant(step_i, device, torch.int32),
                step_f=G.constant(step_f, device),
                w6=G.constant(w6, device),
                extent={k: tuple(int(e) for e in v)
                        for k, v in extent.items()},
                compute=compute, step_factor=float(step_factor),
                max_alpha=float(max_alpha),
                opacity_gain=float(opacity_gain),
                transmittance=bool(transmittance))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _take3(level: Tensor, idx, w, out_dtype: torch.dtype) -> Tensor:
    """Separable shifted resample of level (lx, ly, lz, C) -> float32
    (nx, ny, nz, C); idx/w per axis (i0, i1) and (w0, w1).  Each axis
    reads `level.dtype` values and accumulates in float32; the
    intermediate between axes is rounded to `out_dtype`."""
    out = level
    for ax in range(3):
        if ax > 0:
            out = out.to(out_dtype)
        shape = [1, 1, 1, 1]
        shape[ax] = -1
        a = out.index_select(ax, idx[ax][0]).float()
        b = out.index_select(ax, idx[ax][1]).float()
        out = a * w[ax][0].view(shape) + b * w[ax][1].view(shape)
    return out


def _tap_rows(row: Tensor, shape) -> tuple:
    """One tap row of the table -> per axis (i0, i1) views."""
    out, o = [], 0
    for n in shape:
        out.append((row[o:o + n], row[o + n:o + 2 * n]))
        o += 2 * n
    return tuple(out)


def march_steps(take, plan: Plan, dev, walked=None):
    """One direction's march over the plan's steps, front to back, from
    every cell of the output block: take(lvl, j) is the j-th tap's
    resample of level lvl, float32 (*shape, C).  Returns (t,)
    transmittance (*shape, 1), or (color (*shape, 3), occlusion (*shape,
    1)).  walked, an int32 view (*shape), where given, receives each
    cell's steps taken before its early-out (the kernel's count)."""
    shape = plan.shape
    sf = plan.step_factor
    if walked is not None:
        walked.fill_(len(plan.steps) if plan.transmittance else 0)
    t = torch.ones(shape + (1,), dtype=torch.float32, device=dev)
    if not plan.transmittance:
        color = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
        occ = torch.zeros(shape + (1,), dtype=torch.float32, device=dev)
    for j0, l0, j1, l1, w, one_m, atten in plan.steps:
        s = take(l0, j0)
        if j1 >= 0:
            s = s * one_m + take(l1, j1) * w
        a = s[..., -1:]
        if plan.opacity_gain != 1.0:
            a = torch.clamp_max(a * plan.opacity_gain, 1.0)
        keep = (1.0 - a) ** sf if sf != 1.0 else 1.0 - a
        if plan.transmittance:
            t = t * keep
            continue
        rgb = s[..., :3]
        if sf != 1.0:
            # optical-depth correction (march.composite): one
            # sample stands in for step_factor steps
            scale = torch.where(
                a > 1e-6, (1.0 - keep) / torch.clamp_min(a, 1e-6), sf)
            rgb = rgb * scale
            a = 1.0 - keep
        # loop-top early-out (fs:94): stop once 1-T >= max_alpha
        active = (1.0 - t) < plan.max_alpha
        if walked is not None:
            walked += active[..., 0]
        wgt = torch.where(active, t, 0.0)
        color = color + wgt * rgb
        occ = occ + wgt * a / atten
        t = torch.where(active, t * keep, t)
    if plan.transmittance:
        return (t,)
    return color, occ


def dense_march_plain(levels: Sequence[Tensor], plan: Plan,
                      walked: Tensor | None = None) -> Tensor:
    """The march in plain PyTorch, one direction after another: levels
    (d, d, d, C) or anisotropic (d, d, d, 6, C), read as the compute dtype
    (the alpha channel alone when transmittance); returns float32 (*shape,
    nb * channels).  walked, an int32 (*shape, nb), where given, receives
    each (cell, direction)'s steps before its early-out."""
    wd = plan.compute
    if plan.transmittance:
        levels = [m[..., -1:] for m in levels]
    # directional levels (d, d, d, 6, C) resample packed, c channels each
    chans = [m.shape[-1] if A.is_aniso_level(m) else None for m in levels]
    lv = [(A.packed(m) if c else m).to(wd) for m, c in zip(levels, chans)]
    dev = levels[0].device
    cout = plan.channels
    out = torch.empty(plan.shape + (plan.nb * cout,), dtype=torch.float32,
                      device=dev)
    for b in range(plan.nb):
        idx, wts, w6 = plan.idx[b], plan.w[b], plan.w6[b]

        def take(lvl, j):
            """Resample level lvl with tap j; a directional level's six
            directions blend after the resample."""
            s = _take3(lv[lvl], _tap_rows(idx[j], plan.shape),
                       _tap_rows(wts[j], plan.shape), wd)
            if chans[lvl] is None:
                return s
            return A.blend(s.reshape(s.shape[:-1] + (6, chans[lvl])), w6)

        res = march_steps(take, plan, dev,
                          None if walked is None else walked[..., b])
        if plan.transmittance:
            out[..., b:b + 1] = res[0]
        else:
            out[..., 4 * b:4 * b + 3] = res[0]
            out[..., 4 * b + 3:4 * b + 4] = res[1]
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _level_views(levels: Sequence[Tensor], plan: Plan) -> list:
    """The tensors the kernel reads: each level, its alpha channel alone
    when transmittance (a view: no copy)."""
    return [m[..., -1:] if plan.transmittance else m for m in levels]


def dense_march(levels: Sequence[Tensor], plan: Plan,
                walked: Tensor | None = None) -> Tensor:
    """The march of `plan` over `levels` (the plain version); walked as in
    dense_march_plain."""
    return dense_march_plain(levels, plan, walked)


# float operations the kernel issues, each rounded on its own: a tap's
# resample, a channel of a direction of six (x: 4 lerps of 2 multiplies
# and an add, y: 2, z: 1); an anisotropic blend, a channel (6 multiplies,
# 5 adds); a two-level step's lerp, a channel; keep = (1 - a)^sf by pow
# mode (sqrt, x * x and powf counted as 1); the composite a step:
# transmittance 1 - a and t * keep, field the early-out test (2), 1 - a,
# color (6), occlusion (3) and t * keep; with sf != 1 the optical-depth
# correction (compare, 1 - keep, max, divide, 3 multiplies, 1 - keep);
# with an opacity gain a multiply and a min
OPS_RESAMPLE = 21
OPS_BLEND = 11
OPS_LERP = 3
OPS_POW = {0: 0, 1: 1, 2: 1, 3: 2, 4: 1}
OPS_STEP_TRANSMITTANCE = 2
OPS_STEP_FIELD = 13
OPS_OPTICAL_DEPTH = 8
OPS_GAIN = 2


def march_work(levels: Sequence[Tensor], plan: Plan,
               walked: Tensor | None = None) -> Tuple[int, int]:
    """(bytes, float operations) the march must move and do, from its
    shapes: each level a tap reads read once (the alpha channel alone when
    transmittance), the tap and step tables read once, the output written
    once; the operations of the steps each (cell, direction) takes, from
    `walked` (the kernel's or the plain version's count), or of every step
    where it is None."""
    nbytes = sum(v.numel() * v.element_size()
                 for i, v in enumerate(_level_views(levels, plan))
                 if i in plan.extent)
    nbytes += sum(t.numel() * t.element_size() for t in (
        plan.idx, plan.w, plan.step_i, plan.step_f, plan.w6))
    nbytes += int(np.prod(plan.shape)) * plan.nb * plan.channels * 4
    nc = plan.channels
    mode = POW_MODES.get(plan.step_factor, 4)
    step = (OPS_POW[mode] + (OPS_GAIN if plan.opacity_gain != 1.0 else 0)
            + (OPS_STEP_TRANSMITTANCE if plan.transmittance else
               OPS_STEP_FIELD + (OPS_OPTICAL_DEPTH if mode else 0)))

    def tap(lvl):
        nd = 6 if A.is_aniso_level(levels[lvl]) else 1
        return nc * (nd * OPS_RESAMPLE + (OPS_BLEND if nd == 6 else 0))

    cost = [step + tap(l0) + (tap(l1) + nc * OPS_LERP if j1 >= 0 else 0)
            for _, l0, j1, l1, _, _, _ in plan.steps]
    prefix = np.concatenate([[0], np.cumsum(cost)])
    if walked is None:
        count = np.zeros(len(prefix), np.int64)
        count[-1] = int(np.prod(plan.shape)) * plan.nb
    else:
        count = torch.bincount(walked.flatten().long(),
                               minlength=len(prefix)).cpu().numpy()
    return int(nbytes), int(np.dot(count, prefix))
