"""Direction-major dense cone march (kernel 9; replaces the XLA scan of
vct_tpu/core/dense.py:134 directional_march_multi).

`dense_march` launches `csrc/dense.cu` for CUDA tensors, once a call for
every direction and cell, and runs the plain PyTorch version for CPU
tensors.  Both read one `Plan`, made by core/dense.py `march_plan` (or
parallel/brick.py for a brick's x-slab): the tap table of every
direction (int32 indices, float32 weights already rounded to the compute
dtype) and the step table.  For CUDA levels march_plan has the tap table
written on the card by one `dense_kernel_taps` launch (`taps_cuda`); on
the CPU it is core/dense.py direction_taps' host table.

The plain version is the eager march the port ran before the kernel: per
direction, each tap two `index_select`s and a lerp per axis (`_take3`),
then the composite (`march_steps`).  On CUDA tensors the kernel runs
inside `_build.Replay`, the autograd Function whose backward replays the
plain version with respect to every level, as the JAX package
differentiates this march by autodiff of the same function.

The kernel reads a packed copy of the levels its taps read: contiguous,
channel-last values of the compute dtype (`pack_levels_plain` states it),
written by one `dense_kernel_pack` launch a march (`pack_levels_cuda`)
into a temporary, and skipped for a level already in that layout
(`level_slots`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import _build

Tensor = torch.Tensor

MAX_LEVELS = 16    # csrc/dense.cu kMaxLevels
MAX_TAP_DIRECTIONS = 64    # csrc/dense.cu kMaxTapDirs: one taps launch
PACK_ALIGN = 16    # bytes: each packed level starts here (the widest load)
# keep = (1 - a) ** sf as at::pow(Tensor, Scalar) evaluates it
POW_MODES = {1.0: 0, 0.5: 1, 2.0: 2, 3.0: 3}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One march call.  Output cells (nx, ny, nz) = `shape`; `idx`/`w`
    (nb, ntaps, 2 (nx + ny + nz)) rows [x i0 | x i1 | y i0 | y i1 | z i0 |
    z i1] on the march's device; `steps` per step
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
    through pinned memory (core/grid.constant).

    The host build, every table reduced and the blend weights taken a
    direction at a time: the oracle that tests and chip_smoke.py hold
    core/dense.py march_plan's memo and card-built table to."""
    idx = np.concatenate([np.asarray(i).reshape(i.shape[:2] + (-1,))
                          for i, _ in axes], axis=2).astype(np.int32)
    w = np.concatenate([np.asarray(v).reshape(v.shape[:2] + (-1,))
                        for _, v in axes], axis=2).astype(np.float32)
    # per tap the highest index + 1 along x, y, z
    reach = np.stack([np.asarray(i).max(axis=(0, 2, 3)) + 1 for i, _ in axes],
                     axis=1)
    step_i, step_f = step_tables(steps, device)
    return Plan(shape=tuple(shape), idx=G.constant(idx, device, torch.int32),
                w=G.constant(w, device), steps=tuple(steps), step_i=step_i,
                step_f=step_f,
                w6=G.constant(np.stack([A.aniso_weights_static(d)
                                        for d in directions]), device),
                extent=level_extent(reach, tap_levels), compute=compute,
                step_factor=float(step_factor), max_alpha=float(max_alpha),
                opacity_gain=float(opacity_gain),
                transmittance=bool(transmittance))


def step_tables(steps, device) -> Tuple[Tensor, Tensor]:
    """The steps on `device` for the kernel: step_i int32 (nsteps, 4) and
    step_f float32 (nsteps, 3), the attenuation as its float32
    reciprocal."""
    step_i = np.array([s[:4] for s in steps], np.int32).reshape(-1, 4)
    step_f = np.array([(s[4], s[5], np.float32(1.0) / np.float32(s[6]))
                       for s in steps], np.float32).reshape(-1, 3)
    return (G.constant(step_i, device, torch.int32),
            G.constant(step_f, device))


def level_extent(reach, tap_levels: Sequence[int]) -> dict:
    """Plan.extent from each tap's highest index + 1 along x, y, z (ntaps,
    3): per level the maximum over its taps."""
    levels = np.asarray(tap_levels)
    order = np.argsort(levels, kind="stable")
    keys, starts = np.unique(levels[order], return_index=True)
    top = np.maximum.reduceat(np.asarray(reach)[order], starts, axis=0)
    return {int(k): tuple(int(e) for e in t) for k, t in zip(keys, top)}


def direction_weights(directions) -> np.ndarray:
    """Plan.w6 on the host: (nb, 6) float32, each direction's static
    anisotropic blend weights, core/aniso.py aniso_weights_static over
    every direction at once.  The norm is summed in another order than
    aniso_weights_static's dot; the float32 weights absorb that, and
    tests/test_torch_dense.py holds them equal to its own."""
    d = np.asarray(directions, np.float64).reshape(-1, 3)
    d = d / np.sqrt(np.sum(d * d, axis=1, keepdims=True))
    sq, neg = d * d, d < 0
    return np.stack([np.where(neg, 0.0, sq), np.where(neg, sq, 0.0)],
                    axis=2).reshape(-1, 6).astype(np.float32)


def taps_cuda(dirs: np.ndarray, dist: Tensor, dl: Tensor, n: int,
              world_size: float, compute: torch.dtype
              ) -> Tuple[Tensor, Tensor]:
    """The tap table on the card, in Plan's layout: idx int32 and w
    float32 (nb, ntaps, 6n) for the (nb, 3) float64 host directions `dirs`
    and each tap's distance `dist` (float64) and level size `dl` (int32),
    both on the card; n cells along each axis.  One dense_kernel_taps
    launch per MAX_TAP_DIRECTIONS directions, which it takes by value: no
    copy, no host read.  Equal to core/dense.py direction_taps bit for
    bit."""
    nb, ntaps = dirs.shape[0], dist.shape[0]
    _build.operand(dist, torch.float64, (ntaps,), "dense march taps: dist")
    _build.operand(dl, torch.int32, (ntaps,), "dense march taps: dl")
    _build.require(compute in (torch.float32, torch.bfloat16),
                   "dense march taps: compute dtype {}, expected float32 or "
                   "bfloat16", compute)
    idx = torch.empty((nb, ntaps, 6 * n), dtype=torch.int32,
                      device=dist.device)
    w = torch.empty((nb, ntaps, 6 * n), dtype=torch.float32,
                    device=dist.device)
    d = np.ascontiguousarray(dirs, np.float64)
    for b0 in range(0, nb, MAX_TAP_DIRECTIONS):
        b1 = min(nb, b0 + MAX_TAP_DIRECTIONS)
        _build.launch("vct_dense_taps", d[b0:b1].ctypes.data, b1 - b0,
                      dist.data_ptr(), dl.data_ptr(), ntaps, n,
                      float(world_size), int(compute == torch.bfloat16),
                      idx[b0].data_ptr(), w[b0].data_ptr())
    return idx, w


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _take3(level: Tensor, idx, w, out_dtype: torch.dtype) -> Tensor:
    """Separable shifted resample of level (lx, ly, lz, C) -> float32
    (nx, ny, nz, C); idx/w per axis (i0, i1) and float32 (w0, w1).  Each
    axis reads `level.dtype` values and accumulates in float32 (the
    weights promote the gathers); the intermediate between axes is
    rounded to `out_dtype`."""
    out = level
    for ax in range(3):
        if ax > 0:
            out = out.to(out_dtype)
        shape = [1, 1, 1, 1]
        shape[ax] = -1
        a = out.index_select(ax, idx[ax][0])
        b = out.index_select(ax, idx[ax][1])
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
    """The values each level gives the march: the level, its alpha channel
    alone when transmittance (a view: no copy)."""
    return [m[..., -1:] if plan.transmittance else m for m in levels]


def pack_levels_plain(levels: Sequence[Tensor], plan: Plan) -> list:
    """The packed copy the kernel reads, in plain PyTorch: each level a
    tap reads as contiguous values of the compute dtype, (d, d, d, C) or
    (d, d, d, 6, C) (whose memory is core/aniso.py packed's (d, d, d,
    6C)), C = 1 (alpha) when transmittance; a level no tap reads as it
    is.  dense_march_plain gives the same bits over it as over `levels`."""
    return [v.to(plan.compute).contiguous() if i in plan.extent else m
            for i, (m, v) in enumerate(zip(levels,
                                           _level_views(levels, plan)))]


@dataclasses.dataclass(frozen=True)
class Slot:
    """One level as the kernel's pack sees it: `view` the values the march
    reads (_level_views), `nd` its directions (1 or 6), `read` whether a
    tap reads it, `pack` whether it needs the copy (read, and not already
    of the compute dtype, contiguous and PACK_ALIGN-aligned), `offset` its
    copy's first element in the pack buffer (-1 without one)."""

    view: Tensor
    nd: int
    read: bool
    pack: bool
    offset: int


def level_slots(levels: Sequence[Tensor], plan: Plan) -> Tuple[list, int]:
    """The host side of the packed copy: a Slot a level, and the pack
    buffer's length in elements of the compute dtype (each copy starting
    at a PACK_ALIGN boundary)."""
    align = PACK_ALIGN // torch.empty((), dtype=plan.compute).element_size()
    slots, total = [], 0
    for i, v in enumerate(_level_views(levels, plan)):
        read = i in plan.extent
        pack = read and not (v.dtype == plan.compute and v.is_contiguous()
                             and v.data_ptr() % PACK_ALIGN == 0)
        slots.append(Slot(v, 6 if A.is_aniso_level(v) else 1, read, pack,
                          total if pack else -1))
        if pack:
            total += -(-v.numel() // align) * align
    return slots, total


def pack_levels_cuda(levels: Sequence[Tensor], plan: Plan) -> list:
    """The kernel's packed copy: one dense_kernel_pack launch for every
    level that needs one (level_slots), into one temporary buffer.  Per
    level, the tensor the march reads: its copy (shaped as
    pack_levels_plain's), the level's values themselves where they are
    already packed, None where no tap reads it."""
    slots, total = level_slots(levels, plan)
    todo = [s for s in slots if s.pack]
    if not todo:
        return [s.view if s.read else None for s in slots]
    buf = torch.empty(total, dtype=plan.compute, device=levels[0].device)
    out = [buf[s.offset:s.offset + s.view.numel()].view(s.view.shape)
           if s.pack else (s.view if s.read else None) for s in slots]
    n = len(todo)
    src = (ctypes.c_longlong * n)()
    dst = (ctypes.c_longlong * n)()
    strides = (ctypes.c_longlong * (5 * n))()
    shape = (ctypes.c_int * (3 * n))()
    nd = (ctypes.c_int * n)()
    for k, (s, t) in enumerate((s, t) for s, t in zip(slots, out) if s.pack):
        v = s.view
        _build.require(v.shape[0] * v.shape[1] * v.shape[2] < 2 ** 31,
                       "dense march pack takes levels of fewer than 2^31 "
                       "voxels, got {}", tuple(v.shape[:3]))
        st = v.stride()
        src[k], dst[k] = v.data_ptr(), t.data_ptr()
        strides[5 * k:5 * k + 5] = [st[0], st[1], st[2],
                                    st[3] if s.nd == 6 else 0, st[-1]]
        shape[3 * k:3 * k + 3] = list(v.shape[:3])
        nd[k] = s.nd
    _build.launch("vct_dense_pack", ctypes.addressof(src),
                  ctypes.addressof(strides), ctypes.addressof(shape),
                  ctypes.addressof(nd), ctypes.addressof(dst), n,
                  plan.channels, int(levels[0].dtype == torch.bfloat16),
                  int(plan.compute == torch.bfloat16))
    return out


def level_table(packed: Sequence[Tensor | None]) -> Tuple[list, list,
                                                          list]:
    """The march kernel's level table from pack_levels_cuda's tensors: per
    level its pointer, the element strides of x and y (flat, two a level;
    z's is the voxel's nd * C values) and nd; 0, (0, 0) and 1 for a level
    no tap reads."""
    ptr, stride, nd = [], [], []
    for t in packed:
        ptr.append(0 if t is None else t.data_ptr())
        stride += [0, 0] if t is None else [t.stride(0), t.stride(1)]
        nd.append(6 if t is not None and A.is_aniso_level(t) else 1)
    return ptr, stride, nd


def dense_march_cuda(levels: Sequence[Tensor], plan: Plan,
                     walked: Tensor | None = None) -> Tensor:
    nl = len(levels)
    dtype = levels[0].dtype
    _build.require(1 <= nl <= MAX_LEVELS,
                   "dense march kernel takes 1 to {} levels, got {}",
                   MAX_LEVELS, nl)
    _build.require(all(m.is_cuda and m.dtype == dtype for m in levels)
                   and dtype in (torch.float32, torch.bfloat16),
                   "dense march kernel takes CUDA levels of one dtype, "
                   "float32 or bfloat16")
    _build.require(plan.compute in (torch.float32, torch.bfloat16),
                   "dense march kernel computes in float32 or bfloat16, not "
                   "{}", plan.compute)
    _build.require(plan.idx.is_cuda and plan.idx.device == levels[0].device,
                   "dense march plan must lie on the levels' card")
    nx, ny, nz = plan.shape
    _build.require(plan.idx.shape[2] == 2 * (nx + ny + nz)
                   and 1 <= plan.nb <= 65535,
                   "dense march plan's tap rows do not match its shape")
    if walked is not None:
        _build.operand(walked, torch.int32, plan.shape + (plan.nb,),
                       "dense march kernel: walked, (*shape, nb)")
    for i, v in enumerate(_level_views(levels, plan)):
        _build.require(v.dim() == 4 or (A.is_aniso_level(v)
                                        and v.shape[3] == 6),
                       "dense march level {}: (d, d, d, C) or (d, d, d, 6, "
                       "C), got {}", i, v.shape)
        _build.require(v.shape[-1] == plan.channels,
                       "dense march level {} has {} channels; the field "
                       "march reads rgba", i, v.shape[-1])
        if i in plan.extent:
            _build.require(all(v.shape[a] >= e
                               for a, e in enumerate(plan.extent[i])),
                           "dense march taps reach {} beyond level {}'s {}",
                           plan.extent[i], i, v.shape[:3])
    packed = pack_levels_cuda(levels, plan)
    ptr, stride, nds = level_table(packed)
    ptrs = (ctypes.c_longlong * nl)(*ptr)
    strides = (ctypes.c_longlong * (2 * nl))(*stride)
    nd = (ctypes.c_int * nl)(*nds)
    sf = plan.step_factor
    out = torch.empty(plan.shape + (plan.nb * plan.channels,),
                      dtype=torch.float32, device=levels[0].device)
    _build.launch("vct_dense_march", ctypes.addressof(ptrs),
                  ctypes.addressof(strides), ctypes.addressof(nd), nl,
                  int(plan.transmittance),
                  int(plan.compute == torch.bfloat16), plan.idx.data_ptr(),
                  plan.w.data_ptr(), plan.idx.shape[1],
                  plan.step_i.data_ptr(), plan.step_f.data_ptr(),
                  len(plan.steps), plan.w6.data_ptr(), plan.nb, nx, ny, nz,
                  POW_MODES.get(sf, 4), sf, int(plan.opacity_gain != 1.0),
                  plan.opacity_gain, plan.max_alpha, out.data_ptr(),
                  None if walked is None else walked.data_ptr())
    return out


def dense_march(levels: Sequence[Tensor], plan: Plan,
                walked: Tensor | None = None) -> Tensor:
    """The march of `plan` over `levels`: the kernel for CUDA tensors (or
    a raise), the plain version for CPU tensors; walked as in
    dense_march_plain."""
    if _build.uses_kernel(*levels, plan.idx):
        # a level no tap reads enters detached, as the plain version leaves
        # it out of the graph: an edge to it would run its producer's
        # backward (a mip's) on zeros
        levels = [m if i in plan.extent else m.detach()
                  for i, m in enumerate(levels)]
        return _build.Replay.apply(
            lambda *lv: dense_march_cuda(lv, plan, walked),
            lambda *lv: dense_march_plain(lv, plan), (), *levels)
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
