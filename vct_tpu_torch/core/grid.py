"""Voxel-grid math: world<->UVW mapping, trilinear sampling, mip reduction.

Port of vct_tpu/core/grid.py with the same conventions: uvw = p / (ws/2)
* 0.5 + 0.5 (VoxelConeTracing.fs:61-63), texel centers at (i+0.5)/D,
clamp-to-edge, grids (D, D, D, C) indexed [x, y, z, channel], mip stacks
as tuples with level 0 finest.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def scalar_like(x: Tensor, value: float) -> Tensor:
    """A 0-d tensor of x's dtype and device holding float32(value).

    Divide by this rather than by a Python float: CUDA rewrites
    tensor / python-scalar as a multiply by the reciprocal, which rounds
    differently from the IEEE division the reference performs."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def constant(x, device, dtype=torch.float32) -> Tensor:
    """A host constant (numbers, tuples, numpy) as a tensor on `device`.

    On the card the copy goes through pinned memory without blocking, so
    it does not wait for the queue: a plain host-to-device copy of
    pageable memory is a host synchronization."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def world_to_uvw(p: Tensor, world_size: float) -> Tensor:
    """World position(s) (..., 3) -> normalized texture coords in [0, 1]."""
    return p / scalar_like(p, world_size * 0.5) * 0.5 + 0.5


def uvw_to_world(uvw: Tensor, world_size: float) -> Tensor:
    return (uvw - 0.5) * world_size


def world_to_index(p: Tensor, world_size: float, dim: int) -> Tensor:
    """World position(s) (..., 3) -> int32 voxel index, clamped to the
    grid."""
    idx = torch.floor(world_to_uvw(p, world_size) * dim).to(torch.int32)
    return idx.clamp(0, dim - 1)


def voxel_center(idx: Tensor, world_size: float, dim: int) -> Tensor:
    """Integer voxel index (..., 3) -> the world-space center of it."""
    uvw = idx.to(torch.float32) + 0.5
    return uvw_to_world(uvw / scalar_like(uvw, dim), world_size)


def trilinear_sample(grid: Tensor, uvw: Tensor) -> Tensor:
    """GL-convention trilinear sample of one level.

    grid (D, D, D, C); uvw (..., 3) in [0, 1] -> (..., C)."""
    d = grid.shape[0]
    c = grid.shape[-1]
    t = uvw * d - 0.5
    i0 = torch.floor(t)
    f = t - i0
    i0 = i0.long()
    i1 = (i0 + 1).clamp(0, d - 1)
    i0 = i0.clamp(0, d - 1)
    flat = grid.reshape(-1, c)

    def gather(ix, iy, iz):
        return flat[(ix * d + iy) * d + iz]

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = gather(x0, y0, z0) * (1 - fz) + gather(x0, y0, z1) * fz
    c01 = gather(x0, y1, z0) * (1 - fz) + gather(x0, y1, z1) * fz
    c10 = gather(x1, y0, z0) * (1 - fz) + gather(x1, y0, z1) * fz
    c11 = gather(x1, y1, z0) * (1 - fz) + gather(x1, y1, z1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def lod_levels(lod: float, num_levels: int) -> Tuple[int, int, float]:
    """(l0, l1, w) of a static lod clamped into a stack of `num_levels`:
    the two levels around it and the weight of the upper one."""
    lod = min(max(float(lod), 0.0), num_levels - 1)
    l0 = min(int(math.floor(lod)), num_levels - 1)
    l1 = min(l0 + 1, num_levels - 1)
    return l0, l1, lod - l0


def sample_lod(mips: Sequence[Tensor], uvw: Tensor, lod: float) -> Tensor:
    """Quadrilinear textureLod with a static lod, a Python float
    (VoxelConeTracing.fs:65): trilinear in the two levels around it and a
    lerp between them."""
    l0, l1, w = lod_levels(lod, len(mips))
    s0 = trilinear_sample(mips[l0], uvw)
    if w == 0.0 or l1 == l0:
        return s0
    return s0 * (1 - w) + trilinear_sample(mips[l1], uvw) * w


def sample_voxels(mips: Sequence[Tensor], p_world: Tensor, lod: float,
                  world_size: float) -> Tensor:
    """SampleVoxels(worldPosition, lod) — VoxelConeTracing.fs:59-66."""
    return sample_lod(mips, world_to_uvw(p_world, world_size), lod)


def downsample2x(grid: Tensor, alpha_mode: str = "mean") -> Tensor:
    """One 2x2x2 box reduction (glGenerateMipmap level build).

    alpha_mode "max" keeps the mean color but takes the alpha channel's
    8-corner max (conservative occupancy for the shadow pyramid).  The
    corners are summed in the reference's order, x outer to z inner."""
    if alpha_mode not in ("mean", "max"):
        raise ValueError(f"unknown alpha_mode {alpha_mode!r}")
    if grid.shape[0] == 1:
        return grid
    corners = [grid[ix::2, iy::2, iz::2]
               for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)]
    total = corners[0]
    for c_ in corners[1:]:
        total = total + c_
    mean = total * 0.125
    if alpha_mode == "mean":
        return mean
    amax = corners[0][..., -1:]
    for c_ in corners[1:]:
        amax = torch.maximum(amax, c_[..., -1:])
    return torch.cat([mean[..., :-1], amax], dim=-1)


def num_mip_levels(d: int, num_levels: int | None) -> int:
    if d & (d - 1):
        raise ValueError(f"grid dim must be a power of two, got {d}")
    full = d.bit_length()
    return full if num_levels is None else min(num_levels, full)


def build_mips(grid: Tensor, num_levels: int | None = None,
               alpha_mode: str = "mean") -> Tuple[Tensor, ...]:
    """Full isotropic mip pyramid, level 0 = input (plain PyTorch)."""
    mips = [grid]
    for _ in range(num_mip_levels(grid.shape[0], num_levels) - 1):
        mips.append(downsample2x(mips[-1], alpha_mode))
    return tuple(mips)


def flatten_mips(mips: Sequence[Tensor]
                 ) -> Tuple[Tensor, Tuple[int, ...], Tuple[int, ...]]:
    """A mip stack as one (V_total, C) tensor, with each level's first row
    and its dim (the JAX package's Pallas layout; the port's kernels take
    the levels apart)."""
    c = mips[0].shape[-1]
    offsets, dims, off = [], [], 0
    for m in mips:
        offsets.append(off)
        dims.append(m.shape[0])
        off += m.shape[0] ** 3
    flat = torch.cat([m.reshape(-1, c) for m in mips], dim=0)
    return flat, tuple(offsets), tuple(dims)


def unflatten_mips(flat: Tensor, offsets: Sequence[int],
                   dims: Sequence[int]) -> Tuple[Tensor, ...]:
    c = flat.shape[-1]
    return tuple(flat[off:off + d ** 3].reshape(d, d, d, c)
                 for off, d in zip(offsets, dims))
