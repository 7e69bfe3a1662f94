"""2x2x2 mip reduction (kernel 1; replaces vct_tpu/ops/mip_pallas.py).

`downsample2x` launches `csrc/mip.cu` for CUDA tensors and runs the plain
PyTorch version (core/grid.py downsample2x) for CPU tensors.  It takes any
channel count, so the voxel build's radiance and occupancy pyramids and
the frame tables' light (C=1) and field (C=208) pyramids all use it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES = 0       # kernel launches since the last reset (chip_smoke reads it)

downsample2x_plain = G.downsample2x


def downsample2x_cuda(grid: Tensor, alpha_mode: str = "mean") -> Tensor:
    global LAUNCHES
    if alpha_mode not in ("mean", "max"):
        raise ValueError(f"unknown alpha_mode {alpha_mode!r}")
    _build.require(grid.is_cuda and grid.dtype == torch.float32
                   and grid.dim() == 4 and grid.is_contiguous(),
                   "mip kernel takes a contiguous float32 (D, D, D, C) "
                   "CUDA tensor")
    d, c = grid.shape[0], grid.shape[-1]
    _build.require(grid.shape[:3] == (d, d, d) and d & (d - 1) == 0,
                   f"mip kernel takes a power-of-two cube, got {tuple(grid.shape)}")
    if d == 1:
        return grid
    h = d // 2
    out = torch.empty((h, h, h, c), dtype=grid.dtype, device=grid.device)
    status = _build.library().vct_mip_downsample(
        grid.data_ptr(), out.data_ptr(), h, c, int(alpha_mode == "max"),
        _build.stream())
    _build.check(status, "vct_mip_downsample")
    LAUNCHES += 1
    return out


def downsample2x(grid: Tensor, alpha_mode: str = "mean") -> Tensor:
    if _build.uses_kernel(grid):
        return downsample2x_cuda(grid, alpha_mode)
    return downsample2x_plain(grid, alpha_mode)


def build_mips(grid: Tensor, num_levels: int | None = None,
               alpha_mode: str = "mean") -> Tuple[Tensor, ...]:
    """Full isotropic mip pyramid, level 0 = input."""
    mips = [grid]
    for _ in range(G.num_mip_levels(grid.shape[0], num_levels) - 1):
        mips.append(downsample2x(mips[-1], alpha_mode))
    return tuple(mips)
