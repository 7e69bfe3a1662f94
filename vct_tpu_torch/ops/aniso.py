"""The anisotropic (6-direction) radiance pyramid's levels: core/aniso.py's
pyramid on the card, one launch of `csrc/aniso.cu` a level.

`downsample_aniso` takes level l, the isotropic level 0 (D, D, D, C) or a
6-direction level (d, d, d, 6, C), to level l+1 (d/2, d/2, d/2, 6, C).
CUDA tensors launch the kernel, which equals the plain version bit for
bit; CPU tensors run the plain PyTorch version (core/aniso.py
downsample_aniso_from_iso, downsample_aniso).  `build_aniso_mips` is the
whole pyramid by that rule.

On CUDA tensors the kernel runs inside `_build.Replay`, the autograd
Function whose backward replays the plain version under autograd, so a
level that needs a gradient keeps it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import _build

Tensor = torch.Tensor


def downsample_aniso_plain(level: Tensor) -> Tensor:
    """Level l -> level l+1 in plain PyTorch: from the isotropic level 0
    or from a 6-direction level."""
    if A.is_aniso_level(level):
        return A.downsample_aniso(level)
    return A.downsample_aniso_from_iso(level)


def downsample_aniso_cuda(level: Tensor) -> Tensor:
    aniso = A.is_aniso_level(level)
    _build.require(level.is_cuda and level.dtype == torch.float32
                   and level.is_contiguous()
                   and (level.dim() == 4 or (aniso and level.shape[3] == 6)),
                   "anisotropic pyramid kernel takes a contiguous float32 "
                   "(D, D, D, C) or (D, D, D, 6, C) CUDA tensor")
    d, c = level.shape[0], level.shape[-1]
    _build.require(level.shape[:3] == (d, d, d) and d > 1
                   and d & (d - 1) == 0,
                   "anisotropic pyramid kernel takes a power-of-two cube "
                   "wider than 1, got {}", tuple(level.shape))
    h = d // 2
    out = torch.empty((h, h, h, 6, c), dtype=level.dtype,
                      device=level.device)
    vec4 = c % 4 == 0 and level.data_ptr() % 16 == 0
    _build.launch("vct_aniso_downsample", level.data_ptr(), out.data_ptr(),
                  h, c, 6 if aniso else 1, int(vec4))
    return out


def downsample_aniso(level: Tensor) -> Tensor:
    if _build.uses_kernel(level):
        return _build.Replay.apply(downsample_aniso_cuda,
                                   downsample_aniso_plain, (), level)
    return downsample_aniso_plain(level)


def build_aniso_mips(grid: Tensor, num_levels: Optional[int] = None
                     ) -> Tuple[Tensor, ...]:
    """The whole pyramid, (iso level 0, aniso level 1, ...), as
    core/aniso.py build_aniso_mips, each level by `downsample_aniso`."""
    mips = [grid]
    for _ in range(G.num_mip_levels(grid.shape[0], num_levels) - 1):
        mips.append(downsample_aniso(mips[-1]))
    return tuple(mips)
