"""2x2x2 mip reduction (kernel 1; replaces vct_tpu/ops/mip_pallas.py).

`downsample2x` launches `csrc/mip.cu` for CUDA tensors and runs the plain
PyTorch version (core/grid.py downsample2x) for CPU tensors.  It takes any
channel count, so the voxel build's radiance and occupancy pyramids and
the frame tables' light (C=1) and field (C=208) pyramids all use it.

On CUDA tensors the kernel runs inside `Downsample2x`, an autograd
Function whose backward is the hand-written adjoint in the same source
(`vct_mip_downsample_bwd`): the gradient of core/grid.py build_mips, which
`downsample2x_bwd_plain` writes out in plain PyTorch.  CPU tensors
differentiate the plain version directly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vctbench.reference.core import grid as G

Tensor = torch.Tensor


downsample2x_plain = G.downsample2x


def _check_mode(alpha_mode: str) -> None:
    if alpha_mode not in ("mean", "max"):
        raise ValueError(f"unknown alpha_mode {alpha_mode!r}")


def _corner_weights(alpha: Tensor) -> list:
    """Per corner (x outer, z inner) of each parent, the share of the
    parent's alpha cotangent that the forward's pairwise maximum chain
    passes it: alpha (D, D, D) -> 8 tensors (D/2, D/2, D/2)."""
    a = [alpha[ix::2, iy::2, iz::2]
         for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)]
    m = [a[0]]
    for aj in a[1:]:
        m.append(torch.maximum(m[-1], aj))
    one, half, zero = 1.0, 0.5, 0.0

    def share(x, y):          # d max(x, y) / dx: 1 above, 1/2 at a tie
        return torch.where(x > y, one, torch.where(x == y, half, zero))

    w = [None] * 8
    carry = torch.ones_like(alpha[::2, ::2, ::2])
    for j in range(7, 0, -1):
        w[j] = carry * share(a[j], m[j - 1])
        carry = carry * share(m[j - 1], a[j])
    w[0] = carry
    return w


def downsample2x_bwd_plain(gout: Tensor, alpha: Tensor | None = None,
                           alpha_mode: str = "mean") -> Tensor:
    """The adjoint of downsample2x, written out: cotangents (H, H, H, C)
    -> (2H, 2H, 2H, C).  Each child takes 0.125 of its parent's cotangent
    in the mean channels; with alpha_mode "max" the last channel's
    cotangent follows the forward's maximum chain over the children's
    alphas `alpha` (2H, 2H, 2H), a tie splitting it in halves (the
    derivative of torch.maximum and jnp.maximum)."""
    _check_mode(alpha_mode)
    g = gout * 0.125
    gin = g.repeat_interleave(2, 0).repeat_interleave(2, 1) \
        .repeat_interleave(2, 2)
    if alpha_mode == "max":
        ga = gout[..., -1]
        corners = [(ix, iy, iz)
                   for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)]
        for (ix, iy, iz), w in zip(corners, _corner_weights(alpha)):
            gin[ix::2, iy::2, iz::2, -1] = w * ga
    return gin


def downsample2x(grid: Tensor, alpha_mode: str = "mean") -> Tensor:
    return downsample2x_plain(grid, alpha_mode)


def build_mips(grid: Tensor, num_levels: int | None = None,
               alpha_mode: str = "mean") -> Tuple[Tensor, ...]:
    """Full isotropic mip pyramid, level 0 = input."""
    mips = [grid]
    for _ in range(G.num_mip_levels(grid.shape[0], num_levels) - 1):
        mips.append(downsample2x(mips[-1], alpha_mode))
    return tuple(mips)
