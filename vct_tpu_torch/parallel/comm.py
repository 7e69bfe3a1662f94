"""The collectives the port's parallel layer needs, in one place.

A reduce over a mesh axis (the splat's partial grids, the shadow map, the
parameter gradients), a gather along x over the model axis (the brick
march's slabs back to whole volumes), the neighbour exchange of the halo
rows, and a gather of image rows to one rank.

Transport.  With NCCL in the group's backend, CUDA tensors go to NCCL as
they are.  NCCL refuses two ranks on one card, so the ranks of a
one-card machine run on gloo, which serves CPU tensors: on an H100 with
PyTorch 2.11, gloo took CUDA tensors for all_reduce, broadcast,
all_gather and gather, but a send of one killed the sending rank
("writev: Bad address"; PERF.md, Findings).  So on a gloo group every
collective on a CUDA
tensor copies it to a host buffer, runs there and copies the result
back, the same way for every call, and STAGED_BYTES counts those bytes
(both ways).  The computation stays on the card: only the collective's
operands move.

Gradients.  The ranks of one model group render the same rows and so
hold the same loss; the train step scales each rank's loss by 1/n_model
(parallel/tile_dp.py).  Every collective whose result is replicated over
an axis therefore sums its gradient over that axis in backward: the
all-reduce's backward is an all-reduce, the x-gather's a reduce and
slice, and the halo exchange sends the halo rows' gradients back to
their owners.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# bytes copied between the card and the host to run collectives on gloo
STAGED_BYTES = 0

# the torch.distributed calls that count_calls counts
_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
          "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather",
          "scatter", "all_to_all", "all_to_all_single", "send", "recv",
          "isend", "irecv", "batch_isend_irecv", "barrier")

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group of its line
    along the axis, its coordinate on it, the line's size and the global
    ranks on it in coordinate order."""

    group: object
    index: int
    size: int
    ranks: Tuple[int, ...]


def axis(mesh, name: str) -> Axis:
    group = mesh.get_group(name)
    return Axis(group=group, index=mesh.get_local_rank(name),
                size=dist.get_world_size(group),
                ranks=tuple(dist.get_process_group_ranks(group)))


def whole(mesh) -> Axis:
    """The whole mesh as one axis, over the default group: the mesh must
    hold every rank of the world."""
    world = dist.get_world_size()
    if mesh.mesh.numel() != world:
        raise ValueError(f"a mesh of {mesh.mesh.numel()} ranks in a world "
                         f"of {world}")
    return Axis(group=dist.group.WORLD, index=dist.get_rank(), size=world,
                ranks=tuple(range(world)))


@contextlib.contextmanager
def count_calls():
    """Count every torch.distributed collective and point-to-point call
    made inside the block (by this package or anything else); yields the
    dict of counts by name."""
    counts = {}
    saved = {n: getattr(dist, n) for n in _CALLS if hasattr(dist, n)}

    def counted(name, fn):
        def call(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _staged(t: Tensor, group) -> bool:
    return t.is_cuda and "nccl" not in dist.get_backend(group)


def _to_host(t: Tensor) -> Tensor:
    global STAGED_BYTES
    STAGED_BYTES += t.numel() * t.element_size()
    return t.cpu()


def _to_card(h: Tensor, like: Tensor) -> Tensor:
    global STAGED_BYTES
    STAGED_BYTES += h.numel() * h.element_size()
    return h.to(like.device)


def all_reduce(x: Tensor, ax: Axis, op: str = "sum") -> Tensor:
    """Out of place: x reduced over the axis (op "sum", "max" or "min")."""
    if ax.size == 1:
        return x.clone()
    if _staged(x, ax.group):
        h = _to_host(x.detach())
        dist.all_reduce(h, op=_OPS[op], group=ax.group)
        return _to_card(h, x)
    out = x.detach().clone()
    dist.all_reduce(out, op=_OPS[op], group=ax.group)
    return out


def all_gather(x: Tensor, ax: Axis) -> List[Tensor]:
    """Every rank's x along the axis, in coordinate order."""
    if ax.size == 1:
        return [x.detach()]
    staged = _staged(x, ax.group)
    src = (_to_host(x.detach()) if staged
           else x.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return [_to_card(p, x) for p in parts] if staged else parts


def exchange(lo: Tensor, hi: Tensor, ax: Axis
             ) -> Tuple[Tensor, Tensor]:
    """The neighbour exchange along the axis: send `hi` to the next rank
    and `lo` to the previous one; returns (what the previous rank sent as
    its hi, what the next rank sent as its lo), None at the ends."""
    staged = _staged(lo, ax.group)
    send_lo = _to_host(lo) if staged else lo.contiguous()
    send_hi = _to_host(hi) if staged else hi.contiguous()
    i, works = ax.index, []
    from_prev = from_next = None
    if i > 0:
        from_prev = torch.empty_like(send_hi)
        works.append(dist.irecv(from_prev, src=ax.ranks[i - 1],
                                group=ax.group, tag=1))
        works.append(dist.isend(send_lo, dst=ax.ranks[i - 1],
                                group=ax.group, tag=2))
    if i < ax.size - 1:
        from_next = torch.empty_like(send_lo)
        works.append(dist.irecv(from_next, src=ax.ranks[i + 1],
                                group=ax.group, tag=2))
        works.append(dist.isend(send_hi, dst=ax.ranks[i + 1],
                                group=ax.group, tag=1))
    for w in works:
        w.wait()
    if staged:
        from_prev = None if from_prev is None else _to_card(from_prev, lo)
        from_next = None if from_next is None else _to_card(from_next, lo)
    return from_prev, from_next


def gather_to_first(x: Tensor, ax: Axis):
    """Every rank's x along the axis, concatenated along axis 0 on the
    axis's first rank in coordinate order; None on the others."""
    staged = _staged(x, ax.group)
    src = _to_host(x.detach()) if staged else x.detach().contiguous()
    first = ax.index == 0
    parts = [torch.empty_like(src) for _ in range(ax.size)] if first \
        else None
    dist.gather(src, parts, dst=ax.ranks[0], group=ax.group)
    if not first:
        return None
    out = torch.cat(parts)
    return _to_card(out, x) if staged else out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, op):
        out = all_reduce(x, ax, op)
        ctx.ax = ax
        if op != "sum":
            ctx.save_for_backward(x == out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.ax, "sum")
        if ctx.saved_tensors:
            g = g * ctx.saved_tensors[0]
        return g, None, None


def reduce(x: Tensor, ax: Axis, op: str = "sum") -> Tensor:
    """all_reduce under autograd: the backward sums the result's gradient
    over the axis (and for "max"/"min" passes it where x holds the
    result)."""
    return _Reduce.apply(x, ax, op)


def reducer(ax: Axis):
    """(x, op) -> x reduced over the axis: what voxelize.splat takes as
    `reduce` to combine the partial grids of a sample shard."""
    return lambda x, op: reduce(x, ax, op)


class _HaloPadX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, h, ax):
        ctx.h, ctx.ax = h, ax
        left, right = exchange(local[:h], local[-h:], ax)
        if left is None:            # the first rank repeats its edge row
            left = local[:1].expand((h,) + local.shape[1:])
        if right is None:
            right = local[-1:].expand((h,) + local.shape[1:])
        return torch.cat([left, local, right])

    @staticmethod
    def backward(ctx, g):
        h, ax = ctx.h, ctx.ax
        g_left, g_mid, g_right = g[:h], g[h:-h], g[-h:]
        # the halo rows' gradients go back to the rows they copied
        from_prev, from_next = exchange(g_left.contiguous(),
                                        g_right.contiguous(), ax)
        grad = g_mid.clone()
        if ax.index == 0:
            grad[0] += g_left.sum(0)
        if ax.index == ax.size - 1:
            grad[-1] += g_right.sum(0)
        if from_prev is not None:     # the previous rank's right halo
            grad[:h] += from_prev
        if from_next is not None:     # the next rank's left halo
            grad[-h:] += from_next
        return grad, None, None


def halo_pad_x(local: Tensor, h: int, ax: Axis) -> Tensor:
    """(lx, ...) -> (lx + 2h, ...): h rows from each x neighbour; the
    outer ranks repeat their own edge row (never read: the march's x
    indices are clamped to the volume's edge)."""
    if h == 0:
        return local
    return _HaloPadX.apply(local, h, ax)


class _GatherX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, ax):
        ctx.ax = ax
        return torch.cat(all_gather(slab, ax))

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        rows = g.shape[0] // ax.size
        g = all_reduce(g, ax, "sum")
        return g[ax.index * rows:(ax.index + 1) * rows], None


def gather_x(slab: Tensor, ax: Axis) -> Tensor:
    """The ranks' x-slabs along the axis -> the whole volume on every
    rank; the backward sums the volume's gradient over the axis and
    keeps this rank's slab."""
    return _GatherX.apply(slab, ax)
