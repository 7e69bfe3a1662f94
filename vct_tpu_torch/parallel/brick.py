"""Brick-sharded dense cone marching for 512^3+ grids (port of
vct_tpu/parallel/brick.py).

Every step of the direction-major dense march (core/dense.py) resamples
a mip level at a constant world shift, separably per axis.  The field
and the fine levels shard along x over the 'model' axis: the y and z
resamples stay local, and the x resample of step k reads level rows
[x_lo - shift_k, x_hi + shift_k], so each shard needs a static halo of
h = ceil(max |dir_x| * dist_k / voxel_l) + 2 rows, fixed by the
schedule.  Each rank receives h rows from each x neighbour once per
level (parallel/comm.halo_pad_x), then marches its slab alone.  A level
whose halo would not fit its shard (small grids, coarse levels) is read
whole.

The march is one ops/dense.dense_march call on the rank's x-slab (one
kernel launch on the card), its tap table holding x rows of the slab's
length, rebased into the halo block, beside full y and z rows
(slab_plan: the unsharded march's table, written on the card for CUDA
levels, cut on the levels' device); the taps and the composite are the
unsharded march's, so each cell gets the same arithmetic.  Like the JAX package, the sharded march runs in the
pyramid's dtype and ignores grid.compute.  Gradients flow through the
exchange (its backward returns the halo rows' gradients to their
owners).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import dense as OD
from vct_tpu_torch.parallel import comm

Tensor = torch.Tensor


def _halo_for_level(dirs: np.ndarray, dists, steps, dl: int,
                    world_size: float) -> int:
    """Static x-halo (level rows) for the steps touching one level."""
    voxel = world_size / dl
    m = 0.0
    for k in steps:
        m = max(m, float(np.max(np.abs(dirs[:, 0]))) * dists[k] / voxel)
    return int(np.ceil(m)) + 2


def shard_plan(dirs: np.ndarray, schedule: M.MarchSchedule, dims,
               world_size: float, n: int, min_shard_rows: int = 8):
    """(halos, sharded) per level, as dicts: the x-halo a level needs and
    whether it shards over n ranks (dl % n == 0 and dl // n >= max(
    min_shard_rows, h + 1)); levels no step touches stay whole."""
    plan, _ = D.plan_groups(schedule.lods, len(dims))
    touch = {}
    for k, (l0, l1, w) in enumerate(plan):
        touch.setdefault(l0, []).append(k)
        if w > 0.0 and l1 != l0:
            touch.setdefault(l1, []).append(k)
    halos, sharded = {}, {}
    for lvl, dl in enumerate(dims):
        ok = False
        if lvl in touch:
            h = _halo_for_level(dirs, schedule.dists, touch[lvl], dl,
                                world_size)
            ok = dl % n == 0 and dl // n >= max(min_shard_rows, h + 1)
        halos[lvl] = h if ok else 0
        sharded[lvl] = ok
    return halos, sharded


def sharded_directional_march_multi(
    mips: Sequence[Tensor],
    directions,                          # (B, 3) unit world directions
    schedule: M.MarchSchedule,
    world_size: float,
    mesh,
    axis_name: str = "model",
    field_dim: Optional[int] = None,
    max_alpha: float = 0.95,
    occlusion_falloff: float = 0.03,
    opacity_gain: float = 1.0,
    transmittance_only: bool = False,
    min_shard_rows: int = 8,
) -> Tensor:
    """dense.directional_march_multi with the field and the fine levels
    sharded along x over `axis_name`: every rank passes the whole
    pyramid and gets its x-slab of the result, (df // n, df, df, B*4), or
    (..., B) when transmittance_only (parallel/comm.gather_x makes it
    whole).  Anisotropic stacks are not sharded."""
    if any(A.is_aniso_level(m) for m in mips[1:]):
        raise NotImplementedError("brick sharding is isotropic-only for now")
    ax = comm.axis(mesh, axis_name)
    n, row0 = ax.size, ax.index
    df = field_dim or mips[0].shape[0]
    dirs = np.asarray(directions, np.float64)
    if dirs.ndim == 1:
        dirs = dirs[None]
    if df % n:
        raise ValueError(f"field_dim {df} not divisible by {n} shards")
    ldf = df // n
    if transmittance_only:
        mips = [m[..., -1:] for m in mips]
    dims = [m.shape[0] for m in mips]
    halos, sharded = shard_plan(dirs, schedule, dims, world_size, n,
                                min_shard_rows)

    # halo-pad each sharded level's slab once, up front
    blocks = []
    for lvl, m in enumerate(mips):
        if sharded[lvl]:
            rows = dims[lvl] // n
            blocks.append(comm.halo_pad_x(m[row0 * rows:(row0 + 1) * rows],
                                          halos[lvl], ax))
        else:
            blocks.append(m)
    plan = slab_plan(mips, blocks, dirs, schedule, world_size, df,
                     (row0 * ldf, (row0 + 1) * ldf),
                     [row0 * (dl // n) - halos[lvl] if sharded[lvl] else 0
                      for lvl, dl in enumerate(dims)],
                     max_alpha=max_alpha,
                     occlusion_falloff=occlusion_falloff,
                     opacity_gain=opacity_gain,
                     transmittance_only=transmittance_only)
    return OD.dense_march(blocks, plan)


def slab_plan(mips: Sequence[Tensor], blocks: Sequence[Tensor], dirs,
              schedule: M.MarchSchedule, world_size: float, df: int,
              xs: Tuple[int, int], base: Sequence[int], **kw) -> OD.Plan:
    """The Plan of the field's x rows [xs[0], xs[1]) over each level's
    block (`blocks`, whose first row is the level's row base[level]): the
    whole field's tap table (core/dense.py tap_rows: one dense_kernel_taps
    launch for CUDA levels, tap_table on the host for CPU levels), its x
    rows sliced to the slab's and rebased into the blocks on the levels'
    device, and the extent from the slab's last rows (tap_reach).  `kw`
    are march_plan's keywords; the compute dtype is the pyramid's."""
    half = D.march_half(mips, schedule, world_size, field_dim=df,
                        compute_dtype=mips[0].dtype, **kw)
    idx, w = D.tap_rows(dirs, half, mips)
    lo, hi = xs
    base = np.asarray(base, np.int64)[list(half.levels)]
    top = np.asarray([blocks[lvl].shape[0] - 1 for lvl in half.levels])
    bounds = G.constant(np.stack([base, top], axis=1), mips[0].device,
                        torch.int32)                       # (ntaps, 2)

    def x_rows(t):
        return torch.cat([t[..., lo:hi], t[..., df + lo:df + hi]], dim=2)

    ix = torch.minimum((x_rows(idx) - bounds[:, :1]).clamp_min(0),
                       bounds[:, 1:])
    reach = D.tap_reach(dirs, half, (hi - 1, df - 1, df - 1))
    reach[:, 0] = np.clip(reach[:, 0] - 1 - base, 0, top) + 1
    return D.half_plan(half, dirs, torch.cat([ix, idx[..., 2 * df:]], dim=2),
                       torch.cat([x_rows(w), w[..., 2 * df:]], dim=2),
                       OD.level_extent(reach, half.levels), (hi - lo, df, df))


def sharded_directional_march(mips: Sequence[Tensor], direction,
                              schedule: M.MarchSchedule, world_size: float,
                              mesh, **kw) -> Tensor:
    """Single-direction brick-sharded march (see multi)."""
    return sharded_directional_march_multi(
        mips, np.asarray(direction, np.float64)[None], schedule, world_size,
        mesh, **kw)


def shard_mips(mesh, mips: Sequence[Tensor], n_min_rows: int = 8,
               axis_name: str = "model"):
    """Each fine level's x-slab on this rank (dl % n == 0 and dl // n >=
    n_min_rows), coarse levels whole."""
    ax = comm.axis(mesh, axis_name)
    out = []
    for m in mips:
        dl = m.shape[0]
        rows = dl // ax.size
        if dl % ax.size == 0 and rows >= n_min_rows:
            out.append(m[ax.index * rows:(ax.index + 1) * rows])
        else:
            out.append(m)
    return tuple(out)


def gather_x(slab: Tensor, mesh, axis_name: str = "model") -> Tensor:
    """The whole volume on every rank from the ranks' x-slabs."""
    return comm.gather_x(slab, comm.axis(mesh, axis_name))
