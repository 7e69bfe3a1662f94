"""The exact per-pixel specular cone march (kernel 8; replaces
vct_tpu/ops/specmarch_pallas.py spec_march_tiles).

Each pixel marches one narrow cone (tan 0.07, VoxelConeTracing.fs:217-223)
along its reflection axis through the radiance mip pyramid, front to back,
with the max-alpha early-out.  Pixels come in 256-pixel groups (tiles);
per (tile, step group) one mip level is chosen for the whole tile:

  * plan_groups / plan_entries — the static step grouping and entry layout,
    the JAX package's, in pure Python;
  * pack_spec_mips — the pyramid: radiance levels from the grid down to
    FLOOR_DIM, bfloat16, back to back (the tap tables' layout).  The JAX
    package packs eight shifted copies of it for 8-granular TPU DMA
    origins; interop.py cuts copy (0, 0), the one spec_march_ref reads;
  * select_spec_levels — plain PyTorch on the device, as it is XLA in JAX:
    per (tile, group) the finest level at or above the schedule's whose
    footprint fits the group's brick-class budget, in JAX's order of float
    operations so every floor lands the same way;
  * step_table — per (tile, step) the level and the constants (distance,
    mip weight times "level is the schedule's", AO attenuation);
  * spec_march_tiles — csrc/specmarch.cu on CUDA tensors, inside the
    autograd Function `_build.Replay` (its backward replays the plain
    version with respect to start4, refl4 and the pyramid's levels,
    specmarch_pallas.py:722-736; the step table gets none, as the JAX
    package's row table does), the plain version (spec_march_plain, the
    function of spec_march_ref) on CPU tensors.

Not carried over: the per-tile brick origins, the row table, the two-hot
weights and expansion matrices.  They feed the TPU's DMAs and selection
matmuls; a kernel that gathers needs none of them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import tap as TP

Tensor = torch.Tensor

TILE = 256        # pixels per group (one 16 x 16 image tile's worth)
NC = 4            # rgba radiance channels
FLOOR_DIM = 8     # coarsest packed level
BUDGETS = {"L": (28, 15, 23), "M": (14, 15, 23), "S": (6, 15, 23)}
MIP_CLS = {"L": "M", "M": "M", "S": "S"}
MAX_STEPS = 128   # csrc/specmarch.cu's per-block step table
MAX_LEVELS = 16
MAX_CELLS = 1 << 31   # csrc/specmarch.cu counts pyramid cells in 32 bits


# ---------------------------------------------------------------------------
# static planning (specmarch_pallas.py:93-242)
# ---------------------------------------------------------------------------

def _level_dims(d0: int) -> Tuple[int, ...]:
    out = []
    d = d0
    while d >= FLOOR_DIM:
        out.append(d)
        d //= 2
    return tuple(out)


def _cls_of(l0g: int, nlev: int) -> str:
    """Brick class by distance from the coarsest level: the second-
    coarsest level's M brick nearly spans it, the coarsest's S spans it
    fully, everything finer gets L."""
    if l0g >= nlev - 1:
        return "S"
    if l0g == nlev - 2:
        return "M"
    return "L"


@functools.lru_cache(maxsize=None)
def plan_groups(schedule: M.MarchSchedule, num_levels: int,
                span_cells: float = 4.0, max_group: int = 4):
    """Static step grouping: runs of equal floor(lod) (clamped into the
    packed stack) whose along-ray span stays within span_cells of the
    group's mip cell size.  Returns a tuple of groups, each
    (l0, ((dist, mip_w, diameter), ...))."""
    plan = M._static_lod_plan(schedule.lods, num_levels)
    groups = []
    cur_l0, cur_steps, start_d = None, [], 0.0
    for k, (l0, l1, w) in enumerate(plan):
        dist = schedule.dists[k]
        cell = schedule.voxel_world_size * (2.0 ** l0)
        if (cur_l0 != l0 or len(cur_steps) >= max_group
                or (dist - start_d) > span_cells * cell):
            if cur_steps:
                groups.append((cur_l0, tuple(cur_steps)))
            cur_l0, cur_steps, start_d = l0, [], dist
        cur_steps.append((dist, w if l1 != l0 else 0.0,
                          schedule.diameters[k]))
    if cur_steps:
        groups.append((cur_l0, tuple(cur_steps)))
    return tuple(groups)


@dataclasses.dataclass(frozen=True)
class EntryPlan:
    """Static (role, group) entry layout: primaries (every group, schedule
    order) then mips (groups >= g_mip).  Every step samples its group's
    primary level and, from g_mip on, the next coarser one."""

    entries: Tuple[Tuple[str, int, str], ...]   # (role, group, class)
    g_mip: int                                  # first group with mip
    m0: int                                     # first mip step index
    nsteps: int                                 # schedule steps
    blocks: Tuple[int, ...]                     # steps per entry
    block_off: Tuple[int, ...]                  # first row per entry
    runs: Tuple[Tuple[str, int, int], ...]      # (cls, entry a, entry b)
    slots: Tuple[int, ...]                      # per-entry class slot
    class_counts: Dict[str, int]

    @property
    def rows(self) -> int:
        """Sample rows per pixel: one per (entry, step)."""
        return sum(self.blocks)


@functools.lru_cache(maxsize=None)
def plan_entries(groups, num_levels: int) -> EntryPlan:
    nlev = num_levels
    g_mip = next((g for g, (_, steps) in enumerate(groups)
                  if any(s[1] > 0.0 for s in steps)), len(groups))
    entries: List[Tuple[str, int, str]] = []
    for g, (l0g, _) in enumerate(groups):
        entries.append(("prim", g, _cls_of(l0g, nlev)))
    for g, (l0g, _) in enumerate(groups):
        if g >= g_mip:
            entries.append(("mip", g, MIP_CLS[_cls_of(l0g, nlev)]))
    blocks, off, block_off = [], 0, []
    for role, g, _ in entries:
        block_off.append(off)
        blocks.append(len(groups[g][1]))
        off += len(groups[g][1])
    runs, slots = [], []
    counts: Dict[str, int] = {}
    for e, (_, _, cls) in enumerate(entries):
        if runs and runs[-1][0] == cls and runs[-1][2] == e:
            runs[-1] = (cls, runs[-1][1], e + 1)
        else:
            runs.append((cls, e, e + 1))
        slots.append(counts.get(cls, 0))
        counts[cls] = counts.get(cls, 0) + 1
    nsteps = sum(len(s) for _, s in groups)
    m0 = sum(len(groups[g][1]) for g in range(g_mip))
    return EntryPlan(entries=tuple(entries), g_mip=g_mip, m0=m0,
                     nsteps=nsteps, blocks=tuple(blocks),
                     block_off=tuple(block_off), runs=tuple(runs),
                     slots=tuple(slots), class_counts=counts)


# ---------------------------------------------------------------------------
# the pyramid
# ---------------------------------------------------------------------------

def pack_spec_mips(mips: Sequence[Tensor]) -> Tuple[Tensor, ...]:
    """Isotropic radiance mips (D, D, D, 4) float32, level 0 first -> the
    levels down to FLOOR_DIM as bf16 views back to back in one buffer."""
    return TP.pack_mips([m for m in mips if m.shape[0] >= FLOOR_DIM])


def check_cells(dims: Sequence[int]) -> None:
    """Refuse a pyramid the march kernel cannot address: its levels' d**3
    cells must number fewer than MAX_CELLS (256**3 down to 8**3 is
    19.2 M)."""
    cells = sum(int(d) ** 3 for d in dims)
    if cells >= MAX_CELLS:
        raise ValueError(f"specular pyramid of {cells} cells: the march "
                         f"kernel addresses cells in 32 bits, fewer than "
                         f"{MAX_CELLS}")


def pyramid_dims(pyramid: Sequence[Tensor]) -> Tuple[int, ...]:
    dims = tuple(m.shape[0] for m in pyramid)
    if dims != _level_dims(dims[0]):
        raise ValueError(f"specular pyramid: levels {dims} are not the "
                         f"halving chain down to {FLOOR_DIM}")
    return dims


# ---------------------------------------------------------------------------
# level selection + step table (specmarch_pallas.select_spec_bricks, the
# level half)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _group_statics(groups, dims: Tuple[int, ...], device: torch.device):
    """Per-group constants of the selection as device tensors, made once:
    first/last step distance (ng, 1), schedule level (ng,), class budget
    (ng, 3), and the level dims (nl,)."""
    nl = len(dims)
    da = [steps[0][0] for _, steps in groups]
    db = [steps[-1][0] for _, steps in groups]
    budget = [BUDGETS[_cls_of(l0g, nl)] for l0g, _ in groups]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return (f32(da)[:, None], f32(db)[:, None],
            torch.as_tensor([l0g for l0g, _ in groups], device=device),
            f32(budget), f32(dims))


def select_spec_levels(start: Tensor,        # (ntiles, tile, 3) world
                       refl: Tensor,         # (ntiles, tile, 3) unit
                       valid: Tensor,        # (ntiles, tile) bool
                       groups, dims: Sequence[int],
                       world_size: float) -> Tensor:
    """Per (tile, group) mip level -> (ntiles, ngroups) int32.

    The group's interval AABB (start + dist * refl over the group's first
    and last step, over the tile's valid pixels) is mapped to cells at
    each level; the level is the finest one at or above the group's
    schedule level whose cell footprint fits the group's class budget (the
    coarsest always fits), and the coarsest for tiles with no valid
    pixel.  The same float operations as select_spec_bricks, vectorized
    over groups and levels."""
    dims = tuple(dims)
    nl = len(dims)
    da, db, l0, budget, dvec = _group_statics(tuple(groups), dims,
                                              start.device)
    big = 3e38
    vm = valid[..., None]
    s_lo = torch.where(vm, start, big).amin(dim=1)[:, None]   # (nt, 1, 3)
    s_hi = torch.where(vm, start, -big).amax(dim=1)[:, None]
    r_lo = torch.where(vm, refl, big).amin(dim=1)[:, None]
    r_hi = torch.where(vm, refl, -big).amax(dim=1)[:, None]
    any_valid = valid.any(dim=1)

    p_lo = s_lo + torch.minimum(da * r_lo, db * r_lo)         # (nt, ng, 3)
    p_hi = s_hi + torch.maximum(da * r_hi, db * r_hi)
    half = G.scalar_like(p_lo, world_size * 0.5)
    umin = torch.clamp(p_lo / half * 0.5 + 0.5, -1e30, 1e30)[:, :, None]
    umax = torch.clamp(p_hi / half * 0.5 + 0.5, -1e30, 1e30)[:, :, None]
    d = dvec[:, None]                                          # (nl, 1)
    lo = torch.floor(torch.minimum(torch.clamp_min(umin * d - 0.5, 0.0),
                                   d - 1.0))
    hi = torch.floor(torch.minimum(torch.clamp_min(umax * d - 0.5, 0.0),
                                   d - 1.0))
    fits = (hi - lo <= budget[:, None]).all(dim=-1)            # (nt, ng, nl)
    lv = torch.arange(nl, device=start.device)
    fits = (fits & (lv >= l0[:, None])) | (lv == nl - 1)
    level = torch.argmax(fits.to(torch.int32), dim=-1)         # first fit
    level = torch.where(any_valid[:, None], level, nl - 1)
    return level.to(torch.int32)


@functools.lru_cache(maxsize=16)
def _step_statics(groups, occlusion_falloff: float, device: torch.device):
    """Per-step constants as device tensors, made once: the step's group
    (nsteps,), its schedule level, distance, mip weight and AO
    attenuation 1 / (1 + falloff * diameter)."""
    sg, l0s, dist, mipw, att = [], [], [], [], []
    for g, (l0g, steps) in enumerate(groups):
        for s_dist, w, diam in steps:
            sg.append(g)
            l0s.append(l0g)
            dist.append(s_dist)
            mipw.append(w)
            att.append(1.0 / (1.0 + occlusion_falloff * diam))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return (torch.as_tensor(sg, device=device),
            torch.as_tensor(l0s, dtype=torch.int32, device=device),
            f32(dist), f32(mipw), f32(att))


def step_table(groups, levels: Tensor, occlusion_falloff: float
               ) -> Tuple[Tensor, Tensor]:
    """Selected levels (ntiles, ngroups) -> per (tile, step) the level
    (ntiles, nsteps) int32 and [distance, mip weight, attenuation]
    (ntiles, nsteps, 3) float32.  The mip weight is the schedule's lerp
    weight where the tile kept its group's schedule level and 0 where it
    fell back to a coarser one (select_spec_bricks' row table: a primary
    row weighs 1 - it, a mip row it)."""
    sg, l0s, dist, mipw, att = _step_statics(
        tuple(groups), float(occlusion_falloff), levels.device)
    step_lv = levels[:, sg].contiguous()
    w_mip = (step_lv == l0s).to(torch.float32) * mipw
    weights = torch.stack([dist.expand_as(w_mip), w_mip,
                           att.expand_as(w_mip)], dim=-1)
    return step_lv, weights


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------

def sample_levels(pyramid: Sequence[Tensor], lv: Tensor,
                  uvw: Tensor) -> Tensor:
    """Per pixel, trilinear_sample of its level of the pyramid."""
    out = torch.zeros((uvw.shape[0], NC), dtype=torch.float32,
                      device=uvw.device)
    for li, lvl in enumerate(pyramid):
        sel = lv == li
        if sel.any():
            out[sel] = G.trilinear_sample(lvl, uvw[sel])
    return out


def spec_march_plain(start4: Tensor, refl4: Tensor, step_levels: Tensor,
                     weights: Tensor, pyramid: Sequence[Tensor], *,
                     world_size: float, max_alpha: float) -> Tensor:
    """Plain PyTorch version (spec_march_ref's function): per step, the
    tile's listed level sampled at start + dist * refl, lerped by the
    step's mip weight with the next coarser level (a weight of 0 leaves
    it as it is), then the sequential front-to-back composite with the
    1 - T < max_alpha early-out and AO attenuation.  start4[:, 3] (the hit
    mask) is the starting transmittance, so misses give exactly 0."""
    nl = len(pyramid)
    pos, t, refl = start4[:, 0:3], start4[:, 3:4], refl4[:, 0:3]
    color = torch.zeros_like(pos)
    occ = torch.zeros_like(t)
    for k in range(step_levels.shape[1]):
        lv = step_levels[:, k].repeat_interleave(TILE)
        dist, w, att = weights[:, k].repeat_interleave(TILE, dim=0).split(
            1, dim=1)
        uvw = G.world_to_uvw(pos + dist * refl, world_size)
        smp = sample_levels(pyramid, lv, uvw)
        smp1 = sample_levels(pyramid, torch.clamp(lv + 1, max=nl - 1), uvw)
        smp = smp * (1.0 - w) + smp1 * w
        al = smp[:, 3:4]
        active = (1.0 - t) < max_alpha
        wpx = torch.where(active, t, 0.0)
        color = color + wpx * smp[:, 0:3]
        occ = occ + wpx * al * att
        t = torch.where(active, t * (1.0 - al), t)
    return torch.cat([color, occ], dim=1)


def spec_march_cuda(start4: Tensor, refl4: Tensor, step_levels: Tensor,
                    weights: Tensor, pyramid: Sequence[Tensor], *,
                    world_size: float, max_alpha: float) -> Tensor:
    n = start4.shape[0]
    ntiles, nsteps = step_levels.shape
    _build.require(n == ntiles * TILE, "specmarch kernel: {}-pixel groups, "
                   "got n={} for {} groups", TILE, n, ntiles)
    f32 = torch.float32
    _build.operand(start4, f32, (n, 4), "specmarch kernel: start4")
    _build.operand(refl4, f32, (n, 4), "specmarch kernel: refl4")
    _build.operand(step_levels, torch.int32, (ntiles, nsteps),
                   "specmarch kernel: step_levels")
    _build.operand(weights, f32, (ntiles, nsteps, 3),
                   "specmarch kernel: weights")
    _build.require(all(x.data_ptr() % 16 == 0
                       for x in (start4, refl4, step_levels, weights)),
                   "specmarch kernel: start4, refl4, step_levels and weights "
                   "must be 16-byte aligned")
    d0, c = TP._chain(pyramid, "specular pyramid")
    _build.require(c == NC and len(pyramid) <= MAX_LEVELS
                   and nsteps <= MAX_STEPS
                   and pyramid[0].data_ptr() % 8 == 0,
                   "specmarch kernel: 8-byte aligned {}-channel pyramid of <= "
                   "{} levels and <= {} steps, got {} channels, {} levels, "
                   "{} steps", NC, MAX_LEVELS, MAX_STEPS, c, len(pyramid),
                   nsteps)
    check_cells([m.shape[0] for m in pyramid])
    out = torch.empty((n, NC), dtype=torch.float32, device=start4.device)
    _build.launch("vct_specmarch", start4.data_ptr(), refl4.data_ptr(),
                  ntiles, step_levels.data_ptr(), weights.data_ptr(), nsteps,
                  pyramid[0].data_ptr(), d0, len(pyramid),
                  float(np.float32(world_size * 0.5)),
                  float(np.float32(max_alpha)), out.data_ptr())
    return out


# the step table's weights get no gradient: their position among
# _build.Replay's tensors (start4, refl4, step_levels, weights, *pyramid)
FROZEN = (3,)


def flat(fn, **kw):
    """fn (spec_march_plain or spec_march_cuda) over its tensors in one
    row, as _build.Replay passes them: start4, refl4, step_levels,
    weights, then the pyramid's levels."""
    return lambda s4, r4, lv, wt, *pyr: fn(s4, r4, lv, wt, pyr, **kw)


def spec_march_tiles(start4: Tensor,        # (n, 4): start xyz, hit mask
                     refl4: Tensor,         # (n, 4): reflection xyz, 0
                     step_levels: Tensor,   # (ntiles, nsteps) int32
                     weights: Tensor,       # (ntiles, nsteps, 3) float32
                     pyramid: Sequence[Tensor], **kw) -> Tensor:
    """Per-pixel specular cone march -> (n, 4) float32 [rgb, occlusion].
    (step_levels, weights) from step_table, pyramid from pack_spec_mips;
    keywords world_size, max_alpha."""
    if _build.uses_kernel(start4, refl4, step_levels, weights, *pyramid):
        return _build.Replay.apply(flat(spec_march_cuda, **kw),
                                   flat(spec_march_plain, **kw), FROZEN,
                                   start4, refl4, step_levels, weights,
                                   *pyramid)
    return spec_march_plain(start4, refl4, step_levels, weights, pyramid,
                            **kw)
