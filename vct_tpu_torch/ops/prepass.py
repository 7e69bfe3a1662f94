"""Per-tile brick selection (kernel 3; replaces
vct_tpu/ops/prepass_pallas.py prepass_tiles, both halves).

For each 256-pixel image tile of the tile-major G-buffer:
  * the light/field half: the light and field mip level + brick origin
    that the tap kernel samples (scal8);
  * the material half, for scenes with a texture atlas: per material
    present in the tile, the finest atlas mip level whose uv footprint
    fits a 32x32-texel brick with its 16-aligned texel bases (mscal,
    mlists), and each pixel's slot among the tile's materials (mslots) —
    what the material kernel (ops/material.py) reads.

`prepass_tiles` launches `csrc/prepass.cu` for CUDA tensors and runs the
plain version for CPU tensors; both give the same integers as the JAX
kernel, whose order of float operations they follow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import tap as T

Tensor = torch.Tensor

NSLOT = 24        # max distinct materials per tile
NSCAL = 5         # mscal row: count, then slot 0's (material, level, bv, bu)
NWORDS = 128      # mlists row: slots 1.. as 4 words each, 4*(NSLOT-1) = 92
THRESH = 14       # max per-axis texel footprint that fits a brick
BCLIP = float(2 ** 22)    # texel bases clip here, exact in float32
MAX_MATERIALS = 64        # the kernel's per-tile material table
MAX_LEVELS = 32           # the kernel tests one level a lane of a warp

LAUNCHES = 0


class AtlasShape(NamedTuple):
    """What the material half needs to know of the atlas pages."""

    num_materials: int
    resolution: int       # level-0 texels per side
    levels: int           # mip levels, log2(resolution) + 1


def _halving(dims: Sequence[int]) -> bool:
    return all(d == dims[0] >> i for i, d in enumerate(dims))


def _light_field_plain(gbuf: Tensor, *, light_dims, field_dims,
                       voxel: float, world_size: float,
                       shadow_offset: float) -> Tensor:
    tile = T.TILE
    ntiles = gbuf.shape[0] // tile
    pos, nrm, geo = gbuf[:, 0:3], gbuf[:, 3:6], gbuf[:, 6:9]
    hit = (gbuf[:, 19] > 0.5).reshape(ntiles, tile)
    uvw_l = G.world_to_uvw(pos + geo * (voxel * shadow_offset), world_size)
    uvw_f = G.world_to_uvw(pos + nrm * voxel, world_size)
    llev, lorg = T.select_light_bricks(uvw_l.reshape(ntiles, tile, 3), hit,
                                       light_dims)
    flev, forg = T.select_field_bricks(uvw_f.reshape(ntiles, tile, 3), hit,
                                       field_dims)
    return torch.cat([llev[:, None], lorg, flev[:, None], forg],
                     dim=1).to(torch.int32)


def _material_plain(gbuf: Tensor, atlas: AtlasShape):
    """The material half (prepass_pallas._one_tile, has_atlas=True)."""
    tile = T.TILE
    n = gbuf.shape[0]
    ntiles = n // tile
    mm = atlas.num_materials
    dev = gbuf.device
    g = gbuf.reshape(ntiles, tile, gbuf.shape[1])
    hit = g[..., 19] > 0.5
    mat = g[..., 17].to(torch.int32)
    u = g[..., 15]
    q = 1.0 - g[..., 16]
    ids = torch.arange(mm, dtype=torch.int32, device=dev)
    onehot = (mat[..., None] == ids) & hit[..., None]     # (ntiles, tile, M)
    big = 3e38

    def mreduce(x, init, op):
        return op(torch.where(onehot, x[..., None], init), dim=1)

    umin = mreduce(u, big, torch.amin)                    # (ntiles, M)
    umax = mreduce(u, -big, torch.amax)
    qmin = mreduce(q, big, torch.amin)
    qmax = mreduce(q, -big, torch.amax)
    present = onehot.any(dim=1)

    # coarse to fine, the finest level that fits wins; the coarsest
    # (1x1) level always fits
    lvl = torch.full((ntiles, mm), float(atlas.levels - 1), device=dev)
    bv = torch.zeros((ntiles, mm), device=dev)
    bu = torch.zeros((ntiles, mm), device=dev)
    for lv in range(atlas.levels - 1, -1, -1):
        rl = max(atlas.resolution >> lv, 1)
        d = 2.0 ** -lv
        base_u = torch.floor(umin * rl - 0.5)
        hi_u = torch.floor(umax * rl - 0.5 + d)
        base_v = torch.floor(qmin * rl - 0.5 - d)
        hi_v = torch.floor(qmax * rl - 0.5)
        if lv == atlas.levels - 1:
            fits = torch.ones_like(present)
        else:
            fits = ((hi_u - base_u <= THRESH) & (hi_v - base_v <= THRESH))
        bva = T.ALIGN * torch.floor(torch.clamp(base_v, -BCLIP, BCLIP)
                                    / T.ALIGN)
        bua = T.ALIGN * torch.floor(torch.clamp(base_u, -BCLIP, BCLIP)
                                    / T.ALIGN)
        lvl = torch.where(fits, float(lv), lvl)
        bv = torch.where(fits, bva, bv)
        bu = torch.where(fits, bua, bu)

    # slots: the present materials in ascending id order
    pres_i = present.to(torch.int32)
    slot_of = torch.cumsum(pres_i, dim=1) - pres_i        # smaller present ids
    count = pres_i.sum(dim=1)
    entry = torch.stack([ids.to(torch.float32).expand(ntiles, mm), lvl, bv,
                         bu], dim=-1).to(torch.int32)     # (ntiles, M, 4)
    target = torch.where(present & (slot_of < NSLOT), slot_of, NSLOT)
    entries = torch.zeros((ntiles, NSLOT + 1, 4), dtype=torch.int32,
                          device=dev)
    entries.scatter_(1, target.long()[..., None].expand(-1, -1, 4), entry)
    mscal = torch.cat([torch.clamp_max(count, NSLOT)[:, None].to(torch.int32),
                       entries[:, 0]], dim=1)
    mlists = torch.zeros((ntiles, NWORDS), dtype=torch.int32, device=dev)
    mlists[:, :4 * (NSLOT - 1)] = entries[:, 1:NSLOT].reshape(ntiles, -1)

    # each pixel's slot: the number of present materials with a smaller id
    below = ((ids < mat[..., None]) & present[:, None, :]).sum(dim=-1)
    mslots = torch.clamp(torch.where(hit, below, 0), 0, NSLOT - 1)
    return mscal, mlists, mslots.reshape(n, 1).to(torch.int32)


def prepass_plain(gbuf: Tensor, *, light_dims, field_dims, voxel: float,
                  world_size: float, shadow_offset: float,
                  atlas: Optional[AtlasShape] = None):
    scal8 = _light_field_plain(gbuf, light_dims=light_dims,
                               field_dims=field_dims, voxel=voxel,
                               world_size=world_size,
                               shadow_offset=shadow_offset)
    if atlas is None:
        return scal8
    return (scal8,) + _material_plain(gbuf, atlas)


def prepass_cuda(gbuf: Tensor, *, light_dims, field_dims, voxel: float,
                 world_size: float, shadow_offset: float,
                 atlas: Optional[AtlasShape] = None):
    global LAUNCHES
    n, gcols = gbuf.shape
    _build.require(gbuf.is_cuda and gbuf.dtype == torch.float32
                   and gbuf.is_contiguous() and gcols >= 20 and gcols % 4 == 0
                   and gbuf.data_ptr() % 16 == 0,
                   "prepass kernel takes a contiguous, 16-byte aligned "
                   "float32 (n, >=20) CUDA G-buffer of 4k columns")
    _build.require(n % T.TILE == 0,
                   f"prepass kernel: {T.TILE}-pixel tiles, got n={n}")
    _build.require(_halving(light_dims) and _halving(field_dims),
                   "prepass kernel: level dims must halve level to level")
    _build.require(max(len(light_dims), len(field_dims)) <= MAX_LEVELS,
                   f"prepass kernel: at most {MAX_LEVELS} levels (one a lane)")
    ntiles = n // T.TILE
    dev = gbuf.device
    scal8 = torch.empty((ntiles, 8), dtype=torch.int32, device=dev)
    nm = res = nlev = 0
    mscal = mlists = mslots = None
    if atlas is not None:
        nm, res, nlev = atlas
        _build.require(0 < nm <= MAX_MATERIALS and nlev <= MAX_LEVELS,
                       f"prepass kernel: 1..{MAX_MATERIALS} materials and "
                       f"at most {MAX_LEVELS} atlas levels, got {nm}, {nlev}")
        mscal = torch.empty((ntiles, NSCAL), dtype=torch.int32, device=dev)
        mlists = torch.empty((ntiles, NWORDS), dtype=torch.int32, device=dev)
        mslots = torch.empty((n, 1), dtype=torch.int32, device=dev)

    def f32(x):     # Python constants rounded to float32 once
        return float(np.float32(x))

    def ptr(x):
        return None if x is None else x.data_ptr()

    status = _build.library().vct_prepass(
        gbuf.data_ptr(), ntiles, gcols, light_dims[0], len(light_dims),
        field_dims[0], len(field_dims), f32(world_size * 0.5), f32(voxel),
        f32(voxel * shadow_offset), scal8.data_ptr(), nm, res, nlev,
        ptr(mscal), ptr(mlists), ptr(mslots), _build.stream())
    _build.check(status, "vct_prepass")
    LAUNCHES += 1
    if atlas is None:
        return scal8
    return scal8, mscal, mlists, mslots


def prepass_tiles(gbuf: Tensor, *, light_dims, field_dims, voxel: float,
                  world_size: float, shadow_offset: float,
                  atlas: Optional[AtlasShape] = None):
    """Tile-major G-buffer (ntiles*tile, >=20) -> scal8 (ntiles, 8) int32:
    [light level, light origin xyz, field level, field origin xyz].

    With `atlas`, returns (scal8, mscal (ntiles, NSCAL), mlists (ntiles,
    NWORDS), mslots (n, 1)), all int32: mscal = [count, slot-0 material,
    level, bv, bu], mlists = slots 1.. as 4 words each from word 0."""
    kw = dict(light_dims=tuple(light_dims), field_dims=tuple(field_dims),
              voxel=voxel, world_size=world_size,
              shadow_offset=shadow_offset,
              atlas=None if atlas is None else AtlasShape(*atlas))
    if _build.uses_kernel(gbuf):
        return prepass_cuda(gbuf, **kw)
    return prepass_plain(gbuf, **kw)


STRESS_KINDS = ("all miss", "one hit", "every material", "every material, "
                "huge uv", "|tu| near 2^24", "wrap corner, level 0",
                "wrap corner, R_l = 4", "random")


def stress_gbuffer(seed: int = 0, *, world_size: float,
                   resolution: int = 64, num_materials: int = MAX_MATERIALS,
                   reps: int = 2) -> np.ndarray:
    """A tile-major (len(STRESS_KINDS) * reps * 256, 32) float32 G-buffer,
    made with numpy from `seed`, of the tiles a real frame rarely holds, to
    hold the prepass and material kernels to their plain versions.  Tile
    kind k (STRESS_KINDS[k]) fills tiles k*reps .. (k+1)*reps - 1:
      0 every pixel a miss;
      1 a single hit pixel;
      2 every material present (more than NSLOT: the slots clamp), each in
        a small uv box in [0, 1];
      3 the same around uv up to +-1e7, whose texel bases clip at +-BCLIP;
      4 one material in a small box near u, 1 - v = 2^24 / R (level 0:
        |tu| near 2^24, where a tap one texel away can round to two);
      5 one material at level 0 on its page's wrap corner (i0 = R - 1,
        j0 = 0);
      6 one material on the wrap corner of the level of R_l = 4, its box
        held to [0, 2] in u and 1 - v by two pixels;
      7 random materials and uv in [-1, 2], a tenth of the pixels missing.
    Positions lie in tile-coherent clusters inside the world, normals and
    geometric normals are random unit vectors."""
    rng = np.random.default_rng(seed)
    r, nm, tile = resolution, num_materials, T.TILE
    ntiles = len(STRESS_KINDS) * reps
    n = ntiles * tile
    g = np.zeros((n, 32), np.float32)
    base = rng.uniform(-0.4, 0.4, (ntiles, 1, 3)) * world_size
    spread = rng.uniform(0.1, 8.0, (ntiles, 1, 1))
    g[:, 0:3] = (base + spread * rng.uniform(-1, 1, (ntiles, tile, 3))
                 ).reshape(n, 3)
    for col in (3, 6):
        v = rng.normal(size=(n, 3))
        g[:, col:col + 3] = v / np.linalg.norm(v, axis=1, keepdims=True)
    uq = np.zeros((ntiles, tile, 2))             # (u, 1 - v) per pixel
    mat = np.zeros((ntiles, tile), np.int64)
    hit = np.ones((ntiles, tile), np.float32)
    for t in range(ntiles):
        kind = t // reps
        if kind == 0:
            hit[t] = 0.0
        elif kind == 1:
            hit[t] = 0.0
            hit[t, rng.integers(tile)] = 1.0
            mat[t] = rng.integers(nm)
            uq[t] = rng.uniform(0, 1, 2)
        elif kind in (2, 3):
            mat[t] = np.arange(tile) % nm
            if kind == 2:
                centre = rng.uniform(0, 1, (nm, 2))
            else:
                centre = (rng.choice([-1.0, 1.0], (nm, 2))
                          * 10.0 ** rng.uniform(5, 7, (nm, 2)))
            uq[t] = centre[mat[t]] + rng.uniform(0, 0.05, (tile, 2))
        elif kind == 4:
            mat[t] = rng.integers(nm)
            uq[t] = (2.0 ** 24 + rng.uniform(0, 3, (tile, 2))) / r
        elif kind in (5, 6):
            rl = r if kind == 5 else 4
            mat[t] = rng.integers(nm)
            # tu in [R_l - 0.9, R_l - 0.01), tv in [0.01, 0.9): the +u tap
            # crosses the wrap column, the -v tap the wrap row
            uq[t, :, 0] = rng.uniform(rl - 0.4, rl + 0.49, tile) / rl
            uq[t, :, 1] = rng.uniform(0.51, 1.4, tile) / rl
            if kind == 6:
                uq[t, 0] = 0.0
                uq[t, 1] = 2.0
        else:
            mat[t] = rng.integers(0, nm, tile)
            uq[t] = rng.uniform(-1, 2, (tile, 2))
            hit[t] = (rng.uniform(size=tile) >= 0.1).astype(np.float32)
    g[:, 15] = uq[..., 0].reshape(n)
    g[:, 16] = (1.0 - uq[..., 1]).reshape(n)
    g[:, 17] = mat.reshape(n)
    g[:, 19] = hit.reshape(n)
    return g
