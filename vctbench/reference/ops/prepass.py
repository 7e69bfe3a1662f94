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

from typing import NamedTuple, Optional

import torch

from vctbench.reference.core import grid as G
from vctbench.reference.ops import tap as T

Tensor = torch.Tensor

NSLOT = 24        # max distinct materials per tile
NSCAL = 5         # mscal row: count, then slot 0's (material, level, bv, bu)
NWORDS = 128      # mlists row: slots 1.. as 4 words each, 4*(NSLOT-1) = 92
THRESH = 14       # max per-axis texel footprint that fits a brick
BCLIP = float(2 ** 22)    # texel bases clip here, exact in float32
MAX_MATERIALS = 64        # the kernel's per-tile material table
MAX_LEVELS = 32           # the kernel tests one level a lane of a warp


class AtlasShape(NamedTuple):
    """What the material half needs to know of the atlas pages."""

    num_materials: int
    resolution: int       # level-0 texels per side
    levels: int           # mip levels, log2(resolution) + 1


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
    return prepass_plain(gbuf, **kw)


STRESS_KINDS = ("all miss", "one hit", "every material", "every material, "
                "huge uv", "|tu| near 2^24", "wrap corner, level 0",
                "wrap corner, R_l = 4", "random")


