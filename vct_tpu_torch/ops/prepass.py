"""Per-tile light/field level selection (kernel 3; replaces
vct_tpu/ops/prepass_pallas.py prepass_tiles for scenes without a texture
atlas).

`prepass_tiles` launches `csrc/prepass.cu` for CUDA tensors and runs the
plain version (ops/tap.py select_light_bricks / select_field_bricks) for
CPU tensors; both give the same integers.  The per-material atlas half of
the JAX kernel (has_atlas=True) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import tap as T

Tensor = torch.Tensor

LAUNCHES = 0


def _halving(dims: Sequence[int]) -> bool:
    return all(d == dims[0] >> i for i, d in enumerate(dims))


def prepass_plain(gbuf: Tensor, *, light_dims, field_dims, voxel: float,
                  world_size: float, shadow_offset: float) -> Tensor:
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


def prepass_cuda(gbuf: Tensor, *, light_dims, field_dims, voxel: float,
                 world_size: float, shadow_offset: float) -> Tensor:
    global LAUNCHES
    n, gcols = gbuf.shape
    _build.require(gbuf.is_cuda and gbuf.dtype == torch.float32
                   and gbuf.is_contiguous() and gcols >= 20,
                   "prepass kernel takes a contiguous float32 (n, >=20) "
                   "CUDA G-buffer")
    _build.require(n % T.TILE == 0,
                   f"prepass kernel: {T.TILE}-pixel tiles, got n={n}")
    _build.require(_halving(light_dims) and _halving(field_dims),
                   "prepass kernel: level dims must halve level to level")
    ntiles = n // T.TILE
    out = torch.empty((ntiles, 8), dtype=torch.int32, device=gbuf.device)

    def f32(x):     # Python constants rounded to float32 once
        return float(np.float32(x))

    status = _build.library().vct_prepass(
        gbuf.data_ptr(), ntiles, gcols, light_dims[0], len(light_dims),
        field_dims[0], len(field_dims), f32(world_size * 0.5), f32(voxel),
        f32(voxel * shadow_offset), out.data_ptr(), _build.stream())
    _build.check(status, "vct_prepass")
    LAUNCHES += 1
    return out


def prepass_tiles(gbuf: Tensor, *, light_dims, field_dims, voxel: float,
                  world_size: float, shadow_offset: float,
                  has_atlas: bool = False) -> Tensor:
    """Tile-major G-buffer (ntiles*tile, >=20) -> scal8 (ntiles, 8) int32:
    [light level, light origin xyz, field level, field origin xyz]."""
    if has_atlas:
        raise NotImplementedError(
            "prepass for texture atlases (per-material entries and pixel "
            "slots) is not ported: ROADMAP Queue 2, material half of "
            "prepass_pallas")
    kw = dict(light_dims=tuple(light_dims), field_dims=tuple(field_dims),
              voxel=voxel, world_size=world_size,
              shadow_offset=shadow_offset)
    if _build.uses_kernel(gbuf):
        return prepass_cuda(gbuf, **kw)
    return prepass_plain(gbuf, **kw)
