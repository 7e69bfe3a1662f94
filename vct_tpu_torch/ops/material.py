"""Per-pixel material fetch from the atlas mip pages (kernel 5; replaces
vct_tpu/ops/material_pallas.py material_tiles).

`atlas_mip_pages` packs the texture atlas into the JAX package's layout:
the fused channels [albedo rgba | specular rgb | height] of every mip
level (2x2 box filter, glGenerateMipmap), REPEAT wrap baked in, stored in
bfloat16 as (M, L * V0, V0 * 8) with V0 = ceil16(R + 32).  Keeping that
layout lets the JAX package's pages shade the port's frames unchanged.

`material_tiles` reads, for each pixel, its tile's entry for the pixel's
slot (ops/prepass.py: material, level, bv, bu) and returns the (n, 16)
row [albedo rgba, specular rgb, h0, hx, hy, 6 zeros]: a bilinear fetch
of the level's page at the pixel's uv, and of the height channel one
level-0 texel along +u and along -v (the taps of CalcBumpNormal,
VoxelConeTracing.fs:108-126).  The function is material_tiles_ref's:
float32 weights on the bfloat16-stored texels.  The TPU kernel rounds its
two-hot weights to bfloat16 as well; it stays within 2e-2 of this.

CUDA tensors launch `csrc/material.cu` inside the autograd Function
`_build.Replay`, whose backward replays the plain version under autograd
with respect to the G-buffer and the pages (material_pallas.py:484-498;
the prepass's integer tables get none); CPU tensors take the plain
version.
"""

from __future__ import annotations

import torch

from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import prepass as PP
from vct_tpu_torch.ops import tap as T

Tensor = torch.Tensor

C8 = 8            # fused channels: albedo rgba, specular rgb, height
MBV = 32          # the TPU's brick extent; pages keep 32 wrap rows/columns
ALIGN = 16
NOUT = 16         # output row: albedo4, spec3, h0, hx, hy, pad


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def atlas_mip_pages(albedo: Tensor, specular: Tensor, height: Tensor
                    ) -> Tensor:
    """Atlas pages (M,R,R,4)/(M,R,R,3)/(M,R,R,1) float32 -> the packed mip
    pages (M, L*V0, V0*8) bfloat16, level l at rows [l*V0, (l+1)*V0), row v
    of level l holding texel row v mod R_l, likewise columns
    (material_pallas.atlas_mip_pages).  R must be a power of two >= 16."""
    m, r = albedo.shape[:2]
    if r < 16 or r & (r - 1):
        raise ValueError(f"atlas resolution {r}: a power of two >= 16")
    level = torch.cat([albedo, specular, height], dim=-1)     # (M,R,R,8)
    v0 = _ceil_to(r + MBV, ALIGN)
    pages = []
    rl = r
    while True:
        rows = torch.arange(v0, device=albedo.device) % rl
        page = level.index_select(1, rows).index_select(2, rows)
        pages.append(page.reshape(m, v0, v0 * C8))
        if rl == 1:
            break
        level = 0.25 * (level[:, 0::2, 0::2] + level[:, 0::2, 1::2]
                        + level[:, 1::2, 0::2] + level[:, 1::2, 1::2])
        rl //= 2
    return torch.cat(pages, dim=1).to(torch.bfloat16).contiguous()


def pages_resolution(pages: Tensor) -> int:
    """The level-0 atlas resolution of packed mip pages."""
    u0 = pages.shape[2] // C8
    r = u0 - MBV
    nlev = r.bit_length()
    if r < 16 or r & (r - 1) or _ceil_to(r + MBV, ALIGN) != u0 \
            or pages.shape[1] != nlev * u0:
        raise ValueError(f"not packed atlas mip pages: {tuple(pages.shape)}")
    return r


def _entries(mscal: Tensor, mlists: Tensor, slots: Tensor, tile: int):
    """Per pixel: (material, level) of its slot's entry and its tile's
    material count."""
    ntiles = mscal.shape[0]
    over = mlists[:ntiles, :4 * (PP.NSLOT - 1)].reshape(ntiles,
                                                         PP.NSLOT - 1, 4)
    ent = torch.cat([mscal[:, None, 1:], over], dim=1)     # (ntiles, NSLOT, 4)
    pix = torch.arange(ntiles, device=mscal.device).repeat_interleave(tile)
    sl = slots.reshape(-1).long()
    return ent[pix, sl, 0].long(), ent[pix, sl, 1], mscal[pix, 0]


def material_plain(gbuf: Tensor, slots: Tensor, mscal: Tensor,
                   mlists: Tensor, pages: Tensor, resolution: int,
                   tile: int = 256) -> Tensor:
    """Plain PyTorch version (material_pallas.material_tiles_ref's
    function, with each pixel's level gathered instead of every level
    evaluated and selected)."""
    n = gbuf.shape[0]
    v0 = _ceil_to(resolution + MBV, ALIGN)
    nlev = pages.shape[1] // v0
    mt, lvl, cnt = _entries(mscal, mlists, slots, tile)
    ok = (cnt > 0) & (lvl >= 0) & (lvl < nlev)
    lvl = torch.clamp(lvl, 0, nlev - 1).long()
    rl_i = torch.clamp_min(torch.full_like(lvl, resolution) >> lvl, 1)
    rl = rl_i.to(torch.float32)
    d = torch.ldexp(torch.ones_like(rl), -lvl.to(torch.int32))
    u = gbuf[:, 15]
    q = 1.0 - gbuf[:, 16]
    flat = pages.reshape(-1, C8)
    row0 = mt * pages.shape[1] + lvl * v0          # page row of texel row 0

    def bil(tu, tv):
        i0 = torch.floor(tu)
        j0 = torch.floor(tv)
        fu = (tu - i0)[:, None]
        fv = (tv - j0)[:, None]
        i0 = torch.remainder(i0.to(torch.int32).long(), rl_i)
        j0 = torch.remainder(j0.to(torch.int32).long(), rl_i)

        def at(jy, ix):
            return flat[(row0 + jy) * v0 + ix].to(torch.float32)

        top = at(j0, i0) * (1 - fu) + at(j0, i0 + 1) * fu
        bot = at(j0 + 1, i0) * (1 - fu) + at(j0 + 1, i0 + 1) * fu
        return top * (1 - fv) + bot * fv

    tu = u * rl - 0.5
    tv = q * rl - 0.5
    main = bil(tu, tv)
    hx = bil(tu + d, tv)[:, C8 - 1:C8]
    hy = bil(tu, tv - d)[:, C8 - 1:C8]
    out = torch.where(ok[:, None], torch.cat([main, hx, hy], dim=1), 0.0)
    pad = torch.zeros((n, NOUT - C8 - 2), dtype=torch.float32,
                      device=gbuf.device)
    return torch.cat([out, pad], dim=1)


def corner_texels(gbuf: Tensor, slots: Tensor, mscal: Tensor,
                  mlists: Tensor, resolution: int, tile: int = 256):
    """Per pixel, what its three bilinear taps read, texels named by (row,
    column) modulo the level's width: (the distinct texels of the 12
    corners, the corners of the +u and -v taps that are none of the main
    tap's 4 -- the heights csrc/material.cu loads beside the main tap's 4
    texels).  Both are 0 for pixels that fetch nothing.  Where |tu| and
    |tv| are below 2^24 a tap one level-0 texel away moves at most one
    texel of the level, so the taps read at most 8 texels (the main 4, a
    new column for +u, a new row for -v) and the kernel loads at most 4
    heights; beyond 2^24 rounding can move it two."""
    nlev = resolution.bit_length()
    _, lvl, cnt = _entries(mscal, mlists, slots, tile)
    ok = (cnt > 0) & (lvl >= 0) & (lvl < nlev)
    lvl = torch.clamp(lvl, 0, nlev - 1).long()
    rl_i = torch.clamp_min(torch.full_like(lvl, resolution) >> lvl, 1)
    rl = rl_i.to(torch.float32)
    d = torch.ldexp(torch.ones_like(rl), -lvl.to(torch.int32))
    tu = gbuf[:, 15] * rl - 0.5
    tv = (1.0 - gbuf[:, 16]) * rl - 0.5

    def floor_i(x):
        return torch.floor(x).to(torch.int32).long()

    def key(j, i):
        return torch.remainder(j, rl_i) * rl_i + torch.remainder(i, rl_i)

    i0, j0, iu, jv = floor_i(tu), floor_i(tv), floor_i(tu + d), floor_i(tv - d)
    main = torch.stack([key(j0 + a, i0 + b) for a in (0, 1) for b in (0, 1)],
                       dim=1)
    bump = torch.stack([key(j0 + a, iu + b) for a in (0, 1) for b in (0, 1)]
                       + [key(jv + a, i0 + b) for a in (0, 1) for b in (0, 1)],
                       dim=1)
    srt = torch.sort(torch.cat([main, bump], dim=1), dim=1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)
    loads = (bump[:, :, None] != main[:, None, :]).all(dim=2).sum(dim=1)
    return torch.where(ok, distinct, 0), torch.where(ok, loads, 0)


def material_cuda(gbuf: Tensor, slots: Tensor, mscal: Tensor,
                  mlists: Tensor, pages: Tensor, resolution: int,
                  tile: int = 256) -> Tensor:
    n, gcols = gbuf.shape
    ntiles = n // tile
    _build.require(tile == T.TILE and n % tile == 0,
                   "material kernel: {}-pixel tiles, n={}", T.TILE, n)
    i32 = torch.int32
    _build.operand(gbuf, torch.float32, (n, gcols), "material kernel: gbuf")
    _build.operand(slots, i32, (n, 1), "material kernel: slots")
    _build.operand(mscal, i32, (ntiles, PP.NSCAL), "material kernel: mscal")
    _build.operand(mlists, i32, (ntiles, PP.NWORDS),
                   "material kernel: mlists")
    _build.operand(pages, torch.bfloat16, pages.shape,
                   "material kernel: pages")
    _build.require(gcols >= 20 and pages.dim() == 3
                   and pages_resolution(pages) == resolution
                   and pages.data_ptr() % 16 == 0,
                   "material kernel: G-buffer (n, >=20) and 16-byte aligned "
                   "packed pages of this resolution")
    out = torch.empty((n, NOUT), dtype=torch.float32, device=gbuf.device)
    _build.launch("vct_material", gbuf.data_ptr(), n, gcols,
                  slots.data_ptr(), mscal.data_ptr(), mlists.data_ptr(),
                  pages.data_ptr(), pages.shape[0], pages.shape[1],
                  resolution, out.data_ptr())
    return out


def material_tiles(gbuf: Tensor,             # (ntiles*tile, >=20) tile-major
                   slots: Tensor,            # (ntiles*tile, 1) int32
                   mscal: Tensor,            # (ntiles, NSCAL) int32
                   mlists: Tensor,           # (ntiles, NWORDS) int32
                   pages: Tensor,            # atlas_mip_pages
                   *, resolution: int, tile: int = 256) -> Tensor:
    """(n, NOUT) float32 rows [albedo rgba, specular rgb, h0, hx, hy, pad];
    rows of tiles without a hit pixel are zero."""
    if _build.uses_kernel(gbuf, slots, mscal, mlists, pages):
        return _build.Replay.apply(
            lambda *t: material_cuda(*t, resolution, tile),
            lambda *t: material_plain(*t, resolution, tile), (), gbuf, slots,
            mscal, mlists, pages)
    return material_plain(gbuf, slots, mscal, mlists, pages, resolution,
                          tile)
