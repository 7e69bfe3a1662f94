"""Per-tile shadow + basis-field taps (kernel 4; replaces
vct_tpu/ops/tap_pallas.py tap_tiles).

Also the plain brick selection the prepass computes
(`select_light_bricks`, `select_field_bricks`; tap_pallas.py:118-194) and
the frame tables' layout: each mip chain is bfloat16, its levels stored
back to back in one buffer (light levels (D, D, D), field levels
(D, D, D, C)), which is what the kernel reads.  The JAX package pads
levels for TPU DMA alignment; interop.py un-pads them into this layout.

`tap_tiles` launches `csrc/tap.cu` for CUDA tensors, inside the autograd
Function `Tap` (its backward replays the plain version, as the JAX
package's custom VJP replays tap_tiles_ref), and runs the plain version
(the semantics of tap_pallas.tap_tiles_ref) for CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vctbench.reference.core import grid as G

Tensor = torch.Tensor

TILE = 256        # pixels per image tile (16 x 16)
BRICK_L = 16      # light brick x-extent == coarsest light mip dim
LBY = 32          # light brick y-extent (16-aligned origin)
BRICK_F = 8       # field brick x/y-extent == coarsest field mip dim
FBZ = 32          # field brick z-extent (16-aligned origin)
ALIGN = 16
NOUT = 16         # [shadow, diffuse rgba, specular rgba, 7 zeros]
KERNEL_POWERS = (8, 32)   # csrc/tap.cu's sharpening: diffuse ^8, specular ^32


# ---------------------------------------------------------------------------
# table layout
# ---------------------------------------------------------------------------

def pack_mips(mips: Sequence[Tensor]) -> Tuple[Tensor, ...]:
    """bf16 copies of the levels, back to back in one buffer (views)."""
    flat = torch.cat([m.reshape(-1) for m in mips]).to(torch.bfloat16)
    out, off = [], 0
    for m in mips:
        out.append(flat[off:off + m.numel()].view(m.shape))
        off += m.numel()
    return tuple(out)


# ---------------------------------------------------------------------------
# per-tile level + brick-origin selection (plain; the prepass kernel's oracle)
# ---------------------------------------------------------------------------

def _select(uvw: Tensor, valid: Tensor, dims: Sequence[int], thresh,
            origin_fn) -> Tuple[Tensor, Tensor]:
    """Finest level whose per-axis cell footprint is within `thresh`
    (None = always fits); the coarsest level always fits.  uvw (ntiles,
    tile, 3), valid (ntiles, tile) -> level (ntiles,), origin (ntiles, 3)."""
    big = 3e38
    vm = valid[..., None]
    umin = torch.where(vm, uvw, big).amin(dim=1)
    umax = torch.where(vm, uvw, -big).amax(dim=1)
    fits, origins = [], []
    for d in dims:
        lo = torch.floor(torch.clamp(umin * d - 0.5, 0.0, d - 1.0))
        hi = torch.floor(torch.clamp(umax * d - 0.5, 0.0, d - 1.0))
        ok = torch.ones(lo.shape[:-1], dtype=torch.bool, device=uvw.device)
        for ax, th in enumerate(thresh):
            if th is not None:
                ok = ok & ((hi[..., ax] - lo[..., ax]) <= th)
        fits.append(ok)
        origins.append(origin_fn(lo, d))
    fits = torch.stack(fits, dim=1)
    fits[:, -1] = True
    level = torch.argmax(fits.to(torch.int32), dim=1)
    origin = torch.stack(origins, dim=1)[
        torch.arange(level.shape[0], device=uvw.device), level]
    any_valid = valid.any(dim=1)
    level = torch.where(any_valid, level, len(dims) - 1)
    origin = torch.where(any_valid[:, None], origin, 0)
    return level.to(torch.int32), origin.to(torch.int32)


def _aligned(lo_ax: Tensor, d: int, extent: int) -> Tensor:
    """16-aligned origin whose `extent` window covers [lo, lo + window)."""
    b = torch.floor(lo_ax / ALIGN) * ALIGN
    return torch.clamp(b, 0, max(d, extent) - extent)


def select_light_bricks(uvw: Tensor, valid: Tensor, dims: Sequence[int]):
    """Light level: x/y footprint <= BRICK_L - 2 cells; z always fits."""
    assert dims[-1] == BRICK_L, dims

    def origin(lo, d):
        ox = torch.clamp(lo[..., 0], 0, d - BRICK_L)
        oy = _aligned(lo[..., 1], d, LBY)
        return torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)

    return _select(uvw, valid, dims, (BRICK_L - 2, BRICK_L - 2, None), origin)


def select_field_bricks(uvw: Tensor, valid: Tensor, dims: Sequence[int]):
    """Field level: x/y footprint <= BRICK_F - 2, z footprint <= 15 (a
    16-aligned 32-wide window covers it plus the trilinear corner)."""
    assert dims[-1] == BRICK_F, dims

    def origin(lo, d):
        ox = torch.clamp(lo[..., 0], 0, d - BRICK_F)
        oy = torch.clamp(lo[..., 1], 0, d - BRICK_F)
        oz = _aligned(lo[..., 2], d, FBZ)
        return torch.stack([ox, oy, oz], dim=-1)

    return _select(uvw, valid, dims,
                   (BRICK_F - 2, BRICK_F - 2, FBZ - ALIGN - 1), origin)


# ---------------------------------------------------------------------------
# the taps
# ---------------------------------------------------------------------------

def _cones(cones_static):
    """(cone dirs (K, 3), cone weights (K,), basis (nb, 3)) as float32."""
    return tuple(np.asarray(x, np.float32) for x in cones_static)


def _norm_rows(v: Tensor) -> Tensor:
    return v * torch.rsqrt(torch.clamp_min(
        torch.sum(v * v, dim=1, keepdim=True), 1e-24))


def _sharpen(w: Tensor, power: int) -> Tensor:
    for _ in range(int(np.log2(power))):
        w = w * w
    return w


def tap_plain(gbuf: Tensor, scalars: Tensor, bumpn: Tensor, campos: Tensor,
              light_mips, field_mips, *, cfield: int, nb: int,
              world_size: float, voxel: float, shadow_offset: float,
              power_diffuse: int, power_specular: int, cones_static,
              chunk: int = 65536) -> Tensor:
    """Plain PyTorch version (tap_pallas.tap_tiles_ref semantics): per-tile
    level trilinear taps of the bf16 tables in float32, then the cone and
    reflection basis weightings.  Runs in pixel chunks to bound memory."""
    cone_dirs, cone_w, basis = _cones(cones_static)
    basis_t = torch.as_tensor(basis, device=gbuf.device)
    n = gbuf.shape[0]
    lvl_l = scalars[:, 0].long().repeat_interleave(TILE)
    lvl_f = scalars[:, 4].long().repeat_interleave(TILE)
    out = torch.zeros((n, NOUT), dtype=torch.float32, device=gbuf.device)
    for s in range(0, n, chunk):
        g = gbuf[s:s + chunk]
        m = g.shape[0]
        pos, normal, geo = g[:, 0:3], g[:, 3:6], g[:, 6:9]
        tangent, bitan = g[:, 9:12], g[:, 12:15]
        uvw_l = G.world_to_uvw(pos + geo * (voxel * shadow_offset),
                               world_size)
        uvw_f = G.world_to_uvw(pos + normal * voxel, world_size)

        shadow = torch.zeros((m,), dtype=torch.float32, device=g.device)
        for li, lvl in enumerate(light_mips):
            sel = lvl_l[s:s + chunk] == li
            if sel.any():
                shadow[sel] = G.trilinear_sample(lvl[..., None],
                                                 uvw_l[sel])[:, 0]
        tap = torch.zeros((m, cfield), dtype=torch.float32, device=g.device)
        for fi, lvl in enumerate(field_mips):
            sel = lvl_f[s:s + chunk] == fi
            if sel.any():
                tap[sel] = G.trilinear_sample(lvl[..., :cfield], uvw_f[sel])

        dw = torch.zeros((m, nb), dtype=torch.float32, device=g.device)
        for cd, cw in zip(cone_dirs, cone_w):
            dv = _norm_rows(tangent * float(cd[0]) + bitan * float(cd[1])
                            + normal * float(cd[2]))
            wp = _sharpen(torch.clamp_min(dv @ basis_t.T, 0.0), power_diffuse)
            wp = wp / torch.clamp_min(torch.sum(wp, dim=1, keepdim=True), 1e-8)
            dw = dw + float(cw) * wp

        sn = _norm_rows(bumpn[s:s + chunk, 0:3])
        eye = _norm_rows(campos[None, :] - pos)
        refl = _norm_rows(
            2.0 * torch.sum(sn * eye, dim=1, keepdim=True) * sn - eye)
        sw = _sharpen(torch.clamp_min(refl @ basis_t.T, 0.0), power_specular)
        sw = sw / torch.clamp_min(torch.sum(sw, dim=1, keepdim=True), 1e-8)

        def fold(wvec, group):
            return torch.einsum("nb,nbc->nc", wvec, group.reshape(m, nb, 4))

        out[s:s + m, 0] = shadow
        out[s:s + m, 1:5] = fold(dw, tap[:, :4 * nb])
        if cfield > 4 * nb:
            out[s:s + m, 5:9] = fold(sw, tap[:, 4 * nb:cfield])
    return out


def tap_tiles(gbuf: Tensor,                 # (ntiles*tile, >=15) tile-major
              scalars: Tensor,              # (ntiles, 8) int32 from prepass
              bumpn: Tensor,                # (n, 4) bump normal xyz
              campos: Tensor,               # (3,) camera position
              light_mips, field_mips, **kw) -> Tensor:
    """Per-pixel (shadow, weighted diffuse rgba, weighted specular rgba)
    -> (n, 16) float32.  light_mips/field_mips come from pack_mips; cfield
    is the field channel count; cones_static = (cone_dirs, cone_weights,
    basis)."""
    return tap_plain(gbuf, scalars, bumpn, campos, light_mips, field_mips,
                     **kw)
