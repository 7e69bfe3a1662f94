"""The fast frame path (port of vct_tpu/render/fast.py:56-482).

  1. ops/raycast.py  — closest hit + G-buffer, whole triangle table, for
                       scenes of at most raycast.MAX_TRIANGLES; above,
     ops/binrast.py  — screen-space binning and the binned raycast
  1b. alpha_resolve  — with a texture atlas: rays that hit a masked texel
                       re-cast past it through the streamed raycast
  2. ops/prepass.py  — per 16x16 tile: light and field mip level + brick,
                       and with an atlas the per-material atlas entries
  3. ops/material.py — with an atlas: albedo, specular and bump heights
  4. ops/tap.py      — shadow tap + basis-weighted diffuse taps, and the
                       specular taps with specular_mode="field"
  4b. ops/specmarch.py — with specular_mode="percone": the exact per-pixel
                       specular cone march over Morton-sorted pixel groups
  5. shading.combine (VoxelConeTracing.fs:165-228), background, untile.

Ported for scenes of up to 2**24 triangles (float32 triangle ids in the
binned raycast), 2**23 with a texture atlas (the alpha re-cast's 16-bit
chunk ids); larger scenes raise.  The JAX path's VCT_RAYCAST=stream
switch (the streamed raycast as the primary raycast) is not carried over.
PyTorch runs eagerly, so the JAX path's two-jit split (a TPU
compile-arena workaround) has no counterpart, and its lax.cond over the
alpha re-cast becomes a host check of a flag: one device-to-host sync per
pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import binrast as BR
from vct_tpu_torch.ops import material as MT
from vct_tpu_torch.ops import mip
from vct_tpu_torch.ops import prepass as PP
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.ops import specmarch as SM
from vct_tpu_torch.ops import tap as TP
from vct_tpu_torch.render import shading
from vct_tpu_torch.render.gbuffer import DeviceScene
from vct_tpu_torch.render.renderer import (MaterialTable, VoxelState,
                                           light_direction)
from vct_tpu_torch.scene import textures as TX
from vct_tpu_torch.stages import count, counting, span

Tensor = torch.Tensor

TSY = 16  # image tile rows
TSX = 16  # image tile cols; TSY * TSX == TP.TILE pixels per tap tile


@dataclasses.dataclass
class FrameTables:
    """Per-voxel-state tables the frame samples (ops/tap.py layout)."""

    light_mips: Tuple[Tensor, ...]       # each (D, D, D) bf16, D = dim..16
    field_mips: Tuple[Tensor, ...]       # each (D, D, D, C) bf16, D = df..8
    atlas_pages: Optional[Tensor] = None  # ops/material.py packed mip pages
    # ops/specmarch.py radiance pyramid, (D, D, D, 4) bf16, D = dim..8;
    # with specular_mode="percone" only
    spec_mips: Optional[Tuple[Tensor, ...]] = None


def supported(cfg: VCTConfig) -> bool:
    """Does this config route through the fast path (same rule as the JAX
    package: volume shadows, field diffuse, field/percone/no specular)?"""
    spec_ok = (not cfg.cones.trace_specular
               or cfg.cones.specular_mode == "field"
               or (cfg.cones.specular_mode == "percone"
                   and not cfg.grid.anisotropic))
    return (cfg.shadow.mode == "volume"
            and cfg.cones.diffuse_mode == "field" and spec_ok)


def _spec_field(cfg: VCTConfig) -> bool:
    return cfg.cones.trace_specular and cfg.cones.specular_mode == "field"


def _spec_percone(cfg: VCTConfig) -> bool:
    return cfg.cones.trace_specular and cfg.cones.specular_mode == "percone"


def _morton3(q: Tensor) -> Tensor:
    """(N, 3) int32 cell coords (7 bits each) -> interleaved Morton key."""
    def part(x):
        x = x & 0x7F
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    return (part(q[:, 0]) << 2) | (part(q[:, 1]) << 1) | part(q[:, 2])


def percone_order(cfg: VCTConfig, pos: Tensor, nrm: Tensor,
                  shade_normal: Tensor, eye: Tensor, hit: Tensor):
    """The march's starts (pos + geometric normal * voxel, fs:92), its
    axes reflect(-E, N_bump) (fs:217) and the pixel order that makes
    256-pixel groups world-space compact: by the Morton code of the start's
    cell in a 128^3 grid, then the reflection octant, misses last, stably
    (jnp.argsort is stable)."""
    ws = cfg.grid.world_size
    refl = shading.reflect_eye(shade_normal, eye)
    start = pos + nrm * cfg.grid.voxel_world_size
    cell = torch.clamp((start + ws * 0.5) * (2.0 / ws) * 64.0,
                       0.0, 127.0).to(torch.int32)
    octant = ((refl[:, 0] > 0).to(torch.int32)
              + 2 * (refl[:, 1] > 0).to(torch.int32)
              + 4 * (refl[:, 2] > 0).to(torch.int32))
    key = torch.where(hit, (_morton3(cell) << 3) | octant, 2 ** 30)
    return start, refl, torch.argsort(key, stable=True)


def spec_march_inputs(cfg: VCTConfig, spec_mips, pos: Tensor, nrm: Tensor,
                      shade_normal: Tensor, eye: Tensor, hit: Tensor):
    """What the specular march takes, in percone_order: (start4 [start,
    hit], refl4 [refl, 0], per (group, step) levels and constants from
    ops/specmarch.py step_table, the order)."""
    ntiles = pos.shape[0] // SM.TILE
    start, refl, perm = percone_order(cfg, pos, nrm, shade_normal, eye, hit)
    start_p, refl_p, hit_p = start[perm], refl[perm], hit[perm]
    dims = SM.pyramid_dims(spec_mips)
    groups = SM.plan_groups(shading.specular_schedule(cfg), len(dims))
    levels = SM.select_spec_levels(
        start_p.reshape(ntiles, SM.TILE, 3),
        refl_p.reshape(ntiles, SM.TILE, 3), hit_p.reshape(ntiles, SM.TILE),
        groups, dims, cfg.grid.world_size)
    step_lv, weights = SM.step_table(groups, levels,
                                     cfg.cones.occlusion_falloff)
    start4 = torch.cat([start_p, hit_p.to(torch.float32)[:, None]], dim=1)
    refl4 = torch.cat([refl_p, torch.zeros_like(refl_p[:, :1])], dim=1)
    return start4, refl4, step_lv, weights, perm


def spec_percone_pass(cfg: VCTConfig, spec_mips, pos: Tensor, nrm: Tensor,
                      shade_normal: Tensor, eye: Tensor, hit: Tensor
                      ) -> Tensor:
    """The exact per-pixel specular cone march (ops/specmarch.py) over
    content-clustered pixel groups -> (N, 4) [rgb, occlusion] in pixel
    order (fast.spec_percone_pass).  A group shares one mip level per step
    group, so groups are made world-space compact by percone_order.  The
    sort, the level selection and the march stay on the device."""
    with span("specmarch.inputs", mark=False):
        start4, refl4, step_lv, weights, perm = spec_march_inputs(
            cfg, spec_mips, pos, nrm, shade_normal, eye, hit)
    with span("specmarch.kernel", mark=False):
        so = SM.spec_march_tiles(start4, refl4, step_lv, weights, spec_mips,
                                 world_size=cfg.grid.world_size,
                                 max_alpha=cfg.cones.max_alpha)
    with span("specmarch.scatter", mark=False):
        out = torch.empty_like(so)
        out[perm] = so
    return out


def _mips_to(vol: Tensor, floor_dim: int) -> Tuple[Tensor, ...]:
    n = int(np.log2(vol.shape[0] // floor_dim)) + 1
    return mip.build_mips(vol, num_levels=n)


def build_frame_tables(cfg: VCTConfig, voxels: VoxelState,
                       mats: MaterialTable) -> FrameTables:
    """Light-transmittance mips (down to the 16^3 light brick), the fused
    diffuse(+specular) field mips (down to the 8^3 field brick), with a
    texture atlas its packed mip pages, and with percone specular the
    radiance pyramid the specular march samples.  The specular field is
    fused only when this config samples it, so a voxel state built for
    field specular can feed a percone frame."""
    if not supported(cfg):
        raise ValueError("fast path needs volume shadows + field cones")
    fields = [voxels.diffuse_field]
    if _spec_field(cfg):
        if voxels.specular_field is None:
            raise ValueError("specular_mode='field' needs a VoxelState "
                             "built with the specular field")
        fields.append(voxels.specular_field)
    with span("tables", mark=False):
        with span("tables.light_mips", mark=False):
            light = _mips_to(voxels.light_volume, TP.BRICK_L)
            light_mips = TP.pack_mips([m[..., 0] for m in light])
        with span("tables.fuse", mark=False):
            fused = torch.cat(fields, dim=-1) if len(fields) > 1 else fields[0]
        with span("tables.field_mips", mark=False):
            field_mips = TP.pack_mips(_mips_to(fused, TP.BRICK_F))
        pages = None
        if mats.atlas is not None:
            with span("tables.atlas_pages", mark=False):
                pages = MT.atlas_mip_pages(mats.atlas.albedo,
                                           mats.atlas.specular,
                                           mats.atlas.height)
        spec_mips = None
        if _spec_percone(cfg):
            with span("tables.spec_mips", mark=False):
                spec_mips = SM.pack_spec_mips(voxels.radiance_mips)
    return FrameTables(light_mips=light_mips, field_mips=field_mips,
                       atlas_pages=pages, spec_mips=spec_mips)


def _tile_order(img: Tensor, hp: int, wp: int) -> Tensor:
    """(H', W', ...) -> tile-major (ntiles*TSY*TSX, ...)."""
    c = img.shape[2:]
    x = img.reshape((hp // TSY, TSY, wp // TSX, TSX) + c)
    x = torch.movedim(x, 2, 1)
    return x.reshape((hp // TSY * (wp // TSX) * TSY * TSX,) + c)


def _untile(flat: Tensor, hp: int, wp: int) -> Tensor:
    c = flat.shape[1:]
    x = flat.reshape((hp // TSY, wp // TSX, TSY, TSX) + c)
    x = torch.movedim(x, 2, 1)
    return x.reshape((hp, wp) + c)


def _pad_edge(img: Tensor, hp: int, wp: int) -> Tensor:
    """Edge-replicate (H, W, C) up to (hp, wp, C) (jnp.pad mode='edge')."""
    h, w = img.shape[:2]
    if hp > h:
        img = torch.cat([img, img[-1:].expand(hp - h, -1, -1)], dim=0)
    if wp > w:
        img = torch.cat([img, img[:, -1:].expand(-1, wp - w, -1)], dim=1)
    return img


def _cones_static(cfg: VCTConfig):
    k = cfg.cones.num_diffuse_cones
    return (
        tuple(map(tuple, np.asarray(C.CONE_DIRECTIONS[:k], np.float32))),
        tuple(float(w) for w in C.CONE_WEIGHTS[:k]),
        tuple(map(tuple, D.direction_basis(cfg.cones.field_basis))),
    )


def render_frame(cfg: VCTConfig,
                 ds: DeviceScene,
                 tables: FrameTables,
                 mats: MaterialTable,
                 origins: Tensor,            # (H, W, 3) camera rays
                 dirs: Tensor,               # (H, W, 3)
                 camera_position: Tensor,    # (3,)
                 light_dir: Optional[Tensor] = None) -> Tensor:
    """Full camera pass -> (H, W, 3) linear RGB.  Above
    raycast.MAX_TRIANGLES, counts the triangles the binning dropped as
    "binning.dropped" (stages.count)."""
    with span("frame", mark=False):
        return _render_frame(cfg, ds, tables, mats, origins, dirs,
                             camera_position, light_dir)


def _render_frame(cfg, ds, tables, mats, origins, dirs, camera_position,
                  light_dir):
    if (mats.atlas is None) != (tables.atlas_pages is None):
        raise ValueError("the material table and the frame tables disagree "
                         "on the texture atlas: build the tables from "
                         "these materials")
    if _spec_percone(cfg) and tables.spec_mips is None:
        raise ValueError("specular_mode='percone' needs frame tables built "
                         "under it (the radiance pyramid, spec_mips)")
    whole = ds.v0.shape[0] <= RP.MAX_TRIANGLES
    with span("rays_and_tables" if whole else "rays"):
        h, w = dirs.shape[:2]
        hp = -(-h // TSY) * TSY
        wp = -(-w // 64) * 64          # binned raycast strip granularity
        if light_dir is None:
            light_dir = light_direction(cfg, dirs.device)
        origin = origins.reshape(-1, 3)[0].contiguous()
        dimg = _pad_edge(dirs, hp, wp)
        d = _tile_order(dimg, hp, wp).contiguous()
        if whole:
            isect, attrs = RP.pack_tables(ds, origin, mats.albedo,
                                          mats.specular, mats.shininess)
    if whole:
        with span("raycast"):
            g = RP.raycast_gbuf24(d, origin, isect, attrs)
    else:
        # the raster-style binned raycast: work per strip scales with the
        # triangles that project onto it
        with span("pack_rows"):
            isect, attrs = BR.pack_rows(ds, origin, mats.albedo,
                                        mats.specular, mats.shininess)
        with span("bin"):
            scal, table, n_col = BR.bin_triangles(ds, origin, d, dimg, isect)
            if counting():
                count("binning.dropped", BR.dropped(n_col, ds.v0.shape[0]))
        with span("raycast"):
            g = BR.raycast_binned(d, origin, scal, table, attrs)
    if mats.atlas is not None and cfg.render.alpha_mask_depth > 0:
        with span("alpha_resolve"):
            g = alpha_resolve(cfg, ds, mats, g, d, origin)
    return _shade(cfg, tables, g, camera_position, light_dir, (h, w, hp, wp))


def _maskable(mats: MaterialTable, thresh: float) -> Tensor:
    """Materials with any texel below the alpha threshold (M,)."""
    return (mats.atlas.albedo[..., 3] < thresh).flatten(1).any(dim=1)


def _candidates(rows: Tensor, maskable: Tensor) -> Tensor:
    """G-buffer rows that hit a maskable material."""
    return (rows[:, 19] > 0.5) & maskable[rows[:, 17].long()]


def recast_inputs(cfg: VCTConfig, mats: MaterialTable, g: Tensor, d: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One alpha re-cast pass's input to the streamed raycast, from the
    G-buffer g and the rays d, both in tile order.

    Up to cfg.render.alpha_mask_budget candidates (hit pixels of materials
    with any masked texel) gather into a fixed-size subset in image order,
    padded with pixel 0; a candidate is masked when its level-0 atlas alpha
    is below the threshold; the subset is sorted by direction (stable),
    masked rays first, so each 256-ray tile keeps a tight cone; masked rays
    get tmin just past their hit and the rest 3e38, so nothing can be hit.
    Returns (idx, masked, d_sub, tmin), each of the budget's length rounded
    up to whole tiles: the slots' pixels, which of them are masked, and
    their rays and minimum distances."""
    return _recast_inputs(cfg, mats, g, d, alpha_test=True)


def _recast_inputs(cfg: VCTConfig, mats: MaterialTable, g: Tensor,
                   d: Tensor, alpha_test: bool
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """recast_inputs; with alpha_test False every candidate counts as
    masked, the load of a camera that sees only masked texels (chip_smoke.py
    builds its stress input so, from the frame's own construction)."""
    thresh = cfg.render.alpha_threshold
    n = g.shape[0]
    dev = g.device
    budget = min(cfg.render.alpha_mask_budget, n)
    budget = -(-budget // RP.TILE) * RP.TILE
    slots = torch.arange(budget, device=dev)
    cand = _candidates(g, _maskable(mats, thresh))
    # nonzero(size=budget, fill_value=0) without a sync: the k-th
    # candidate goes to slot k, slots past the count keep pixel 0
    rank = torch.cumsum(cand.to(torch.int64), 0) - 1
    dest = torch.where(cand & (rank < budget), rank, budget)
    idx = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, dest, torch.arange(n, device=dev))
    idx = idx[:budget]
    masked = slots < cand.sum()
    rows = g[idx]
    if alpha_test:
        alpha = TX.sample_atlas(mats.atlas.albedo, rows[:, 17].long(),
                                rows[:, 15:17])[:, 3]
        masked = masked & (alpha < thresh)
    # sort the subset by direction (stable) so each 256-ray tile has a
    # tight bounding cone for the chunk culling
    d_sub = d[idx]
    qd = torch.clamp((d_sub + 1.0) * 15.999, 0.0, 31.0).to(torch.int32)
    key = (qd[:, 0] << 10) | (qd[:, 1] << 5) | qd[:, 2]
    order = torch.argsort(torch.where(masked, key, 2 ** 30), stable=True)
    idx, masked, d_sub = idx[order], masked[order], d_sub[order]
    tmin = torch.where(masked, rows[order, 18] * (1.0 + 1e-5) + 1e-4,
                       3.0e38)
    return idx, masked, d_sub.contiguous(), tmin


def alpha_resolve(cfg: VCTConfig, ds: DeviceScene, mats: MaterialTable,
                  g: Tensor, d: Tensor, origin: Tensor) -> Tensor:
    """Alpha-mask see-through (fs:169-172 `discard`): hits whose sampled
    albedo alpha is below the threshold re-cast past the masked surface,
    so the geometry behind it shades (fast.alpha_resolve).

    Per pass, the masked ones among up to cfg.render.alpha_mask_budget
    candidates re-enter the streamed raycast with tmin just past their hit
    (recast_inputs), and only their rows are written back.  A second pass
    runs only when a re-cast ray landed on a maskable material again, up
    to cfg.render.alpha_mask_depth passes.  Overflow pixels and deeper
    stacks keep the background.  The flag that decides a pass is read on
    the host: one sync per pass."""
    n = g.shape[0]
    with span("alpha_resolve.pack", mark=False):
        maskable = _maskable(mats, cfg.render.alpha_threshold)
        isect, attrs, spheres = RP.pack_tables_stream(
            ds, origin, mats.albedo, mats.specular, mats.shininess)
        flag = _candidates(g, maskable).any()
    for _ in range(cfg.render.alpha_mask_depth):
        with span("alpha_resolve.flag", mark=False):
            again = bool(flag)                # host sync: the pass's flag
        if not again:
            break
        with span("alpha_resolve.inputs", mark=False):
            idx, masked, d_sub, tmin = recast_inputs(cfg, mats, g, d)
            lists, counts = RP.select_chunks(
                d_sub.reshape(-1, RP.TILE, 3), spheres)
        with span("alpha_resolve.kernel", mark=False):
            g_sub = RP.raycast_stream(d_sub, origin, isect, attrs, lists,
                                      counts, spheres, tmin=tmin)
        with span("alpha_resolve.writeback", mark=False):
            # write back only the masked rows; index n takes the padding
            out = torch.cat([g, g.new_zeros((1, g.shape[1]))])
            out[torch.where(masked, idx, n)] = g_sub
            g = out[:n]
            # another pass only when a re-cast ray landed on a maskable
            # material again (a stacked mask)
            flag = (masked & _candidates(g_sub, maskable)).any()
    return g


def _shade(cfg: VCTConfig, tables: FrameTables, g: Tensor,
           camera_position: Tensor, light_dir: Tensor, hw) -> Tensor:
    h, w, hp, wp = hw
    textured = tables.atlas_pages is not None
    with span("prepass"):
        voxel = cfg.grid.voxel_world_size
        ws = cfg.grid.world_size
        pos = g[:, 0:3]
        nrm = g[:, 3:6]
        hit = g[:, 19] > 0.5
        pkw = dict(light_dims=tuple(m.shape[0] for m in tables.light_mips),
                   field_dims=tuple(m.shape[0] for m in tables.field_mips),
                   voxel=voxel, world_size=ws,
                   shadow_offset=cfg.shadow.normal_offset)
        if not textured:
            # per-tile light/field level + brick selection; material
            # constants ride the raycast's attribute rows
            scal = PP.prepass_tiles(g, **pkw)
        else:
            # the prepass adds per-material atlas entries and pixel slots;
            # the material kernel fetches albedo, specular and the bump
            # heights
            pages = tables.atlas_pages
            res = MT.pages_resolution(pages)
            atlas = PP.AtlasShape(pages.shape[0], res, res.bit_length())
            scal, mscal, mlists, mslots = PP.prepass_tiles(g, atlas=atlas,
                                                           **pkw)
    if textured:
        with span("material"):
            mout = MT.material_tiles(g, mslots, mscal, mlists, pages,
                                     resolution=res)
        with span("bump_normal"):
            albedo4 = mout[:, 0:4]
            spec = mout[:, 4:7]
            shade_normal = TX.bump_normal_from_heights(
                mout[:, 7], mout[:, 8], mout[:, 9], g[:, 9:12], g[:, 12:15],
                nrm)
    with span("tap"):
        if not textured:
            albedo4 = g[:, 20:24]
            spec = g[:, 24:27]
            shade_normal = nrm
        spec = shading.spec_gray_fallback(spec)
        eye = C.normalize(camera_position - pos)
        nb = cfg.cones.field_basis

        # shadow + basis-weighted diffuse (+ specular in field mode) taps,
        # one kernel
        bumpn = torch.cat([shade_normal,
                           torch.zeros_like(shade_normal[:, :1])], dim=1)
        cfield = 4 * nb * (2 if _spec_field(cfg) else 1)
        taps = TP.tap_tiles(
            g, scal, bumpn, camera_position.contiguous(), tables.light_mips,
            tables.field_mips, cfield=cfield, nb=nb, world_size=ws,
            voxel=voxel, shadow_offset=cfg.shadow.normal_offset,
            power_diffuse=int(cfg.cones.basis_power_diffuse),
            power_specular=int(cfg.cones.basis_power_specular),
            cones_static=_cones_static(cfg))
    ind_spec = taps[:, 5:9]
    if _spec_percone(cfg):
        # the exact per-pixel specular cone march in place of the field
        with span("specmarch"):
            ind_spec = spec_percone_pass(cfg, tables.spec_mips, pos, nrm,
                                         shade_normal, eye, hit)

    with span("combine"):
        rgb = shading.combine(
            cfg, albedo=albedo4[:, :3], spec_color=spec, normal=shade_normal,
            light_dir=light_dir, eye_dir=eye, shadow=taps[:, 0],
            ind_diffuse_rgb=taps[:, 1:4], ind_diffuse_occ=taps[:, 4],
            ind_spec_rgb=ind_spec[:, 0:3], ind_spec_occ=ind_spec[:, 3],
            shininess=g[:, 27])
        bg = G.constant(cfg.render.background, rgb.device, rgb.dtype)
        visible = hit & (albedo4[:, 3] >= cfg.render.alpha_threshold)
        rgb = torch.where(visible[:, None], rgb, bg)
        out = _untile(rgb, hp, wp)[:h, :w]
    return out
