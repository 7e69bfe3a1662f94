"""The fast frame path (port of vct_tpu/render/fast.py:56-482).

  1. ops/raycast.py — closest hit + G-buffer, whole triangle table
  2. ops/prepass.py — per 16x16 tile: light and field mip level + brick
  3. ops/tap.py     — shadow tap + basis-weighted diffuse/specular taps
  4. shading.combine (VoxelConeTracing.fs:165-228), background, untile.

Ported for scenes of at most 2048 triangles without a texture atlas and
field-mode specular.  The other branches of the JAX path raise
NotImplementedError naming the ROADMAP item that ports them; nothing
falls back silently.  PyTorch runs eagerly, so the JAX path's two-jit
split (a TPU compile-arena workaround) has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vct_tpu.config import VCTConfig
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.ops import mip
from vct_tpu_torch.ops import prepass as PP
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.ops import tap as TP
from vct_tpu_torch.render import shading
from vct_tpu_torch.render.gbuffer import DeviceScene
from vct_tpu_torch.render.renderer import (MaterialTable, VoxelState,
                                           light_direction)

Tensor = torch.Tensor

TSY = 16  # image tile rows
TSX = 16  # image tile cols; TSY * TSX == TP.TILE pixels per tap tile


@dataclasses.dataclass
class FrameTables:
    """Per-voxel-state tables the frame samples (ops/tap.py layout)."""

    light_mips: Tuple[Tensor, ...]       # each (D, D, D) bf16, D = dim..16
    field_mips: Tuple[Tensor, ...]       # each (D, D, D, C) bf16, D = df..8


def supported(cfg: VCTConfig) -> bool:
    """Does this config route through the fast path (same rule as the JAX
    package: volume shadows, field diffuse, field/percone/no specular)?"""
    spec_ok = (not cfg.cones.trace_specular
               or cfg.cones.specular_mode == "field"
               or (cfg.cones.specular_mode == "percone"
                   and not cfg.grid.anisotropic))
    return (cfg.shadow.mode == "volume"
            and cfg.cones.diffuse_mode == "field" and spec_ok)


def _refuse_off_slice(cfg: VCTConfig, mats: MaterialTable) -> None:
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "percone":
        raise NotImplementedError(
            "specular_mode='percone' needs the exact specular march: "
            "ROADMAP Queue 2 item 8 (specmarch_pallas)")
    if mats.atlas is not None:
        raise NotImplementedError(
            "texture atlases need the alpha re-cast and the material "
            "kernel: ROADMAP Queue 2 items 4 and 6 (raycast_stream, "
            "material_pallas)")


def _mips_to(vol: Tensor, floor_dim: int) -> Tuple[Tensor, ...]:
    n = int(np.log2(vol.shape[0] // floor_dim)) + 1
    return mip.build_mips(vol, num_levels=n)


def build_frame_tables(cfg: VCTConfig, voxels: VoxelState,
                       mats: MaterialTable) -> FrameTables:
    """Light-transmittance mips (down to the 16^3 light brick) and the
    fused diffuse(+specular) field mips (down to the 8^3 field brick)."""
    if not supported(cfg):
        raise ValueError("fast path needs volume shadows + field cones")
    _refuse_off_slice(cfg, mats)
    light = _mips_to(voxels.light_volume, TP.BRICK_L)
    fields = [voxels.diffuse_field]
    if cfg.cones.trace_specular:
        if voxels.specular_field is None:
            raise ValueError("specular_mode='field' needs a VoxelState "
                             "built with the specular field")
        fields.append(voxels.specular_field)
    fused = torch.cat(fields, dim=-1) if len(fields) > 1 else fields[0]
    return FrameTables(
        light_mips=TP.pack_mips([m[..., 0] for m in light]),
        field_mips=TP.pack_mips(_mips_to(fused, TP.BRICK_F)))


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
    """Full camera pass -> (H, W, 3) linear RGB."""
    _refuse_off_slice(cfg, mats)
    if ds.v0.shape[0] > RP.MAX_TRIANGLES:
        raise NotImplementedError(
            f"{ds.v0.shape[0]} triangles exceed the whole-table raycast's "
            f"{RP.MAX_TRIANGLES}: the binned raycast is ROADMAP Queue 2 "
            "item 3 (binrast_pallas)")
    h, w = dirs.shape[:2]
    hp = -(-h // TSY) * TSY
    wp = -(-w // 64) * 64
    if light_dir is None:
        light_dir = light_direction(cfg, dirs.device)
    origin = origins.reshape(-1, 3)[0].contiguous()
    d = _tile_order(_pad_edge(dirs, hp, wp), hp, wp).contiguous()
    isect, attrs = RP.pack_tables(ds, origin, mats.albedo, mats.specular,
                                  mats.shininess)
    g = RP.raycast_gbuf24(d, origin, isect, attrs)
    return _shade(cfg, tables, g, camera_position, light_dir, (h, w, hp, wp))


def _shade(cfg: VCTConfig, tables: FrameTables, g: Tensor,
           camera_position: Tensor, light_dir: Tensor, hw) -> Tensor:
    h, w, hp, wp = hw
    voxel = cfg.grid.voxel_world_size
    ws = cfg.grid.world_size
    pos = g[:, 0:3]
    nrm = g[:, 3:6]
    hit = g[:, 19] > 0.5

    # per-tile light/field level + brick selection
    scal = PP.prepass_tiles(
        g, light_dims=tuple(m.shape[0] for m in tables.light_mips),
        field_dims=tuple(m.shape[0] for m in tables.field_mips),
        voxel=voxel, world_size=ws, shadow_offset=cfg.shadow.normal_offset)

    albedo4 = g[:, 20:24]
    spec = shading.spec_gray_fallback(g[:, 24:27])
    shade_normal = nrm
    eye = C.normalize(camera_position - pos)
    nb = cfg.cones.field_basis

    # shadow + basis-weighted diffuse (+ specular) taps, one kernel
    bumpn = torch.cat([shade_normal, torch.zeros_like(shade_normal[:, :1])],
                      dim=1)
    cfield = 4 * nb * (2 if cfg.cones.trace_specular else 1)
    taps = TP.tap_tiles(
        g, scal, bumpn, camera_position.contiguous(), tables.light_mips,
        tables.field_mips, cfield=cfield, nb=nb, world_size=ws, voxel=voxel,
        shadow_offset=cfg.shadow.normal_offset,
        power_diffuse=int(cfg.cones.basis_power_diffuse),
        power_specular=int(cfg.cones.basis_power_specular),
        cones_static=_cones_static(cfg))

    rgb = shading.combine(
        cfg, albedo=albedo4[:, :3], spec_color=spec, normal=shade_normal,
        light_dir=light_dir, eye_dir=eye, shadow=taps[:, 0],
        ind_diffuse_rgb=taps[:, 1:4], ind_diffuse_occ=taps[:, 4],
        ind_spec_rgb=taps[:, 5:8], ind_spec_occ=taps[:, 8],
        shininess=g[:, 27])
    bg = torch.as_tensor(cfg.render.background, dtype=rgb.dtype,
                         device=rgb.device)
    visible = hit & (albedo4[:, 3] >= cfg.render.alpha_threshold)
    rgb = torch.where(visible[:, None], rgb, bg)
    return _untile(rgb, hp, wp)[:h, :w]
