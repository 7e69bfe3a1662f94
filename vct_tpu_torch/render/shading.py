"""Schedules, the shadow providers, the dense light volume and cone
fields, the per-pixel indirect providers and the combine of
VoxelConeTracing.fs:165-228 (port of vct_tpu/render/shading.py, without
the brick-sharded branches).

The per-pixel providers serve the per-cone oracle renderer
(renderer.render_rays) and the build's extra GI bounces: "percone" ones
march each cone through the radiance pyramid (core/march.py), "field"
ones tap the basis fields and weight them by basis_weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# schedules (all static from config)
# ---------------------------------------------------------------------------

def diffuse_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    ca = cfg.cones
    return M.march_schedule(ca.diffuse_tan_half_angle,
                            cfg.grid.voxel_world_size, ca.max_distance,
                            ca.max_steps)


def specular_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    ca = cfg.cones
    return M.march_schedule(ca.specular_tan_half_angle,
                            cfg.grid.voxel_world_size, ca.max_distance,
                            ca.max_steps)


def specular_field_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    """The specular field build's coarser schedule
    (ConeSetConfig.field_specular_step_factor)."""
    ca = cfg.cones
    return M.march_schedule(
        ca.specular_tan_half_angle, cfg.grid.voxel_world_size,
        ca.max_distance, ca.max_steps,
        step_factor=ca.field_specular_step_factor)


def shadow_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    """Shadow cones traverse the whole grid with denser steps."""
    md = cfg.shadow.max_distance
    if md is None:
        md = 3.0 ** 0.5 * cfg.grid.world_size
    return M.march_schedule(
        cfg.shadow.tan_half_angle, cfg.grid.voxel_world_size, md,
        cfg.cones.max_steps, step_factor=cfg.shadow.step_factor)


def field_dim(cfg: VCTConfig) -> int:
    if cfg.cones.field_dim is not None:
        return cfg.cones.field_dim
    return min(cfg.grid.dim, 128)


def march_compute_dtype(cfg: VCTConfig):
    """Dense-march contraction dtype (GridConfig.compute)."""
    return torch.bfloat16 if cfg.grid.compute == "bfloat16" else None


# ---------------------------------------------------------------------------
# light volume + shadow taps
# ---------------------------------------------------------------------------

def build_light_volume(cfg: VCTConfig, unlit_mips, light_dir=None) -> Tensor:
    """Dense light-transmittance volume (D, D, D, 1): the shadow cone
    toward the (static) config light from every voxel center."""
    if light_dir is None:
        light_dir = cfg.light.direction
    d = np.asarray(light_dir, np.float64)
    d = d / np.linalg.norm(d)
    return D.directional_march(
        unlit_mips, d, shadow_schedule(cfg), cfg.grid.world_size,
        field_dim=cfg.grid.dim, opacity_gain=cfg.shadow.opacity_gain,
        transmittance_only=True, compute_dtype=march_compute_dtype(cfg))


def shadow_cone_value(mips: Sequence[Tensor], position: Tensor,
                      normal: Tensor, light_dir: Tensor,
                      schedule: M.MarchSchedule, cfg: VCTConfig) -> Tensor:
    """Per-query shadow cone (shadow mode "percone"): the transmittance of
    a narrow cone toward the light (3,) through the occupancy pyramid from
    position (..., 3) offset along normal, with per-sample opacity gain
    and the step-density correction.  Returns shadow in [0, 1], 1 = lit."""
    voxel = cfg.grid.voxel_world_size
    start = position + normal * (voxel * cfg.shadow.normal_offset)
    d = light_dir.expand_as(start)
    if schedule.num_steps == 0:
        return position.new_ones(position.shape[:-1])
    dists = G.constant(schedule.dists, position.device, position.dtype)
    points = start[..., None, :] + dists[:, None] * d[..., None, :]
    samples = M.sample_schedule(mips, points, schedule.lods,
                                cfg.grid.world_size, direction=d)
    a = torch.clamp_max(samples[..., 3] * cfg.shadow.opacity_gain, 1.0)
    if schedule.step_factor != 1.0:
        keep = (1.0 - a) ** schedule.step_factor
    else:
        keep = 1.0 - a
    return torch.prod(keep, dim=-1)


def shadow_volume_tap(cfg: VCTConfig, light_volume: Tensor,
                      position: Tensor, normal: Tensor) -> Tensor:
    """One trilinear tap of the transmittance volume (D, D, D, 1) at the
    offset surface point (the unpacked form of shadow_volume_tap_packed)."""
    voxel = cfg.grid.voxel_world_size
    p = position + normal * (voxel * cfg.shadow.normal_offset)
    uvw = G.world_to_uvw(p, cfg.grid.world_size)
    return G.trilinear_sample(light_volume, uvw)[..., 0]


def pack_light_corners(light_volume: Tensor) -> Tensor:
    """(D, D, D, 1) -> (D^3, 8): each cell's 2x2x2 trilinear corner
    neighborhood (edge-replicated +1 shifts).  Corner order: bit2=dx,
    bit1=dy, bit0=dz."""
    v = light_volume[..., 0]
    corners = []
    for dx in (0, 1):
        vx = v if dx == 0 else torch.cat([v[1:], v[-1:]], dim=0)
        for dy in (0, 1):
            vy = vx if dy == 0 else torch.cat([vx[:, 1:], vx[:, -1:]], dim=1)
            for dz in (0, 1):
                vz = vy if dz == 0 else torch.cat(
                    [vy[:, :, 1:], vy[:, :, -1:]], dim=2)
                corners.append(vz)
    return torch.stack(corners, dim=-1).reshape(-1, 8)


def shadow_volume_tap_packed(cfg: VCTConfig, packed: Tensor, dim: int,
                             position: Tensor, normal: Tensor) -> Tensor:
    """One trilinear tap of the transmittance volume at the offset point,
    against pack_light_corners output (shading.shadow_volume_tap math)."""
    voxel = cfg.grid.voxel_world_size
    p = position + normal * (voxel * cfg.shadow.normal_offset)
    t = torch.clamp(G.world_to_uvw(p, cfg.grid.world_size) * dim - 0.5,
                    0.0, dim - 1.0)
    i0 = torch.floor(t)
    f = t - i0
    i = i0.long()
    row = (i[..., 0] * dim + i[..., 1]) * dim + i[..., 2]
    corners = packed[row]
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    w = torch.cat([
        (fx if k & 4 else 1.0 - fx) * (fy if k & 2 else 1.0 - fy)
        * (fz if k & 1 else 1.0 - fz) for k in range(8)], dim=-1)
    return torch.sum(corners * w, dim=-1)


# ---------------------------------------------------------------------------
# cone fields
# ---------------------------------------------------------------------------

def build_cone_field(cfg: VCTConfig, mips, schedule: M.MarchSchedule
                     ) -> Tensor:
    """Cone-gather fields for the direction basis, stacked channelwise:
    (df, df, df, B*4) with per-direction (rgb, occlusion)."""
    return D.directional_march_multi(
        mips, D.direction_basis(cfg.cones.field_basis), schedule,
        cfg.grid.world_size, field_dim=field_dim(cfg),
        max_alpha=cfg.cones.max_alpha,
        occlusion_falloff=cfg.cones.occlusion_falloff,
        compute_dtype=march_compute_dtype(cfg))


# ---------------------------------------------------------------------------
# per-pixel indirect providers
# ---------------------------------------------------------------------------

def pixel_cone_dirs(cfg: VCTConfig, normal: Tensor, tangent: Tensor,
                    bitangent: Tensor) -> Tensor:
    """World-space diffuse cone directions per pixel: normalize(TBN @
    dir_i) — fs:175,198.  Returns (..., K, 3)."""
    tbn = C.tbn_matrix(tangent, bitangent, normal)
    return C.rotate_cones(tbn, G.constant(
        C.CONE_DIRECTIONS[:cfg.cones.num_diffuse_cones], tbn.device))


def indirect_diffuse_percone(cfg: VCTConfig, mips: Sequence[Tensor],
                             position: Tensor, normal: Tensor,
                             cone_dirs: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact per-pixel K-cone gather (fs:196-199) -> (rgb, occlusion)."""
    ca = cfg.cones
    start = position + normal * cfg.grid.voxel_world_size    # fs:92
    weights = tuple(float(w) for w in C.CONE_WEIGHTS[:ca.num_diffuse_cones])
    return M.cone_march_multi(
        mips, start, cone_dirs, weights, diffuse_schedule(cfg),
        cfg.grid.world_size, max_alpha=ca.max_alpha,
        occlusion_falloff=ca.occlusion_falloff)


def indirect_specular_percone(cfg: VCTConfig, mips: Sequence[Tensor],
                              position: Tensor, normal: Tensor,
                              refl_dir: Tensor) -> Tuple[Tensor, Tensor]:
    """The mirror cone (tan 0.07, fs:218) marched per pixel ->
    (rgb, occlusion)."""
    ca = cfg.cones
    start = position + normal * cfg.grid.voxel_world_size
    rgb, occ, _ = M.cone_march(
        mips, start, refl_dir, specular_schedule(cfg), cfg.grid.world_size,
        max_alpha=ca.max_alpha, occlusion_falloff=ca.occlusion_falloff)
    return rgb, occ


def _field_tap(cfg: VCTConfig, field: Tensor, position: Tensor,
               normal: Tensor) -> Tensor:
    """Trilinear tap of the stacked fields at the offset point: (..., B, 4)."""
    p = position + normal * cfg.grid.voxel_world_size
    out = G.trilinear_sample(field, G.world_to_uvw(p, cfg.grid.world_size))
    return out.reshape(out.shape[:-1] + (cfg.cones.field_basis, 4))


def indirect_diffuse_field(cfg: VCTConfig, field: Tensor, position: Tensor,
                           normal: Tensor, cone_dirs: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """Field-mode K-cone gather: the cone weights and the basis weights
    fold into one (..., B) weight vector over one field tap."""
    basis = D.direction_basis(cfg.cones.field_basis)
    ca = cfg.cones
    wb = D.basis_weights(cone_dirs, basis, ca.basis_power_diffuse)
    cw = G.constant(C.CONE_WEIGHTS[:ca.num_diffuse_cones], wb.device)
    w = torch.einsum("k,...kb->...b", cw, wb)
    out = torch.einsum("...b,...bc->...c", w,
                       _field_tap(cfg, field, position, normal))
    return out[..., :3], out[..., 3]


def indirect_specular_field(cfg: VCTConfig, field: Tensor, position: Tensor,
                            normal: Tensor, refl_dir: Tensor
                            ) -> Tuple[Tensor, Tensor]:
    basis = D.direction_basis(cfg.cones.field_basis)
    w = D.basis_weights(refl_dir, basis, cfg.cones.basis_power_specular)
    out = torch.einsum("...b,...bc->...c", w,
                       _field_tap(cfg, field, position, normal))
    return out[..., :3], out[..., 3]


# ---------------------------------------------------------------------------
# the combine (fs:165-228)
# ---------------------------------------------------------------------------

def combine(
    cfg: VCTConfig,
    albedo: Tensor,              # (..., 3)
    spec_color: Tensor,          # (..., 3) after gray-fallback
    normal: Tensor,              # (..., 3) shading normal
    light_dir: Tensor,           # (3,)
    eye_dir: Tensor,             # (..., 3) normalize(camera - P), fs:183
    shadow: Tensor,              # (...,)
    ind_diffuse_rgb: Tensor,     # (..., 3)
    ind_diffuse_occ: Tensor,     # (...,)
    ind_spec_rgb: Tensor,        # (..., 3)
    ind_spec_occ: Tensor,        # (...,)
    shininess,                   # float or (...,) per-pixel Phong exponent
) -> Tensor:
    n = C.normalize(normal)
    l = light_dir
    e = eye_dir

    # DIFFUSE — fs:186-205
    cos_theta = torch.clamp_min(torch.sum(n * l, dim=-1), 0.0)
    direct_diffuse = shadow * cos_theta
    if not cfg.render.show_diffuse:
        direct_diffuse = torch.zeros_like(direct_diffuse)
    if not cfg.render.show_indirect_diffuse:
        ind_diffuse_rgb = torch.zeros_like(ind_diffuse_rgb)
    occlusion = 1.0 - ind_diffuse_occ                # fs:201
    diffuse_reflection = (
        direct_diffuse[..., None] + occlusion[..., None] * ind_diffuse_rgb
    ) * albedo                                       # fs:205

    # SPECULAR — fs:208-223; reflect(-L, N) = 2*dot(N,L)*N - L
    spec_reflect = C.normalize(
        2.0 * torch.sum(n * l, dim=-1, keepdim=True) * n - l)
    spec = torch.clamp_min(torch.sum(e * spec_reflect, dim=-1), 0.0) \
        ** shininess
    direct_specular = spec * shadow
    if not cfg.render.show_specular:
        direct_specular = torch.zeros_like(direct_specular)
    if not cfg.render.show_indirect_specular:
        ind_spec_rgb = torch.zeros_like(ind_spec_rgb)
    if cfg.cones.trace_specular:
        spec_occlusion = 1.0 - ind_spec_occ          # fs:221
        specular_reflection = (
            ind_spec_rgb + spec_occlusion[..., None]
            * direct_specular[..., None]) * spec_color  # fs:223
    else:
        specular_reflection = torch.zeros_like(diffuse_reflection)

    # AMBIENT — fs:225
    ambient = cfg.light.ambient_factor * albedo * occlusion[..., None]
    return ambient + diffuse_reflection + specular_reflection   # fs:227


def reflect_eye(normal: Tensor, eye_dir: Tensor) -> Tensor:
    """reflect(-E, N) = 2*dot(N,E)*N - E — the specular cone axis, fs:217."""
    n = C.normalize(normal)
    return C.normalize(
        2.0 * torch.sum(n * eye_dir, dim=-1, keepdim=True) * n - eye_dir)


def spec_gray_fallback(spec: Tensor) -> Tensor:
    """specColor = length(spec.gb) > 0 ? spec : spec.rrr — fs:209-210."""
    gb = torch.sqrt(torch.sum(spec[..., 1:3] ** 2, dim=-1, keepdim=True))
    return torch.where(gb > 0.0, spec, spec[..., 0:1])
