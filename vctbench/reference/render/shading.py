"""Schedules, the shadow providers, the dense light volume and cone
fields, the per-pixel indirect providers and the combine of
VoxelConeTracing.fs:165-228 (port of vct_tpu/render/shading.py).

The per-pixel providers serve the per-cone oracle renderer
(renderer.render_rays) and the build's extra GI bounces: "percone" ones
march each cone through the radiance pyramid (core/march.py), "field"
ones tap the basis fields and weight them by basis_weights.
"""

from __future__ import annotations

import torch

from vctbench.reference.config import VCTConfig
from vctbench.reference.core import cones as C
from vctbench.reference.core import dense as D
from vctbench.reference.core import grid as G
from vctbench.reference.core import march as M

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
# per-pixel indirect providers
# ---------------------------------------------------------------------------


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
