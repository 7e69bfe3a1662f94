"""The per-cone frame (the port's render_rays) in plain torch, float32, in
blocks of camera rays: the all-pairs Möller–Trumbore raycast, the
alpha-mask re-cast, the surface inputs from the texture atlas, the
volume-shadow tap, the 6 diffuse cones and the specular cone of every
pixel (march.py), the combine, then the miss and discard background.

What it takes from the frozen reference (vctbench/reference): the
device scene in its Morton order (so that ties of the raycast break on
the same triangle), the G-buffer's interpolation, the atlas fetch and
CalcBumpNormal, the shadow tap, reflect, the gray fallback and the
combine (VoxelConeTracing.fs:165-228).  The raycast with its least hit
distance, the re-cast and the cone frame are written here.

The raycast.  Every ray of a block is tested against every triangle by
Möller–Trumbore's determinants with the shared origin folded into each
triangle (three (N, 3) x (3, T) float32 matmuls), and the winner's
barycentrics come from the same folded products: this form was matched
to the port's pinhole path.  Any other rounding of the same
test differs where it matters most: the atrium holds coplanar
overlapping panels (the ceiling at y = -4 under larger slabs), hit at
the same t up to rounding, so another rounding picks the other surface
on whole patches of pixels; and at grazing hits on tiled textures the
barycentrics of Möller–Trumbore's unfolded form move uv by up to 3e-4,
which the bump normal and the specular power turn into visible
differences.

Where it departs from the port: the cone frame inverts transpose(T, B,
N) by its cofactors (the port by an LU solve); the cone march is the
shader's loop (march.py), where the port composites a whole cone at
once by cumulative products; both give the same values up to rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from vctbench.reference.config import VCTConfig
from vctbench.reference.core import cones as C
from vctbench.reference.core import grid as G
from vctbench.reference.render import gbuffer as GB
from vctbench.reference.render import shading as S
from vctbench.reference.render.renderer import (MaterialTable, VoxelState,
                                                light_direction)
from vctbench.reference.scene import textures as TX
from vctbench.reference_oracle import march as M

Tensor = torch.Tensor

# rays a block, which bounds the (rays x triangles) intermediates of the
# raycast (65,536 x 1,122 float32: 294 MB each); the image does not
# depend on it
BLOCK = 65536
EPS = 1e-7


class Pinhole(NamedTuple):
    """Möller–Trumbore's triple products with the shared origin folded
    into each triangle (T, 3): det = d . (e2 x e1), u det = d . (e2 x s),
    v det = d . (s x e1), t det = e2 . (s x e1), s = origin - v0."""

    a: Tensor
    b: Tensor
    c: Tensor
    k: Tensor


def pinhole(ds: GB.DeviceScene, origin: Tensor) -> Pinhole:
    s = origin[None, :] - ds.v0
    c = torch.linalg.cross(s, ds.e1, dim=-1)
    return Pinhole(torch.linalg.cross(ds.e2, ds.e1, dim=-1),
                   torch.linalg.cross(ds.e2, s, dim=-1), c,
                   torch.sum(ds.e2 * c, dim=-1))


def intersect(ph: Pinhole, d: Tensor, tmin: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Rays (N, 3) from the shared origin against every triangle: the
    closest hit past 1e-4 (and past tmin (N,) where given) -> (t, tri,
    det), t = inf for a miss, ties to the lowest triangle index.  The
    conditions u >= 0, v >= 0, u + v <= 1, t > 1e-4 are multiplied
    through by |det|."""
    det = d @ ph.a.T                                             # (N, T)
    ud = d @ ph.b.T
    vd = d @ ph.c.T
    sg = torch.sign(det)
    ad = det.abs()
    sk = sg * ph.k[None, :]
    valid = ((ad > EPS) & (sg * ud >= 0) & (sg * vd >= 0)
             & (sg * (ud + vd) <= ad) & (sk > 1e-4 * ad))
    t = sk / torch.clamp_min(ad, EPS)
    if tmin is not None:
        valid = valid & (t > tmin[:, None])
    t = torch.where(valid, t, torch.inf)
    tri = torch.argmin(t, dim=-1)
    pick = tri[:, None]
    return t.gather(1, pick)[:, 0], tri, det.gather(1, pick)[:, 0]


def raycast(ds: GB.DeviceScene, ph: Pinhole, origin: Tensor, d: Tensor,
            tmin: Optional[Tensor] = None) -> GB.GBuffer:
    """The G-buffer of rays (N, 3) from `origin` (3,): the closest hit,
    its barycentrics u = (u det) / det and v = (v det) / det."""
    t, tri, det = intersect(ph, d, tmin)
    inv = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    u = torch.sum(d * ph.b[tri], dim=-1) * inv
    v = torch.sum(d * ph.c[tri], dim=-1) * inv
    return GB._interp_gbuffer(ds, origin[None, :].expand_as(d), d, t, u, v,
                              tri)


def alpha_recast(cfg: VCTConfig, ds: GB.DeviceScene, mats: MaterialTable,
                 ph: Pinhole, origin: Tensor, d: Tensor, g: GB.GBuffer
                 ) -> GB.GBuffer:
    """fs:169-172's discard shows the surface behind: a hit whose albedo
    alpha is under the threshold is cast again from just past it
    (t (1 + 1e-5) + 1e-4), alpha_mask_depth times."""
    if cfg.render.alpha_mask_depth <= 0 or mats.atlas is None:
        return g
    for _ in range(cfg.render.alpha_mask_depth):
        alpha = mats.sample_albedo(g.material, g.uv)[:, 3]
        masked = g.hit & (alpha < cfg.render.alpha_threshold)
        tmin = torch.where(masked, g.t * (1.0 + 1e-5) + 1e-4, -1.0)
        again = raycast(ds, ph, origin, d, tmin)

        def pick(a, b):
            m = masked.reshape(masked.shape + (1,) * (a.dim() - 1))
            return torch.where(m, b, a)

        g = GB.map_gbuffer(pick, g, again)
    return g


def cone_frame(tangent: Tensor, bitangent: Tensor, normal: Tensor,
               dirs: Tensor) -> Tensor:
    """normalize(TBN @ dir) for TBN = inverse(transpose(mat3(T, B, N)))
    (fs:175, 198): the columns of that inverse are B x N, N x T and T x B
    over det = T . (B x N).  dirs (K, 3) -> (N, K, 3)."""
    bn = torch.linalg.cross(bitangent, normal, dim=-1)
    nt = torch.linalg.cross(normal, tangent, dim=-1)
    tb = torch.linalg.cross(tangent, bitangent, dim=-1)
    det = torch.sum(tangent * bn, dim=-1, keepdim=True)
    out = (dirs[None, :, 0:1] * bn[:, None] + dirs[None, :, 1:2] * nt[:, None]
           + dirs[None, :, 2:3] * tb[:, None]) / det[:, None]
    return C.normalize(out)


def shade(cfg: VCTConfig, voxels: VoxelState, mats: MaterialTable,
          g: GB.GBuffer, camera: Tensor, light: Tensor,
          q: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """The fragment stage of one block -> (N, 3) linear RGB."""
    cc = cfg.cones
    voxel, ws = cfg.grid.voxel_world_size, cfg.grid.world_size
    albedo = mats.sample_albedo(g.material, g.uv)
    spec = S.spec_gray_fallback(mats.sample_specular(g.material, g.uv))
    normal = g.normal
    if mats.atlas is not None:
        normal = TX.bump_normal(mats.atlas, g.material, g.uv, g.tangent,
                                g.bitangent, g.normal)
    shadow = S.shadow_volume_tap(cfg, voxels.light_volume, g.position,
                                 g.geo_normal)
    eye = C.normalize(camera - g.position)                     # fs:183
    start = g.position + g.normal * voxel                      # fs:92
    pyr = voxels.radiance_mips

    k = cc.num_diffuse_cones
    axes = cone_frame(g.tangent, g.bitangent, g.normal,
                      G.constant(C.CONE_DIRECTIONS[:k], start.device))
    steps = M.cone_steps(cc.diffuse_tan_half_angle, voxel, cc.max_distance,
                         cc.max_steps)
    ind_d = start.new_zeros((start.shape[0], 3))
    ind_d_occ = start.new_zeros((start.shape[0],))
    for i in range(k):                                         # fs:196-199
        rgb, occ = M.cone_trace(pyr, start, axes[:, i], steps, ws,
                                cc.max_alpha, cc.occlusion_falloff, q)
        w = float(C.CONE_WEIGHTS[i])
        ind_d = ind_d + w * rgb
        ind_d_occ = ind_d_occ + w * occ

    if cc.trace_specular:                                      # fs:217-220
        refl = S.reflect_eye(normal, eye)
        ind_s, ind_s_occ = M.cone_trace(
            pyr, start, refl,
            M.cone_steps(cc.specular_tan_half_angle, voxel, cc.max_distance,
                         cc.max_steps),
            ws, cc.max_alpha, cc.occlusion_falloff, q)
    else:
        ind_s, ind_s_occ = torch.zeros_like(ind_d), torch.zeros_like(
            ind_d_occ)

    rgb = S.combine(cfg, albedo=albedo[:, :3], spec_color=spec,
                    normal=normal, light_dir=light, eye_dir=eye,
                    shadow=shadow, ind_diffuse_rgb=ind_d,
                    ind_diffuse_occ=ind_d_occ, ind_spec_rgb=ind_s,
                    ind_spec_occ=ind_s_occ,
                    shininess=mats.shininess[g.material.long()])
    bg = G.constant(cfg.render.background, rgb.device)
    shown = g.hit & (albedo[:, 3] >= cfg.render.alpha_threshold)
    return torch.where(shown[:, None], rgb, bg)


def render(cfg: VCTConfig, ds: GB.DeviceScene, voxels: VoxelState,
           mats: MaterialTable, origins: Tensor, dirs: Tensor,
           camera: Tensor, q: Optional[Callable[[Tensor], Tensor]] = None
           ) -> Tensor:
    """The frame of camera rays (one shared origin) -> origins.shape[:-1]
    + (3,) linear RGB."""
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    origin = o[0]
    ph = pinhole(ds, origin)
    light = light_direction(cfg, d.device)
    out = []
    for s in range(0, d.shape[0], BLOCK):
        db = d[s:s + BLOCK]
        g = alpha_recast(cfg, ds, mats, ph, origin, db,
                         raycast(ds, ph, origin, db))
        out.append(shade(cfg, voxels, mats, g, camera, light, q))
    return torch.cat(out).reshape(origins.shape[:-1] + (3,))
