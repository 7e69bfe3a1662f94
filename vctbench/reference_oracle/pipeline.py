"""The plain reference of the per-cone route and its lower-precision
control, through vctbench/spec.py's interface.

The route is the port's oracle renderer (render/renderer.render_rays),
which the port takes where the fast frame cannot run, here because the
cones are marched per pixel (cones.diffuse_mode and specular_mode
"percone"), as the upstream fragment shader marches them
(Shader/VoxelConeTracing.fs:82-107, 165-229).  The build is
reference_aniso's with no basis field (the route marches the pyramid
itself): the splats, the isotropic occupancy pyramid with max alpha,
the light volume's transmittance march (the frozen plain dense march)
and the 6-direction radiance pyramid of Crassin, Neyret, Sainz, Green
and Eisemann, "Interactive Indirect Illumination Using Voxel Cone
Tracing" (Pacific Graphics 2011).  The frame is frame.py, its cone
march march.py.  Plain torch in float32, TF32 off; it loads nothing of
vct_tpu_torch, vct_tpu or jax.

The control (lower_precision=True) rounds what the build hands on
(splats, both pyramids, the light volume) and every sample of every
cone march to the precision below the configuration's (float32 to
bfloat16).  `percone_work` gives the (bytes, float operations) of one
frame's cone marches (march.march_work).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vctbench.reference import pipeline as P
from vctbench.reference.config import VCTConfig
from vctbench.reference.core import grid as G
from vctbench.reference.ops import mip
from vctbench.reference.render import renderer as R
from vctbench.reference.render import shading
from vctbench.reference.render.voxelize import splat
from vctbench.reference_aniso import aniso as A
from vctbench.reference_aniso.renderer import RADIANCE_CHANNELS
from vctbench.reference_oracle import frame as FR
from vctbench.reference_oracle import march as M

Tensor = torch.Tensor


def build_voxel_state(cfg: VCTConfig, samples: R.SamplesDevice,
                      mats: R.MaterialTable,
                      q: Optional[Callable[[Tensor, str], Tensor]] = None,
                      works: Optional[List[Tuple[int, int]]] = None
                      ) -> R.VoxelState:
    """Splats, the occupancy pyramid, the light volume and the 6-direction
    radiance pyramid under cfg.light; q and works as in the frozen
    build."""
    if q is None:
        def q(x, _):
            return x
    dim, ws = cfg.grid.dim, cfg.grid.world_size
    dev = samples.positions.device
    light_color = G.constant(cfg.light.color, dev)
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    emissive = mats.emissive[samples.material_ids.long()]
    weights = torch.ones(samples.positions.shape[0], dtype=albedo.dtype,
                         device=dev)
    unlit = q(splat(samples.positions, albedo[:, :3], weights, dim, ws,
                    mode=cfg.voxelize.mode), "float32")
    unlit_mips = tuple(q(m, "float32") for m in mip.build_mips(
        unlit, cfg.grid.num_levels, alpha_mode="max"))
    d = np.asarray(cfg.light.direction, np.float64)
    light_volume = q(R._march(
        cfg, unlit_mips, (d / np.linalg.norm(d))[None],
        shading.shadow_schedule(cfg), works, field_dim=dim,
        opacity_gain=cfg.shadow.opacity_gain, transmittance_only=True),
        cfg.grid.compute)
    shadow = shading.shadow_volume_tap_packed(
        cfg, shading.pack_light_corners(light_volume), dim,
        samples.positions, samples.normals)
    radiance = albedo[:, :3] * light_color * shadow[:, None] + emissive
    lit = q(splat(samples.positions, radiance, weights, dim, ws,
                  mode=cfg.voxelize.mode), "float32")
    pyramid = A.build_aniso_mips(lit, cfg.grid.num_levels)
    return R.VoxelState(radiance_mips=tuple(q(m, "float32") for m in pyramid),
                        unlit_mips=unlit_mips, light_volume=light_volume)


class Built(NamedTuple):
    cfg: VCTConfig
    voxels: R.VoxelState


class Reference(P.Reference):
    """The reference prepared for one per-cone configuration."""

    def __init__(self, config: dict, scene_base, scene_frame, device,
                 lower_precision: bool = False):
        super().__init__(config, scene_base, scene_frame, device,
                         lower_precision)
        cc = self.cfg.cones
        if not self.cfg.grid.anisotropic:
            raise ValueError("this reference builds the anisotropic pyramid: "
                             "the configuration's grid.anisotropic is false")
        if cc.diffuse_mode != "percone" or (
                cc.trace_specular and cc.specular_mode != "percone"):
            raise ValueError("this reference marches the cones per pixel: "
                             "the configuration's cone modes are not "
                             "'percone'")
        if self.cfg.shadow.mode != "volume":
            raise ValueError("this reference taps the light volume: the "
                             "configuration's shadow mode is not 'volume'")

    def build(self, light=None,
              works: Optional[List[Tuple[int, int]]] = None) -> Built:
        cfg = self._cfg(light)
        with torch.no_grad():
            return Built(cfg, build_voxel_state(cfg, self.samples,
                                                self.mats, q=self.q,
                                                works=works))

    def frame(self, built: Built, origins, dirs, position) -> torch.Tensor:
        q = None
        if self.q is not None:
            def q(x):
                return self.q(x, "float32")
        with torch.no_grad():
            return FR.render(built.cfg, self.ds, built.voxels, self.mats,
                             origins, dirs, position, q=q)

    def percone_work(self, active: float) -> Tuple[int, int]:
        """(bytes, float operations) of one frame's cone marches: every
        pixel's diffuse cones and specular cone, float32, of which the
        share `active` of the scheduled samples runs (march.march_work)."""
        cfg, cc = self.cfg, self.cfg.cones
        voxel, g = cfg.grid.voxel_world_size, cfg.grid
        diffuse = M.cone_steps(cc.diffuse_tan_half_angle, voxel,
                               cc.max_distance, cc.max_steps)
        cones = [diffuse] * cc.num_diffuse_cones
        if cc.trace_specular:
            cones.append(M.cone_steps(cc.specular_tan_half_angle, voxel,
                                      cc.max_distance, cc.max_steps))
        return M.march_work(
            cfg.render.width * cfg.render.height, cones,
            A.pyramid_shapes(g.dim, RADIANCE_CHANNELS, g.num_levels),
            active)
