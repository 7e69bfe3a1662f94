"""Config tree for the VCT framework.

The reference hard-codes every operating constant (SURVEY.md §5 "Config"):
voxel dim / grid world size (Voxel_Cone_Tracing.h:16-17), shadow map size
(:35), light direction (:14), ambient factor (:53), cone constants
(Shader/VoxelConeTracing.fs:43-57), PCF radius/bias (:136,186), shininess
(Mesh.h:86), window size (main.cpp:10-11).  Here each becomes a config field
whose default equals the reference value.

A copy of the port's config.py (its presets left out: a configuration
file of the benchmark holds the whole tree it runs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Voxel grid geometry. Ref: Voxel_Cone_Tracing.h:16-17."""

    dim: int = 128                 # voxels per side (power of two)
    world_size: float = 150.0      # world-space extent of the cube
    levels: Optional[int] = None   # mip levels; None = full chain (log2(dim)+1)
    anisotropic: bool = False      # 6-direction mips (ref's acknowledged-missing feature)
    dtype: str = "float32"
    # dense-march contraction dtype: "bfloat16" runs the resample matmuls
    # at bf16 MXU throughput with f32 accumulation (core/dense.py); the
    # reference samples RGBA8 textures, so bf16 (8-bit mantissa) still
    # carries more precision than the reference's own voxel storage.
    compute: str = "float32"       # "float32" | "bfloat16"

    @property
    def num_levels(self) -> int:
        full = int(np.log2(self.dim)) + 1
        return full if self.levels is None else min(self.levels, full)

    @property
    def voxel_world_size(self) -> float:
        # Ref: VoxelConeTracing.fs:89 — VoxelGridWorldSize / VoxelDimensions
        return self.world_size / self.dim


@dataclasses.dataclass(frozen=True)
class ConeSetConfig:
    """Cone-march constants. Ref: Shader/VoxelConeTracing.fs:43-57,198,218."""

    max_distance: float = 75.0       # fs:43 (== world_size/2 at defaults)
    max_alpha: float = 0.95          # fs:44
    diffuse_tan_half_angle: float = 0.577   # fs:198 — tan(60deg/2)
    specular_tan_half_angle: float = 0.07   # fs:218 (live value; comment says 0.105)
    occlusion_falloff: float = 0.03  # fs:101 — 1/(1 + k*diameter) AO attenuation
    num_diffuse_cones: int = 6       # fs:46
    trace_specular: bool = True
    max_steps: Optional[int] = None  # cap on march steps; None = schedule-derived
    # Cone evaluation strategy (SURVEY.md §7.1):
    #  "percone": march per pixel — the reference's exact fragment-shader
    #    semantics (gather-heavy; the parity oracle).
    #  "field": direction-major dense marches (core/dense.py) precompute
    #    cone-gather fields over a world-direction basis; per pixel the
    #    cones interpolate the fields at one position — exact at voxel
    #    centers, trilinear+spherical interpolation elsewhere; the
    #    TPU-native fast path (no arbitrary gathers in the march).
    diffuse_mode: str = "percone"    # "percone" | "field"
    specular_mode: str = "percone"   # "percone" | "field"
    field_basis: int = 26            # direction-basis size for field mode
    # Field resolution; None = min(grid, 128).  Measured fidelity at the
    # sponza256 operating point vs the exact per-pixel cone march
    # (scripts/fidelity_field.py -> FIDELITY_r03.json, 2048-pixel subset):
    # diffuse rel-RMS 0.44 @128^3 vs 0.22 @256^3 (resolution-dominated;
    # 256^3 costs 8x build time and ~7 GB of fields), specular rel-RMS
    # 0.63 at BOTH (narrow mirror cones are basis-limited at 26 dirs —
    # resolution does not help).  128 is therefore the perf default;
    # set field_dim=grid.dim or the percone modes (the exact oracle
    # path) when GI fidelity matters more than frame rate.
    field_dim: Optional[int] = None
    basis_power_diffuse: float = 8.0     # spherical interp sharpness
    basis_power_specular: float = 32.0
    # Step-density factor for the SPECULAR basis-field build only (the
    # r4 build split measured it at 421 ms of the 1.3 s build: 26 dirs x
    # the long tan-0.07 schedule).  2.0 marches every other distance with
    # the optical-depth-corrected composite (core/march.composite
    # semantics) — a second-order change to a field whose mirror-cone
    # error is already basis-limited (rel-RMS 0.63).  The exact percone
    # path (specular_mode="percone") never uses this.
    field_specular_step_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class LightConfig:
    """Directional light. Ref: Voxel_Cone_Tracing.h:14,53."""

    direction: Tuple[float, float, float] = (0.0, 1.0, 0.25)
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient_factor: float = 0.1      # Voxel_Cone_Tracing.h:53
    # GI path depth.  2 = reference behavior (direct-lit voxels + one
    # cone-gathered camera bounce, README.md:14).  Each extra bounce
    # re-gathers indirect diffuse at the surface samples through the
    # current radiance pyramid and re-injects ("can increase to more
    # bounce", README.md:14 — unimplemented there).
    gi_bounces: int = 2


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Shadow computation.

    mode="volume": dense directional march (core/dense.py) computes the
      light-transmittance volume once per scene+light; every shadow query is
      one trilinear tap.  Exact cone-shadow values at voxel centers; the
      TPU-native replacement for the 4096^2 depth map (and the default).
    mode="percone": an explicit shadow cone marched from every query point —
      identical math, per-query cost (the oracle for "volume").
    mode="map": rasterized depth from the light + PCF, matching the
      reference (Voxel_Cone_Tracing.h:81-105, VoxelConeTracing.fs:132-163).
    """

    mode: str = "volume"             # "volume" | "percone" | "map"
    # cone mode
    tan_half_angle: float = 0.03     # narrow cone toward the light
    normal_offset: float = 2.0       # start offset in voxel widths
    step_factor: float = 0.5         # denser steps so thin occluders don't leak
    # Saturating per-sample opacity gain.  Trilinear filtering turns a
    # 1-voxel occluder into a tent of peak weight <=1, so raw transmittance
    # through a thin wall stays ~0.5 (phase-dependent striping).  min(1, g*a)
    # hardens the core shadow; penumbra comes from the cone aperture.
    opacity_gain: float = 4.0
    # Shadow cones must traverse the WHOLE grid (a directional light's
    # occluder can be anywhere), unlike gather cones' MAX_DISTANCE=75.
    # None -> grid diagonal (sqrt(3) * world_size).
    max_distance: Optional[float] = None
    # map mode (reference parity)
    map_size: int = 4096             # Voxel_Cone_Tracing.h:35
    ortho_extent: float = 120.0      # ortho(-120,120,...), V_C_T.h:84
    ortho_near: float = -100.0
    ortho_far: float = 100.0
    pcf_radius: int = 2              # 5x5 kernel, fs:136
    pcf_bias: float = 0.002          # fs:186
    # The ref's main pass divides the 25-tap PCF sum by 9 ("shadow *= 0.111f",
    # fs:158) which brightens shadows 2.78x; its voxelize pass divides by 25
    # (Voxelization.fs:46). "reference" reproduces both; "correct" uses /25.
    pcf_normalization: str = "correct"   # "correct" | "reference"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Camera/framebuffer. Ref: main.cpp:10-11, Voxel_Cone_Tracing.h:161-163."""

    width: int = 1280
    height: int = 720
    fov_degrees: float = 45.0        # Camera.h ZOOM default
    z_near: float = 0.1              # Voxel_Cone_Tracing.h:163
    z_far: float = 1000.0
    shininess: float = 20.0          # Mesh.h:86
    opacity: float = 1.0             # Mesh.h:87
    alpha_threshold: float = 0.5     # fs:171 alpha-mask discard
    # Alpha-mask SEE-THROUGH (fs:169-172 `discard`): a discarded fragment
    # exposes the depth-tested geometry BEHIND it, so the raycaster must
    # continue past masked hits.  alpha_mask_depth = bounded re-cast
    # iterations (0 disables; masked pixels then show the background —
    # the pre-r5 behavior).  Applies only when materials carry textures
    # (the reference reads alpha from DiffuseTexture, fs:167).
    alpha_mask_depth: int = 2
    # fast path: masked pixels re-cast through the streamed kernel in a
    # gathered subset of at most this many rays per iteration; overflow
    # pixels keep the background fallback (conservative, budget-bounded)
    alpha_mask_budget: int = 65536
    # display toggles (ref fields Voxel_Cone_Tracing.h:51-52, never wired there)
    show_diffuse: bool = True
    show_indirect_diffuse: bool = True
    show_specular: bool = True
    show_indirect_specular: bool = True
    # clear color: gray when AmbientFactor < 0.5 else white (V_C_T.h:153-159)
    background: Tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class VoxelizeConfig:
    """Deterministic scatter voxelization (replaces Voxelization.{vs,gs,fs})."""

    samples_per_voxel_width: float = 2.0   # surface sample density
    mode: str = "mean"               # "mean" (deterministic) | "max"


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Multi-device layout (SURVEY.md §2.4).

    data_parallel: image tiles / surface samples over the 'data' mesh axis.
    brick_parallel: >1 shards the voxel pyramid's fine mip levels (and the
      dense marches' field outputs) along x over the 'model' axis, with
      static halo exchange per march step group (parallel/brick.py — halo
      widths are derived from the march schedule, not configured).
    Consumed by parallel.mesh.make_mesh_for(cfg) and renderer.
    build_voxel_state(..., mesh=...).
    """

    data_axis: str = "data"          # image-tile data parallelism
    model_axis: str = "model"        # voxel-brick spatial parallelism
    data_parallel: int = 1
    brick_parallel: int = 1          # >1 shards fine mip levels along x


@dataclasses.dataclass(frozen=True)
class VCTConfig:
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    cones: ConeSetConfig = dataclasses.field(default_factory=ConeSetConfig)
    light: LightConfig = dataclasses.field(default_factory=LightConfig)
    shadow: ShadowConfig = dataclasses.field(default_factory=ShadowConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    voxelize: VoxelizeConfig = dataclasses.field(default_factory=VoxelizeConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
    use_pallas: bool = True          # Pallas kernels on TPU; pure-XLA otherwise

    def replace(self, **kw) -> "VCTConfig":
        return dataclasses.replace(self, **kw)

