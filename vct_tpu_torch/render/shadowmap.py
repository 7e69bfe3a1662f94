"""Rasterized shadow map and PCF, the reference-parity shadow mode "map"
(port of vct_tpu/render/shadowmap.py:39-147).

No rasterizer: the voxelization's surface samples scatter-min their
light-space depths into the light's ortho grid, each over a 3x3-texel
footprint so that the point sampling closes raster coverage holes (a hole
would read as depth 1.0, lit, and leak light).  Light transform, bias,
CLAMP_TO_EDGE bilinear fetch and the 5x5 PCF with `current - bias <=
closest` follow the reference (Voxel_Cone_Tracing.h:83-95,
Voxelization.vs:18-19, VoxelConeTracing.fs:132-163); the main pass's
25-tap sum is scaled by 0.111 under pcf_normalization="reference" (the
fs:158 quirk) and divided by 25 otherwise, and the voxelize pass always
divides by 25 (Voxelization.fs:46).

Plain PyTorch on every device, as it is XLA in the JAX package: no Pallas
kernel computes the map or the PCF.  Every step rounds each operation on
its own (no matmul, no fused multiply-add), so the card and the CPU give
the same bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import grid as G

Tensor = torch.Tensor


def light_matrix(cfg: VCTConfig) -> np.ndarray:
    """Biased light view-projection: world -> [0,1]^2 uv x [0,1] depth.

    0.5 * (ortho(-e,e,-e,e,n,f) @ lookAt(lightDir, 0, up)) + 0.5, the
    DepthModelViewProjectionMatrix pipeline (Voxel_Cone_Tracing.h:83-85)
    with the [0,1] bias the vertex shaders apply (Voxelization.vs:18-19).
    Computed in float64 and cast to float32 at the end."""
    eye = np.asarray(cfg.light.direction, np.float64)
    up = np.array([0.0, 1.0, 0.0])
    if np.linalg.norm(np.cross(-eye / np.linalg.norm(eye), up)) < 1e-8:
        up = np.array([0.0, 0.0, 1.0])            # light along +y
    view = CAM.look_at(eye, np.zeros(3), up)
    e = cfg.shadow.ortho_extent
    proj = CAM.ortho(-e, e, -e, e, cfg.shadow.ortho_near,
                     cfg.shadow.ortho_far)

    bias = np.eye(4)
    bias[:3, :3] *= 0.5
    bias[:3, 3] = 0.5
    return (bias @ proj @ view).astype(np.float32)


def project(matrix: np.ndarray, p: Tensor) -> Tuple[Tensor, Tensor]:
    """World points (..., 3) -> (uv (..., 2), depth (...)) in light space.

    Each coordinate is x*m0 + y*m1 + z*m2 + m3 with every multiply and add
    rounded on its own, in that order: a matmul may order or fuse the
    three terms differently on each device, and the depth compare flips
    on one ulp."""
    m = np.asarray(matrix, np.float32)
    out = []
    for r in range(3):
        h = p[..., 0] * float(m[r, 0])
        h = h + p[..., 1] * float(m[r, 1])
        h = h + p[..., 2] * float(m[r, 2])
        out.append(h + float(m[r, 3]))
    return torch.stack(out[:2], dim=-1), out[2]


def _index(floored: Tensor, size: int) -> Tensor:
    """A floored float as int64, first clamped to [-2, size + 1]: a
    float-to-integer cast out of range is undefined on CUDA, and the clamp
    keeps every in-range test's answer (i + d for |d| <= 1 stays out of
    [0, size) on both sides)."""
    return torch.clamp(floored, -2.0, size + 1.0).long()


def build_shadow_map(cfg: VCTConfig, positions: Tensor) -> Tensor:
    """Scatter-min surface-sample depths into the (S, S) light grid.

    map[iy, ix] = min depth of the samples landing in that texel's 3x3
    neighborhood; empty texels stay at 1.0 (the far plane).  Taps out of
    the map or off the frustum's depth range write 1.0 at the clipped
    texel, so they never change it.  A min does not depend on the order
    of its operands, so the scatter gives the same bits on every run and
    device, though the card reduces in no fixed order."""
    size = cfg.shadow.map_size
    uv, depth = project(light_matrix(cfg), positions)
    ix = _index(torch.floor(uv[..., 0] * size), size)
    iy = _index(torch.floor(uv[..., 1] * size), size)
    in_depth = (depth >= 0.0) & (depth <= 1.0)
    flat = torch.ones(size * size, dtype=depth.dtype, device=depth.device)
    one = torch.ones((), dtype=depth.dtype, device=depth.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            x, y = ix + dx, iy + dy
            inside = ((x >= 0) & (x < size) & (y >= 0) & (y < size)
                      & in_depth)
            idx = (torch.clamp(y, 0, size - 1) * size
                   + torch.clamp(x, 0, size - 1))
            flat.scatter_reduce_(0, idx.reshape(-1),
                                 torch.where(inside, depth, one).reshape(-1),
                                 "amin", include_self=True)
    return flat.reshape(size, size)


def _bilinear_depth(shadow_map: Tensor, uv: Tensor) -> Tensor:
    """GL_LINEAR + CLAMP_TO_EDGE fetch of the depth texture
    (Voxel_Cone_Tracing.h:92-95); texel centers at (i+0.5)/S."""
    s = shadow_map.shape[0]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = torch.clamp(_index(x0, s), 0, s - 1)
    y0 = torch.clamp(_index(y0, s), 0, s - 1)
    x1 = torch.clamp(x0 + 1, 0, s - 1)
    y1 = torch.clamp(y0 + 1, 0, s - 1)
    flat = shadow_map.reshape(-1)
    d00 = flat[y0 * s + x0]
    d01 = flat[y0 * s + x1]
    d10 = flat[y1 * s + x0]
    d11 = flat[y1 * s + x1]
    return ((d00 * (1 - fx) + d01 * fx) * (1 - fy)
            + (d10 * (1 - fx) + d11 * fx) * fy)


def pcf_shadow(cfg: VCTConfig, shadow_map: Tensor, position: Tensor,
               normalization: str) -> Tensor:
    """5x5 PCF: mean of `current - bias <= closest` over the kernel
    (VoxelConeTracing.fs:141-158).  normalization "main" applies the
    config's pcf_normalization ("reference" = the /9 quirk), "voxelize"
    always divides by the true tap count (Voxelization.fs:46)."""
    uv, current = project(light_matrix(cfg), position)
    size = cfg.shadow.map_size
    r = cfg.shadow.pcf_radius
    offs = G.constant([[dx / size, dy / size]
                       for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
                      position.device, position.dtype)
    lhs = current - cfg.shadow.pcf_bias
    total = torch.zeros(position.shape[:-1], dtype=position.dtype,
                        device=position.device)
    for off in offs:
        closest = _bilinear_depth(shadow_map, uv + off)
        total = total + (lhs <= closest).to(total.dtype)
    if normalization == "main" and cfg.shadow.pcf_normalization == "reference":
        return total * 0.111                       # fs:158 quirk (25 taps / 9)
    return total / G.scalar_like(total, (2 * r + 1) ** 2)
