"""Material textures: the per-material atlas, bilinear REPEAT sampling and
bump normals (port of vct_tpu/scene/textures.py:36-174, 250-262).

The atlas pages are built on the host in numpy, with the JAX package's
code (bilinear resize, mask folded into albedo alpha), and then move to
the device.  `sample_atlas` is a plain gather, as in the JAX package: the
frame path reads textures through the material kernel (ops/material.py);
this gather serves the voxel build's per-sample albedo, the alpha
re-cast's alpha test and the per-cone oracle renderer (`bump_normal`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vctbench.inputs.scene import Material

Tensor = torch.Tensor


def _resize_bilinear_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host-side bilinear resize (H, W, C) -> (h, w, C); align-corners=False
    (GL texel-center convention)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.astype(np.float32)
    ys = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx) + img[y0][:, x1] * (1 - fy) * fx
    b = img[y1][:, x0] * fy * (1 - fx) + img[y1][:, x1] * fy * fx
    return (a + b).astype(np.float32)


def _page(tex: Optional[np.ndarray], const: Sequence[float], res: int,
          channels: int) -> np.ndarray:
    """One material's atlas page: resampled texture or constant fill."""
    if tex is None:
        page = np.empty((res, res, channels), np.float32)
        page[:] = np.asarray(const, np.float32)[:channels]
        return page
    t = np.asarray(tex, np.float32)
    if t.ndim == 2:
        t = t[..., None]
    if t.shape[-1] < channels:       # e.g. RGB diffuse -> RGBA alpha=1
        pad = np.ones(t.shape[:-1] + (channels - t.shape[-1],), np.float32)
        t = np.concatenate([t, pad], axis=-1)
    return _resize_bilinear_np(t[..., :channels], (res, res))


@dataclasses.dataclass
class TextureAtlas:
    """Per-material texture pages on the device: albedo (M, R, R, 4) rgba,
    specular (M, R, R, 3), height (M, R, R, 1)."""

    albedo: Tensor
    specular: Tensor
    height: Tensor

    @property
    def resolution(self) -> int:
        return self.albedo.shape[1]

    @staticmethod
    def from_materials(materials: List[Material], resolution: int = 256,
                       device="cuda") -> "TextureAtlas":
        alb, spec, hgt = [], [], []
        for m in materials:
            a = _page(m.albedo_texture, m.albedo, resolution, 4)
            if m.mask_texture is not None:
                # MaskTexture folds into diffuse alpha: the discard test
                # reads matColor.a (VoxelConeTracing.fs:169-172)
                a[..., 3] = _page(m.mask_texture, (1.0,), resolution, 1)[..., 0]
            elif m.albedo_texture is not None and \
                    np.asarray(m.albedo_texture).shape[-1] < 4:
                a[..., 3] = m.albedo[3]
            alb.append(a)
            spec.append(_page(m.specular_texture, m.specular, resolution, 3))
            hgt.append(_page(m.height_texture, (0.0,), resolution, 1))

        def put(pages):
            return torch.as_tensor(np.stack(pages), device=device)

        return TextureAtlas(albedo=put(alb), specular=put(spec),
                            height=put(hgt))


def has_textures(materials: List[Material]) -> bool:
    return any(
        m.albedo_texture is not None or m.specular_texture is not None
        or m.height_texture is not None or m.mask_texture is not None
        for m in materials)


def sample_atlas(atlas_pages: Tensor, material_id: Tensor, uv: Tensor
                 ) -> Tensor:
    """Bilinear REPEAT-wrapped fetch: pages (M,R,R,C), material_id (...,),
    uv (...,2) -> (...,C).  GL convention: texel centers at (i+0.5)/R,
    v=0 at the bottom row (images are stored top-down, so v flips)."""
    m, rh, rw, c = atlas_pages.shape
    u = uv[..., 0] * rw - 0.5
    v = (1.0 - uv[..., 1]) * rh - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = u0.to(torch.int32).long()
    v0 = v0.to(torch.int32).long()
    u1 = torch.remainder(u0 + 1, rw)
    v1 = torch.remainder(v0 + 1, rh)
    u0 = torch.remainder(u0, rw)
    v0 = torch.remainder(v0, rh)

    flat = atlas_pages.reshape(-1, c)
    base = material_id.long() * (rh * rw)

    def fetch(vy, ux):
        return flat[base + vy * rw + ux]

    top = fetch(v0, u0) * (1 - fu) + fetch(v0, u1) * fu
    bot = fetch(v1, u0) * (1 - fu) + fetch(v1, u1) * fu
    return top * (1 - fv) + bot * fv


def _norm3(v: Tensor) -> Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True), 1e-12)


def bump_normal(atlas: TextureAtlas, material_id: Tensor, uv: Tensor,
                tangent: Tensor, bitangent: Tensor, normal: Tensor) -> Tensor:
    """CalcBumpNormal (VoxelConeTracing.fs:108-126) on the atlas: three
    bilinear taps of the height page, one texel apart in u and in v."""
    off = 1.0 / atlas.resolution
    h0 = sample_atlas(atlas.height, material_id, uv)[..., 0]
    du = torch.stack([torch.full_like(uv[..., 0], off),
                      torch.zeros_like(uv[..., 0])], dim=-1)
    hx = sample_atlas(atlas.height, material_id, uv + du)[..., 0]
    hy = sample_atlas(atlas.height, material_id, uv + du.flip(-1))[..., 0]
    return bump_normal_from_heights(h0, hx, hy, tangent, bitangent, normal)


def bump_normal_from_heights(h0: Tensor, hx: Tensor, hy: Tensor,
                             tangent: Tensor, bitangent: Tensor,
                             normal: Tensor) -> Tensor:
    """CalcBumpNormal (VoxelConeTracing.fs:108-126) from the three height
    taps: t1 = normalize(1, 0, dx), t2 = normalize(0, 1, dy), the normal
    normalize(cross(t1, t2)) rotated into world space by the TBN frame."""
    dx = hx - h0
    dy = hy - h0
    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    t1 = _norm3(torch.stack([one, zero, dx], dim=-1))
    t2 = _norm3(torch.stack([zero, one, dy], dim=-1))
    bn = _norm3(torch.linalg.cross(t1, t2, dim=-1))
    world = (tangent * bn[..., 0:1] + bitangent * bn[..., 1:2]
             + normal * bn[..., 2:3])
    return _norm3(world)
