"""Primary visibility for the per-cone oracle renderer, and the scene's
geometry on the device (port of vct_tpu/render/gbuffer.py).

Rays intersect the triangle soup and the hit's barycentrics interpolate
the attributes the reference's vertex shader hands the fragment stage
(VoxelConeTracing.vs:25-36).  Two paths, both plain PyTorch on every
device: they are the oracle the fast path's kernels are checked against,
so they do not run through those kernels.
  * `raycast`, Möller–Trumbore over all triangles for rays of any
    origins, in chunks of rays;
  * the pinhole path for camera rays (one shared origin): with the
    origin fixed, det, u*det and v*det are linear in the ray direction,
    so the test is three (N, 3) x (3, T) float32 matmuls, a sign-folded
    mask and an argmin.

Triangles are stored in the JAX package's Morton order: the winner is
the first minimum by triangle index (torch.argmin, as jnp.argmin), so
another order would change tie-breaks and material ids.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from vctbench.inputs.scene import Scene

Tensor = torch.Tensor


@dataclasses.dataclass
class GBuffer:
    """Per-pixel surface attributes; invalid where ~hit."""

    hit: Tensor            # (...,) bool
    t: Tensor              # (...,) ray parameter
    position: Tensor       # (..., 3) world
    normal: Tensor         # (..., 3) shading normal (vertex-interpolated)
    geo_normal: Tensor     # (..., 3) face normal
    tangent: Tensor        # (..., 3)
    bitangent: Tensor      # (..., 3)
    uv: Tensor             # (..., 2)
    material: Tensor       # (...,) int32
    tri: Tensor            # (...,) int32


def map_gbuffer(fn: Callable, *gbufs: GBuffer) -> GBuffer:
    """GBuffer of fn applied field by field (jax.tree_util.tree_map)."""
    return GBuffer(**{f.name: fn(*(getattr(g, f.name) for g in gbufs))
                      for f in dataclasses.fields(GBuffer)})


@dataclasses.dataclass
class DeviceScene:
    """Scene geometry as device tensors (the renderer's working set)."""

    v0: Tensor            # (T, 3)
    e1: Tensor            # (T, 3)
    e2: Tensor            # (T, 3)
    vn: Tensor            # (T, 3, 3) per-corner normals
    vt: Tensor            # (T, 3, 3) tangents
    vb: Tensor            # (T, 3, 3) bitangents
    vuv: Tensor           # (T, 3, 2)
    face_normal: Tensor   # (T, 3)
    material: Tensor      # (T,) int32

    @staticmethod
    def from_scene(scene: Scene, device="cuda", dtype=torch.float32
                   ) -> "DeviceScene":
        tv = scene.triangle_vertices()
        idx = scene.indices
        order = _morton_order(tv.mean(axis=1))

        def put(x, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=device)

        tvo = tv[order]
        return DeviceScene(
            v0=put(tvo[:, 0]),
            e1=put(tvo[:, 1] - tvo[:, 0]),
            e2=put(tvo[:, 2] - tvo[:, 0]),
            vn=put(scene.normals[idx][order]),
            vt=put(scene.tangents[idx][order]),
            vb=put(scene.bitangents[idx][order]),
            vuv=put(scene.uvs[idx][order]),
            face_normal=put(scene.face_normals()[order]),
            material=put(scene.tri_material[order], torch.int32),
        )


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Stable argsort of 30-bit 3D Morton codes of the centroids."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip((c - lo) / ext * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))
    return np.argsort(code, kind="stable")


def _pick(x: Tensor, tri: Tensor) -> Tensor:
    """x[rows, tri] of an (N, T) array."""
    return x.gather(1, tri[:, None])[:, 0]


def _intersect_chunk(origins: Tensor, dirs: Tensor, ds: DeviceScene,
                     eps: float = 1e-7
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Möller–Trumbore, all rays (N, 3) x all triangles.  Returns
    (t, u, v, tri) of the closest hit, t = inf for a miss."""
    pvec = torch.linalg.cross(dirs[:, None, :], ds.e2[None], dim=-1)
    det = torch.sum(pvec * ds.e1[None], dim=-1)                  # (N, T)
    inv_det = torch.where(det.abs() > eps, 1.0 / det, 0.0)
    tvec = origins[:, None, :] - ds.v0[None]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, ds.e1[None], dim=-1)
    v = torch.sum(dirs[:, None, :] * qvec, dim=-1) * inv_det
    t = torch.sum(ds.e2[None] * qvec, dim=-1) * inv_det
    valid = ((det.abs() > eps) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > 1e-4))
    t = torch.where(valid, t, torch.inf)
    tri = torch.argmin(t, dim=-1)
    return _pick(t, tri), _pick(u, tri), _pick(v, tri), tri


def raycast(ds: DeviceScene, origins, dirs, chunk_size: int = 4096,
            device="cuda") -> GBuffer:
    """Closest-hit G-buffer for rays of any batch shape (..., 3).  The
    rays (tensors or host arrays) are put on `device`, where `ds` must
    lie; chunks of `chunk_size` rays bound the (N, T) intermediates."""
    origins = torch.as_tensor(origins, dtype=torch.float32, device=device)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=device)
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    parts = [_intersect_chunk(o[s:s + chunk_size], d[s:s + chunk_size], ds)
             for s in range(0, n, chunk_size)]
    t, u, v, tri = (torch.cat(x) for x in zip(*parts))
    g = _interp_gbuffer(ds, o, d, t, u, v, tri)
    return map_gbuffer(lambda x: x.reshape(shape + x.shape[1:]), g)


def _interp_gbuffer(ds: DeviceScene, o: Tensor, d: Tensor, t: Tensor,
                    u: Tensor, v: Tensor, tri: Tensor) -> GBuffer:
    hit = torch.isfinite(t)
    ts = torch.where(hit, t, 0.0)
    w0 = (1.0 - u - v)[:, None]
    uu, vv = u[:, None], v[:, None]

    def interp(attr):   # (T, 3, C) -> (N, C)
        a = attr[tri]
        return w0 * a[:, 0] + uu * a[:, 1] + vv * a[:, 2]

    normal = interp(ds.vn)
    normal = normal / torch.clamp_min(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), 1e-12)
    return GBuffer(hit=hit, t=ts, position=o + ts[:, None] * d,
                   normal=normal, geo_normal=ds.face_normal[tri],
                   tangent=interp(ds.vt), bitangent=interp(ds.vb),
                   uv=interp(ds.vuv), material=ds.material[tri],
                   tri=tri.to(torch.int32))
