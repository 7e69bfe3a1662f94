"""Scene geometry on the device (port of vct_tpu/render/gbuffer.py:54-112).

Triangles are stored in the JAX package's Morton order: the raycast's
winner is the first minimum by triangle index, so another order would
change tie-breaks and material ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vct_tpu_torch.scene.mesh import Scene

Tensor = torch.Tensor


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
