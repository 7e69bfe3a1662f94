"""Scene/mesh representation: struct-of-arrays triangle soup + materials.

Replaces the reference's Mesh/Model/Vertex classes (Mesh.h:12-28,
Model.h:75-139) with host-side numpy arrays: positions, normals, uvs,
tangents, bitangents, triangle indices, per-triangle material ids, and a
material table.  No GL buffers — device arrays are created by the renderer.

Tangent generation follows the standard per-triangle UV-derivative method
(what Assimp's CalcTangentSpace provides to the reference, Model.h:43).

A copy of vct_tpu/scene/mesh.py: the port keeps its own host modules and
imports nothing of the JAX package; tests/test_torch_scene.py pins the
scenes built from it equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Material:
    """Reference material inputs (VoxelConeTracing.fs:12-20, Mesh.h:86-111).

    Textures are numpy float arrays in [0,1] or None; constant fallbacks are
    used when a texture slot is empty (matching an unbound GL sampler reading
    as the constant color here, rather than undefined).
    """

    name: str = "default"
    albedo: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 20.0                   # Mesh.h:86
    albedo_texture: Optional[np.ndarray] = None    # (H, W, 4)
    specular_texture: Optional[np.ndarray] = None  # (H, W, 3)
    height_texture: Optional[np.ndarray] = None    # (H, W) bump source
    mask_texture: Optional[np.ndarray] = None      # (H, W) alpha mask


@dataclasses.dataclass
class Scene:
    """Triangle soup + materials, all host-side numpy (f32/i32)."""

    positions: np.ndarray       # (V, 3)
    normals: np.ndarray         # (V, 3)
    uvs: np.ndarray             # (V, 2)
    tangents: np.ndarray        # (V, 3)
    bitangents: np.ndarray      # (V, 3)
    indices: np.ndarray         # (T, 3) int32
    tri_material: np.ndarray    # (T,) int32
    materials: List[Material]

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    def triangle_vertices(self) -> np.ndarray:
        """(T, 3, 3) world-space triangle corners."""
        return self.positions[self.indices]

    def triangle_areas(self) -> np.ndarray:
        tv = self.triangle_vertices()
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def face_normals(self) -> np.ndarray:
        """Geometric normals from the edge cross product, normalized.
        Matches the voxelization GS (Voxelization.gs:24-27) up to edge
        labeling: n = normalize(cross(v1-v0, v2-v0))."""
        tv = self.triangle_vertices()
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        l = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(l, 1e-20)

    def transformed(self, scale: float = 1.0,
                    translate: Tuple[float, float, float] = (0, 0, 0)) -> "Scene":
        """Uniform scale + translate (the ref applies scale 0.05 to Sponza,
        Voxel_Cone_Tracing.h:183)."""
        return dataclasses.replace(
            self,
            positions=self.positions * scale + np.asarray(translate, np.float32))


def compute_tangents(positions: np.ndarray, normals: np.ndarray,
                     uvs: np.ndarray, indices: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent/bitangent from UV derivatives, area-accumulated
    then Gram-Schmidt orthogonalized against the normal."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    bit = np.zeros((v, 3), np.float64)
    p = positions[indices]          # (T, 3, 3)
    t = uvs[indices]                # (T, 3, 2)
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    d1, d2 = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tdir = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    bdir = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]
    for corner in range(3):
        np.add.at(tan, indices[:, corner], tdir)
        np.add.at(bit, indices[:, corner], bdir)
    # orthogonalize; fall back to an arbitrary frame for degenerate UVs
    n = normals.astype(np.float64)
    tan = tan - n * np.sum(tan * n, axis=-1, keepdims=True)
    bad = np.linalg.norm(tan, axis=-1) < 1e-8
    if bad.any():
        alt = np.cross(n[bad], np.where(
            np.abs(n[bad, 1:2]) < 0.9, [[0, 1, 0]], [[1, 0, 0]]))
        tan[bad] = alt
    tan /= np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)
    bit_sign = np.sign(np.sum(np.cross(n, tan) * bit, axis=-1))
    bit_sign = np.where(bit_sign == 0, 1.0, bit_sign)
    bit = np.cross(n, tan) * bit_sign[:, None]
    return tan.astype(np.float32), bit.astype(np.float32)


def scene_from_arrays(positions, indices, normals=None, uvs=None,
                      tri_material=None, materials=None) -> Scene:
    """Build a Scene, deriving missing attributes (smooth normals from area-
    weighted face normals — Assimp GenSmoothNormals analogue, Model.h:43)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    t = indices.shape[0]
    if normals is None:
        normals = np.zeros_like(positions)
        tv = positions[indices]
        fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])  # area-weighted
        for corner in range(3):
            np.add.at(normals, indices[:, corner], fn)
        normals /= np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    else:
        normals = np.asarray(normals, np.float32)
    if uvs is None:
        uvs = np.zeros((positions.shape[0], 2), np.float32)
    else:
        uvs = np.asarray(uvs, np.float32)
    tangents, bitangents = compute_tangents(positions, normals, uvs, indices)
    if tri_material is None:
        tri_material = np.zeros((t,), np.int32)
    if materials is None:
        materials = [Material()]
    return Scene(
        positions=positions, normals=normals, uvs=uvs, tangents=tangents,
        bitangents=bitangents, indices=indices,
        tri_material=np.asarray(tri_material, np.int32), materials=materials)


def merge_scenes(scenes: List[Scene]) -> Scene:
    """Concatenate scenes, remapping material ids."""
    offs_v = 0
    offs_m = 0
    pos, nrm, uv, tan, bit, idx, mat = [], [], [], [], [], [], []
    materials: List[Material] = []
    for s in scenes:
        pos.append(s.positions)
        nrm.append(s.normals)
        uv.append(s.uvs)
        tan.append(s.tangents)
        bit.append(s.bitangents)
        idx.append(s.indices + offs_v)
        mat.append(s.tri_material + offs_m)
        materials.extend(s.materials)
        offs_v += s.num_vertices
        offs_m += len(s.materials)
    return Scene(
        positions=np.concatenate(pos), normals=np.concatenate(nrm),
        uvs=np.concatenate(uv), tangents=np.concatenate(tan),
        bitangents=np.concatenate(bit), indices=np.concatenate(idx),
        tri_material=np.concatenate(mat), materials=materials)


def subdivide_scene(scene: Scene, levels: int = 1) -> Scene:
    """4-way midpoint subdivision, `levels` times: every triangle splits
    into 4 via edge midpoints with linearly-interpolated attributes.  The
    SURFACES ARE IDENTICAL — renders must match the input scene — so this
    is both a triangle-count stress generator (Sponza-scale primary
    visibility, Model.h:43: 1 level = 4x triangles) and a parity fixture
    for the streamed raycast's culling.  Midpoint vertices are duplicated
    per triangle (no welding — the renderer consumes triangle soup)."""
    for _ in range(levels):
        idx = scene.indices
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]

        def mid(x, renorm=False):
            va, vb, vc = x[a], x[b], x[c]
            mab = 0.5 * (va + vb)
            mbc = 0.5 * (vb + vc)
            mca = 0.5 * (vc + va)
            out = np.concatenate([va, vb, vc, mab, mbc, mca])
            if renorm:
                n = np.linalg.norm(out, axis=-1, keepdims=True)
                out = out / np.maximum(n, 1e-12)
            return np.ascontiguousarray(out, np.float32)

        t = idx.shape[0]
        # new vertex layout: [A | B | C | AB | BC | CA], each length t
        va, vb, vc = 0, t, 2 * t
        ab, bc, ca = 3 * t, 4 * t, 5 * t
        r = np.arange(t, dtype=np.int32)
        new_idx = np.concatenate([
            np.stack([va + r, ab + r, ca + r], axis=1),
            np.stack([ab + r, vb + r, bc + r], axis=1),
            np.stack([ca + r, bc + r, vc + r], axis=1),
            np.stack([ab + r, bc + r, ca + r], axis=1),
        ]).astype(np.int32)
        scene = Scene(
            positions=mid(scene.positions),
            normals=mid(scene.normals, renorm=True),
            uvs=mid(scene.uvs),
            tangents=mid(scene.tangents, renorm=True),
            bitangents=mid(scene.bitangents, renorm=True),
            indices=new_idx,
            tri_material=np.tile(scene.tri_material, 4).astype(np.int32),
            materials=scene.materials,
        )
    return scene
