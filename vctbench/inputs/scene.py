"""The benchmark's scene, frozen: the procedural Sponza-class atrium
(1,122 triangles, 8 materials, textures with an alpha-masked banner
fabric) and its 4-way midpoint subdivision, in numpy.

A copy of the port's scene/atrium.py and of the parts of scene/mesh.py
that build it, so that an edit to the program's scene modules cannot
move the workload.  Both the program (through its own Scene and
Material types) and the reference (vctbench/reference) are handed these
arrays.  vctbench/tests/test_vctbench_inputs.py holds them equal, bit for
bit, to today's vct_tpu_torch.scene.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

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

    def triangle_vertices(self) -> np.ndarray:
        """(T, 3, 3) world-space triangle corners."""
        return self.positions[self.indices]

    def face_normals(self) -> np.ndarray:
        """Geometric normals from the edge cross product, normalized.
        Matches the voxelization GS (Voxelization.gs:24-27) up to edge
        labeling: n = normalize(cross(v1-v0, v2-v0))."""
        tv = self.triangle_vertices()
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        l = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(l, 1e-20)


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


# material ids
FLOOR, WALL, COLUMN, TRIM, BANNER_R, BANNER_G, BANNER_B, CRATE = range(8)


def _checker(n=128, tiles=8):
    ij = np.add.outer(np.arange(n) * tiles // n, np.arange(n) * tiles // n)
    c = (ij % 2).astype(np.float32)
    albedo = np.empty((n, n, 4), np.float32)
    albedo[..., 0] = 0.45 + 0.35 * c
    albedo[..., 1] = 0.42 + 0.33 * c
    albedo[..., 2] = 0.38 + 0.30 * c
    albedo[..., 3] = 1.0
    height = 0.5 + 0.25 * c
    return albedo, height.astype(np.float32)


def _brick(n=128, rows=8, cols=4):
    y = np.arange(n)[:, None] * rows / n
    x = np.arange(n)[None, :] * cols / n
    row = np.floor(y)
    xs = x + 0.5 * (row % 2)
    mortar = ((y - row < 0.12) | ((xs - np.floor(xs)) < 0.06))
    albedo = np.empty((n, n, 4), np.float32)
    base = np.where(mortar, 0.75, 0.55)
    tint = 0.08 * np.sin(7.0 * np.floor(xs) + 13.0 * row)
    albedo[..., 0] = np.where(mortar, base, 0.58 + tint)
    albedo[..., 1] = np.where(mortar, base, 0.35 + 0.5 * tint)
    albedo[..., 2] = np.where(mortar, base, 0.28 + 0.3 * tint)
    albedo[..., 3] = 1.0
    return albedo.astype(np.float32)


def _fabric(n=96, color=(0.7, 0.1, 0.1)):
    y = np.arange(n)[:, None] / n
    x = np.arange(n)[None, :] / n
    weave = 0.85 + 0.15 * np.sin(40.0 * x) * np.sin(40.0 * y)
    albedo = np.empty((n, n, 4), np.float32)
    for c in range(3):
        albedo[..., c] = color[c] * weave
    albedo[..., 3] = 1.0
    # scalloped lower edge -> alpha mask (the README "Alpha Textures" path)
    mask = (y < 0.85 + 0.1 * np.abs(np.sin(12.0 * x))).astype(np.float32)
    return albedo.astype(np.float32), np.broadcast_to(
        mask, (n, n)).astype(np.float32)


class _Builder:
    def __init__(self):
        self.v: List[Tuple[float, float, float]] = []
        self.uv: List[Tuple[float, float]] = []
        self.tris: List[Tuple[int, int, int]] = []
        self.mats: List[int] = []

    def quad(self, corners, mat, uv_scale=1.0, uvs=None):
        """corners counter-clockwise seen from the normal side."""
        base = len(self.v)
        self.v.extend(corners)
        if uvs is None:
            c = np.asarray(corners)
            e1 = c[1] - c[0]
            e2 = c[3] - c[0]
            l1 = float(np.linalg.norm(e1)) * uv_scale
            l2 = float(np.linalg.norm(e2)) * uv_scale
            uvs = [(0.0, 0.0), (l1, 0.0), (l1, l2), (0.0, l2)]
        self.uv.extend(uvs)
        for t in ((base, base + 1, base + 2), (base, base + 2, base + 3)):
            self.tris.append(t)
            self.mats.append(mat)

    def box(self, center, dims, mat, uv_scale=1.0, top=True, bottom=True):
        cx, cy, cz = center
        dx, dy, dz = dims[0] / 2, dims[1] / 2, dims[2] / 2
        x0, x1, y0, y1, z0, z1 = cx - dx, cx + dx, cy - dy, cy + dy, cz - dz, cz + dz
        self.quad([(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],
                  mat, uv_scale)                                        # +z
        self.quad([(x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)],
                  mat, uv_scale)                                        # -z
        self.quad([(x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)],
                  mat, uv_scale)                                        # +x
        self.quad([(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
                  mat, uv_scale)                                        # -x
        if top:
            self.quad([(x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)],
                      mat, uv_scale)                                    # +y
        if bottom:
            self.quad([(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
                      mat, uv_scale)                                    # -y

    def column(self, x, z, y0, y1, radius, mat, sides=8):
        """Octagonal prism column with a simple capital slab."""
        ang = [(2.0 * math.pi * k / sides) for k in range(sides)]
        ring = [(x + radius * math.cos(a), z + radius * math.sin(a))
                for a in ang]
        for k in range(sides):
            ax, az = ring[k]
            bx, bz = ring[(k + 1) % sides]
            u0 = k / sides * 4.0
            u1 = (k + 1) / sides * 4.0
            self.quad([(bx, y0, bz), (ax, y0, az), (ax, y1, az),
                       (bx, y1, bz)], mat,
                      uvs=[(u0, 0.0), (u1, 0.0), (u1, 2.0), (u0, 2.0)])
        cap = radius * 1.4
        self.box((x, y1 + radius * 0.35, z),
                 (2 * cap, radius * 0.7, 2 * cap), mat, uv_scale=0.2)


def atrium(length: float = 120.0, width: float = 60.0,
           height: float = 50.0) -> Scene:
    """The Sponza-stand-in: colonnaded two-story hall, open light well.

    Interior x in [-L/2, L/2], floor y=-H/2, z in [-W/2, W/2]; sized to sit
    inside the default 150-unit voxel grid like scaled Sponza does.
    """
    b = _Builder()
    hl, hw, hh = length / 2, width / 2, height / 2
    floor_y = -hh
    story = height * 0.42            # first-story column top
    gallery_t = 1.5                  # gallery slab thickness

    # floor (checker, uv tiles ~ every 10 units)
    b.quad([(-hl, floor_y, -hw), (-hl, floor_y, hw), (hl, floor_y, hw),
            (hl, floor_y, -hw)], FLOOR, uv_scale=0.1)
    # long walls (brick), normals inward
    b.quad([(-hl, floor_y, -hw), (hl, floor_y, -hw), (hl, hh, -hw),
            (-hl, hh, -hw)], WALL, uv_scale=0.08)
    b.quad([(hl, floor_y, hw), (-hl, floor_y, hw), (-hl, hh, hw),
            (hl, hh, hw)], WALL, uv_scale=0.08)
    # end walls
    b.quad([(-hl, floor_y, hw), (-hl, floor_y, -hw), (-hl, hh, -hw),
            (-hl, hh, hw)], WALL, uv_scale=0.08)
    b.quad([(hl, floor_y, -hw), (hl, floor_y, hw), (hl, hh, hw),
            (hl, hh, -hw)], WALL, uv_scale=0.08)
    # roof strips with a central open light well (the atrium opening):
    # strips along both z edges, well spans |z| < 0.3*W and |x| < 0.4*L
    wz = 0.3 * width
    wx = 0.4 * length
    b.quad([(-hl, hh, -hw), (hl, hh, -hw), (hl, hh, -wz), (-hl, hh, -wz)],
           WALL, uv_scale=0.08)
    b.quad([(-hl, hh, wz), (hl, hh, wz), (hl, hh, hw), (-hl, hh, hw)],
           WALL, uv_scale=0.08)
    b.quad([(-hl, hh, -wz), (-wx, hh, -wz), (-wx, hh, wz), (-hl, hh, wz)],
           WALL, uv_scale=0.08)
    b.quad([(wx, hh, -wz), (hl, hh, -wz), (hl, hh, wz), (wx, hh, wz)],
           WALL, uv_scale=0.08)

    # colonnades at z = +-0.38 W, two stories, columns every ~13 units
    zc = 0.38 * width
    n_cols = 9
    xs = np.linspace(-hl + 8.0, hl - 8.0, n_cols)
    r = 1.8
    for x in xs:
        for zs in (-zc, zc):
            b.column(float(x), zs, floor_y, floor_y + story, r, COLUMN)
            b.column(float(x), zs, floor_y + story + gallery_t,
                     floor_y + story + gallery_t + story * 0.8,
                     r * 0.8, COLUMN)
    # gallery slabs between colonnade and wall (leave the nave open)
    for z0, z1 in ((-hw, -zc + r), (zc - r, hw)):
        b.box((0.0, floor_y + story + gallery_t / 2, (z0 + z1) / 2),
              (length, gallery_t, z1 - z0), TRIM, uv_scale=0.1)
    # architrave beams along each colonnade (second-story support)
    for zs in (-zc, zc):
        b.box((0.0, floor_y + 2 * story + gallery_t + 1.0, zs),
              (length, 2.0, 3.0), TRIM, uv_scale=0.1)

    # hanging banners across the nave (alpha-masked fabric)
    for i, mat in enumerate((BANNER_R, BANNER_G, BANNER_B)):
        x = (i - 1) * 0.28 * length
        top = floor_y + story * 1.9
        bot = top - 14.0
        b.quad([(x, bot, -6.0), (x, bot, 6.0), (x, top, 6.0),
                (x, top, -6.0)], mat,
               uvs=[(0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)])
        b.quad([(x, bot, 6.0), (x, bot, -6.0), (x, top, -6.0),
                (x, top, 6.0)], mat,
               uvs=[(1.0, 1.0), (0.0, 1.0), (0.0, 0.0), (1.0, 0.0)])

    # floor clutter for contact shadows / AO
    b.box((-0.15 * length, floor_y + 3.0, 0.0), (6.0, 6.0, 6.0), CRATE,
          uv_scale=0.25)
    b.box((0.2 * length, floor_y + 2.0, -0.1 * width), (4.0, 4.0, 4.0),
          CRATE, uv_scale=0.25)
    b.box((0.05 * length, floor_y + 1.5, 0.15 * width), (3.0, 3.0, 3.0),
          CRATE, uv_scale=0.25)

    checker_a, checker_h = _checker()
    brick_a = _brick()
    fr_a, fr_m = _fabric(color=(0.72, 0.10, 0.10))
    fg_a, fg_m = _fabric(color=(0.10, 0.50, 0.16))
    fb_a, fb_m = _fabric(color=(0.12, 0.20, 0.62))
    materials = [
        Material(name="floor", albedo=(0.8, 0.78, 0.74, 1.0),
                 specular=(0.25, 0.25, 0.25), albedo_texture=checker_a,
                 height_texture=checker_h),
        Material(name="wall", albedo=(0.6, 0.4, 0.3, 1.0),
                 albedo_texture=brick_a),
        Material(name="column", albedo=(0.75, 0.72, 0.65, 1.0),
                 specular=(0.1, 0.1, 0.1)),
        Material(name="trim", albedo=(0.55, 0.52, 0.48, 1.0),
                 specular=(0.35, 0.35, 0.35)),
        Material(name="banner_r", albedo=(0.72, 0.10, 0.10, 1.0),
                 albedo_texture=fr_a, mask_texture=fr_m),
        Material(name="banner_g", albedo=(0.10, 0.50, 0.16, 1.0),
                 albedo_texture=fg_a, mask_texture=fg_m),
        Material(name="banner_b", albedo=(0.12, 0.20, 0.62, 1.0),
                 albedo_texture=fb_a, mask_texture=fb_m),
        Material(name="crate", albedo=(0.5, 0.35, 0.2, 1.0)),
    ]
    return scene_from_arrays(
        np.asarray(b.v, np.float32), np.asarray(b.tris, np.int32),
        uvs=np.asarray(b.uv, np.float32),
        tri_material=np.asarray(b.mats, np.int32), materials=materials)
