"""Wavefront OBJ/MTL loader — numpy replacement for the reference's Assimp
import path (Model.h:43-139: Triangulate | GenSmoothNormals | FlipUVs |
CalcTangentSpace) and its 4-slot material loading (Model.h:126-136).

Supports: v/vt/vn, f with arbitrary polygon fan triangulation and negative
indices, usemtl/mtllib; MTL Kd/Ks/Ke/Ns/d, map_Kd/map_Ks/map_bump/map_d
(PNG/JPG via utils.image; TGA via _read_tga).  Missing files degrade to
constant-color materials with a warning, matching the reference's
print-and-continue behavior (Model.h:179-183).

A copy of vct_tpu/scene/obj.py: backend="auto" parses geometry with the
native parser (vct_tpu_torch/native), "python" with the plain one here.
tests/test_torch_image.py pins the scenes equal to the JAX package's
backend="python", tests/test_torch_native.py the two backends bit-equal.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from vct_tpu_torch import native
from vct_tpu_torch.scene.mesh import Material, Scene, scene_from_arrays
from vct_tpu_torch.utils.image import read_jpg, read_png


def _read_tga(path: str) -> np.ndarray:
    """Minimal TGA reader: uncompressed or RLE true-color/grayscale."""
    with open(path, "rb") as fh:
        data = fh.read()
    idlen = data[0]
    imgtype = data[2]
    w = int.from_bytes(data[12:14], "little")
    h = int.from_bytes(data[14:16], "little")
    bpp = data[16] // 8
    desc = data[17]
    pos = 18 + idlen
    n = w * h
    if imgtype in (2, 3):
        raw = np.frombuffer(data[pos:pos + n * bpp], np.uint8).reshape(n, bpp)
    elif imgtype in (10, 11):
        out = np.empty((n, bpp), np.uint8)
        i = 0
        while i < n:
            hdr = data[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:
                px = np.frombuffer(data[pos:pos + bpp], np.uint8)
                pos += bpp
                out[i:i + count] = px
            else:
                out[i:i + count] = np.frombuffer(
                    data[pos:pos + count * bpp], np.uint8).reshape(count, bpp)
            i += count
        raw = out
    else:
        raise ValueError(f"unsupported TGA type {imgtype}")
    img = raw.reshape(h, w, bpp)
    if bpp >= 3:
        img = img[..., [2, 1, 0] + ([3] if bpp == 4 else [])]  # BGR(A)->RGB(A)
    if not (desc & 0x20):          # origin at bottom -> flip to top-first
        img = img[::-1]
    return np.ascontiguousarray(img)


def load_texture(path: str) -> Optional[np.ndarray]:
    """Image file -> float (H, W, C) in [0,1], or None on failure.

    PNG/TGA/JPG — the stb_image formats the reference's texture path
    consumes (Model.h:141-186, stb_image.h)."""
    try:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".png":
            img = read_png(path)
        elif ext == ".tga":
            img = _read_tga(path)
        elif ext in (".jpg", ".jpeg"):
            return read_jpg(path)               # already float [0,1]
        else:
            return None
        return img.astype(np.float32) / 255.0
    except Exception as e:                      # noqa: BLE001
        print(f"texture load failed: {path}: {e}")   # Model.h:179-183 style
        return None


def _parse_mtl(path: str) -> Dict[str, Material]:
    mats: Dict[str, Material] = {}
    cur: Optional[dict] = None
    base = os.path.dirname(path)
    out: Dict[str, dict] = {}
    try:
        lines = open(path, errors="replace").read().splitlines()
    except OSError as e:
        print(f"mtllib load failed: {path}: {e}")
        return mats
    for line in lines:
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        key = tok[0]
        if key == "newmtl":
            cur = {"name": tok[1] if len(tok) > 1 else "unnamed"}
            out[cur["name"]] = cur
        elif cur is None:
            continue
        elif key in ("Kd", "Ks", "Ke"):
            cur[key] = tuple(float(x) for x in tok[1:4])
        elif key == "Ns":
            cur["Ns"] = float(tok[1])
        elif key == "d":
            cur["d"] = float(tok[1])
        elif key in ("map_Kd", "map_Ks", "map_bump", "bump", "map_d"):
            cur[key.replace("bump", "map_bump") if key == "bump" else key] = \
                os.path.join(base, tok[-1].replace("\\", "/"))
    for name, m in out.items():
        kd = m.get("Kd", (1.0, 1.0, 1.0))
        tex = load_texture(m["map_Kd"]) if "map_Kd" in m else None
        if tex is not None and tex.shape[-1] == 3:
            tex = np.concatenate([tex, np.ones_like(tex[..., :1])], axis=-1)
        mask = load_texture(m["map_d"]) if "map_d" in m else None
        if mask is not None and mask.ndim == 3:
            mask = mask[..., 0]
        spec_tex = load_texture(m["map_Ks"]) if "map_Ks" in m else None
        if spec_tex is not None and spec_tex.shape[-1] == 4:
            spec_tex = spec_tex[..., :3]
        height = load_texture(m["map_bump"]) if "map_bump" in m else None
        if height is not None and height.ndim == 3:
            height = height[..., 0]
        mats[name] = Material(
            name=name,
            albedo=(*kd, m.get("d", 1.0)),
            specular=m.get("Ks", (0.0, 0.0, 0.0)),
            emissive=m.get("Ke", (0.0, 0.0, 0.0)),
            shininess=m.get("Ns", 20.0),
            albedo_texture=tex,
            specular_texture=spec_tex,
            height_texture=height,
            mask_texture=mask,
        )
    return mats


def _load_obj_native(path: str, flip_uv: bool, scale: float) -> Scene:
    """Geometry through vct_tpu_torch/native (bit-identical to the Python
    parser); MTL and textures stay in Python."""
    pos, uv, nrm, tris, tri_mat, mat_names, mtllibs, any_normals = \
        native.parse_obj_geometry(path, flip_uv=flip_uv, scale=scale)
    base = os.path.dirname(path)
    mtl: Dict[str, Material] = {}
    for lib in mtllibs:
        mtl.update(_parse_mtl(os.path.join(base, lib)))
    materials = [mtl.get(n, Material(name=n)) for n in mat_names]
    if not materials:
        materials = [Material()]
    if not any_normals or float(np.abs(nrm).sum()) == 0.0:
        nrm = None
    return scene_from_arrays(pos, tris, normals=nrm, uvs=uv,
                             tri_material=tri_mat, materials=materials)


def load_obj(path: str, flip_uv: bool = True, scale: float = 1.0,
             backend: str = "auto") -> Scene:
    """Load an OBJ (+MTL) into a Scene.

    flip_uv mirrors Assimp's aiProcess_FlipUVs used by the reference
    (Model.h:43).  Vertices are de-duplicated per (v, vt, vn) triple;
    smooth normals are generated when the file has none
    (GenSmoothNormals analogue).  scale applies the reference's uniform
    model transform (0.05 for Sponza, Voxel_Cone_Tracing.h:183).

    backend="auto" parses geometry with the native C++ parser
    (vct_tpu_torch/native, the Assimp-import counterpart), bit-identical
    arrays to the Python parser, and raises if the library cannot be
    built; "python" forces the Python parser; anything else raises
    ValueError.  MTL, material and texture loading run in Python either
    way.
    """
    if backend not in ("auto", "python"):
        raise ValueError(f"unknown OBJ backend {backend!r}")
    if backend == "auto":
        return _load_obj_native(path, flip_uv, scale)
    positions: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    mtl: Dict[str, Material] = {}
    mat_index: Dict[str, int] = {}
    materials: List[Material] = []
    cur_mat = 0

    vmap: Dict[Tuple[int, int, int], int] = {}
    out_pos: List = []
    out_uv: List = []
    out_nrm: List = []
    tris: List[Tuple[int, int, int]] = []
    tri_mat: List[int] = []
    any_normals = False

    def get_mat(name: str) -> int:
        if name not in mat_index:
            mat_index[name] = len(materials)
            materials.append(mtl.get(name, Material(name=name)))
        return mat_index[name]

    def resolve(count: int, idx: int) -> int:
        return idx - 1 if idx > 0 else count + idx

    def vertex(spec: str) -> int:
        parts = spec.split("/")
        vi = resolve(len(positions), int(parts[0]))
        ti = (resolve(len(uvs), int(parts[1]))
              if len(parts) > 1 and parts[1] else -1)
        ni = (resolve(len(normals), int(parts[2]))
              if len(parts) > 2 and parts[2] else -1)
        key = (vi, ti, ni)
        if key not in vmap:
            vmap[key] = len(out_pos)
            out_pos.append(positions[vi])
            if ti >= 0:
                u, v = uvs[ti]
                out_uv.append((u, 1.0 - v if flip_uv else v))
            else:
                out_uv.append((0.0, 0.0))
            out_nrm.append(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return vmap[key]

    base = os.path.dirname(path)
    for line in open(path, errors="replace"):
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        key = tok[0]
        if key == "v":
            positions.append(tuple(float(x) for x in tok[1:4]))
        elif key == "vt":
            uvs.append((float(tok[1]), float(tok[2]) if len(tok) > 2 else 0.0))
        elif key == "vn":
            normals.append(tuple(float(x) for x in tok[1:4]))
            any_normals = True
        elif key == "mtllib":
            mtl.update(_parse_mtl(os.path.join(base, " ".join(tok[1:]))))
        elif key == "usemtl":
            cur_mat = get_mat(tok[1] if len(tok) > 1 else "default")
        elif key == "f":
            vs = [vertex(s) for s in tok[1:]]
            for i in range(1, len(vs) - 1):      # fan triangulation
                tris.append((vs[0], vs[i], vs[i + 1]))
                tri_mat.append(cur_mat)

    if not materials:
        materials = [Material()]
    pos = np.asarray(out_pos, np.float32) * np.float32(scale)
    nrm = np.asarray(out_nrm, np.float32)
    if not any_normals or float(np.abs(nrm).sum()) == 0.0:
        nrm = None
    return scene_from_arrays(
        pos, np.asarray(tris, np.int32), normals=nrm,
        uvs=np.asarray(out_uv, np.float32),
        tri_material=np.asarray(tri_mat, np.int32), materials=materials)
