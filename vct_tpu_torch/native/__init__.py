"""ctypes binding for the native host runtime (vct_native.cpp): the OBJ
geometry parser and the stratified surface sampler.

The library is built with g++ at first use into `vct_tpu_torch/_build/`,
named by a hash of the source, the compiler and the flags, so a changed
source or toolchain builds anew and a stale library never loads.  The
build compiles to a temporary name and renames it into place under an
fcntl lock on the build directory, so processes that build at once (test
workers, spawned ranks) all load one whole library.  A build that fails
raises with the compiler's output: nothing falls back to the plain paths
(scene/obj.py's Python parser, render/voxelize.py's numpy sampler), which
are chosen only by their callers' backend="python".

Parity contract: bit-identical outputs to the plain implementations
(tests/test_torch_native.py).  No -march=native: the library must give
the same bits, and load, on every x86-64 host.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "vct_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
BUILD_TIMEOUT_S = 300


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvct_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library (a no-op when the one for this source,
    compiler and flags exists); raise RuntimeError if the compiler cannot
    run or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when lock closes
        if out.exists():                     # another process built it
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                res = subprocess.run([CXX, *FLAGS, "-o", tmp, str(SOURCE)],
                                     capture_output=True, text=True,
                                     timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"vct_native build failed: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"vct_native build failed ({CXX} exit "
                                   f"{res.returncode}):\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vct_obj_parse.restype = ctypes.c_void_p
    lib.vct_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                  ctypes.c_float]
    lib.vct_obj_counts.restype = None
    lib.vct_obj_counts.argtypes = [ctypes.c_void_p, c_i64p, c_i64p, c_i64p,
                                   c_i64p, c_i32p]
    lib.vct_obj_fill.restype = None
    lib.vct_obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
    lib.vct_obj_free.restype = None
    lib.vct_obj_free.argtypes = [ctypes.c_void_p]
    lib.vct_sample_levels.restype = None
    lib.vct_sample_levels.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_void_p]
    lib.vct_sample_fill.restype = ctypes.c_int64
    lib.vct_sample_fill.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 5
    return lib


def available() -> bool:
    """True when the library builds (or is built) and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_obj_geometry(path: str, flip_uv: bool = True, scale: float = 1.0):
    """Native OBJ geometry parse: (positions, uvs, normals, tris, tri_mat,
    mat_names, mtllibs, any_normals), the arrays scene/obj.py's Python
    parser builds.  Raises OSError when the file cannot be read."""
    lib = library()
    with open(path, "rb"):       # the Python parser's error for a bad path
        pass
    h = lib.vct_obj_parse(os.fsencode(path), int(flip_uv), float(scale))
    if not h:
        raise OSError(f"vct_native could not read {path}")
    try:
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        mb = ctypes.c_int64()
        lb = ctypes.c_int64()
        an = ctypes.c_int32()
        lib.vct_obj_counts(h, ctypes.byref(nv), ctypes.byref(nt),
                           ctypes.byref(mb), ctypes.byref(lb),
                           ctypes.byref(an))
        pos = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        nrm = np.empty((nv.value, 3), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        tri_mat = np.empty((nt.value,), np.int32)
        names = ctypes.create_string_buffer(max(1, mb.value))
        libs = ctypes.create_string_buffer(max(1, lb.value))
        lib.vct_obj_fill(h, _ptr(pos), _ptr(uv), _ptr(nrm), _ptr(tris),
                         _ptr(tri_mat), ctypes.cast(names, ctypes.c_void_p),
                         ctypes.cast(libs, ctypes.c_void_p))
        mat_names = (names.raw[:mb.value].decode(errors="replace").split("\n")
                     if mb.value else [])
        mtllibs = (libs.raw[:lb.value].decode(errors="replace").split("\n")
                   if lb.value else [])
        return (pos, uv, nrm, tris, tri_mat, mat_names, mtllibs,
                bool(an.value))
    finally:
        lib.vct_obj_free(h)


def surface_samples(tv: np.ndarray, t_uv: np.ndarray, fn: np.ndarray,
                    tri_material: np.ndarray, voxel_world_size: float,
                    samples_per_voxel_width: float,
                    max_samples_per_tri: int = 4096):
    """Native stratified surface sampling, render/voxelize.py's
    generate_surface_samples in triangle-major order: (positions, normals,
    uvs, material_ids, tri_ids)."""
    lib = library()
    t = tv.shape[0]
    shapes = ((tv, (t, 3, 3)), (t_uv, (t, 3, 2)), (fn, (t, 3)),
              (tri_material, (t,)))
    for a, shape in shapes:
        if a.shape != shape:
            raise ValueError(f"surface_samples: shape {a.shape}, expected "
                             f"{shape}")
    if t >= 2 ** 31:
        raise ValueError(f"surface_samples: {t} triangles overflow the "
                         "int32 triangle ids")
    tv = np.ascontiguousarray(tv, np.float32)
    t_uv = np.ascontiguousarray(t_uv, np.float32)
    fn = np.ascontiguousarray(fn, np.float32)
    tri_material = np.ascontiguousarray(tri_material, np.int32)
    nmax = int(np.sqrt(max_samples_per_tri))
    levels = np.empty((t,), np.int32)
    lib.vct_sample_levels(_ptr(tv), t, np.float32(voxel_world_size),
                          np.float32(samples_per_voxel_width), nmax,
                          _ptr(levels))
    total = int(np.sum(levels.astype(np.int64) ** 2))
    pos = np.empty((total, 3), np.float32)
    nrm = np.empty((total, 3), np.float32)
    uv = np.empty((total, 2), np.float32)
    mat = np.empty((total,), np.int32)
    tri = np.empty((total,), np.int32)
    written = lib.vct_sample_fill(_ptr(tv), _ptr(t_uv), _ptr(fn),
                                  _ptr(tri_material), _ptr(levels), t,
                                  _ptr(pos), _ptr(nrm), _ptr(uv),
                                  _ptr(mat), _ptr(tri))
    if written != total:
        raise RuntimeError(f"vct_sample_fill wrote {written} samples of "
                           f"{total}")
    return pos, nrm, uv, mat, tri
