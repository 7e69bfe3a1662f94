"""Build and load the port's CUDA kernels at first use.

Every `ops/csrc/*.cu` file compiles on its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface under `vct_tpu_torch/_build/`, named by a hash of the sources
and flags, which is loaded with ctypes.  Each launcher
takes device pointers and the CUDA stream as integers, launches on that
stream without synchronizing, and returns `cudaGetLastError()`; `check`
turns a nonzero status into an exception.

Nothing here runs at import: a CPU-only installation imports every module
of the package and never needs nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong

# launcher name -> argument types (every launcher returns its cudaError_t)
SIGNATURES = {
    # src, dst, h, c, max_alpha, stream
    "vct_mip_downsample": (_P, _P, _I, _I, _I, _P),
    # gout, alpha (or null), gin, h, c, max_alpha, stream
    "vct_mip_downsample_bwd": (_P, _P, _P, _I, _I, _I, _P),
    # src, dst, h, c, src_dirs (1 or 6), vec4, stream
    "vct_aniso_downsample": (_P, _P, _I, _I, _I, _I, _P),
    # dirs, origin, isect, attrs, n, t, out, stream
    "vct_raycast": (_P, _P, _P, _P, _I, _I, _P, _P),
    # gbuf, ntiles, gcols, ld0, nl, fd0, nf, half_ws, voxel, voxel_off,
    # scal8, nm, res, nlev, mscal, mlists, mslots, stream
    "vct_prepass": (_P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _I, _I, _I,
                    _P, _P, _P, _P),
    # gbuf, n, gcols, slots, mscal, mlists, pages, num_materials,
    # rows_per_mat, res, out, stream
    "vct_material": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    # dirs, origin, isect, attrs, lists, ncol, counts, tmin, miss, nrt,
    # out, kept (or null), stream
    "vct_raycast_stream": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                           _P),
    # gbuf, ntiles, gcols, scal8, bumpn, campos, light, ld0, field, fd0,
    # cfield, consts, nb, ncones, half_ws, voxel, voxel_off, out, stream
    "vct_tap": (_P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I,
                _F, _F, _F, _P, _P),
    # dirs, origin, scal, ns, table, np_rows, attrs, out, kept (or null),
    # stream
    "vct_binrast": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _P),
    # v0, e1, e2, vn, vt, vb, vuv, face_normal, material, origin, albedo,
    # specular, shininess (each of the last three or null), t, isect,
    # attrs, stream
    "vct_bin_pack": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                     _P, _P, _P),
    # dirs, fsum, xsum, ns, srows, scols, hp, wp, smm, ssum, frame, stream
    "vct_bin_strips": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # v0, e1, e2, origin, frame, t, ns, srows, scols, nb_med, nb_col, info,
    # blk, blkoff, totals, n_col_total, keys, tris (or null), stream
    "vct_bin_tris": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                     _P, _P, _P, _P, _P),
    # sorted, perm (or null), tris (or null), slots_total, nbins, ns, scols,
    # isect, bounds, pad_off, shift, scal, table, np_rows, stream
    "vct_bin_table": (_P, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P, _L,
                      _P),
    # start4, refl4, ntiles, step_lv, weights, nsteps, pyramid, d0, nl,
    # half_ws, max_alpha, out, stream
    "vct_specmarch": (_P, _P, _I, _P, _P, _I, _P, _I, _I, _F, _F, _P, _P),
    # level_ptr, level_stride, level_nd (host arrays), nl, transmittance,
    # compute_bf16, tidx, tw, ntaps, step_i, step_f, nsteps, w6, nb, nx,
    # ny, nz, pow_mode, sf, use_gain, gain, max_alpha, out, walked (or
    # null), stream
    "vct_dense_march": (_P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _I,
                        _P, _I, _I, _I, _I, _I, _F, _I, _F, _F, _P, _P, _P),
    # src_ptr, src_stride, shape, nd, dst_ptr (host arrays), nl, nc,
    # level_bf16, compute_bf16, stream
    "vct_dense_pack": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # kernel reports: (nb, cfield,) info -> info[0:4] = registers, spill
    # bytes a thread, shared bytes a block, resident warps per SM
    "vct_tap_occupancy": (_I, _I, _P),
    "vct_raycast_occupancy": (_P,),
    "vct_raycast_stream_occupancy": (_P,),
    "vct_binrast_occupancy": (_P,),
    "vct_specmarch_occupancy": (_P,),
    "vct_prepass_occupancy": (_P,),
    "vct_material_occupancy": (_P,),
    "vct_dense_occupancy": (_I, _P),
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile ops/csrc into one shared library (a no-op when the library
    for these sources and flags exists).  nvcc's reports, with ptxas's
    per-kernel registers and spills, are kept beside it as `.log`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libvct_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / f"{cu.stem}.o" for cu in cus]
        procs = [subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for cu, o in zip(cus, objs)]
        logs = [f"== {cu.name}\n{pr.communicate()[0]}"
                for cu, pr in zip(cus, procs)]
        failed = [cu.name for cu, pr in zip(cus, procs) if pr.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = Path(tmp) / out.name
        res = subprocess.run(
            [nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
             *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.vct_error_string.argtypes = [ctypes.c_int]
    lib.vct_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if status != 0:
        msg = library().vct_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def occupancy(reporter: str, *args: int) -> dict:
    """What the card makes of a kernel, from its `*_occupancy` reporter:
    registers and spill (local) bytes a thread, shared bytes a block, and
    resident warps per SM."""
    info = (ctypes.c_int * 4)()
    check(getattr(library(), reporter)(*args, ctypes.addressof(info)),
          reporter)
    return dict(zip(("registers", "spill_bytes", "shared_bytes",
                     "warps_per_sm"), info))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every op: CUDA tensors launch the kernel, CPU
    tensors take the plain PyTorch version; anything else is refused, as
    are operands on different devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on CUDA or all on the CPU, "
                     f"got {sorted(kinds)}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward would drop a gradient: grad
    mode is on and a floating input requires grad.  Every device refuses,
    as the JAX package, whose kernel has no VJP, fails to differentiate
    it on every backend."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{name} has no backward: its output cannot carry gradients to "
            f"inputs that require grad (run it under torch.no_grad(), or "
            f"detach them)")


def replay_grads(plain, args, wanted, gout: torch.Tensor) -> tuple:
    """The backward of a kernel whose function `plain` computes: plain(*args)
    replayed under autograd on detached copies of the args, and its
    vector-Jacobian product with `gout`.  Returns one entry per arg: the
    gradient where `wanted` is true (None where an arg does not reach the
    output), None elsewhere.  This is how the JAX package's custom VJPs
    differentiate its kernels: by their jnp references."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_() if w else a
              for a, w in zip(args, wanted)]
        leaves = [x for x, w in zip(xs, wanted) if w]
        grads = iter(torch.autograd.grad(plain(*xs), leaves, gout,
                                         allow_unused=True))
    return tuple(next(grads) if w else None for w in wanted)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)
