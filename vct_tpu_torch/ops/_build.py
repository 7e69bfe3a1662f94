"""Build and load the port's CUDA kernels at first use.

Every `ops/csrc/*.cu` file compiles on its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface under `vct_tpu_torch/_build/`, named by a hash of the sources
and flags, which is loaded with ctypes.  Each launcher
takes device pointers and the CUDA stream as integers, launches on that
stream without synchronizing, and returns `cudaGetLastError()`.

This module is the one boundary every op crosses to reach a kernel:
`launch` calls a launcher on the current stream, turns a nonzero status
into an exception (`check`) and counts the kernels it started under the
launcher's row of `SIGNATURES` (`launches`, `reset_launches`);
`operand` and `require` check what a launcher is given, building their
message only on failure; `Replay` is the autograd Function of every
kernel whose backward replays its plain version.

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
_L, _D = ctypes.c_longlong, ctypes.c_double

# launcher name -> (the launch counter's row, the kernels one call starts,
# the argument types); every launcher takes the stream last and returns
# its cudaError_t.  The *_occupancy reporters launch nothing: no row.
SIGNATURES = {
    # src, dst, h, c, max_alpha, stream
    "vct_mip_downsample": ("mip", 1, (_P, _P, _I, _I, _I, _P)),
    # gout, alpha (or null), gin, h, c, max_alpha, stream
    "vct_mip_downsample_bwd": ("mip_bwd", 1, (_P, _P, _P, _I, _I, _I, _P)),
    # src, dst, h, c, src_dirs (1 or 6), vec4, stream
    "vct_aniso_downsample": ("aniso", 1, (_P, _P, _I, _I, _I, _I, _P)),
    # dirs, origin, isect, attrs, n, t, out, stream
    "vct_raycast": ("raycast", 1, (_P, _P, _P, _P, _I, _I, _P, _P)),
    # gbuf, ntiles, gcols, ld0, nl, fd0, nf, half_ws, voxel, voxel_off,
    # scal8, nm, res, nlev, mscal, mlists, mslots, stream
    "vct_prepass": ("prepass", 1, (_P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                   _P, _I, _I, _I, _P, _P, _P, _P)),
    # gbuf, n, gcols, slots, mscal, mlists, pages, num_materials,
    # rows_per_mat, res, out, stream
    "vct_material": ("material", 1, (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                                     _P, _P)),
    # dirs, origin, isect, attrs, lists, ncol, counts, tmin, miss, nrt,
    # out, kept (or null), stream
    "vct_raycast_stream": ("raycast_stream", 1, (_P, _P, _P, _P, _P, _I, _P,
                                                 _P, _P, _I, _P, _P, _P)),
    # gbuf, ntiles, gcols, scal8, bumpn, campos, light, ld0, field, fd0,
    # cfield, consts, nb, ncones, half_ws, voxel, voxel_off, out, stream
    "vct_tap": ("tap", 1, (_P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P,
                           _I, _I, _F, _F, _F, _P, _P)),
    # dirs, origin, scal, ns, table, np_rows, attrs, out, kept (or null),
    # stream
    "vct_binrast": ("binrast", 1, (_P, _P, _P, _I, _P, _I, _P, _P, _P, _P)),
    # v0, e1, e2, vn, vt, vb, vuv, face_normal, material, origin, albedo,
    # specular, shininess (each of the last three or null), t, isect,
    # attrs, stream
    "vct_bin_pack": ("binning", 1, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _P, _P, _P)),
    # dirs, fsum, xsum, ns, srows, scols, hp, wp, smm, ssum, frame, stream
    "vct_bin_strips": ("binning", 2, (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                      _P, _P)),
    # v0, e1, e2, origin, frame, t, ns, srows, scols, nb_med, nb_col, info,
    # blk, blkoff, totals, n_col_total, keys, tris (or null), stream
    "vct_bin_tris": ("binning", 3, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _P, _P, _P, _P, _P, _P, _P, _P)),
    # sorted, perm (or null), tris (or null), slots_total, nbins, ns, scols,
    # isect, bounds, pad_off, shift, scal, table, np_rows, stream
    "vct_bin_table": ("binning", 3, (_P, _P, _P, _L, _I, _I, _I, _P, _P, _P,
                                     _P, _P, _P, _L, _P)),
    # start4, refl4, ntiles, step_lv, weights, nsteps, pyramid, d0, nl,
    # half_ws, max_alpha, out, stream
    "vct_specmarch": ("specmarch", 1, (_P, _P, _I, _P, _P, _I, _P, _I, _I,
                                       _F, _F, _P, _P)),
    # level_ptr, level_stride, level_nd (host arrays), nl, transmittance,
    # compute_bf16, tidx, tw, ntaps, step_i, step_f, nsteps, w6, nb, nx,
    # ny, nz, pow_mode, sf, use_gain, gain, max_alpha, out, walked (or
    # null), stream
    "vct_dense_march": ("dense_march", 1, (_P, _P, _P, _I, _I, _I, _P, _P,
                                           _I, _P, _P, _I, _P, _I, _I, _I,
                                           _I, _I, _F, _I, _F, _F, _P, _P,
                                           _P)),
    # src_ptr, src_stride, shape, nd, dst_ptr (host arrays), nl, nc,
    # level_bf16, compute_bf16, stream
    "vct_dense_pack": ("dense_pack", 1, (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _P)),
    # dirs (host array), nb, dist, dl, ntaps, n, world_size, compute_bf16,
    # idx, w, stream
    "vct_dense_taps": ("dense_taps", 1, (_P, _I, _P, _P, _I, _I, _D, _I, _P,
                                         _P, _P)),
    # start, dirs, n, k, level_ptr, level_shape (host arrays), nl, step_f,
    # step_i (host arrays), nsteps, weights (host array), half_ws,
    # max_alpha, out, walked (or null), stream
    "vct_percone": ("percone", 1, (_P, _P, _I, _I, _P, _P, _I, _P, _P, _I,
                                   _P, _F, _F, _P, _P, _P)),
    # kernel reports: (nb, cfield,) info -> info[0:4] = registers, spill
    # bytes a thread, shared bytes a block, resident warps per SM
    "vct_tap_occupancy": (None, 0, (_I, _I, _P)),
    "vct_raycast_occupancy": (None, 0, (_P,)),
    "vct_raycast_stream_occupancy": (None, 0, (_P,)),
    "vct_binrast_occupancy": (None, 0, (_P,)),
    "vct_specmarch_occupancy": (None, 0, (_P,)),
    "vct_prepass_occupancy": (None, 0, (_P,)),
    "vct_material_occupancy": (None, 0, (_P,)),
    "vct_dense_occupancy": (None, 0, (_I, _P)),
    "vct_percone_occupancy": (None, 0, (_I, _P)),
}

# kernels launched since the last reset_launches, by row
_launched = dict.fromkeys((row for row, _, _ in SIGNATURES.values() if row),
                          0)


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
    for name, (_, _, args) in SIGNATURES.items():
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


def launch(name: str, *args) -> None:
    """Launch `name` with `args` and the current stream, raise through
    `check` where the launch was refused, and count the kernels it started
    under its row (a refused launch counts nothing)."""
    check(getattr(library(), name)(*args, stream()), name)
    row, kernels, _ = SIGNATURES[name]
    _launched[row] += kernels


def launches() -> dict:
    """Kernels launched since the last reset_launches, by row: a copy."""
    return dict(_launched)


def reset_launches() -> None:
    for row in _launched:
        _launched[row] = 0


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
    """The current device's current CUDA stream as a raw handle: the
    value of torch.cuda.current_stream().cuda_stream, read without making
    a Stream object (every launch reads it)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


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


class Replay(torch.autograd.Function):
    """A kernel differentiated by its plain version: forward fwd(*tensors)
    (the kernel on the card; the tests inject the plain version on the
    CPU), backward plain(*tensors) replayed under autograd (replay_grads).
    fwd and plain close over the call's other arguments.  The tensors at
    the positions in `frozen` get no gradient, nor does a tensor that needs
    none (an integer tensor never does)."""

    @staticmethod
    def forward(ctx, fwd, plain, frozen, *tensors):
        ctx.plain, ctx.frozen = plain, frozen
        ctx.save_for_backward(*tensors)
        return fwd(*tensors)

    @staticmethod
    def backward(ctx, gout):
        wanted = [w and i not in ctx.frozen
                  for i, w in enumerate(ctx.needs_input_grad[3:])]
        return (None, None, None) + replay_grads(ctx.plain, ctx.saved_tensors,
                                                 wanted, gout)


def require(cond: bool, what: str, *args) -> None:
    """Raise ValueError unless cond; the message is what.format(*args),
    built only then (these checks run on every call)."""
    if not cond:
        raise ValueError(what.format(*args) if args else what)


def operand(x: torch.Tensor, dtype: torch.dtype, shape: tuple,
            what: str) -> None:
    """Raise ValueError, naming the operand `what`, unless x is a
    contiguous CUDA tensor of this dtype and shape (the message is built
    only then)."""
    if not (x.is_cuda and x.dtype == dtype and x.is_contiguous()
            and tuple(x.shape) == tuple(shape)):
        raise ValueError(f"{what}: expected a contiguous {dtype} CUDA tensor "
                         f"of shape {tuple(shape)}, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
