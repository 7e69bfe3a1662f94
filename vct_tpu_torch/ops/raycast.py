"""Same-origin closest-hit raycast + G-buffer (kernel 2; replaces
vct_tpu/ops/raycast_pallas.py raycast_gbuf24).

`pack_tables` folds the shared camera origin into per-triangle constants
(det = d.a, u*det = d.b, v*det = d.c, t*det = k); `raycast_gbuf24`
launches `csrc/raycast.cu` for CUDA tensors and runs the plain version
for CPU tensors.  Both take the first minimum by triangle index, and both
round every multiply and add separately, as the reference does.

G-buffer columns (NOUT = 32): 0:3 position, 3:6 shading normal, 6:9 geo
normal, 9:12 tangent, 12:15 bitangent, 15:17 uv, 17 material id, 18 t,
19 hit, 20:24 material albedo, 24:27 specular, 27 shininess, 28:32 zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vct_tpu_torch.ops import _build
from vct_tpu_torch.render.gbuffer import DeviceScene

Tensor = torch.Tensor

NISECT = 16             # a3 b3 c3 k, zero padded
NATTR = 48              # vn9 vt9 vb9 uv6 fn3 mat1 alb4 spec3 shin1, padded
NOUT = 32
MAX_TRIANGLES = 2048    # the whole-table path's limit (render/fast.py)
EPS = 1e-7
TMIN_EPS = 1e-4
BIG = 3.0e38            # "no hit" sentinel

LAUNCHES = 0


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """jnp.cross's formula, term by term."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def pack_tables(ds: DeviceScene, origin: Tensor,
                albedo: Optional[Tensor] = None,
                specular: Optional[Tensor] = None,
                shininess: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per-triangle tables for a fixed ray origin: isect (T, 16) and attrs
    (T, 48), one row per triangle (the JAX package stores isect
    transposed and pads T; the rows are the same).  albedo (M, 4),
    specular (M, 3), shininess (M,) are per-material constants expanded to
    per-triangle rows."""
    t = ds.v0.shape[0]
    dev = ds.v0.device
    tvec = origin[None, :] - ds.v0
    c = _cross(tvec, ds.e1)
    a = _cross(ds.e2, ds.e1)
    b = _cross(ds.e2, tvec)
    k = ds.e2[:, 0] * c[:, 0] + ds.e2[:, 1] * c[:, 1] + ds.e2[:, 2] * c[:, 2]
    zeros = torch.zeros((t, NISECT - 10), dtype=torch.float32, device=dev)
    isect = torch.cat([a, b, c, k[:, None], zeros], dim=-1)

    mat = ds.material.long()
    alb = (albedo[mat] if albedo is not None
           else torch.zeros((t, 4), dtype=torch.float32, device=dev))
    spec = (specular[mat] if specular is not None
            else torch.zeros((t, 3), dtype=torch.float32, device=dev))
    shin = (shininess[mat] if shininess is not None
            else torch.full((t,), 20.0, dtype=torch.float32, device=dev))
    attrs = torch.cat([
        ds.vn.reshape(t, 9), ds.vt.reshape(t, 9), ds.vb.reshape(t, 9),
        ds.vuv.reshape(t, 6), ds.face_normal,
        ds.material.to(torch.float32)[:, None], alb, spec, shin[:, None],
        torch.zeros((t, NATTR - 45), dtype=torch.float32, device=dev),
    ], dim=-1)
    return isect.contiguous(), attrs.contiguous()


def _finish_gbuf(d: Tensor, origin: Tensor, tbest: Tensor, u: Tensor,
                 v: Tensor, arow: Tensor) -> Tensor:
    """Barycentric G-buffer rows (raycast_pallas._finish_gbuf)."""
    hit = tbest < BIG
    ts = torch.where(hit, tbest, 0.0)
    w0 = 1.0 - u - v

    def interp3(a9):
        return w0 * a9[:, 0:3] + u * a9[:, 3:6] + v * a9[:, 6:9]

    normal = interp3(arow[:, 0:9])
    nn = (normal[:, 0:1] * normal[:, 0:1] + normal[:, 1:2] * normal[:, 1:2]
          + normal[:, 2:3] * normal[:, 2:3])
    normal = normal * torch.rsqrt(torch.clamp_min(nn, 1e-24))
    vuv = arow[:, 27:33]
    uv = w0 * vuv[:, 0:2] + u * vuv[:, 2:4] + v * vuv[:, 4:6]
    pos = origin[None, :] + ts * d
    n = d.shape[0]
    return torch.cat([
        pos, normal, arow[:, 33:36], interp3(arow[:, 9:18]),
        interp3(arow[:, 18:27]), uv, arow[:, 36:37], ts,
        hit.to(torch.float32), arow[:, 37:45],
        torch.zeros((n, NOUT - 28), dtype=torch.float32, device=d.device),
    ], dim=1)


def raycast_plain(dirs: Tensor, origin: Tensor, isect: Tensor,
                  attrs: Tensor, chunk: int = 65536) -> Tensor:
    """Plain PyTorch version: (N, T) hit tests per chunk of rays."""
    t = isect.shape[0]
    lanes = torch.arange(t, device=dirs.device)
    out = []
    for s in range(0, dirs.shape[0], chunk):
        d = dirs[s:s + chunk]

        def dot3(r0):
            return (d[:, 0:1] * isect[None, :, r0]
                    + d[:, 1:2] * isect[None, :, r0 + 1]
                    + d[:, 2:3] * isect[None, :, r0 + 2])

        det, ud, vd = dot3(0), dot3(3), dot3(6)
        kk = isect[None, :, 9]
        sgn = torch.sign(det)
        ad = torch.abs(det)
        sinv = sgn * (1.0 / torch.clamp_min(ad, EPS))
        valid = ((ad > EPS) & (sgn * ud >= 0) & (sgn * vd >= 0)
                 & (sgn * (ud + vd) <= ad) & (sgn * kk > TMIN_EPS * ad))
        tcand = torch.where(valid, kk * sinv, BIG)
        tbest = tcand.min(dim=1, keepdim=True).values
        idx = torch.where(tcand == tbest, lanes, t).min(dim=1,
                                                         keepdim=True).values
        hit = tbest < BIG
        sel = idx.clamp_max(t - 1)
        u = torch.where(hit, torch.gather(ud * sinv, 1, sel), 0.0)
        v = torch.where(hit, torch.gather(vd * sinv, 1, sel), 0.0)
        arow = torch.where(hit, attrs[sel[:, 0]], 0.0)
        out.append(_finish_gbuf(d, origin, tbest, u, v, arow))
    return torch.cat(out, dim=0)


def raycast_cuda(dirs: Tensor, origin: Tensor, isect: Tensor,
                 attrs: Tensor) -> Tensor:
    global LAUNCHES
    for x, shape in ((dirs, (dirs.shape[0], 3)), (origin, (3,)),
                     (isect, (isect.shape[0], NISECT)),
                     (attrs, (isect.shape[0], NATTR))):
        _build.require(x.is_cuda and x.dtype == torch.float32
                       and x.is_contiguous() and tuple(x.shape) == shape,
                       f"raycast kernel: expected contiguous float32 CUDA "
                       f"{shape}, got {tuple(x.shape)} {x.dtype}")
    n, t = dirs.shape[0], isect.shape[0]
    out = torch.empty((n, NOUT), dtype=torch.float32, device=dirs.device)
    status = _build.library().vct_raycast(
        dirs.data_ptr(), origin.data_ptr(), isect.data_ptr(),
        attrs.data_ptr(), n, t, out.data_ptr(), _build.stream())
    _build.check(status, "vct_raycast")
    LAUNCHES += 1
    return out


def raycast_gbuf24(dirs: Tensor, origin: Tensor, isect: Tensor,
                   attrs: Tensor) -> Tensor:
    """(N, 3) same-origin rays -> (N, NOUT) packed G-buffer."""
    if _build.uses_kernel(dirs, origin, isect, attrs):
        return raycast_cuda(dirs, origin, isect, attrs)
    return raycast_plain(dirs, origin, isect, attrs)
