"""Same-origin closest-hit raycasts + G-buffer (kernels 2 and 6; replace
vct_tpu/ops/raycast_pallas.py raycast_gbuf24 and raycast_stream).

`pack_tables` folds the shared camera origin into per-triangle constants
(det = d.a, u*det = d.b, v*det = d.c, t*det = k); `raycast_gbuf24`
launches `csrc/raycast.cu` for CUDA tensors and runs the plain version
for CPU tensors.  Both take the first minimum by triangle index, and both
round every multiply and add separately, as the reference does.  The
kernel first drops, per 256-ray block, the rows no ray of the block can
hit (`tile_cull_plain` is that predicate in plain PyTorch); the plain
version tests every row, with the same result.  On CUDA tensors the
kernel runs inside the autograd Function `Raycast`, whose backward gives
the attribute table its gradient by replaying the plain version over
chunks of BWD_CHUNK rays (raycast_pallas._raycast_bwd); the streamed
raycast has no backward and refuses inputs that need one, as the binned
raycast (ops/binrast.py) does.

The streamed raycast tests each 256-ray tile against only the
128-triangle chunks whose bounding sphere touches the tile's direction
cone (`pack_tables_stream`, `select_chunks`: plain PyTorch, as in the JAX
package), front to back, with a per-ray minimum distance for the
alpha-mask re-cast; `raycast_stream` launches `csrc/raycast_stream.cu`
for CUDA tensors and runs the plain version for CPU tensors.  The kernel
gives each warp of GROUP rays (or each of its two parts, `stream_parts`)
its own cone, drops the listed chunks' rows that cone misses and skips
rays that cannot hit (`stream_cull_plain` and `stream_walk_plain` state
its cull and its walk in plain PyTorch).

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
MAX_TRIANGLES = 2048    # render/fast.py: above, the binned raycast
EPS = 1e-7
TMIN_EPS = 1e-4
BIG = 3.0e38            # "no hit" sentinel
TILE = 256              # rays per tile: a streamed list row, a whole-table block
CHUNK = 128             # triangles per streamed chunk
CULLED = 0x7FFFFFFF     # list word of a culled chunk: sorts after every kept one
MAX_CHUNKS = 1 << 16    # a list word holds the chunk id in its low 16 bits
# the per-tile cull of the whole-table and binned kernels (cull_rows,
# csrc/raycast_common.cuh)
CULL_MARGIN = 1e-4      # half-space margin, relative to the row's scale
CONE_SLACK = 4e-6       # taken off the cone's least dot product
WIDE_DOT = 1e-4         # at or below: no bounding cone, keep every row
# the streamed kernel's walk (csrc/raycast_stream.cu)
GROUP = 32              # rays a warp, walked as one or two parts
SPLIT_DOT = 0.9998477   # cos 1 deg: a wider neighbour angle splits the warp
CULL_PARTS = 512        # warp parts stream_cull_plain culls at a time
BWD_CHUNK = 8192        # rays a chunk of the whole-table backward's replay
# may_keep_row's norm bounds (csrc/raycast_common.cuh): their sum above the
# one or the least below the other, a row is left to keep_row alone
NORM_BOUND_MIN = 1e-18
NORM_BOUND_MAX = 1e18


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
                 v: Tensor, arow: Tensor, miss_at=BIG) -> Tensor:
    """Barycentric G-buffer rows (raycast_pallas._finish_gbuf); a ray hit
    when tbest < miss_at."""
    hit = tbest < miss_at
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


def _hits(d: Tensor, rows: Tensor):
    """The hit test of rays d (..., 3) against table rows (..., 16),
    broadcast: valid, and ud, vd, kk with the signed inverse determinant
    (t = kk * sinv)."""

    def dot3(r0):
        return (d[..., 0] * rows[..., r0] + d[..., 1] * rows[..., r0 + 1]
                + d[..., 2] * rows[..., r0 + 2])

    det, ud, vd = dot3(0), dot3(3), dot3(6)
    kk = rows[..., 9]
    sgn = torch.sign(det)
    ad = torch.abs(det)
    sinv = sgn * (1.0 / torch.clamp_min(ad, EPS))
    valid = ((ad > EPS) & (sgn * ud >= 0) & (sgn * vd >= 0)
             & (sgn * (ud + vd) <= ad) & (sgn * kk > TMIN_EPS * ad))
    return valid, ud, vd, kk, sinv


def hit_tests(d: Tensor, isect: Tensor):
    """The hit test of every ray against every row, (N, T) each: valid,
    and ud, vd, kk with the signed inverse determinant (t = kk * sinv)."""
    return _hits(d[:, None, :], isect[None])


def _halve(x: Tensor, dim: int) -> Tensor:
    """Pairwise sum along `dim` (a power of two) in the order of a warp's
    xor-shuffle reduction: element i adds i + half, halving each step."""
    while x.shape[dim] > 1:
        a, b = x.split(x.shape[dim] // 2, dim=dim)
        x = a + b
    return x.squeeze(dim)


def tile_cones(dirs: Tensor, group: int = TILE,
               live: Optional[Tensor] = None):
    """The direction cone of each `group`-ray block (TILE: a block of
    csrc/raycast.cu and csrc/binrast.cu; GROUP: a warp of
    csrc/raycast_stream.cu), in the kernels' float order: dirs (N, 3) ->
    axis (ngroups, 3), sin of the half-angle (ngroups,) and `wide`
    (ngroups,) where no cone narrower than a half-space bounds the group.
    Rays of length 0, rays where `live` (N,) is False and the padding of a
    ragged last group cannot hit and do not widen the cone.  The half-
    angle's cosine is the least ray-axis dot product less CONE_SLACK,
    which exceeds its rounding error.  `group` is 32 times a power of two:
    the warps' xor-shuffle sums, then the warp totals pairwise."""
    n = dirs.shape[0]
    ng = -(-n // group)
    d = torch.cat([dirs, dirs.new_zeros((ng * group - n, 3))])
    dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    aims = dd > 0.0
    if live is not None:
        aims[:n] &= live
    dn = torch.where(aims[:, None], d / torch.sqrt(dd)[:, None], 0.0)
    # warp totals (32 lanes), then the group's warp totals
    s = _halve(_halve(dn.reshape(ng, group // 32, 32, 3), 2), 1)
    norm = torch.sqrt(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1] + s[:, 2] * s[:, 2])
    axis = s / torch.clamp_min(norm, 1e-12)[:, None]
    a = axis.repeat_interleave(group, dim=0)
    dots = dn[:, 0] * a[:, 0] + dn[:, 1] * a[:, 1] + dn[:, 2] * a[:, 2]
    min_dot = torch.where(aims, dots, BIG).reshape(ng, group).amin(dim=1)
    cos_a = torch.clamp(min_dot - CONE_SLACK, WIDE_DOT, 1.0)
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    return axis, sin_a, min_dot <= WIDE_DOT


def cull_rows(axis: Tensor, sin_a: Tensor, wide: Tensor,
              rows: Tensor) -> Tensor:
    """The per-tile cull's verdict on table rows against tile cones, in
    csrc/raycast_common.cuh keep_row's float order, broadcast: axis
    (..., 3), sin_a and wide (...), rows (..., 16) -> keep (...) bool.

    A ray d hits row (a, b, c, k) only if sign(det) = sign(k) = s and
    s*d.b >= 0, s*d.c >= 0, s*d.(a - b - c) >= 0 (so s*d.a >= 0): d lies
    in four half-spaces through the origin.  A tile drops a row when its
    cone (axis A, half-angle alpha) misses one of them by a margin:
    s*A.n + sin(alpha)*|n| + CULL_MARGIN*S < 0, where S is |n|, or
    |a| + |b| + |c| for a - b - c.  Every ray of the cone then has
    s*d.n < -(2/pi)*CULL_MARGIN*S*|d|, far beyond the hit test's rounding
    (about 3e-7*S*|d|), so a dropped row fails the rounded hit test for
    every ray of the tile and the first minimum is unchanged.  A row with
    k = 0 never hits; a wide tile keeps every row."""
    a, b, c, k = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], rows[..., 9]
    sgn = torch.sign(k)

    def norm(v):
        return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                          + v[..., 2] * v[..., 2])

    na, nb, nc = norm(a), norm(b), norm(c)
    e = a - b - c
    keep = sgn != 0.0
    for n, nn, scale in ((a, na, na), (b, nb, nb), (c, nc, nc),
                         (e, norm(e), na + nb + nc)):
        an = sgn * (axis[..., 0] * n[..., 0] + axis[..., 1] * n[..., 1]
                    + axis[..., 2] * n[..., 2])
        keep = keep & (an + sin_a * nn + CULL_MARGIN * scale >= 0.0)
    return keep | wide


def may_keep_rows(axis: Tensor, sin_a: Tensor, wide: Tensor,
                  rows: Tensor) -> Tensor:
    """csrc/raycast_common.cuh may_keep_row in its float order, broadcast
    as cull_rows: cull_rows with each norm |n| replaced by the upper bound
    (|n0| + |n1| + |n2|) * 1.0001, no square roots.  Rounding to nearest is
    monotone in each replaced term, so it keeps every row cull_rows keeps
    as long as cull_rows's squared norms are finite and rounded relative to
    their size: a row whose bounds of a, b and c sum above NORM_BOUND_MAX,
    or whose least bound lies below NORM_BOUND_MIN, is kept, for cull_rows
    alone to decide.  The streamed kernel asks keep_row only for the rows
    this keeps."""
    a, b, c, k = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], rows[..., 9]
    sgn = torch.sign(k)

    def bound(v):
        v = v.abs()
        return (v[..., 0] + v[..., 1] + v[..., 2]) * 1.0001

    e = a - b - c
    ua, ub, uc, ue = bound(a), bound(b), bound(c), bound(e)
    total = ua + ub + uc
    keep = sgn != 0.0
    for n, nn, scale in ((a, ua, ua), (b, ub, ub), (c, uc, uc),
                         (e, ue, total)):
        an = sgn * (axis[..., 0] * n[..., 0] + axis[..., 1] * n[..., 1]
                    + axis[..., 2] * n[..., 2])
        keep = keep & (an + sin_a * nn + CULL_MARGIN * scale >= 0.0)
    least = torch.fmin(torch.fmin(ua, ub), torch.fmin(uc, ue))
    in_range = (total <= NORM_BOUND_MAX) & (least >= NORM_BOUND_MIN)
    return (keep | ((sgn != 0.0) & ~in_range)) | wide


def tile_cull_plain(dirs: Tensor, isect: Tensor) -> Tensor:
    """Which rows each TILE-ray block of the whole-table kernel keeps:
    dirs (N, 3), isect (T, 16) -> keep (ntiles, T) bool, in the kernel's
    float order (tile_cones, cull_rows)."""
    axis, sin_a, wide = tile_cones(dirs)
    return cull_rows(axis[:, None], sin_a[:, None], wide[:, None],
                     isect[None])


def raycast_plain(dirs: Tensor, origin: Tensor, isect: Tensor,
                  attrs: Tensor, chunk: int = 65536) -> Tensor:
    """Plain PyTorch version: (N, T) hit tests per chunk of rays."""
    t = isect.shape[0]
    lanes = torch.arange(t, device=dirs.device)
    out = []
    for s in range(0, dirs.shape[0], chunk):
        d = dirs[s:s + chunk]
        valid, ud, vd, kk, sinv = hit_tests(d, isect)
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
    n, t = dirs.shape[0], isect.shape[0]
    f32 = torch.float32
    _build.operand(dirs, f32, (n, 3), "raycast kernel: dirs")
    _build.operand(origin, f32, (3,), "raycast kernel: origin")
    _build.operand(isect, f32, (t, NISECT), "raycast kernel: isect")
    _build.operand(attrs, f32, (t, NATTR), "raycast kernel: attrs")
    _build.require(isect.data_ptr() % 16 == 0,
                   "raycast kernel: isect rows are read as float4s and must "
                   "be 16-byte aligned")
    out = torch.empty((n, NOUT), dtype=torch.float32, device=dirs.device)
    _build.launch("vct_raycast", dirs.data_ptr(), origin.data_ptr(),
                  isect.data_ptr(), attrs.data_ptr(), n, t, out.data_ptr())
    return out


def raycast_bwd_plain(dirs: Tensor, origin: Tensor, isect: Tensor,
                      attrs: Tensor, gout: Tensor) -> Tensor:
    """The gradient to the attribute table (raycast_pallas._raycast_bwd):
    raycast_plain replayed under autograd over chunks of BWD_CHUNK rays,
    the chunks' gradients summed (a ray's row depends on its own hit
    only, so the sum over chunks is the whole batch's gradient).  A
    chunk's replay holds (BWD_CHUNK, T) intermediates, whatever the image
    size.  The last chunk is cut short, which gives what the JAX
    package's zero cotangents on padded rays give."""
    dattrs = torch.zeros_like(attrs)
    for s in range(0, dirs.shape[0], BWD_CHUNK):
        dattrs += _build.replay_grads(
            lambda at: raycast_plain(dirs[s:s + BWD_CHUNK], origin, isect,
                                     at), (attrs,), (True,),
            gout[s:s + BWD_CHUNK])[0]
    return dattrs


class Raycast(torch.autograd.Function):
    """The whole-table raycast by `fwd` (the kernel on the card; the tests
    inject raycast_plain on the CPU).  Gradients reach `attrs` only: the
    directions, the origin and the hit tests get none, as hit topology is
    a step function (raycast_pallas.py:271-315)."""

    @staticmethod
    def forward(ctx, dirs, origin, isect, attrs, fwd):
        ctx.save_for_backward(dirs, origin, isect, attrs)
        return fwd(dirs, origin, isect, attrs)

    @staticmethod
    def backward(ctx, gout):
        dirs, origin, isect, attrs = ctx.saved_tensors
        dattrs = None
        if ctx.needs_input_grad[3]:
            dattrs = raycast_bwd_plain(dirs, origin, isect, attrs, gout)
        return None, None, None, dattrs, None


def raycast_gbuf24(dirs: Tensor, origin: Tensor, isect: Tensor,
                   attrs: Tensor) -> Tensor:
    """(N, 3) same-origin rays -> (N, NOUT) packed G-buffer."""
    if _build.uses_kernel(dirs, origin, isect, attrs):
        return Raycast.apply(dirs, origin, isect, attrs, raycast_cuda)
    return raycast_plain(dirs, origin, isect, attrs)


# ---------------------------------------------------------------------------
# the streamed raycast
# ---------------------------------------------------------------------------

def _norm_rows3(x: Tensor) -> Tensor:
    return torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
                      + x[:, 2] * x[:, 2])


def _check_chunks(nchunk: int) -> None:
    if nchunk > MAX_CHUNKS:
        raise ValueError(f"{nchunk} chunks of {CHUNK} triangles: the streamed "
                         f"raycast's list words hold at most {MAX_CHUNKS} "
                         f"chunk ids ({MAX_CHUNKS * CHUNK} triangles)")


def pack_tables_stream(ds: DeviceScene, origin: Tensor,
                       albedo: Optional[Tensor] = None,
                       specular: Optional[Tensor] = None,
                       shininess: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Streaming tables: isect (Tp, 16), attrs (Tp, 48) zero-padded to a
    CHUNK multiple Tp, and spheres (nchunk, 4): per chunk the bounding
    sphere of its real triangles' corners, (center - origin, radius),
    radius -BIG for an all-padding chunk (raycast_pallas.pack_tables_stream)."""
    t = ds.v0.shape[0]
    tp = -(-t // CHUNK) * CHUNK
    nchunk = tp // CHUNK
    _check_chunks(nchunk)
    isect, attrs = pack_tables(ds, origin, albedo, specular, shininess)
    dev = isect.device

    def pad(x):
        return torch.cat([x, x.new_zeros((tp - t, x.shape[1]))])

    verts = pad(torch.cat([ds.v0, ds.v0 + ds.e1, ds.v0 + ds.e2], dim=1))
    real = (torch.arange(tp, device=dev) < t)[:, None]
    vmin = torch.where(real, verts, BIG).reshape(nchunk, CHUNK * 3, 3).amin(1)
    vmax = torch.where(real, verts, -BIG).reshape(nchunk, CHUNK * 3, 3).amax(1)
    any_real = real.reshape(nchunk, CHUNK).any(dim=1)
    center = torch.where(any_real[:, None], 0.5 * (vmin + vmax), 0.0)
    radius = torch.where(any_real, _norm_rows3(
        torch.where(any_real[:, None], vmax - center, 0.0)), -BIG)
    spheres = torch.cat([center - origin[None, :], radius[:, None]], dim=1)
    return pad(isect).contiguous(), pad(attrs).contiguous(), spheres


def select_chunks(dirs: Tensor, spheres: Tensor) -> Tuple[Tensor, Tensor]:
    """Per ray tile, the chunks whose sphere touches the tile's direction
    cone, front to back: dirs (nrt, TILE, 3) unit, spheres (nchunk, 4) ->
    lists (nrt, nchunk) int32 words (near << 16) | chunk id sorted
    ascending, culled entries CULLED at the end, and counts (nrt,) int32
    (raycast_pallas.select_chunks)."""
    nrt = dirs.shape[0]
    nchunk = spheres.shape[0]
    _check_chunks(nchunk)
    axis = dirs.sum(dim=1)
    axis = axis / torch.clamp_min(_norm_rows3(axis), 1e-12)[:, None]
    min_dot = (dirs * axis[:, None, :]).sum(dim=2).amin(dim=1)
    cos_a = torch.clamp(min_dot, 1e-4, 1.0)
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    wide = min_dot <= 1e-4   # no bounding cone: keep every chunk
    v = spheres[:, :3]
    r = spheres[:, 3]
    along = (axis[:, 0:1] * v[None, :, 0] + axis[:, 1:2] * v[None, :, 1]
             + axis[:, 2:3] * v[None, :, 2])                 # (nrt, nchunk)
    vv = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])[None, :]
    perp = torch.sqrt(torch.clamp_min(vv - along * along, 0.0))
    dist = cos_a[:, None] * perp - sin_a[:, None] * along
    keep = (dist <= r[None, :]) & (along >= -r[None, :]) | wide[:, None]
    counts = keep.sum(dim=1).to(torch.int32)
    near = torch.clamp_min(torch.sqrt(torch.clamp_min(vv, 0.0)) - r[None, :],
                           0.0)
    near_q = torch.clamp(torch.floor(near), 0, 32766).to(torch.int32)
    ids = torch.arange(nchunk, dtype=torch.int32, device=dirs.device)
    words = (ids[None, :] | (near_q << 16)).masked_fill(~keep, CULLED)
    return torch.sort(words, dim=1).values.contiguous(), counts


def miss_distance(dirs: Tensor, spheres: Tensor) -> Tensor:
    """Per-ray miss sentinel of the streamed raycast (N,): the exit
    distance of the scene box (the real chunks' spheres) times 1.001 plus
    1e-2.  Every real hit is closer, and unlike BIG it lets the front-to-
    back stop fire in tiles that hold sky rays."""
    real = spheres[:, 3] >= 0.0
    c3, r3 = spheres[:, :3], spheres[:, 3:4]
    vmin = torch.where(real[:, None], c3 - r3, BIG).amin(dim=0)
    vmax = torch.where(real[:, None], c3 + r3, -BIG).amax(dim=0)
    dinv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
    ta = vmin[None, :] * dinv
    tb = vmax[None, :] * dinv
    tfar = torch.clamp_min(torch.maximum(ta, tb).amin(dim=1), 0.0)
    return tfar * 1.001 + 1e-2


def raycast_stream_plain(dirs: Tensor, origin: Tensor, isect: Tensor,
                         attrs: Tensor, lists: Tensor, counts: Tensor,
                         tmin: Tensor, miss: Tensor,
                         chunk: int = 16384) -> Tensor:
    """Plain PyTorch version: every ray against every listed triangle of
    its tile at once; the winner is the smallest t, ties to the earliest
    (list position, triangle in chunk) -- the kernel's walk order."""
    nrt = counts.shape[0]
    tp = isect.shape[0]
    nchunk = tp // CHUNK
    dev = dirs.device
    pos = torch.arange(lists.shape[1], device=dev)
    listed = pos[None, :] < counts[:, None].long()
    ids = torch.where(listed, (lists & 0xFFFF).long(), nchunk)
    rank = torch.full((nrt, nchunk + 1), tp, dtype=torch.long, device=dev)
    rank.scatter_(1, ids, pos[None, :].expand(nrt, -1).contiguous())
    tri = torch.arange(tp, device=dev)
    rank = rank[:, tri // CHUNK]
    order = torch.where(rank < tp, rank * CHUNK + tri % CHUNK, tp * CHUNK)
    out = []
    for s in range(0, dirs.shape[0], chunk):
        d = dirs[s:s + chunk]
        key = order[torch.arange(s, s + d.shape[0], device=dev) // TILE]
        valid, ud, vd, kk, sinv = hit_tests(d, isect)
        tval = kk * sinv
        valid = (valid & (tval > tmin[s:s + chunk, None])
                 & (key < tp * CHUNK))
        tcand = torch.where(valid, tval, BIG)
        tbest = tcand.min(dim=1, keepdim=True).values
        win = torch.where(tcand == tbest, key, tp * CHUNK).argmin(dim=1,
                                                                  keepdim=True)
        hit = tbest < miss[s:s + chunk, None]
        u = torch.where(hit, torch.gather(ud * sinv, 1, win), 0.0)
        v = torch.where(hit, torch.gather(vd * sinv, 1, win), 0.0)
        arow = torch.where(hit, attrs[win[:, 0]], 0.0)
        out.append(_finish_gbuf(d, origin, tbest, u, v, arow,
                                miss_at=miss[s:s + chunk, None]))
    return torch.cat(out, dim=0)


def stream_live(dirs: Tensor, tmin: Tensor, miss: Tensor) -> Tensor:
    """Which rays of the streamed raycast can hit anything (N,): a
    candidate needs tmin < t < best <= miss, and a ray of length 0 never
    hits.  The kernel's cones, stop and early exit count only these."""
    dd = dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1] \
        + dirs[:, 2] * dirs[:, 2]
    return (tmin < miss) & (dd > 0.0)


def stream_parts(dirs: Tensor, tmin: Tensor, miss: Tensor) -> Tensor:
    """How the streamed kernel splits each warp of GROUP rays: (ngroups, 2,
    GROUP) bool, which lanes each of its two parts holds.  A warp whose
    widest angle between neighbouring live rays (stream_live) has a cosine
    below SPLIT_DOT splits after the first such pair (alpha_resolve's
    direction sort puts rays of two cells in it, and one cone over both
    keeps up to 100x the rows); else part 0 holds all 32 lanes and part 1
    none.  In the kernel's float order: unit directions, then the pairs'
    dot products."""
    n = dirs.shape[0]
    ng = n // GROUP
    live = stream_live(dirs, tmin, miss).reshape(ng, GROUP)
    d = dirs.reshape(ng, GROUP, 3)
    dd = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    dn = torch.where(live[..., None], d / torch.sqrt(dd)[..., None], 0.0)
    a, b = dn[:, :-1], dn[:, 1:]
    pair = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])
    pair = torch.where(live[:, :-1] & live[:, 1:], pair, 2.0)
    widest = pair.amin(dim=1, keepdim=True)
    lane = torch.arange(GROUP, device=dirs.device)[None, :]
    first = torch.where(pair == widest, lane[:, 1:], GROUP).amin(dim=1)
    split = torch.where(widest[:, 0] < SPLIT_DOT, first, GROUP)
    return torch.stack([lane < split[:, None], lane >= split[:, None]], dim=1)


def _part_lists(lists: Tensor, counts: Tensor, ng: int):
    """Each warp part's list, from its tile's (parts 2g and 2g + 1 are warp
    g's): chunk ids (2 ng, L) (0 past the count), listed (2 ng, L), the
    count (2 ng,) and the tile (2 ng,), L the longest count."""
    tile = torch.arange(2 * ng, device=lists.device) // (2 * TILE // GROUP)
    cnt = counts[tile].long()
    length = int(counts.max()) if counts.numel() else 0
    listed = torch.arange(length, device=lists.device)[None, :] < cnt[:, None]
    chunk = torch.where(listed, (lists[tile, :length] & 0xFFFF).long(), 0)
    return chunk, listed, cnt, tile


def _part_rays(dirs: Tensor, tmin: Tensor, miss: Tensor, parts: Tensor):
    """Every warp part's rays: dirs (2 ng * GROUP, 3), and which of them
    walk (live and in the part) (2 ng * GROUP,)."""
    ng = parts.shape[0]
    live = stream_live(dirs, tmin, miss).reshape(ng, 1, GROUP)
    d = dirs.reshape(ng, 1, GROUP, 3).expand(ng, 2, GROUP, 3)
    return d.reshape(-1, 3), (live & parts).reshape(-1)


def stream_cull_plain(dirs: Tensor, isect: Tensor, lists: Tensor,
                      counts: Tensor, tmin: Tensor, miss: Tensor) -> Tensor:
    """Which rows of each listed chunk each part of each warp of
    csrc/raycast_stream.cu keeps (stream_parts): (ngroups, 2, L, CHUNK)
    bool, L the longest list, in the kernel's float order: the cone of the
    part's live rays (stream_live, tile_cones) against each row's
    half-spaces (cull_rows, which states why a dropped row never hits).
    Positions past a list's count keep nothing, nor does a part with no
    live ray (the kernel reads no chunk for it); a wide part keeps the
    rest."""
    ng = dirs.shape[0] // GROUP
    parts = stream_parts(dirs, tmin, miss)
    d, walks = _part_rays(dirs, tmin, miss, parts)
    axis, sin_a, wide = tile_cones(d, GROUP, walks)
    walks = walks.reshape(2 * ng, GROUP).any(dim=1)
    chunk, listed, _, _ = _part_lists(lists, counts, ng)
    table = isect.reshape(-1, CHUNK, NISECT)
    keep = torch.zeros((2 * ng, chunk.shape[1], CHUNK), dtype=torch.bool,
                       device=dirs.device)
    for u0 in range(0, 2 * ng, CULL_PARTS):
        u = slice(u0, u0 + CULL_PARTS)
        k = cull_rows(axis[u, None, None], sin_a[u, None, None],
                      wide[u, None, None], table[chunk[u]])
        keep[u] = k & (listed[u] & walks[u, None])[:, :, None]
    return keep.reshape(ng, 2, chunk.shape[1], CHUNK)


def stream_walk_plain(dirs: Tensor, origin: Tensor, isect: Tensor,
                      attrs: Tensor, lists: Tensor, counts: Tensor,
                      tmin: Tensor, miss: Tensor, keep: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """csrc/raycast_stream.cu's walk in plain PyTorch: each warp part's
    rays (stream_parts) against only the rows `keep` (stream_cull_plain)
    holds for it, list position by list position, best replaced on a
    strict '<' in (position, row) order, and the part stopping at the
    first position whose chunk's near bound is at or beyond every live ray
    of the part's best.  Returns the (N, NOUT) G-buffer, which equals
    raycast_stream_plain's bit for bit, and each warp's count of kept rows
    over the positions its parts tested (ngroups,) int32: the kernel's
    `kept`."""
    n = dirs.shape[0]
    ng = n // GROUP
    dev = dirs.device
    parts = stream_parts(dirs, tmin, miss)
    d, walks = _part_rays(dirs, tmin, miss, parts)
    walks = walks.reshape(2 * ng, GROUP)
    chunk, _, cnt, tile = _part_lists(lists, counts, ng)
    keep = keep.reshape(2 * ng, -1, CHUNK)
    table = isect.reshape(-1, CHUNK, NISECT)
    d = d.reshape(2 * ng, GROUP, 1, 3)
    # the other part's lanes never update
    t_from = torch.where(parts, tmin.reshape(ng, 1, GROUP),
                         float("inf")).reshape(2 * ng, GROUP, 1)
    best = miss.reshape(ng, 1, GROUP).expand(ng, 2, GROUP).reshape(
        2 * ng, GROUP).clone()
    win = torch.full((2 * ng, GROUP), -1, dtype=torch.long, device=dev)
    bu = torch.zeros((2 * ng, GROUP), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    kept = torch.zeros(2 * ng, dtype=torch.long, device=dev)
    walking = walks.any(dim=1)
    lane_ids = torch.arange(CHUNK, device=dev)
    for p in range(chunk.shape[1]):
        if p > 0:
            near = (lists[tile, p] >> 16).float()
            top = torch.where(walks, best, -BIG).amax(dim=1)
            walking &= ~((p < cnt) & (near >= top))
        gi = torch.nonzero(walking & (p < cnt))[:, 0]
        if gi.numel() == 0:
            continue
        rows = table[chunk[gi, p]]                           # (k, CHUNK, 16)
        kp = keep[gi, p]                                     # (k, CHUNK)
        kept[gi] += kp.sum(dim=1)
        valid, ud, vd, kk, sinv = _hits(d[gi], rows[:, None])
        tval = kk * sinv
        tc = torch.where(valid & kp[:, None] & (tval > t_from[gi]), tval, BIG)
        tb = tc.amin(dim=2, keepdim=True)
        first = torch.where(tc == tb, lane_ids, CHUNK).amin(dim=2,
                                                            keepdim=True)
        first = first.clamp_max(CHUNK - 1)
        better = tb[..., 0] < best[gi]
        best[gi] = torch.where(better, tb[..., 0], best[gi])
        win[gi] = torch.where(better, chunk[gi, p, None] * CHUNK
                              + first[..., 0], win[gi])
        for acc, x in ((bu, ud), (bv, vd)):
            acc[gi] = torch.where(better, torch.gather(x * sinv, 2,
                                                       first)[..., 0], acc[gi])
    def own(x):
        """Each lane's result from its own part, (N, 1)."""
        x = x.reshape(ng, 2, GROUP)
        return torch.where(parts[:, 0], x[:, 0], x[:, 1]).reshape(n, 1)

    best, win, bu, bv = own(best), own(win), own(bu), own(bv)
    hit = best < miss[:, None]
    arow = torch.where(hit, attrs[win[:, 0].clamp_min(0)], 0.0)
    u = torch.where(hit, bu, 0.0)
    v = torch.where(hit, bv, 0.0)
    g = _finish_gbuf(dirs, origin, best, u, v, arow, miss_at=miss[:, None])
    return g, kept.reshape(ng, 2).sum(dim=1).to(torch.int32)


def raycast_stream_cuda(dirs: Tensor, origin: Tensor, isect: Tensor,
                        attrs: Tensor, lists: Tensor, counts: Tensor,
                        tmin: Tensor, miss: Tensor,
                        kept: Optional[Tensor] = None) -> Tensor:
    """Launch csrc/raycast_stream.cu: the (N, NOUT) G-buffer.  kept: an
    optional (N // GROUP,) int32 tensor that receives each warp's count of
    kept rows over the chunks it tested (stream_walk_plain's), so that
    chip_smoke.py can show that the culled bound counts the tests the
    kernel makes; the frame path passes none."""
    n, tp, nrt = dirs.shape[0], isect.shape[0], counts.shape[0]
    f32, i32 = torch.float32, torch.int32
    _build.operand(dirs, f32, (n, 3), "streamed raycast kernel: dirs")
    _build.operand(origin, f32, (3,), "streamed raycast kernel: origin")
    _build.operand(isect, f32, (tp, NISECT), "streamed raycast kernel: isect")
    _build.operand(attrs, f32, (tp, NATTR), "streamed raycast kernel: attrs")
    _build.operand(lists, i32, (nrt, lists.shape[1]),
                   "streamed raycast kernel: lists")
    _build.operand(counts, i32, (nrt,), "streamed raycast kernel: counts")
    _build.operand(tmin, f32, (n,), "streamed raycast kernel: tmin")
    _build.operand(miss, f32, (n,), "streamed raycast kernel: miss")
    if kept is not None:
        _build.operand(kept, i32, (n // GROUP,),
                       "streamed raycast kernel: kept")
    _build.require(n == nrt * TILE and tp % CHUNK == 0
                   and lists.shape[1] >= tp // CHUNK,
                   "streamed raycast kernel: one list row per 256 rays and "
                   "a CHUNK-padded table")
    _build.require(isect.data_ptr() % 16 == 0,
                   "streamed raycast kernel: isect rows are read as float4s "
                   "and must be 16-byte aligned")
    out = torch.empty((n, NOUT), dtype=torch.float32, device=dirs.device)
    _build.launch("vct_raycast_stream", dirs.data_ptr(), origin.data_ptr(),
                  isect.data_ptr(), attrs.data_ptr(), lists.data_ptr(),
                  lists.shape[1], counts.data_ptr(), tmin.data_ptr(),
                  miss.data_ptr(), nrt, out.data_ptr(),
                  None if kept is None else kept.data_ptr())
    return out


def raycast_stream(dirs: Tensor, origin: Tensor, isect: Tensor,
                   attrs: Tensor, lists: Tensor, counts: Tensor,
                   spheres: Tensor, tmin: Optional[Tensor] = None) -> Tensor:
    """Streamed closest-hit G-buffer: (N, 3) same-origin unit rays, N a
    TILE multiple, tables from pack_tables_stream, lists from
    select_chunks -> (N, NOUT), columns as raycast_gbuf24.

    tmin: optional (N,) or (N, 1) per-ray minimum hit distance (the alpha-
    mask re-cast continues rays past a masked hit); none by default."""
    kernel = _build.uses_kernel(dirs, origin, isect, attrs, lists, counts,
                                spheres)
    _build.refuse_grad("the streamed raycast (raycast_stream)", dirs,
                       origin, isect, attrs, spheres, *(
                           () if tmin is None else (tmin,)))
    n = dirs.shape[0]
    if n % TILE:
        raise ValueError(f"streamed raycast: {TILE}-ray tiles, got n={n}")
    if tmin is None:
        tmin = torch.full((n,), -1.0, dtype=torch.float32, device=dirs.device)
    tmin = tmin.reshape(n).contiguous()
    lists = lists[:counts.shape[0]]       # the JAX package pads 8-row groups
    args = (dirs, origin, isect, attrs, lists, counts, tmin,
            miss_distance(dirs, spheres))
    return raycast_stream_cuda(*args) if kernel else \
        raycast_stream_plain(*args)
