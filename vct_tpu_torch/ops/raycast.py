"""Same-origin closest-hit raycasts + G-buffer (kernels 2 and 6; replace
vct_tpu/ops/raycast_pallas.py raycast_gbuf24 and raycast_stream).

`pack_tables` folds the shared camera origin into per-triangle constants
(det = d.a, u*det = d.b, v*det = d.c, t*det = k); `raycast_gbuf24`
launches `csrc/raycast.cu` for CUDA tensors and runs the plain version
for CPU tensors.  Both take the first minimum by triangle index, and both
round every multiply and add separately, as the reference does.  The
kernel first drops, per 256-ray block, the rows no ray of the block can
hit (`tile_cull_plain` is that predicate in plain PyTorch); the plain
version tests every row, with the same result.

The streamed raycast tests each 256-ray tile against only the
128-triangle chunks whose bounding sphere touches the tile's direction
cone (`pack_tables_stream`, `select_chunks`: plain PyTorch, as in the JAX
package), front to back, with a per-ray minimum distance for the
alpha-mask re-cast; `raycast_stream` launches `csrc/raycast_stream.cu`
for CUDA tensors and runs the plain version for CPU tensors.

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

LAUNCHES = 0
STREAM_LAUNCHES = 0


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


def hit_tests(d: Tensor, isect: Tensor):
    """The hit test of every ray against every row, (N, T) each: valid,
    and ud, vd, kk with the signed inverse determinant (t = kk * sinv)."""

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
    return valid, ud, vd, kk, sinv


def _halve(x: Tensor, dim: int) -> Tensor:
    """Pairwise sum along `dim` (a power of two) in the order of a warp's
    xor-shuffle reduction: element i adds i + half, halving each step."""
    while x.shape[dim] > 1:
        a, b = x.split(x.shape[dim] // 2, dim=dim)
        x = a + b
    return x.squeeze(dim)


def tile_cones(dirs: Tensor):
    """The direction cone of each TILE-ray block, in csrc/raycast.cu's
    float order: dirs (N, 3) -> axis (ntiles, 3), sin of the half-angle
    (ntiles,) and `wide` (ntiles,) where no cone narrower than a
    half-space bounds the block.  Rays of length 0 (and the padding of a
    ragged last block) cannot hit and do not widen the cone.  The half-
    angle's cosine is the least ray-axis dot product less CONE_SLACK,
    which exceeds its rounding error."""
    n = dirs.shape[0]
    nt = -(-n // TILE)
    d = torch.cat([dirs, dirs.new_zeros((nt * TILE - n, 3))])
    dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    live = dd > 0.0
    dn = torch.where(live[:, None], d / torch.sqrt(dd)[:, None], 0.0)
    # warp totals (32 lanes), then the block's 8 warp totals
    s = _halve(_halve(dn.reshape(nt, TILE // 32, 32, 3), 2), 1)
    norm = torch.sqrt(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1] + s[:, 2] * s[:, 2])
    axis = s / torch.clamp_min(norm, 1e-12)[:, None]
    a = axis.repeat_interleave(TILE, dim=0)
    dots = dn[:, 0] * a[:, 0] + dn[:, 1] * a[:, 1] + dn[:, 2] * a[:, 2]
    min_dot = torch.where(live, dots, BIG).reshape(nt, TILE).amin(dim=1)
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
    global LAUNCHES
    for x, shape in ((dirs, (dirs.shape[0], 3)), (origin, (3,)),
                     (isect, (isect.shape[0], NISECT)),
                     (attrs, (isect.shape[0], NATTR))):
        _build.require(x.is_cuda and x.dtype == torch.float32
                       and x.is_contiguous() and tuple(x.shape) == shape,
                       f"raycast kernel: expected contiguous float32 CUDA "
                       f"{shape}, got {tuple(x.shape)} {x.dtype}")
    _build.require(isect.data_ptr() % 16 == 0,
                   "raycast kernel: isect rows are read as float4s and must "
                   "be 16-byte aligned")
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


def raycast_stream_cuda(dirs: Tensor, origin: Tensor, isect: Tensor,
                        attrs: Tensor, lists: Tensor, counts: Tensor,
                        tmin: Tensor, miss: Tensor) -> Tensor:
    global STREAM_LAUNCHES
    n, tp, nrt = dirs.shape[0], isect.shape[0], counts.shape[0]
    for x, dt, shape in ((dirs, torch.float32, (n, 3)),
                         (origin, torch.float32, (3,)),
                         (isect, torch.float32, (tp, NISECT)),
                         (attrs, torch.float32, (tp, NATTR)),
                         (lists, torch.int32, (nrt, lists.shape[1])),
                         (counts, torch.int32, (nrt,)),
                         (tmin, torch.float32, (n,)),
                         (miss, torch.float32, (n,))):
        _build.require(x.is_cuda and x.dtype == dt and x.is_contiguous()
                       and tuple(x.shape) == shape,
                       f"streamed raycast kernel: expected contiguous {dt} "
                       f"CUDA {shape}, got {tuple(x.shape)} {x.dtype}")
    _build.require(n == nrt * TILE and tp % CHUNK == 0
                   and lists.shape[1] >= tp // CHUNK,
                   "streamed raycast kernel: one list row per 256 rays and "
                   "a CHUNK-padded table")
    out = torch.empty((n, NOUT), dtype=torch.float32, device=dirs.device)
    status = _build.library().vct_raycast_stream(
        dirs.data_ptr(), origin.data_ptr(), isect.data_ptr(),
        attrs.data_ptr(), lists.data_ptr(), lists.shape[1],
        counts.data_ptr(), tmin.data_ptr(), miss.data_ptr(), nrt,
        out.data_ptr(), _build.stream())
    _build.check(status, "vct_raycast_stream")
    STREAM_LAUNCHES += 1
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
