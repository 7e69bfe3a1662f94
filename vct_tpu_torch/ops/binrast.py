"""Binned closest-hit raycast for large scenes (kernel 7; replaces
vct_tpu/ops/binrast_pallas.py raycast_pinhole_binned).

The frame raycast above raycast.MAX_TRIANGLES.  Its work scales with the
triangles that project onto each part of the screen, not with rays x
triangles:

  1. `bin_triangles` (plain PyTorch on the device, as XLA in the JAX
     package) projects every triangle gnomonically in a frame built from
     the ray grid, clips it against the near plane z = ZEPS, and bins it
     to the 16x64-pixel strips (STRIPE rays, four consecutive 16x16 tiles
     of render/fast.py's tile-major order) its screen box overlaps.
     Triangles over at most KA strips, or KB within the medium budget, go
     to per-strip bins; wider ones to per-column bins.  One sort of the
     (bin, triangle) pairs puts each bin's triangles in one SEGAL-aligned
     segment of a row table (NP, 16).
  2. `raycast_binned` walks, for each strip, its own segment and then its
     column's, GANGW rows at a time, and keeps the first minimum in walk
     order; `csrc/binrast.cu` fuses the G-buffer row (`finish_binned`)
     into the walk.  The kernel walks each 16x16 tile of a strip on its
     own and first drops the rows the tile's direction cone cannot hit
     (`walk_cull_plain` states which, in the kernel's float order); the
     plain walk tests every row, with the same result.  It has no
     backward, as binrast_pallas has no VJP: with grad mode on, inputs
     that require grad are refused on every device.

Testing a superset of a strip's triangles is always safe, since the
winner is the minimum: a gang that runs past its segment into the next
bin's rows only adds real triangles (binrast_pallas.py:40-45).

Everything is the JAX package's function, in exact float32: its matvecs,
norms and crosses are written out term by term (no matmul, so no TF32),
and where it sorts (bin << 19) | triangle words the port does too, so a
bin's rows come in the same order and exact-t ties go the same way.  The
JAX package's compare-sum searchsorted (a TPU workaround) is
torch.searchsorted over the same nondecreasing envelopes.  Binning reads
no value back to the host.

Not carried over: `scene_tfar` (binrast_pallas.py:517), which has no
caller, and the VCT_RAYCAST=stream route of the JAX frame path.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render.gbuffer import DeviceScene

Tensor = torch.Tensor

STRIPE = 1024        # rays per strip: one 16x64-pixel screen strip
GANGW = 256          # table rows per step of a strip's walk
SEGAL = 128          # segment alignment in the row table
KA = 4               # strip slots per triangle in the dense emission
KB = 16              # strip slots per triangle in the medium emission
KC = 32              # column slots per triangle (frames up to 2048 px wide)
ZEPS = 1e-3          # near-plane clip distance (world units)
NOUT8 = 8            # raycast_binned_plain row: t, id, u, v, hit, 0, 0, 0
SENTINEL = 0x7FFFFFFF  # packed word of an unused slot: sorts last
MAX_IDS = 1 << 24    # triangle ids ride in a float32 column: exact below
PLAIN_TESTS = 1 << 25  # hit tests per batch of the plain walk (memory)

LAUNCHES = 0


def _budgets(t_real: int) -> Tuple[int, int]:
    """Static emission budgets (medium, column), scaled with the scene."""
    nb_med = min(max(16384, t_real // 12), t_real)
    nb_col = min(max(8192, t_real // 32), t_real)
    return nb_med, nb_col


def dropped(n_col_total: Tensor, t_real: int) -> Tensor:
    """bin_triangles' column-tier triangles beyond the column budget, the
    ones it drops (0-d, on the device)."""
    return torch.clamp_min(n_col_total - _budgets(t_real)[1], 0)


def _check_ids(t: int) -> None:
    if t > MAX_IDS:
        raise ValueError(f"{t} triangles: the binned raycast carries "
                         f"triangle ids as float32, exact for at most "
                         f"{MAX_IDS}")


def pack_rows(ds: DeviceScene, origin: Tensor,
              albedo: Optional[Tensor] = None,
              specular: Optional[Tensor] = None,
              shininess: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """raycast.pack_tables with the triangle id in isect column 10:
    (isect (T, 16), attrs (T, 48)).  The JAX package concatenates the two
    into one (Tp, 64) table and writes the id when it gathers rows."""
    _check_ids(ds.v0.shape[0])
    isect, attrs = RP.pack_tables(ds, origin, albedo, specular, shininess)
    isect[:, 10] = torch.arange(isect.shape[0], dtype=torch.float32,
                                device=isect.device)
    return isect, attrs


def _mv(a: Tensor, b: Tensor) -> Tensor:
    """a (..., 3) . b (3,), each product and sum rounded on its own."""
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])


def _gnomonic_frame(dflat: Tensor, dimg: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Orthonormal (ex, ey, f): f the mean ray, ex along the image x axis."""
    f = dflat.sum(dim=0)
    f = f / torch.clamp_min(_norm(f), 1e-12)
    ex = (dimg[:, -1] - dimg[:, 0]).sum(dim=0)
    ex = ex - _mv(ex, f) * f
    ex = ex / torch.clamp_min(_norm(ex), 1e-12)
    ey = RP._cross(f[None], ex[None])[0]
    return ex, ey, f


def _rev_cummin(x: Tensor) -> Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [0]), dim=0).values, [0])


def _sort_slots(bins_all: Tensor, tris_all: Tensor, t_real: int,
                nbins: int) -> Tuple[Tensor, Tensor]:
    """(bin, triangle) slots sorted by bin; unused slots (bin >= nbins)
    last.  Below 2**19 triangles the pairs pack into one int32 word and
    sort by value, so a bin's triangles ascend by id; above, a stable sort
    on the bin keeps emission order (binrast_pallas.py:264-275)."""
    if t_real < (1 << 19):
        words = torch.where(bins_all >= nbins, SENTINEL,
                            (bins_all << 19) | tris_all)
        sw = torch.sort(words).values
        unused = sw == SENTINEL
        return (torch.where(unused, nbins, sw >> 19),
                torch.where(unused, 0, sw & 0x7FFFF))
    sorted_bin, perm = torch.sort(bins_all, stable=True)
    return sorted_bin, tris_all[perm]


def bin_triangles(ds: DeviceScene, origin: Tensor, dflat: Tensor,
                  dimg: Tensor, isect: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Screen-space binning -> per-strip contiguous triangle segments.

    dflat: (ns*STRIPE, 3) unit rays in tile-major order; dimg: the same
    rays as the padded (hp, wp, 3) image (hp % 16 == 0, wp % 64 == 0);
    isect: pack_rows's (T, 16) table.

    Returns scal (4, ns) int32 [strip-segment row offset, strip gangs,
    column-segment row offset, column gangs], the row table (NP, 16) (the
    JAX package's isect_p, transposed) and n_col_total, a 0-d tensor.
    Budgets overflow conservatively: medium overflow joins the column
    tier, and column overflow beyond the column budget is dropped from
    binning (dropped(n_col_total, T) counts them)."""
    hp, wp = dimg.shape[:2]
    if hp % 16 or wp % 64:
        raise ValueError(f"padded image {hp}x{wp}: need hp % 16 == 0 and "
                         "wp % 64 == 0")
    srows, scols = hp // 16, wp // 64
    if scols > KC:
        raise ValueError(f"{scols} strip columns: raise KC for frames wider "
                         f"than {64 * KC} px")
    ns = srows * scols
    _check_ids(ds.v0.shape[0])
    if dflat.shape[0] != ns * STRIPE:
        raise ValueError(f"{dflat.shape[0]} rays for {ns} strips")
    dev = dflat.device
    i32 = dict(dtype=torch.int32, device=dev)

    ex, ey, f = _gnomonic_frame(dflat, dimg)

    # --- strip rects from their own rays (+ one-pixel margin) ---
    z = _mv(dflat, f)
    u = _mv(dflat, ex) / z
    v = _mv(dflat, ey) / z
    pu = (u.max() - u.min()) / wp
    pv = (v.max() - v.min()) / hp
    us = u.reshape(ns, STRIPE)
    vs = v.reshape(ns, STRIPE)
    # sign so strip-grid columns ascend in u and rows ascend in v
    ucol = us.mean(dim=1).reshape(srows, scols)
    vrow = vs.mean(dim=1).reshape(srows, scols)
    su = torch.where(ucol[0, 0] <= ucol[0, -1], 1.0, -1.0)
    sv = torch.where(vrow[0, 0] <= vrow[-1, 0], 1.0, -1.0)
    us = us * su
    vs = vs * sv
    s_ulo = us.amin(dim=1) - pu
    s_uhi = us.amax(dim=1) + pu
    s_vlo = vs.amin(dim=1) - pv
    s_vhi = vs.amax(dim=1) + pv

    # monotone column/row envelopes: prefix-max his, suffix-min los
    col_hi = torch.cummax(s_uhi.reshape(srows, scols).amax(dim=0),
                          dim=0).values
    row_hi = torch.cummax(s_vhi.reshape(srows, scols).amax(dim=1),
                          dim=0).values
    col_lo = _rev_cummin(s_ulo.reshape(srows, scols).amin(dim=0))
    row_lo = _rev_cummin(s_vlo.reshape(srows, scols).amin(dim=1))

    # --- triangle screen boxes with near-plane clipping ---
    t_real = ds.v0.shape[0]
    verts = torch.stack([ds.v0, ds.v0 + ds.e1, ds.v0 + ds.e2],
                        dim=1) - origin[None, None, :]        # (T, 3, 3)
    vz = _mv(verts, f)                                         # (T, 3)
    front = vz > ZEPS
    all_behind = ~front.any(dim=1)
    # candidates: the 3 vertices (where in front) and the 3 edge crossings
    # of z = ZEPS (where the edge straddles the plane)
    e_b = torch.roll(verts, -1, dims=1)
    zb = torch.roll(vz, -1, dims=1)
    crossing = front ^ torch.roll(front, -1, dims=1)
    dz = zb - vz
    w = (ZEPS - vz) / torch.where(torch.abs(dz) < 1e-20, 1e-20, dz)
    pcross = verts + w[..., None] * (e_b - verts)
    cand = torch.cat([verts, pcross], dim=1)                   # (T, 6, 3)
    cval = torch.cat([front, crossing], dim=1)                 # (T, 6)
    cz = torch.clamp_min(_mv(cand, f), ZEPS)
    cu = _mv(cand, ex) / cz * su
    cv = _mv(cand, ey) / cz * sv
    t_ulo = torch.where(cval, cu, RP.BIG).amin(dim=1)
    t_uhi = torch.where(cval, cu, -RP.BIG).amax(dim=1)
    t_vlo = torch.where(cval, cv, RP.BIG).amin(dim=1)
    t_vhi = torch.where(cval, cv, -RP.BIG).amax(dim=1)

    # counts of envelope entries below (left) or at-or-below (right)
    jmin = torch.clamp(torch.searchsorted(col_hi, t_ulo), 0, scols - 1)
    jmax = torch.searchsorted(col_lo, t_uhi, right=True) - 1
    imin = torch.clamp(torch.searchsorted(row_hi, t_vlo), 0, srows - 1)
    imax = torch.searchsorted(row_lo, t_vhi, right=True) - 1
    nw = torch.clamp_min(jmax - jmin + 1, 0)
    nh = torch.clamp_min(imax - imin + 1, 0)
    area = torch.where(all_behind, 0, nw * nh)

    # three emission tiers: strip slots (dense + budgeted medium) and
    # per-column slots for the wide tail
    nb_med, nb_col = _budgets(t_real)
    is_a = (area >= 1) & (area <= KA)
    is_m0 = (area > KA) & (area <= KB)
    m_over = is_m0 & (torch.cumsum(is_m0.int(), 0) > nb_med)
    is_m = is_m0 & ~m_over
    is_c0 = ((area > KB) | m_over) & ~all_behind & (nw >= 1) & (nh >= 1)
    is_c = is_c0 & (torch.cumsum(is_c0.int(), 0) <= nb_col)
    n_col_total = is_c0.sum()

    def emit(slots, jmn, jmx, imn, tri_ids, valid, cap, col_tier):
        kk = torch.arange(cap, device=dev)[None, :]
        if col_tier:             # bins [ns, ns+scols): one per column
            binid = ns + jmn[:, None] + kk
        else:
            ww = torch.clamp_min(jmx - jmn + 1, 1)[:, None]
            binid = ((imn[:, None] + kk // ww) * scols
                     + jmn[:, None] + kk % ww)
        ok = valid[:, None] & (kk < slots[:, None])
        binid = torch.where(ok, binid, ns + scols).to(torch.int32)
        tri = tri_ids[:, None].expand(binid.shape).to(torch.int32)
        return binid.reshape(-1), tri.reshape(-1)

    tri_ids = torch.arange(t_real, device=dev)
    ta, ra = emit(area, jmin, jmax, imin, tri_ids, is_a, KA, False)
    # one stable argsort selects both budgeted tiers; the column tier
    # starts at the device-side count of medium triangles, clamped as
    # lax.dynamic_slice clamps its start
    key3 = torch.where(is_m, 0, torch.where(is_c, 1, 2))
    order = torch.argsort(key3, stable=True)
    m_sel = order[:nb_med]
    start = torch.clamp_max(is_m.sum(), t_real - nb_col)
    c_sel = order[start + torch.arange(nb_col, device=dev)]
    tm, rm = emit(area[m_sel], jmin[m_sel], jmax[m_sel], imin[m_sel],
                  m_sel, is_m[m_sel], KB, False)
    tc, rc = emit(nw[c_sel], jmin[c_sel], jmax[c_sel], imin[c_sel],
                  c_sel, is_c[c_sel], KC, True)
    bins_all = torch.cat([ta, tm, tc])
    tris_all = torch.cat([ra, rm, rc])
    nbins = ns + scols
    sorted_bin, sorted_tri = _sort_slots(bins_all, tris_all, t_real, nbins)

    # per-bin segments (strips then columns), SEGAL-aligned in the table
    bounds = torch.searchsorted(sorted_bin, torch.arange(nbins + 1, **i32))
    c_i = bounds[1:] - bounds[:-1]
    p_i = (c_i + SEGAL - 1) // SEGAL * SEGAL
    pad_off = torch.cat([torch.zeros(1, dtype=p_i.dtype, device=dev),
                         torch.cumsum(p_i, 0)])               # (nbins+1,)
    slots_total = bins_all.shape[0]
    np_rows = slots_total + SEGAL * nbins + GANGW             # static bound

    # table row -> source slot: src = row - (pad_off[bin] - bounds[bin]),
    # a piecewise-constant shift built by adding each boundary's step and
    # a cumulative sum.  A padding row's src points at the next bin's
    # slots (or an unused slot, whose triangle is still real): testing
    # extra real triangles is conservative.
    bnd = pad_off[1:nbins]
    shift = pad_off[:nbins] - bounds[:nbins]
    steps = torch.zeros(np_rows, dtype=shift.dtype, device=dev)
    steps.index_add_(0, bnd, shift[1:] - shift[:-1])
    padmb = torch.cumsum(steps, 0) + shift[0]
    src = torch.clamp(torch.arange(np_rows, device=dev) - padmb, 0,
                      slots_total - 1)
    table = isect[sorted_tri.long()[src]]                      # (NP, 16)

    gseg = (p_i[:ns] + GANGW - 1) // GANGW
    col_of = ns + torch.arange(ns, device=dev) % scols
    gcol = (p_i[col_of] + GANGW - 1) // GANGW
    scal = torch.stack([pad_off[:ns], gseg, pad_off[col_of], gcol]).to(
        torch.int32)
    return scal.contiguous(), table, n_col_total


def _batches(scal: Tensor, per_row: int) -> Iterator[Tuple[Tensor, int]]:
    """Strips in batches of similar walk length, shortest first: (strips,
    the longest walk's length), each batch at most PLAIN_TESTS / per_row
    padded walk rows (or one strip).  Empty walks are skipped."""
    gangs = (scal[1] + scal[3]).long()
    by_len = torch.argsort(gangs, stable=True)
    glen = gangs[by_len].tolist()
    s, ns = 0, len(glen)
    while s < ns:
        e = s + 1          # grow the batch while its padded walk fits
        while (e < ns
               and (e + 1 - s) * per_row * GANGW * glen[e] <= PLAIN_TESTS):
            e += 1
        if glen[e - 1]:
            yield by_len[s:e], glen[e - 1] * GANGW
        s = e


def _walk(scal: Tensor, strips: Tensor, length: int) -> Tuple[Tensor, Tensor]:
    """Table rows of each strip's walk, padded to `length`: (rows, live),
    both (len(strips), length)."""
    off, gseg, coff, gcol = (scal[k, strips].long()[:, None]
                             for k in range(4))
    pos = torch.arange(length, device=scal.device)[None, :]
    seg_len = gseg * GANGW
    rows = torch.where(pos < seg_len, off + pos, coff + pos - seg_len)
    live = pos < (gseg + gcol) * GANGW
    return torch.where(live, rows, 0), live


def raycast_binned_plain(dflat: Tensor, scal: Tensor,
                         table: Tensor) -> Tensor:
    """Plain PyTorch version of the walk: (ns*STRIPE, 3) rays ->
    (ns*STRIPE, 8) rows [t, triangle id, u, v, hit, 0, 0, 0], the JAX
    package's raycast_binned output (t = BIG, the rest 0 on a miss).
    Each strip's rays meet every row of its walk at once; the winner is
    the smallest t, ties to the earliest walk position.  Strips go in
    batches of similar walk length, at most PLAIN_TESTS hit tests each
    (or one strip)."""
    n = dflat.shape[0]
    dev = dflat.device
    out = torch.zeros((n, NOUT8), dtype=torch.float32, device=dev)
    out[:, 0] = RP.BIG
    for strips, length in _batches(scal, STRIPE):
        rows, live = _walk(scal, strips, length)
        tri = table[rows]                                     # (B, L, 16)
        ray = (strips[:, None] * STRIPE
               + torch.arange(STRIPE, device=dev)[None, :])   # (B, STRIPE)
        d = dflat[ray][:, :, None, :]                         # (B, S, 1, 3)

        def dot3(c0):
            return (d[..., 0] * tri[:, None, :, c0]
                    + d[..., 1] * tri[:, None, :, c0 + 1]
                    + d[..., 2] * tri[:, None, :, c0 + 2])

        det, ud, vd = dot3(0), dot3(3), dot3(6)
        kk = tri[:, None, :, 9]
        sgn = torch.sign(det)
        ad = torch.abs(det)
        sinv = sgn * (1.0 / torch.clamp_min(ad, RP.EPS))
        valid = ((ad > RP.EPS) & (sgn * ud >= 0) & (sgn * vd >= 0)
                 & (sgn * (ud + vd) <= ad) & (sgn * kk > RP.TMIN_EPS * ad)
                 & live[:, None, :])
        tcand = torch.where(valid, kk * sinv, RP.BIG)
        tbest = tcand.amin(dim=2, keepdim=True)
        pos = torch.arange(length, device=dev)
        first = torch.where(tcand == tbest, pos, length).amin(dim=2,
                                                               keepdim=True)
        hit = tbest < RP.BIG
        win = torch.gather(tri[:, None, :, 10].expand(-1, STRIPE, -1), 2,
                           first)

        def pick(x):
            return torch.where(hit, torch.gather(x * sinv, 2, first), 0.0)

        res = torch.cat([tbest, torch.where(hit, win, 0.0), pick(ud),
                         pick(vd), hit.float()], dim=2)
        out[ray.reshape(-1), :5] = res.reshape(-1, 5)
    return out


def walk_cull_plain(dflat: Tensor, scal: Tensor, table: Tensor) -> Tensor:
    """Which rows of its strip's walk each 256-ray tile of csrc/binrast.cu
    keeps: (ntiles, L) bool over walk positions, L the longest walk
    (positions past a strip's walk are False), in the kernel's float order:
    the tile's cone (raycast.tile_cones) against each row's half-spaces
    (raycast.cull_rows, which states why a dropped row never hits).  Rows
    at or past the table's end are dropped; a wide tile keeps the rest."""
    tps = STRIPE // RP.TILE                   # tiles a strip
    ns = dflat.shape[0] // STRIPE
    axis, sin_a, wide = RP.tile_cones(dflat)
    length = int((scal[1] + scal[3]).max()) * GANGW if ns else 0
    keep = torch.zeros((ns * tps, length), dtype=torch.bool,
                       device=dflat.device)
    for strips, walk in _batches(scal, tps * RP.NISECT):
        rows, live = _walk(scal, strips, walk)
        live = live & (rows < table.shape[0])
        tiles = strips[:, None] * tps + torch.arange(tps, device=dflat.device)
        k = RP.cull_rows(axis[tiles][:, :, None], sin_a[tiles][:, :, None],
                         wide[tiles][:, :, None],
                         table[torch.where(live, rows, 0)][:, None])
        keep[tiles.reshape(-1), :walk] = (k & live[:, None]).reshape(-1, walk)
    return keep


def finish_binned(dflat: Tensor, origin: Tensor, out8: Tensor,
                  attrs: Tensor) -> Tensor:
    """Winner rows -> the (n, NOUT) G-buffer (raycast_gbuf24's columns):
    gather each hit's attribute row and interpolate."""
    hit = out8[:, 4:5] > 0.5
    tri = torch.clamp(out8[:, 1].long(), 0, attrs.shape[0] - 1)
    arow = torch.where(hit, attrs[tri], 0.0)
    u = torch.where(hit, out8[:, 2:3], 0.0)
    v = torch.where(hit, out8[:, 3:4], 0.0)
    return RP._finish_gbuf(dflat, origin, out8[:, 0:1], u, v, arow)


def raycast_binned_cuda(dflat: Tensor, origin: Tensor, scal: Tensor,
                        table: Tensor, attrs: Tensor,
                        kept: Optional[Tensor] = None) -> Tensor:
    """Launch csrc/binrast.cu: the (n, NOUT) G-buffer.  kept: an optional
    (n // 256,) int32 tensor that receives each tile's count of the walk
    rows its cull kept (walk_cull_plain's row sums).  It exists only so
    that chip_smoke.py can show that the culled bound counts the tests the
    kernel makes; the frame path never passes it, and no caller should."""
    global LAUNCHES
    n = dflat.shape[0]
    ns = n // STRIPE
    checks = [(dflat, torch.float32, (ns * STRIPE, 3)),
              (origin, torch.float32, (3,)),
              (scal, torch.int32, (4, ns)),
              (table, torch.float32, (table.shape[0], RP.NISECT)),
              (attrs, torch.float32, (attrs.shape[0], RP.NATTR))]
    if kept is not None:
        checks.append((kept, torch.int32, (n // RP.TILE,)))
    for x, dt, shape in checks:
        _build.require(x.is_cuda and x.dtype == dt and x.is_contiguous()
                       and tuple(x.shape) == shape,
                       f"binned raycast kernel: expected contiguous {dt} "
                       f"CUDA {shape}, got {tuple(x.shape)} {x.dtype}")
    _build.require(ns > 0 and table.shape[0] < 2 ** 31
                   and table.data_ptr() % 16 == 0,
                   "binned raycast kernel: one strip of rays at least and "
                   "a 16-byte aligned table (rows are read as float4s) of "
                   "fewer than 2**31 rows")
    out = torch.empty((n, RP.NOUT), dtype=torch.float32, device=dflat.device)
    status = _build.library().vct_binrast(
        dflat.data_ptr(), origin.data_ptr(), scal.data_ptr(), ns,
        table.data_ptr(), table.shape[0], attrs.data_ptr(), out.data_ptr(),
        None if kept is None else kept.data_ptr(), _build.stream())
    _build.check(status, "vct_binrast")
    LAUNCHES += 1
    return out


def raycast_binned(dflat: Tensor, origin: Tensor, scal: Tensor,
                   table: Tensor, attrs: Tensor) -> Tensor:
    """Binned closest hit -> (n, NOUT) G-buffer, from bin_triangles's
    scal and table and pack_rows's attrs."""
    kernel = _build.uses_kernel(dflat, origin, scal, table, attrs)
    _build.refuse_grad("the binned raycast (raycast_binned)", dflat, origin,
                       table, attrs)
    if kernel:
        return raycast_binned_cuda(dflat, origin, scal, table, attrs)
    return finish_binned(dflat, origin,
                         raycast_binned_plain(dflat, scal, table), attrs)


def raycast_pinhole_binned(ds: DeviceScene, origin: Tensor, dflat: Tensor,
                           dimg: Tensor,
                           albedo: Optional[Tensor] = None,
                           specular: Optional[Tensor] = None,
                           shininess: Optional[Tensor] = None) -> Tensor:
    """The whole pipeline: pack + bin + walk -> (n, NOUT) G-buffer.  dflat
    is the tile-major flattening of dimg's rays; all share `origin`."""
    isect, attrs = pack_rows(ds, origin, albedo, specular, shininess)
    scal, table, _ = bin_triangles(ds, origin, dflat, dimg, isect)
    return raycast_binned(dflat, origin, scal, table, attrs)
