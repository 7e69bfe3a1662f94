"""The dense march's tap table on the card (core/dense.py march_plan,
ops/dense.py taps_cuda, csrc/dense.cu dense_kernel_taps): on the CPU the
launcher's arguments and refusals, march_plan's kernel route and
parallel/brick.py's slab plan, with the library stood in for by
core/dense.py tap_table; on a CUDA card the kernel's table bit for bit
against direction_taps at sponza256's operating point.  No JAX here: the
card has none."""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from vct_tpu_torch.config import preset
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.ops import _build
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import dense as OD
from vct_tpu_torch.parallel import brick as B
from vct_tpu_torch.render import shading as S

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4


@pytest.fixture
def card():
    """The CUDA card, decided when a test runs: the kernel has no CPU
    mode, so without a card the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def marches(cfg):
    """sponza256's three marches under `cfg`: (name, schedule,
    directions, march_plan keywords)."""
    light = np.asarray(cfg.light.direction, np.float64)
    basis = D.direction_basis(cfg.cones.field_basis).astype(np.float64)
    field = dict(field_dim=S.field_dim(cfg), max_alpha=cfg.cones.max_alpha,
                 occlusion_falloff=cfg.cones.occlusion_falloff)
    return [("light", S.shadow_schedule(cfg),
             (light / np.linalg.norm(light))[None],
             dict(field_dim=cfg.grid.dim, transmittance_only=True,
                  opacity_gain=cfg.shadow.opacity_gain)),
            ("diffuse", S.diffuse_schedule(cfg), basis, field),
            ("specular", S.specular_field_schedule(cfg), basis, field)]


def shapes(cfg, device):
    """Stand-ins for the pyramid, 6-direction above level 0 where the grid
    is anisotropic: march_plan reads each level's size and device alone."""
    six = (6,) if cfg.grid.anisotropic else ()
    return [torch.empty((cfg.grid.dim >> i, 1, 1) + (six if i else ())
                        + (4,), device=device)
            for i in range(cfg.grid.num_levels)]


def host_taps(mips, dirs, sched, world_size, compute, field_dim, **_):
    """direction_taps in Plan's row layout (nb, ntaps, 6 field_dim), and
    the extent make_plan takes from that table."""
    dims = [m.shape[0] for m in mips]
    _, groups = D.plan_groups(sched.lods, len(dims))
    idx, w = D.direction_taps(dirs, sched, groups, dims, field_dim,
                              world_size, compute)
    reach = idx.max(axis=(0, 3, 4)) + 1
    rows = (dirs.shape[0], idx.shape[1], -1)
    return (idx.reshape(rows), w.reshape(rows),
            OD.level_extent(reach, D.tap_levels(groups)))


class _FakeTaps:
    """The library's vct_dense_taps stood in for on the CPU: reads its
    arguments from the pointers as the card would and writes
    core/dense.py tap_table's rows to idx and w."""

    def __init__(self):
        self.calls = []

    def vct_dense_taps(self, dirs, nb, dist, dl, ntaps, n, world_size,
                       compute_bf16, idx, w, stream):
        def read(addr, kind, k):
            return np.array(ctypes.cast(addr, ctypes.POINTER(kind))[:k])

        d = read(dirs, ctypes.c_double, 3 * nb).reshape(nb, 3)
        ti, tw = D.tap_table(d, read(dist, ctypes.c_double, ntaps),
                             read(dl, ctypes.c_int, ntaps).astype(np.int64),
                             n, world_size,
                             torch.bfloat16 if compute_bf16 else torch.float32)
        for src, dst in ((np.ascontiguousarray(ti, np.int32), idx),
                         (np.ascontiguousarray(tw, np.float32), w)):
            ctypes.memmove(dst, src.ctypes.data, src.nbytes)
        self.calls.append((nb, ntaps, n, world_size, compute_bf16))
        return 0


class _OnCard:
    """A CPU tensor as _build.operand sees a card's: every check of the
    operand but its device."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


@pytest.fixture
def fake(monkeypatch):
    """The library stood in for by _FakeTaps, and the CPU standing in for
    the card in _build.operand's checks."""
    lib = _FakeTaps()
    operand = _build.operand
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(_build, "operand",
                        lambda x, *a: operand(_OnCard(x), *a))
    return lib


def _tap_operands(n=12):
    return torch.linspace(1.0, 40.0, n, dtype=torch.float64), torch.full(
        (n,), 32, dtype=torch.int32)


TAP_REFUSALS = {
    "strided dist": lambda d, l: (torch.repeat_interleave(d, 2)[::2], l,
                                  torch.float32),
    "float32 dist": lambda d, l: (d.float(), l, torch.float32),
    "int64 dl": lambda d, l: (d, l.long(), torch.float32),
    "short dl": lambda d, l: (d, l[:-1], torch.float32),
    "2-d dist": lambda d, l: (d[None], l, torch.float32),
    "float16 compute": lambda d, l: (d, l, torch.float16),
}


@pytest.mark.parametrize("case", sorted(TAP_REFUSALS))
def test_taps_cuda_refuses_bad_operands(fake, case):
    """taps_cuda checks dist and dl as every wrapper checks its operands
    (_build.operand: contiguous, dtype, shape; the CPU stands in for the
    card) and the compute dtype, and launches nothing when one fails."""
    dist, dl, compute = TAP_REFUSALS[case](*_tap_operands())
    before = _build.launches()
    with pytest.raises(ValueError, match="dense march taps"):
        OD.taps_cuda(np.eye(3), dist, dl, 8, 150.0, compute)
    assert _build.launches() == before and not fake.calls


@pytest.mark.parametrize("which", ["dist", "dl"])
def test_taps_cuda_refuses_host_operands(which):
    """Without a stand-in, a CPU dist or dl is refused before any pointer
    reaches the kernel."""
    dist, dl = _tap_operands()
    if which == "dl":
        dist = _OnCard(dist)
    with pytest.raises(ValueError, match=f"dense march taps: {which}"):
        OD.taps_cuda(np.eye(3), dist, dl, 8, 150.0, torch.float32)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb", [1, 26, 64, 70, 130])
def test_taps_cuda_launches_once_per_64_directions(fake, nb, compute):
    """taps_cuda's arguments, with the library stood in for: each launch
    takes at most MAX_TAP_DIRECTIONS directions by value and writes its
    slab of the table; together they give direction_taps' table."""
    cfg = dataclasses.replace(preset("sponza256"), grid=dataclasses.replace(
        preset("sponza256").grid, dim=32))
    mips = shapes(cfg, "cpu")
    _, sched, _, kw = marches(cfg)[1]
    rng = np.random.default_rng(nb)
    dirs = rng.normal(size=(nb, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dims = [m.shape[0] for m in mips]
    _, groups = D.plan_groups(sched.lods, len(dims))
    dist, dl = D.tap_geometry(sched, groups, dims)
    before = _build.launches()
    idx, w = OD.taps_cuda(dirs, torch.as_tensor(dist),
                          torch.as_tensor(dl, dtype=torch.int32),
                          kw["field_dim"], cfg.grid.world_size, compute)
    after = _build.launches()
    launches = -(-nb // OD.MAX_TAP_DIRECTIONS)
    assert after["dense_taps"] - before["dense_taps"] == launches
    assert {k: v for k, v in after.items() if k != "dense_taps"} == {
        k: v for k, v in before.items() if k != "dense_taps"}
    assert [c[0] for c in fake.calls] == [
        min(OD.MAX_TAP_DIRECTIONS, nb - b0)
        for b0 in range(0, nb, OD.MAX_TAP_DIRECTIONS)]
    assert all(c[1:] == (len(dist), kw["field_dim"], cfg.grid.world_size,
                         int(compute == torch.bfloat16)) for c in fake.calls)
    want_i, want_w, _ = host_taps(mips, dirs, sched, cfg.grid.world_size,
                                  compute, **kw)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert np.array_equal(idx.numpy(), want_i)
    assert np.array_equal(w.numpy(), want_w)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["light", "diffuse", "specular"])
def test_kernel_route_plan_equals_the_cpu_plan(fake, monkeypatch, which,
                                               compute):
    """march_plan with the kernel's route taken (uses_kernel forced, the
    library stood in for): one dense_taps launch a call, and the Plan of
    the CPU route field for field."""
    cfg = dataclasses.replace(preset("sponza256"), grid=dataclasses.replace(
        preset("sponza256").grid, dim=32))
    mips = shapes(cfg, "cpu")
    _, sched, dirs, kw = {m[0]: m for m in marches(cfg)}[which]
    want = D.march_plan(mips, dirs, sched, cfg.grid.world_size,
                        compute_dtype=compute, **kw)
    monkeypatch.setattr(_build, "uses_kernel", lambda *t: True)
    before = _build.launches()["dense_taps"]
    got = D.march_plan(mips, dirs, sched, cfg.grid.world_size,
                       compute_dtype=compute, **kw)
    assert _build.launches()["dense_taps"] - before == 1
    for f in dataclasses.fields(OD.Plan):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (torch.equal(a, b) if isinstance(b, torch.Tensor)
                else a == b), f.name


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("anisotropic", [False, True])
def test_card_taps_equal_direction_taps(card, anisotropic, compute):
    """On the card: the kernel's table for the three marches of sponza256
    and of its anisotropic variant (sponza256_aniso) at the operating
    point (256^3 light volume, 128^3 fields) and for 64 suns equals
    direction_taps bit for bit, and the plan's extent equals the host
    build's."""
    cfg = preset("sponza256")
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, anisotropic=anisotropic))
    mips = shapes(cfg, card)
    rng = np.random.default_rng(64)
    suns = rng.normal(size=(64, 3))
    suns[:, 1] = np.abs(suns[:, 1])
    suns /= np.linalg.norm(suns, axis=1, keepdims=True)
    runs = marches(cfg) + [("light", marches(cfg)[0][1], s[None],
                            marches(cfg)[0][3]) for s in suns]
    for which, sched, dirs, kw in runs:
        plan = D.march_plan(mips, dirs, sched, cfg.grid.world_size,
                            compute_dtype=compute, **kw)
        want_i, want_w, extent = host_taps(mips, dirs, sched,
                                           cfg.grid.world_size, compute,
                                           **kw)
        assert np.array_equal(plan.idx.cpu().numpy(), want_i), which
        assert np.array_equal(plan.w.cpu().numpy(), want_w), which
        assert plan.extent == extent, which


def _host_slab(mips, blocks, dirs, sched, ws, df, xs, base, **kw):
    """The slab plan as parallel/brick.py built it on the host: the whole
    table from direction_taps, its x rows sliced and rebased in numpy,
    every table through ops/dense.make_plan."""
    dims = [m.shape[0] for m in mips]
    lod_plan, groups = D.plan_groups(sched.lods, len(dims))
    levels = D.tap_levels(groups)
    idx, w = D.direction_taps(dirs, sched, groups, dims, df, ws,
                              mips[0].dtype)
    x = slice(*xs)
    ix = idx[:, :, 0, :, x].copy()
    for j, lvl in enumerate(levels):
        ix[:, j] = np.clip(ix[:, j] - base[lvl], 0, blocks[lvl].shape[0] - 1)
    return OD.make_plan(
        [(ix, w[:, :, 0, :, x]), (idx[:, :, 1], w[:, :, 1]),
         (idx[:, :, 2], w[:, :, 2])], levels,
        D.step_table(sched, lod_plan, groups,
                     kw.get("occlusion_falloff", 0.03)), dirs,
        (xs[1] - xs[0], df, df), mips[0].device, mips[0].dtype,
        sched.step_factor, kw.get("max_alpha", 0.95),
        kw.get("opacity_gain", 1.0), kw.get("transmittance_only", False))


SLAB_MARCHES = {
    # tests/test_torch_brick.py's shadow march: level 0 shards at 32^3
    "shadow": (np.asarray([[0.0, 0.97014254, 0.24253564]]),
               lambda: M.march_schedule(0.2, 150.0 / 32, 150.0, 12,
                                        step_factor=0.5),
               dict(opacity_gain=4.0, transmittance_only=True)),
    # its gather march: one direction along the sharded axis
    "gather": (np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                           [0.6, -0.64, 0.48]]),
               lambda: M.march_schedule(0.577, 150.0 / 32, 75.0, 12), {}),
}


@pytest.mark.parametrize("route", ["host", "kernel"])
@pytest.mark.parametrize("n,row0", [(2, 0), (2, 1), (4, 0), (4, 2), (4, 3)])
@pytest.mark.parametrize("march", sorted(SLAB_MARCHES))
def test_slab_plan_equals_the_host_slab(fake, monkeypatch, march, n, row0,
                                        route):
    """brick.slab_plan (the whole table from tap_rows, its x rows cut and
    rebased on the levels' device, the extent from the slab's last rows)
    gives the Plan of brick's former host build field for field, on the
    CPU's route and, with the library stood in for, on the kernel's (one
    dense_taps launch)."""
    dirs, sched, kw = SLAB_MARCHES[march]
    dirs, sched, df, ws = dirs / np.linalg.norm(dirs, axis=1,
                                                keepdims=True), sched(), 32, 150.0
    mips = [torch.empty((32 >> i, 1, 1, 4)) for i in range(6)]
    dims = [m.shape[0] for m in mips]
    halos, sharded = B.shard_plan(dirs, sched, dims, ws, n, 4)
    assert any(sharded.values())
    blocks = [torch.empty((dl // n + 2 * halos[lvl], 1, 1, 4))
              if sharded[lvl] else mips[lvl] for lvl, dl in enumerate(dims)]
    base = [row0 * (dl // n) - halos[lvl] if sharded[lvl] else 0
            for lvl, dl in enumerate(dims)]
    xs = (row0 * (df // n), (row0 + 1) * (df // n))
    if route == "kernel":
        monkeypatch.setattr(_build, "uses_kernel", lambda *t: True)
    before = _build.launches()["dense_taps"]
    got = B.slab_plan(mips, blocks, dirs, sched, ws, df, xs, base, **kw)
    assert _build.launches()["dense_taps"] - before == (route == "kernel")
    want = _host_slab(mips, blocks, dirs, sched, ws, df, xs, base, **kw)
    for f in dataclasses.fields(OD.Plan):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a.dtype == b.dtype and torch.equal(a, b)
                if isinstance(b, torch.Tensor) else a == b), f.name
