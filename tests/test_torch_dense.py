"""Kernel 9, the direction-major dense march (vct_tpu_torch/ops/dense.py,
csrc/dense.cu), on the CPU: its tap table, its plain version against the
JAX package's directional_march_multi, its dispatch and its autograd
Function.  The CUDA kernel is held to the plain version on the card by
chip_smoke.py.

Bounds:
  * the tap table (core/dense.direction_taps, every direction at once):
    equal to the bit to a table built one (direction, tap, axis) at a
    time from the JAX package's _axis_indices, with the clamped rows'
    weights merged and rounded to the compute dtype as the march rounds
    them;
  * the plain march fed from the table against JAX's under jax.jit, as
    the JAX package runs it (eager JAX evaluates x ** 0.5 as a pow one
    ulp away from the square root on some inputs, and the
    optical-depth correction's 1 - keep magnifies it): atol 1e-6 on
    values of order 1, tests/test_torch_host.py's dense bound, in float32 and
    bfloat16, transmittance and field mode, isotropic and anisotropic
    stacks, step factors 0.5, 1 and 2;
  * _build.Replay with the plain version injected: gradients within 1e-6 of
    the largest gradient of autograd through the plain version, and no
    gradient edge to a level no tap reads;
  * the packed copy the kernel reads (pack_levels_plain): the plain march
    over it equal to the bit to the plain march over the levels; the
    wrapper's host side (level_slots, pack_levels_cuda with the library
    stood in for, level_table) packing exactly the levels the kernel
    cannot read as they are, into aligned, disjoint slots of one buffer;
  * the plan's two halves (core/dense.py march_plan): the memoised route
    equal field for field to the host build, on a hit and on a miss; a
    hit on a repeat under another direction and a miss on a change of
    every value the direction-free half is keyed on; the extent from each
    row's last cell equal to make_plan's from the whole table.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import aniso as JA
from vct_tpu.core import dense as JD
from vct_tpu.core import grid as JG
from vct_tpu.core import march as JM
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import dense as OD
from vct_tpu_torch.render import shading as S

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

WS = 150.0
DIM = 16


def pyramid(aniso: bool, seed: int = 3):
    """The same random 16^3 stack for both packages, as the voxel build
    makes one (render/voxelize.splat_finish): alpha the occupancy, 0 or
    1, on a tenth of the cells, rgb a color in occupied cells and 0 in
    empty ones: (JAX levels, port levels)."""
    rng = np.random.default_rng(seed)
    g = rng.random((DIM, DIM, DIM, 4), np.float32)
    g[..., 3] = rng.random((DIM, DIM, DIM)) < 0.1
    g[..., :3] *= g[..., 3:]
    if aniso:
        jm = JA.build_aniso_mips(jnp.asarray(g))
    else:
        jm = JG.build_mips(jnp.asarray(g))
    return jm, [torch.from_numpy(np.array(m)) for m in jm]


def reference_taps(dirs, schedule, dims, df, dtype):
    """The table one (direction, tap, axis) at a time, as the port built
    it per direction before the kernel: JAX's _axis_indices, the two
    nonzeros of each clamped row merged, the weights rounded to dtype."""
    _, groups = D.plan_groups(schedule.lods, len(dims))
    idx, wts = [], []
    for d in dirs:
        for (l0, l1), steps in groups:
            for k in steps:
                for lvl in ((l0, l1) if l1 != l0 else (l0,)):
                    dl = dims[lvl]
                    shift = d * schedule.dists[k] / (WS / dl)
                    for ax in range(3):
                        i0, i1, f = JD._axis_indices(df, dl, float(shift[ax]))
                        one_m = np.float32(1.0) - f
                        same = i0 == i1
                        idx.append(np.stack([i0, i1]))
                        wts.append(np.stack([
                            np.where(same, one_m + f, one_m),
                            np.where(same, np.float32(0.0), f)]))
    shape = (len(dirs), -1, 3, 2, df)
    w = torch.as_tensor(np.stack(wts).reshape(shape)).to(dtype).float()
    return np.stack(idx).reshape(shape), w.numpy()


def sponza32():
    cfg = preset("sponza256")
    return dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid,
                                                             dim=32))


def schedules_32():
    """sponza256 cut to 32^3: (name, schedule, directions' basis or the
    light, field dim)."""
    cfg = sponza32()
    light = np.asarray(cfg.light.direction, np.float64)
    light = (light / np.linalg.norm(light))[None]
    return [("light", S.shadow_schedule(cfg), light, cfg.grid.dim),
            ("diffuse", S.diffuse_schedule(cfg), None, S.field_dim(cfg)),
            ("specular", S.specular_field_schedule(cfg), None,
             S.field_dim(cfg))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("basis", [6, 26])
@pytest.mark.parametrize("which", ["light", "diffuse", "specular"])
def test_tap_table_matches_per_direction(which, basis, dtype):
    _, sched, dirs, df = {s[0]: s for s in schedules_32()}[which]
    if dirs is None:
        dirs = D.direction_basis(basis).astype(np.float64)
    else:
        dirs = np.concatenate([dirs, D.direction_basis(basis)])
    dims = [32 >> i for i in range(6)]
    _, groups = D.plan_groups(sched.lods, len(dims))
    idx, w = D.direction_taps(dirs, sched, groups, dims, df, WS, dtype)
    ridx, rw = reference_taps(dirs, sched, dims, df, dtype)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(w, rw)
    assert idx.shape[1] == len(D.tap_levels(groups))


def test_step_table_consumes_every_tap_once():
    for _, sched, _, _ in schedules_32():
        lod_plan, groups = D.plan_groups(sched.lods, 6)
        steps = D.step_table(sched, lod_plan, groups, 0.03)
        levels = D.tap_levels(groups)
        taps = []
        for k, (j0, l0, j1, l1, w, one_m, atten) in enumerate(steps):
            taps.append((j0, l0))
            if j1 >= 0:
                taps.append((j1, l1))
                assert w == float(np.float32(lod_plan[k][2])) and w > 0
                assert one_m == float(np.float32(1.0) - np.float32(w))
            assert atten == float(np.float32(
                1.0 + 0.03 * sched.diameters[k]))
        assert taps == list(enumerate(levels))


@pytest.mark.parametrize("sf", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("stack", ["iso", "aniso"])
@pytest.mark.parametrize("transmittance", [False, True])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_plain_matches_jax(compute, transmittance, stack, sf):
    jm, pm = pyramid(stack == "aniso")
    sched = JM.march_schedule(0.3, WS / DIM, 75.0, step_factor=sf)
    basis = JD.direction_basis(6)[[0, 3, 5]]
    basis = np.concatenate([basis, [[0.6, -0.64, 0.48]]])
    df = 8 if sf == 2.0 else DIM
    kw = dict(field_dim=df, opacity_gain=2.0 if transmittance else 1.0,
              transmittance_only=transmittance)
    b = np.asarray(jax.jit(lambda m: JD.directional_march_multi(
        m, basis, sched, WS,
        compute_dtype=jnp.bfloat16 if compute else None, **kw))(jm))
    b = np.moveaxis(b, 0, -2).reshape(df, df, df, -1)
    before = _build.launches()
    a = D.directional_march_multi(
        pm, basis, sched, WS,
        compute_dtype=torch.bfloat16 if compute else None, **kw)
    assert _build.launches() == before    # CPU tensors never launch
    assert a.dtype == torch.float32 and a.shape == b.shape
    np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)
    assert float(a.abs().max()) > 0


def _host_plan(mips, dirs, sched, compute, field_dim, max_alpha=0.95,
               occlusion_falloff=0.03, opacity_gain=1.0,
               transmittance_only=False, world_size=WS):
    """The Plan as the port built it before the memo: every table on the
    host (direction_taps, step_table) through ops/dense.make_plan."""
    dims = [m.shape[0] for m in mips]
    lod_plan, groups = D.plan_groups(sched.lods, len(dims))
    idx, w = D.direction_taps(np.asarray(dirs, np.float64), sched, groups,
                              dims, field_dim, world_size, compute)
    return OD.make_plan([(idx[:, :, a], w[:, :, a]) for a in range(3)],
                        D.tap_levels(groups),
                        D.step_table(sched, lod_plan, groups,
                                     occlusion_falloff), dirs,
                        (field_dim,) * 3, mips[0].device, compute,
                        sched.step_factor, max_alpha, opacity_gain,
                        transmittance_only)


def _plan(mips, dirs, sched, df, transmittance=False, compute=None):
    return _host_plan(mips, dirs, sched, compute or torch.float32, df,
                      transmittance_only=transmittance)


def test_plan_layout_and_extent():
    _, pm = pyramid(False)
    sched = M.march_schedule(0.3, WS / DIM, 75.0)
    dirs = D.direction_basis(6)
    plan = _plan(pm, dirs, sched, 8)
    assert plan.idx.dtype == torch.int32 and plan.w.dtype == torch.float32
    assert tuple(plan.idx.shape) == (6, plan.idx.shape[1], 2 * 3 * 8)
    assert plan.step_i.shape == (len(plan.steps), 4)
    assert torch.equal(plan.w6, torch.as_tensor(np.stack(
        [A.aniso_weights_static(d) for d in dirs])))
    # the attenuation's float32 reciprocal, as the kernel multiplies
    for row, s in zip(plan.step_f.numpy(), plan.steps):
        assert row[2] == np.float32(1.0) / np.float32(s[6])
    for lvl, ext in plan.extent.items():
        assert all(1 <= e <= pm[lvl].shape[a] for a, e in enumerate(ext))


def test_dispatch_refuses_mixed_devices_and_cpu_kernel():
    _, pm = pyramid(False)
    sched = M.march_schedule(0.3, WS / DIM, 75.0)
    plan = _plan(pm, D.direction_basis(6)[:2], sched, 8)
    with pytest.raises(ValueError):
        OD.dense_march([m.to("meta") for m in pm], plan)
    with pytest.raises(ValueError):             # the kernel takes CUDA
        OD.dense_march_cuda(pm, plan)


@pytest.mark.parametrize("stack", ["iso", "aniso"])
@pytest.mark.parametrize("transmittance", [False, True])
def test_function_gradient_matches_plain(stack, transmittance):
    """_build.Replay with the plain forward injected (as the mip tests
    drive Downsample2x): its backward replays the plain version."""
    _, pm = pyramid(stack == "aniso", seed=5)
    sched = M.march_schedule(0.3, WS / DIM, 75.0, step_factor=2.0)
    plan = _plan(pm, D.direction_basis(6)[:3], sched, 8, transmittance,
                 torch.bfloat16)
    rng = np.random.default_rng(7)

    def grads(fn):
        lv = [m.detach().clone().requires_grad_() for m in pm]
        out = fn(lv)
        wgt = torch.as_tensor(rng.random(out.shape, np.float32))
        return out, torch.autograd.grad((out * wgt).sum(), lv,
                                        allow_unused=True)

    rng = np.random.default_rng(7)
    got_out, got = grads(lambda lv: _build.Replay.apply(
        lambda *m: OD.dense_march_plain(m, plan),
        lambda *m: OD.dense_march_plain(m, plan), (), *lv))
    rng = np.random.default_rng(7)
    ref_out, ref = grads(lambda lv: OD.dense_march_plain(lv, plan))
    assert torch.equal(got_out, ref_out)
    top = max(float(r.abs().max()) for r in ref if r is not None)
    assert top > 0
    for g, r in zip(got, ref):
        if r is None:
            assert g is None or float(g.abs().max()) == 0
        else:
            assert float((g - r).abs().max()) <= 1e-6 * top


def test_kernel_route_leaves_untouched_levels_out_of_the_graph(
        monkeypatch):
    """Through _build.Replay (the kernel's route, the plain forward
    injected) the levels no tap reads get no gradient edge, as through the
    plain version: their producers' backward (the mip's) must not run."""
    rng = np.random.default_rng(13)
    g = rng.random((DIM, DIM, DIM, 4), np.float32)
    # alphas below 1: sqrt's derivative at 1 - a = 0 is infinite
    g[..., 3] = 0.5 * (rng.random((DIM, DIM, DIM)) < 0.2)
    sched = M.march_schedule(0.03, WS / DIM, 40.0, step_factor=0.5)
    dirs = np.array([[0.6, -0.64, 0.48]])

    def grads(kernel_route):
        x = torch.as_tensor(g).requires_grad_()
        mips = G.build_mips(x, alpha_mode="max")
        plan = _plan(mips, dirs, sched, DIM, transmittance=True)
        with monkeypatch.context() as mp:
            if kernel_route:
                mp.setattr(_build, "uses_kernel", lambda *t: True)
                mp.setattr(OD, "dense_march_cuda",
                           lambda lv, p, walked=None:
                           OD.dense_march_plain(lv, p, walked))
            out = OD.dense_march(mips, plan)
        assert set(plan.extent) != set(range(len(mips)))
        return torch.autograd.grad(out.sum(), mips, allow_unused=True)

    got, ref = grads(True), grads(False)
    top = max(float(r.abs().max()) for r in ref if r is not None)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if b is not None:       # summed in another order: 1e-6 of the top
            assert float((a - b).abs().max()) <= 1e-6 * top


def test_brick_slab_plan_matches_whole_march():
    """A plan of x rows of their own length (a slab of the output, as
    parallel/brick.py builds them) gives the whole march's rows."""
    _, pm = pyramid(False, seed=9)
    sched = M.march_schedule(0.3, WS / DIM, 75.0, step_factor=0.5)
    dirs = D.direction_basis(26)[:4].astype(np.float64)
    whole = D.directional_march_multi(pm, dirs, sched, WS, field_dim=DIM)
    dims = [m.shape[0] for m in pm]
    lod_plan, groups = D.plan_groups(sched.lods, len(dims))
    idx, w = D.direction_taps(dirs, sched, groups, dims, DIM, WS,
                              torch.float32)
    xs = slice(4, 10)
    plan = OD.make_plan(
        [(idx[:, :, 0, :, xs], w[:, :, 0, :, xs]), (idx[:, :, 1], w[:, :, 1]),
         (idx[:, :, 2], w[:, :, 2])], D.tap_levels(groups),
        D.step_table(sched, lod_plan, groups, 0.03), dirs, (6, DIM, DIM),
        pm[0].device, torch.float32, sched.step_factor, 0.95, 1.0, False)
    assert torch.equal(OD.dense_march(pm, plan), whole[xs])


@pytest.mark.parametrize("transmittance", [False, True])
def test_walked_counts_the_steps_before_the_early_out(transmittance):
    rng = np.random.default_rng(11)
    g = rng.random((DIM, DIM, DIM, 4), np.float32)
    g[..., 3] = rng.random((DIM, DIM, DIM)) < 0.6      # dense occupancy
    pm = G.build_mips(torch.as_tensor(g))
    sched = M.march_schedule(0.3, WS / DIM, 75.0)
    n = sched.num_steps
    dirs = D.direction_basis(6)[:3]
    for max_alpha, every in ((0.95, transmittance), (1.5, True)):
        plan = dataclasses.replace(_plan(pm, dirs, sched, 8, transmittance),
                                   max_alpha=max_alpha)
        walked = torch.full((8, 8, 8, 3), -1, dtype=torch.int32)
        out = OD.dense_march(pm, plan, walked)
        assert torch.equal(out, OD.dense_march(pm, plan))
        assert int(walked.min()) >= 1 and int(walked.max()) == n
        assert bool((walked == n).all()) == every
        if not every:
            # the cells that stopped after m steps: the march cut to its
            # first m steps gives them the whole march's output
            m = int(walked.min())
            cut = dataclasses.replace(plan, steps=plan.steps[:m])
            stopped = (walked == m).repeat_interleave(4, dim=-1)
            assert m < n and bool(stopped.any())
            assert torch.equal(OD.dense_march(pm, cut)[stopped], out[stopped])


def test_march_work_by_hand():
    """One 4^3 rgba level, one direction, a 3-step schedule at step
    factor 1 in field mode: 97 operations a step (21 a channel of the
    resample, 13 of the composite) for every cell; the level, the tables
    and the output's bytes once."""
    level = torch.rand(4, 4, 4, 4)
    sched = M.march_schedule(0.0, 1.0, 3.5)
    assert sched.num_steps == 3
    plan = _plan([level], np.array([[1.0, 0.0, 0.0]]), sched, 4)
    nbytes, ops = OD.march_work([level], plan)
    tables = (plan.idx.numel() + plan.w.numel() + plan.step_i.numel()
              + plan.step_f.numel() + plan.w6.numel()) * 4
    assert nbytes == 64 * 16 + tables + 64 * 16
    assert ops == 64 * 3 * (4 * 21 + 13)
    walked = torch.full((4, 4, 4, 1), 2, dtype=torch.int32)
    walked[0] = 1
    assert OD.march_work([level], plan, walked)[1] == (
        48 * 2 + 16) * (4 * 21 + 13)
    # transmittance reads the alpha channel alone: 2 operations a step
    tplan = _plan([level], np.array([[1.0, 0.0, 0.0]]), sched, 4, True)
    nbytes, ops = OD.march_work([level], tplan)
    assert nbytes == 64 * 4 + (tplan.idx.numel() * 2 + 3 * 4 + 3 * 3
                               + 6) * 4 + 64 * 4
    assert ops == 64 * 3 * (21 + 2)


# ---------------------------------------------------------------------------
# the packed copy the kernel reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf", [0.5, 1.0])
@pytest.mark.parametrize("transmittance", [False, True])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stack", ["iso", "aniso"])
def test_plain_march_over_packed_levels_is_bit_equal(stack, compute,
                                                     transmittance, sf):
    """Rounding each value to the compute dtype once, in the pack, gives
    the march the bits it gets rounding it at every tap."""
    _, pm = pyramid(stack == "aniso", seed=17)
    sched = M.march_schedule(0.3, WS / DIM, 75.0, step_factor=sf)
    dirs = np.concatenate([D.direction_basis(6)[[0, 3]], [[0.6, -0.64,
                                                           0.48]]])
    plan = _plan(pm, dirs, sched, DIM, transmittance, compute)
    packed = OD.pack_levels_plain(pm, plan)
    for i, (m, p) in enumerate(zip(pm, packed)):
        if i not in plan.extent:
            assert p is m
            continue
        assert p.dtype == compute and p.is_contiguous()
        assert p.shape[:-1] == m.shape[:-1]
        assert p.shape[-1] == (1 if transmittance else m.shape[-1])
    walked = [torch.empty((DIM,) * 3 + (3,), dtype=torch.int32)
              for _ in range(2)]
    want = OD.dense_march_plain(pm, plan, walked[0])
    got = OD.dense_march_plain(packed, plan, walked[1])
    assert torch.equal(got, want) and torch.equal(walked[1], walked[0])
    assert float(want.abs().max()) > 0


def _slot_plan(mips, transmittance=False, compute=torch.bfloat16):
    sched = M.march_schedule(0.3, WS / DIM, 75.0)
    return _plan(mips, D.direction_basis(6)[:2], sched, 8, transmittance,
                 compute)


def _check_slots(slots, total, plan):
    """Slots of the copies lie in order, PACK_ALIGN-aligned and disjoint
    inside the buffer; the others hold no offset."""
    esize = torch.empty((), dtype=plan.compute).element_size()
    end = 0
    for s in slots:
        if not s.pack:
            assert s.offset == -1
            continue
        assert s.offset >= end and (s.offset * esize) % OD.PACK_ALIGN == 0
        end = s.offset + s.view.numel()
    assert end <= total and (total * esize) % OD.PACK_ALIGN == 0


@pytest.mark.parametrize("stack", ["iso", "aniso"])
def test_level_slots_pack_what_the_kernel_cannot_read_as_is(stack):
    _, pm = pyramid(stack == "aniso", seed=19)
    nd = [6 if A.is_aniso_level(m) else 1 for m in pm]
    bf = [m.to(torch.bfloat16) for m in pm]
    cases = (
        # float32 levels, bfloat16 compute (the operating point): a copy
        (pm, False, torch.bfloat16, True),
        # already the compute dtype, contiguous: read as they are
        (bf, False, torch.bfloat16, False),
        (pm, False, torch.float32, False),
        # transmittance reads alpha alone: a strided view, so a copy
        (pm, True, torch.float32, True),
        (bf, True, torch.bfloat16, True))
    for mips, trans, compute, copied in cases:
        plan = _slot_plan(mips, trans, compute)
        slots, total = OD.level_slots(mips, plan)
        assert [s.nd for s in slots] == nd
        assert [s.read for s in slots] == [i in plan.extent
                                           for i in range(len(mips))]
        assert [s.pack for s in slots] == [copied and s.read for s in slots]
        assert (total > 0) == copied
        _check_slots(slots, total, plan)
        for s, m in zip(slots, mips):
            assert s.view.shape[-1] == (1 if trans else m.shape[-1])


def test_level_slots_copy_a_misaligned_level_and_skip_an_unread_one():
    """A contiguous level of the compute dtype that starts off a 16-byte
    boundary is copied (the kernel's vector loads need the alignment); a
    level no tap reads is neither read nor copied."""
    _, pm = pyramid(False, seed=21)
    bf = [m.to(torch.bfloat16) for m in pm]
    flat = torch.empty(bf[0].numel() + 1, dtype=torch.bfloat16)
    bf[0] = flat[1:].view(bf[0].shape).copy_(bf[0])
    assert bf[0].is_contiguous() and bf[0].data_ptr() % OD.PACK_ALIGN
    plan = _slot_plan(bf)
    assert 0 in plan.extent
    slots, total = OD.level_slots(bf, plan)
    assert slots[0].pack and not any(s.pack for s in slots[1:])
    assert total == -(-bf[0].numel() // 8) * 8
    g = torch.as_tensor(np.random.default_rng(23).random(
        (DIM, DIM, DIM, 4), np.float32))
    mips = G.build_mips(g, alpha_mode="max")
    sched = M.march_schedule(0.03, WS / DIM, 40.0, step_factor=0.5)
    plan = _plan(mips, np.array([[0.6, -0.64, 0.48]]), sched, DIM, True)
    unread = set(range(len(mips))) - set(plan.extent)
    assert unread
    slots, _ = OD.level_slots(mips, plan)
    for i in unread:
        assert not slots[i].read and not slots[i].pack


class _FakePack:
    """The library's vct_dense_pack stood in for on the CPU: checks each
    level's source pointer, strides, shape and nd against the views the
    march reads and writes pack_levels_plain's copy to its destination
    pointer."""

    def __init__(self, views, compute):
        self.by_ptr = {v.data_ptr(): v for v in views}
        self.compute = compute
        self.calls = []
        self.written = 0        # bytes written to the destinations

    def vct_dense_pack(self, src, stride, shape, nd, dst, n, nc, level_bf16,
                       compute_bf16, stream):
        def read(addr, kind, k):
            return list(ctypes.cast(addr, ctypes.POINTER(kind))[:k])

        src, dst = read(src, ctypes.c_longlong, n), read(dst, ctypes.c_longlong, n)
        stride = read(stride, ctypes.c_longlong, 5 * n)
        shape, nd = read(shape, ctypes.c_int, 3 * n), read(nd, ctypes.c_int, n)
        assert compute_bf16 == int(self.compute == torch.bfloat16)
        for k in range(n):
            v = self.by_ptr[src[k]]
            aniso = A.is_aniso_level(v)
            assert level_bf16 == int(v.dtype == torch.bfloat16)
            assert nc == v.shape[-1] and shape[3 * k:3 * k + 3] == list(
                v.shape[:3])
            st = v.stride()
            assert stride[5 * k:5 * k + 5] == [
                st[0], st[1], st[2], st[3] if aniso else 0, st[-1]]
            assert nd[k] == (6 if aniso else 1)
            c = v.to(self.compute).contiguous()
            ctypes.memmove(dst[k], c.data_ptr(), c.numel() * c.element_size())
            self.written += c.numel() * c.element_size()
        self.calls.append(n)
        return 0


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transmittance", [False, True])
@pytest.mark.parametrize("stack", ["iso", "aniso"])
def test_pack_levels_cuda_host_side(stack, transmittance, compute,
                                    monkeypatch):
    """pack_levels_cuda's buffer, slots and launch arguments, with the
    library stood in for: one launch for the levels that need a copy (none
    where every level is packed already), each copy equal to
    pack_levels_plain's, the counters, and the march's level table."""
    _, pm = pyramid(stack == "aniso", seed=25)
    plan = _slot_plan(pm, transmittance, compute)
    fake = _FakePack(OD._level_views(pm, plan), compute)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    slots, _ = OD.level_slots(pm, plan)
    copied = [s.pack for s in slots]
    before = _build.launches()
    packed = OD.pack_levels_cuda(pm, plan)
    plain = OD.pack_levels_plain(pm, plan)
    after = _build.launches()
    assert after["dense_pack"] - before["dense_pack"] == len(fake.calls) \
        == int(any(copied))
    assert {k: v for k, v in after.items() if k != "dense_pack"} == {
        k: v for k, v in before.items() if k != "dense_pack"}
    assert fake.calls == ([sum(copied)] if any(copied) else [])
    esize = torch.empty((), dtype=compute).element_size()
    assert fake.written == esize * sum(s.view.numel() for s in slots
                                       if s.pack)
    for i, (t, p, s) in enumerate(zip(packed, plain, slots)):
        if not s.read:
            assert t is None
            continue
        assert torch.equal(t, p) and t.dtype == compute
        assert t.is_contiguous() and t.data_ptr() % OD.PACK_ALIGN == 0
        if not s.pack:
            assert t.data_ptr() == pm[i].data_ptr()
    ptr, stride, nd = OD.level_table(packed)
    for i, t in enumerate(packed):
        if t is None:
            assert (ptr[i], stride[2 * i:2 * i + 2], nd[i]) == (0, [0, 0], 1)
            continue
        assert ptr[i] == t.data_ptr()
        assert stride[2 * i:2 * i + 2] == [t.stride(0), t.stride(1)]
        assert nd[i] == (6 if A.is_aniso_level(t) else 1)
        # z's stride is the voxel's nd * C values, as the kernel assumes
        assert t.stride(2) == nd[i] * plan.channels


# ---------------------------------------------------------------------------
# the plan's two halves: the direction-free memo and the tap table
# ---------------------------------------------------------------------------

def _levels_32(stack):
    """sponza256's pyramid cut to 32^3, as shapes: zeros, 6-direction
    above level 0 for the anisotropic stack."""
    return [torch.zeros((32 >> i,) * 3 + ((6, 4) if stack == "aniso" and i
                                          else (4,)))
            for i in range(6)]


def _march_32(which):
    """(schedule, directions, march_plan keywords) of one of sponza256's
    three marches at 32^3: the light volume, or a field over its basis."""
    cfg = sponza32()
    _, sched, light, df = {s[0]: s for s in schedules_32()}[which]
    if which == "light":
        return sched, light, dict(field_dim=df, transmittance_only=True,
                                  opacity_gain=cfg.shadow.opacity_gain)
    return sched, D.direction_basis(cfg.cones.field_basis), dict(
        field_dim=df, max_alpha=cfg.cones.max_alpha,
        occlusion_falloff=cfg.cones.occlusion_falloff)


def _assert_plans_equal(got, want):
    for f in dataclasses.fields(OD.Plan):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stack", ["iso", "aniso"])
@pytest.mark.parametrize("which", ["light", "diffuse", "specular"])
def test_memoised_plan_equals_the_host_build(which, stack, compute):
    """march_plan (the direction-free half from the memo, the tap table
    from direction_taps on the CPU, extent from the last cells) gives the
    host build's Plan field for field, on a miss and on a hit."""
    mips = _levels_32(stack)
    sched, dirs, kw = _march_32(which)
    want = _host_plan(mips, dirs, sched, compute, **kw)
    for _ in range(2):
        _assert_plans_equal(D.march_plan(mips, dirs, sched, WS,
                                         compute_dtype=compute, **kw), want)


@pytest.fixture
def fresh_memo():
    """plan_half's memo emptied, so that a miss counted in the test is the
    test's own and not an earlier test's entry."""
    D.plan_half.cache_clear()
    yield
    D.plan_half.cache_clear()


def _memo_delta(call):
    before = D.plan_memo_info()
    out = call()
    after = D.plan_memo_info()
    return out, (after.hits - before.hits, after.misses - before.misses)


MEMO_CHANGES = {
    "schedule": lambda a: dict(a, sched=M.march_schedule(0.2, WS / 32,
                                                         75.0)),
    "level sizes": lambda a: dict(a, mips=a["mips"][:-1]),
    "field shape": lambda a: dict(a, field_dim=8),
    "dtype": lambda a: dict(a, compute=torch.bfloat16),
    "falloff": lambda a: dict(a, occlusion_falloff=0.05),
    "max alpha": lambda a: dict(a, max_alpha=0.9),
    "gain": lambda a: dict(a, opacity_gain=2.0),
    "transmittance": lambda a: dict(a, transmittance_only=True),
    "world size": lambda a: dict(a, world_size=WS / 2),
}


def _memo_args():
    return dict(mips=_levels_32("iso"), sched=M.march_schedule(
        0.3, WS / 32, 75.0), field_dim=16, compute=torch.float32,
        occlusion_falloff=0.03, max_alpha=0.95, opacity_gain=1.0,
        transmittance_only=False, world_size=WS)


def _memo_plan(a, dirs):
    return D.march_plan(a["mips"], dirs, a["sched"], a["world_size"],
                        field_dim=a["field_dim"], max_alpha=a["max_alpha"],
                        occlusion_falloff=a["occlusion_falloff"],
                        opacity_gain=a["opacity_gain"],
                        transmittance_only=a["transmittance_only"],
                        compute_dtype=a["compute"])


@pytest.mark.parametrize("change", sorted(MEMO_CHANGES))
def test_plan_memo_hits_on_a_repeat_and_misses_on_a_change(change,
                                                          fresh_memo):
    """A repeated call, under another direction, finds the direction-free
    half in the memo (the same step tables, no copy); a change of any
    value it depends on misses, and the plan then equals the host
    build's."""
    a = _memo_args()
    dirs = D.direction_basis(6)[:2].astype(np.float64)
    _memo_delta(lambda: _memo_plan(a, dirs))
    first, seen = _memo_delta(lambda: _memo_plan(a, dirs[::-1]))
    assert seen == (1, 0)
    again, seen = _memo_delta(lambda: _memo_plan(a, dirs))
    assert seen == (1, 0) and again.step_i is first.step_i
    b = MEMO_CHANGES[change](a)
    got, seen = _memo_delta(lambda: _memo_plan(b, dirs))
    assert seen == (0, 1) and got.step_i is not first.step_i
    _assert_plans_equal(got, _host_plan(
        b["mips"], dirs, b["sched"], b["compute"], b["field_dim"],
        b["max_alpha"], b["occlusion_falloff"], b["opacity_gain"],
        b["transmittance_only"], b["world_size"]))


def test_plan_memo_misses_on_another_device(fresh_memo):
    """The device is part of the key: the same values on another device
    build their own half there (a meta tensor stands in for the card)."""
    a = _memo_args()
    key = (a["sched"], tuple(m.shape[0] for m in a["mips"]), 16, WS,
           torch.float32, 0.03, 0.95, 1.0, False)
    cpu, _ = _memo_delta(lambda: D.plan_half(*key, torch.device("cpu")))
    again, seen = _memo_delta(lambda: D.plan_half(*key, torch.device("cpu")))
    assert seen == (1, 0) and again is cpu
    meta, seen = _memo_delta(lambda: D.plan_half(*key, torch.device("meta")))
    assert seen == (0, 1) and meta.step_i.device.type == "meta"
    assert meta.tap_dist.device.type == "meta"
    assert meta.steps == cpu.steps and meta.levels == cpu.levels
    # the held arrays are read-only
    assert not cpu.dist.flags.writeable and not cpu.dl.flags.writeable


def _directions(kind, n=12, seed=29):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if kind == "axis":
        return D.direction_basis(6).astype(np.float64)
    if kind == "negative":
        return -np.abs(d)
    return d


@pytest.mark.parametrize("which", ["light", "diffuse", "specular"])
@pytest.mark.parametrize("kind", ["random", "axis", "negative", "clamp"])
def test_last_cell_extent_equals_the_table_extent(kind, which):
    """tap_extent reads each (direction, tap, axis)'s last cell alone;
    make_plan reduces the whole table: the same extent.  "clamp" marches
    in a world of 1/20 the size, so shifts run past both edges."""
    mips = _levels_32("iso")
    sched, _, kw = _march_32(which)
    dirs = _directions(kind)
    ws = WS / 20 if kind == "clamp" else WS
    dims = tuple(m.shape[0] for m in mips)
    df = kw["field_dim"]
    half = D.plan_half(sched, dims, df, ws, torch.float32, 0.03, 0.95, 1.0,
                       False, torch.device("cpu"))
    lod_plan, groups = D.plan_groups(sched.lods, len(dims))
    idx, w = D.direction_taps(dirs, sched, groups, dims, df, ws,
                              torch.float32)
    want = OD.make_plan([(idx[:, :, a], w[:, :, a]) for a in range(3)],
                        D.tap_levels(groups), [], dirs, (df,) * 3, "cpu",
                        torch.float32, 1.0, 0.95, 1.0, False).extent
    assert D.tap_extent(dirs, half) == want
    if kind == "clamp":
        top = np.asarray(dims)[list(half.levels)][None, :, None, None, None]
        assert bool((idx == 0).any()) and bool((idx == top - 1).any())


def _weight_directions(kind):
    """Directions for direction_weights: 64 suns of the relight traffic's
    path (vctbench/traffic/relight.json), the 26-direction basis, or 4096
    random ones with zero, negative-zero and axis components among them."""
    if kind == "relight suns":
        import json
        import pathlib
        from vctbench.inputs import traffic
        mix = json.loads((pathlib.Path(__file__).parents[1] / "vctbench"
                          / "traffic" / "relight.json").read_text())
        return traffic.make_paths(mix, 2 ** 31 + 27, 64).light
    if kind == "basis":
        return D.direction_basis(26).astype(np.float64)
    d = np.random.default_rng(27).normal(size=(4096, 3))
    d[:64, 0], d[64:128, 1] = 0.0, -0.0
    d[128:192, 1:] = 0.0
    return d


@pytest.mark.parametrize("kind", ["relight suns", "basis", "random"])
def test_direction_weights_equal_aniso_weights_static(kind):
    """Plan.w6 over every direction at once equals aniso_weights_static a
    direction at a time, bit for bit."""
    dirs = _weight_directions(kind)
    want = np.stack([A.aniso_weights_static(d) for d in dirs])
    got = OD.direction_weights(dirs)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
