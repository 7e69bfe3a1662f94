"""The per-cone march kernel's plain twin and wrapper (ops/percone.py) on
the CPU; the kernel itself (csrc/percone.cu) is held to the twin bit for
bit by chip_smoke on the card.

  * the twin equals vctbench/reference_oracle/march.cone_trace (and the
    reference frame's cone-order sum of the diffuse cones) bit for bit on
    isotropic and 6-direction pyramids, at both apertures;
  * it agrees with core/march's cone_march_multi and cone_march, and
    with the JAX package's (vct_tpu/core/march.py), within
    tests/test_torch_oracle.py's atol 1e-5 on inputs without early-out
    ties (no alpha within 1e-5 of max_alpha);
  * reading the three facing directions equals the six-direction blend;
  * its steps run equal core/march.composite's percone.active counter;
  * gather_cuda's launch arguments with the library stood in for, and
    its refusals (dtype, shape, cones, steps, texels, the CPU): it
    raises and launches nothing, and never falls back;
  * render/shading's providers launch once a call with the kernel's
    route taken (the twin injected), count as core/march does, carry a
    gradient through _build.Replay, and on CPU tensors run core/march
    exactly as before.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import march as JM
from vct_tpu_torch import stages
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import percone as PC
from vct_tpu_torch.render import shading as S
from vctbench.reference_oracle import march as RM

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

DIM, WS = 16, 150.0
VOXEL = WS / DIM
MAX_ALPHA, FALLOFF = 0.95, 0.03
ATOL = 1e-5                 # tests/test_torch_oracle.py's march bound
APERTURES = {"diffuse": (0.577, 6), "specular": (0.07, 1)}
WEIGHTS = {"diffuse": tuple(float(w) for w in C.CONE_WEIGHTS),
           "specular": (1.0,)}


def _grid(seed):
    """A 16^3 grid of emissive blobs, dense enough that many cones reach
    max_alpha."""
    rng = np.random.default_rng(seed)
    g = np.zeros((DIM, DIM, DIM, 4), np.float32)
    for _ in range(24):
        c = rng.integers(0, DIM, 3)
        r = int(rng.integers(1, 4))
        sl = tuple(slice(max(0, x - r), x + r) for x in c)
        g[sl + (slice(0, 3),)] = rng.uniform(0.1, 1.0, 3)
        g[sl + (3,)] = rng.uniform(0.3, 1.0)
    return torch.from_numpy(g)


PYRAMIDS = {"iso": lambda g: G.build_mips(g),
            "aniso": lambda g: A.build_aniso_mips(g)}


def _rays(seed, n, k):
    """n starts inside the grid and (n, k, 3) unit directions, with some
    axis-aligned ones (components 0 and -0)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-50.0, 50.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, k, 3))
    d[0, :] = [0.0, -1.0, 0.0]
    d[1, :] = [-0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[1, :, 0] = -0.0
    return torch.from_numpy(start), torch.from_numpy(d)


def _case(kind, aperture, seed=5, n=64):
    tan, k = APERTURES[aperture]
    mips = PYRAMIDS[kind](_grid(seed))
    start, dirs = _rays(seed + 1, n, k)
    sched = M.march_schedule(tan, VOXEL, 75.0)
    table = PC.step_table(sched, len(mips), FALLOFF)
    kw = dict(table=table, weights=WEIGHTS[aperture], world_size=WS,
              max_alpha=MAX_ALPHA)
    return mips, start, dirs, sched, kw


def _reference(mips, start, dirs, tan, weights):
    """The reference frame's gather: cone_trace per cone, summed in cone
    order from zeros (vctbench/reference_oracle/frame.py shade)."""
    steps = RM.cone_steps(tan, VOXEL, 75.0)
    rgb = start.new_zeros((start.shape[0], 3))
    occ = start.new_zeros((start.shape[0],))
    for i, w in enumerate(weights):
        c, o = RM.cone_trace(mips, start, dirs[:, i], steps, WS, MAX_ALPHA,
                             FALLOFF)
        rgb = rgb + w * c
        occ = occ + w * o
    return rgb, occ


@pytest.mark.parametrize("aperture", sorted(APERTURES))
@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_twin_equals_the_reference_bit_for_bit(kind, aperture):
    mips, start, dirs, sched, kw = _case(kind, aperture)
    walked = torch.zeros((), dtype=torch.int64)
    out = PC.gather_plain(start, dirs, *mips, walked=walked, **kw)
    rgb, occ = _reference(mips, start, dirs, APERTURES[aperture][0],
                          WEIGHTS[aperture])
    assert torch.equal(out[:, :3], rgb) and torch.equal(out[:, 3], occ)
    samples = dirs.shape[0] * dirs.shape[1] * sched.num_steps
    assert 0 < int(walked) < samples        # some cones stop early
    assert float(out[:, 3].max()) > 0.1     # the cones see the blobs


def _alpha_gap(mips, start, dirs, sched):
    """The least |alpha so far - max_alpha| over every step of every cone,
    by core/march's cumulative product: how near the early-out ties."""
    pts = start[:, None, None, :] + (G.constant(sched.dists, start.device)
                                     [:, None] * dirs[:, :, None, :])
    smp = M.sample_schedule(mips, pts, sched.lods, WS, direction=dirs)
    t = torch.cumprod(1.0 - smp[..., 3], dim=-1)
    return float(((1.0 - t) - MAX_ALPHA).abs().min())


@pytest.mark.parametrize("aperture", sorted(APERTURES))
@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_twin_agrees_with_core_march(kind, aperture):
    mips, start, dirs, sched, kw = _case(kind, aperture)
    assert _alpha_gap(mips, start, dirs, sched) > ATOL     # no ties here
    out = PC.gather_plain(start, dirs, *mips, **kw)
    if aperture == "diffuse":
        rgb, occ = M.cone_march_multi(mips, start, dirs, WEIGHTS[aperture],
                                      sched, WS, MAX_ALPHA, FALLOFF)
    else:
        rgb, occ, _ = M.cone_march(mips, start, dirs[:, 0], sched, WS,
                                   MAX_ALPHA, FALLOFF)
    np.testing.assert_allclose(out[:, :3].numpy(), rgb.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out[:, 3].numpy(), occ.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("direction", [
    (0.6, -0.64, 0.48), (-0.6, 0.64, -0.48), (0.0, -1.0, 0.0),
    (-0.0, 0.0, -1.0), (1.0, 0.0, -0.0)])
def test_three_facing_directions_equal_six(direction):
    """The kernel's read of a 6-direction level, the three directions the
    cone faces (2a on the + side of axis a, 2a + 1 on the -) blended by
    the squared components in axis order, equals the twin's
    aniso.sample_aniso_level, which blends all six, bit for bit."""
    rng = np.random.default_rng(3)
    level = torch.from_numpy(rng.random((4, 4, 4, 6, 4), np.float32))
    uvw = torch.from_numpy(rng.uniform(-0.2, 1.2, (50, 3)).astype(np.float32))
    d = torch.tensor(direction, dtype=torch.float32)
    d = (d / torch.sqrt(torch.sum(d * d))).expand(50, 3)
    six = G.trilinear_sample(A.packed(level), uvw).reshape(50, 6, 4)
    face = torch.arange(3) * 2 + (d < 0.0).long()
    facing = torch.gather(six, 1, face[..., None].expand(50, 3, 4))
    w = d * d
    got = w[:, 0:1] * facing[:, 0]
    for a in (1, 2):
        got = got + w[:, a:a + 1] * facing[:, a]
    assert torch.equal(got, A.sample_aniso_level(level, uvw, d))


@pytest.mark.parametrize("aperture", sorted(APERTURES))
@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_twin_agrees_with_the_jax_march(kind, aperture):
    """The twin against the JAX package's cone_march_multi (diffuse) and
    cone_march (specular) on the same pyramids, starts and directions,
    within tests/test_torch_oracle.py's atol 1e-5, on inputs without
    early-out ties."""
    mips, start, dirs, sched, kw = _case(kind, aperture)
    assert _alpha_gap(mips, start, dirs, sched) > ATOL     # no ties here
    out = PC.gather_plain(start, dirs, *mips, **kw)
    jm = tuple(jnp.asarray(m.numpy()) for m in mips)
    jsched = JM.march_schedule(APERTURES[aperture][0], VOXEL, 75.0)
    if aperture == "diffuse":
        rgb, occ = jax.jit(JM.cone_march_multi, static_argnums=(3, 4, 5))(
            jm, jnp.asarray(start.numpy()), jnp.asarray(dirs.numpy()),
            WEIGHTS[aperture], jsched, WS, MAX_ALPHA, FALLOFF)
    else:
        rgb, occ, _ = jax.jit(JM.cone_march, static_argnums=(3, 4))(
            jm, jnp.asarray(start.numpy()), jnp.asarray(dirs[:, 0].numpy()),
            jsched, WS, MAX_ALPHA, FALLOFF)
    np.testing.assert_allclose(out[:, :3].numpy(), np.asarray(rgb),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[:, 3].numpy(), np.asarray(occ),
                               atol=ATOL, rtol=0)
    assert float(np.asarray(occ).max()) > 0.1     # the cones see the blobs


@pytest.fixture
def counting(monkeypatch):
    monkeypatch.setattr(stages, "MARK", lambda name: None)
    stages.reset_counters()
    yield
    stages.reset_counters()


@pytest.mark.parametrize("aperture", sorted(APERTURES))
@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_twin_steps_equal_the_composite_counter(kind, aperture, counting):
    mips, start, dirs, sched, kw = _case(kind, aperture)
    walked = torch.zeros((), dtype=torch.int64)
    PC.gather_plain(start, dirs, *mips, walked=walked, **kw)
    M.cone_march(mips, start[:, None, :], dirs, sched, WS, MAX_ALPHA,
                 FALLOFF, count=True)
    got = stages.counters()
    assert int(got["percone.active"][0]) == int(walked)
    assert int(got["percone.samples"][0]) == dirs.shape[0] * dirs.shape[
        1] * sched.num_steps


def test_step_table_follows_lod_levels():
    sched = M.march_schedule(0.07, VOXEL, 75.0)
    table = PC.step_table(sched, 5, FALLOFF)
    assert len(table) == sched.num_steps
    with pytest.raises(ValueError, match="step factor 2.0"):
        PC.step_table(M.march_schedule(0.07, VOXEL, 75.0, step_factor=2.0),
                      5, FALLOFF)
    for st, dist, diam, lod in zip(table, sched.dists, sched.diameters,
                                   sched.lods):
        l0, l1, w = G.lod_levels(lod, 5)
        assert (st.dist, st.l0, st.w, st.omw) == (dist, l0, w, 1.0 - w)
        assert st.l1 == (l1 if w > 0.0 and l1 != l0 else l0)
        assert st.div == 1.0 + FALLOFF * diam
    f, i = PC._host_table(table)
    assert f.dtype == np.float32 and i.dtype == np.int32
    assert f.tolist() == [[np.float32(s.dist), np.float32(s.w),
                           np.float32(s.omw), np.float32(s.div)]
                          for s in table]


# ---------------------------------------------------------------------------
# the wrapper, with the library stood in for
# ---------------------------------------------------------------------------

class _OnCard:
    """A CPU tensor as _build.operand sees a card's: every check of the
    operand but its device."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


class _FakePercone:
    """The library stood in for: vct_percone decodes its host arrays while
    they live and returns `status`."""

    def __init__(self):
        self.calls = []
        self.status = 0

    def vct_percone(self, start, dirs, n, k, level_ptr, level_shape, nl,
                    step_f, step_i, nsteps, weights, half_ws, max_alpha,
                    out, walked, stream):
        def read(ctype, addr, count):
            return list((ctype * count).from_address(addr))
        self.calls.append(dict(
            n=n, k=k, nl=nl, nsteps=nsteps, half_ws=half_ws,
            max_alpha=max_alpha, walked=walked,
            levels=read(ctypes.c_longlong, level_ptr, nl),
            shape=read(ctypes.c_int, level_shape, 2 * nl),
            step_f=read(ctypes.c_float, step_f, 4 * nsteps),
            step_i=read(ctypes.c_int, step_i, 2 * nsteps),
            weights=read(ctypes.c_float, weights, k)))
        return self.status

    def vct_error_string(self, status):
        return b"stand-in error"


@pytest.fixture
def fake(monkeypatch):
    lib = _FakePercone()
    operand = _build.operand
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(_build, "operand",
                        lambda x, *a: operand(_OnCard(x), *a))
    return lib


@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_gather_cuda_launch_arguments(fake, kind, walk):
    mips, start, dirs, sched, kw = _case(kind, "diffuse")
    walked = torch.zeros((), dtype=torch.int64) if walk else None
    before = _build.launches()["percone"]
    out = PC.gather_cuda(start, dirs, *mips, walked=walked, **kw)
    assert _build.launches()["percone"] - before == 1
    assert out.shape == (64, 4) and out.dtype == torch.float32
    (call,) = fake.calls
    assert (call["n"], call["k"], call["nl"], call["nsteps"]) == (
        64, 6, len(mips), sched.num_steps)
    assert call["levels"] == [m.data_ptr() for m in mips]
    assert call["shape"] == [v for m in mips for v in (
        m.shape[0], 6 if m.dim() == 5 else 1)]
    f, i = PC._host_table(kw["table"])
    assert call["step_f"] == f.reshape(-1).tolist()
    assert call["step_i"] == i.reshape(-1).tolist()
    assert call["weights"] == [float(np.float32(w)) for w in kw["weights"]]
    assert call["half_ws"] == np.float32(WS * 0.5)
    assert call["max_alpha"] == float(np.float32(MAX_ALPHA))
    assert call["walked"] == (walked.data_ptr() if walk else None)


REFUSALS = {
    "float64 level": lambda m, s, d: ([m[0].double()] + m[1:], s, d,
                                      "level 0: expected"),
    "bfloat16 level": lambda m, s, d: (m[:1] + [m[1].bfloat16()] + m[2:], s,
                                       d, "level 1: expected"),
    "three channels": lambda m, s, d: ([m[0][..., :3].contiguous()] + m[1:],
                                       s, d, "level 0: expected"),
    "strided level": lambda m, s, d: ([m[0].transpose(0, 1)] + m[1:], s, d,
                                      "level 0: expected"),
    "start (n, 4)": lambda m, s, d: (m, torch.zeros(64, 4), d,
                                     "start: expected"),
    "dirs (n, 3)": lambda m, s, d: (m, s, d[:, 0], "dirs: expected"),
    "nine cones": lambda m, s, d: (m, s, torch.cat([d, d[:, :3]], dim=1),
                                   "1 to 8 cones"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_gather_cuda_refuses_bad_operands(fake, case):
    mips, start, dirs, sched, kw = _case("aniso", "diffuse")
    m, s, d, msg = REFUSALS[case](list(mips), start, dirs)
    before = _build.launches()
    with pytest.raises(ValueError, match=f"percone kernel: .*{msg}"):
        PC.gather_cuda(s, d, *m, **kw)
    assert fake.calls == [] and _build.launches() == before


def test_gather_cuda_refuses_long_schedules_and_large_pyramids(
        fake, monkeypatch):
    mips, start, dirs, sched, kw = _case("iso", "specular")
    long = dict(kw, table=kw["table"] * 20)
    assert len(long["table"]) > PC.MAX_STEPS
    with pytest.raises(ValueError, match="at most 128 steps"):
        PC.gather_cuda(start, dirs, *mips, **long)
    monkeypatch.setattr(PC, "MAX_CELLS", DIM ** 3)
    with pytest.raises(ValueError, match="addresses texels in 32 bits"):
        PC.gather_cuda(start, dirs, *mips, **kw)
    assert fake.calls == []


def test_gather_cuda_never_runs_cpu_tensors(monkeypatch):
    """Without the stand-in, a CPU operand is refused, not marched."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    mips, start, dirs, sched, kw = _case("aniso", "diffuse")
    with pytest.raises(ValueError, match="CUDA tensor"):
        PC.gather_cuda(start, dirs, *mips, **kw)


def test_refused_launch_raises(fake):
    fake.status = 1
    mips, start, dirs, sched, kw = _case("iso", "diffuse")
    with pytest.raises(RuntimeError, match="vct_percone: CUDA error 1"):
        PC.gather_cuda(start, dirs, *mips, **kw)


# ---------------------------------------------------------------------------
# render/shading's providers
# ---------------------------------------------------------------------------

def _cfg(kind):
    cfg = preset("aniso128" if kind == "aniso" else "cornell64_full")
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=DIM, world_size=WS))


def _provider_inputs(kind, seed=11, n=48):
    cfg = _cfg(kind)
    mips = PYRAMIDS[kind](_grid(seed))
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(-40, 40, (n, 3)).astype(np.float32))
    nrm = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    t, bt = C.orthonormal_frame(nrm)
    return cfg, mips, pos, nrm, S.pixel_cone_dirs(cfg, nrm, t, bt)


def _providers(cfg, mips, pos, nrm, cone_dirs):
    d = S.indirect_diffuse_percone(cfg, mips, pos, nrm, cone_dirs)
    s = S.indirect_specular_percone(cfg, mips, pos, nrm, cone_dirs[:, 0])
    return d + s


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel's route taken on the CPU: uses_kernel forced, the launch
    replaced by the twin, counted into the percone row."""
    def twin(*args, **kw):
        _build._launched["percone"] += 1
        return PC.gather_plain(*args, **kw)
    monkeypatch.setattr(_build, "uses_kernel", lambda *t: True)
    monkeypatch.setattr(PC, "gather_cuda", twin)


@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_providers_launch_once_a_call_and_count(kind, kernel_route,
                                                counting):
    cfg, mips, pos, nrm, cone_dirs = _provider_inputs(kind)
    before = _build.launches()["percone"]
    got = _providers(cfg, mips, pos, nrm, cone_dirs)
    assert _build.launches()["percone"] - before == 2
    kernel_counts = {k: int(v) for k, (v, _) in stages.counters().items()}
    stages.reset_counters()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "uses_kernel", lambda *t: False)
        want = _providers(cfg, mips, pos, nrm, cone_dirs)
    march_counts = {k: int(v) for k, (v, _) in stages.counters().items()}
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    assert kernel_counts == march_counts
    assert 0 < kernel_counts["percone.active"] < kernel_counts[
        "percone.samples"]


def test_providers_on_cpu_run_core_march_unchanged(monkeypatch):
    """CPU tensors take core/march exactly as before: bit-equal outputs,
    no launch."""
    monkeypatch.setattr(PC, "cone_gather",
                        lambda *a, **k: pytest.fail("kernel route taken"))
    cfg, mips, pos, nrm, cone_dirs = _provider_inputs("aniso")
    got = _providers(cfg, mips, pos, nrm, cone_dirs)
    ca = cfg.cones
    start = pos + nrm * cfg.grid.voxel_world_size
    rgb, occ = M.cone_march_multi(
        mips, start, cone_dirs, tuple(float(w) for w in C.CONE_WEIGHTS),
        S.diffuse_schedule(cfg), WS, ca.max_alpha, ca.occlusion_falloff)
    srgb, socc, _ = M.cone_march(mips, start, cone_dirs[:, 0],
                                 S.specular_schedule(cfg), WS, ca.max_alpha,
                                 ca.occlusion_falloff)
    for a, b in zip(got, (rgb, occ, srgb, socc)):
        assert torch.equal(a, b)


def test_kernel_route_gradient_is_the_twins(kernel_route):
    """Under autograd the kernel's route runs in _build.Replay, whose
    backward replays the twin: the pyramid's gradient equals autograd of
    the twin itself."""
    cfg, mips, pos, nrm, cone_dirs = _provider_inputs("iso")
    leaf = mips[0].clone().requires_grad_()
    pyramid = G.build_mips(leaf)
    rgb, occ = S.indirect_diffuse_percone(cfg, pyramid, pos, nrm, cone_dirs)
    got, = torch.autograd.grad((rgb.sum() + occ.sum()), leaf)
    ca = cfg.cones
    pyramid = G.build_mips(leaf)
    table = PC.step_table(S.diffuse_schedule(cfg), len(pyramid),
                          ca.occlusion_falloff)
    out = PC.gather_plain(pos + nrm * cfg.grid.voxel_world_size, cone_dirs,
                          *pyramid, table=table,
                          weights=tuple(float(w) for w in C.CONE_WEIGHTS),
                          world_size=WS, max_alpha=ca.max_alpha)
    want, = torch.autograd.grad(out.sum(), leaf)
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_read_levels_renumbers_the_table():
    sched = M.march_schedule(0.577, VOXEL, 75.0)
    table = PC.step_table(sched, 5, FALLOFF)
    compact, levels = PC.read_levels(table)
    assert levels == (0, 1, 2, 3)
    for st, ct in zip(table, compact):
        assert (levels[ct.l0], levels[ct.l1]) == (st.l0, st.l1)
        assert ct._replace(l0=st.l0, l1=st.l1) == st
    spec = PC.step_table(M.march_schedule(0.07, VOXEL, 75.0), 5, FALLOFF)
    assert PC.read_levels(spec)[1] == (0,)
    assert PC.read_levels(())[1] == (0,)


def _levels_with_gradient(kind, route):
    """The pyramid levels that a backward through both providers reaches
    (a tensor hook on each level)."""
    cfg, mips, pos, nrm, cone_dirs = _provider_inputs(kind)
    leaf = mips[0].clone().requires_grad_()
    pyramid = PYRAMIDS[kind](leaf)
    reached = set()
    for i, m in enumerate(pyramid[1:], start=1):
        m.register_hook(lambda g, i=i: reached.add(i))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "uses_kernel", lambda *t: route)
        mp.setattr(PC, "gather_cuda", PC.gather_plain)
        out = _providers(cfg, pyramid, pos, nrm, cone_dirs)
    torch.autograd.grad(sum(x.sum() for x in out), leaf)
    return reached


@pytest.mark.parametrize("kind", sorted(PYRAMIDS))
def test_kernel_route_reaches_the_levels_core_march_reaches(kind):
    """The march takes only the levels its schedules read, so the
    backward reaches no other level (whose mip backward would run on
    zeros)."""
    got = _levels_with_gradient(kind, True)
    assert got == _levels_with_gradient(kind, False)
    assert got and len(got) < len(PYRAMIDS[kind](_grid(0))) - 1
