"""The port's brick-sharded dense march (vct_tpu_torch/parallel/brick.py)
against its unsharded march and the JAX package's sharded one, on gloo
process groups of CPU ranks.

tests/test_brick.py's fixtures: its make_mips (80 random emissive cells),
DIRS (one direction along the sharded axis), its schedules and its 32^3
field config.  One spawn of 4 ranks (a 1 x 4 mesh) serves the marches,
the gradient and the shard decisions, one of 2 ranks (1 x 2) the march
and the builds; the JAX references run on the conftest's 8 CPU devices
(a 2 x 4 mesh), as tests/test_brick.py runs them, under jax.jit.

Bounds are test_brick.py's: the marches rtol 1e-4 / atol 1e-5 (measured:
the port's sharded march is bit-equal to its unsharded one, since each
cell gets the same arithmetic), the gradient rtol 1e-3 / atol 1e-4 and
the build rtol 2e-5 / atol 2e-5 (the light volume bit-equal, the splat's
partial grids summed over the ranks in another order).  The ranks import
only torch and the port: jax is imported inside the tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vct_tpu_torch.config import preset
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.parallel import brick as B
from vct_tpu_torch.parallel import comm
from vct_tpu_torch.parallel import mesh as ML
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

WS, DIM = 150.0, 32
DIRS = np.asarray([
    [0.0, 0.0, 1.0],
    [1.0, 0.0, 0.0],           # along the sharded axis — worst case
    [0.6, -0.64, 0.48],
])
DIRS = DIRS / np.linalg.norm(DIRS, axis=-1, keepdims=True)
LIGHT_DIR = np.asarray([[0.0, 0.97014254, 0.24253564]])
MARCH = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
BUILD = dict(rtol=2e-5, atol=2e-5)


def make_mips(dim=32, seed=0):
    """tests/test_brick.py's make_mips, through the port's build_mips."""
    rng = np.random.default_rng(seed)
    base = np.zeros((dim, dim, dim, 4), np.float32)
    for _ in range(80):
        i, j, k = rng.integers(1, dim - 1, size=3)
        base[i, j, k] = [*rng.uniform(0.2, 1.0, 3), rng.uniform(0.3, 1.0)]
    return G.build_mips(torch.as_tensor(base))


def gather_sched():
    return M.march_schedule(0.577, WS / DIM, 75.0, 12)


def shadow_sched():
    # a wider shadow cone, so that level 0 shards at this toy size
    return M.march_schedule(0.2, WS / DIM, WS, 12, step_factor=0.5)


def grad_sched():
    return M.march_schedule(0.577, WS / 16, 75.0, 8)


def field_cfg(brick_parallel):
    """tests/test_brick.py's integration config: sponza256 at 32^3 in
    float32, 32^3 fields of a 6-direction basis, 2 diffuse cones."""
    cfg = preset("sponza256")
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=32, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=32, field_basis=6,
                                  num_diffuse_cones=2),
        sharding=dataclasses.replace(cfg.sharding, data_parallel=1,
                                     brick_parallel=brick_parallel))


def grad_through_march(mesh=None):
    """d sum(march) / d level 0 at 16^3 over DIRS[:2], summed over the
    model axis when sharded (each rank's gradient is its slab's share)."""
    mips = make_mips(16, seed=4)
    lvl0 = mips[0].clone().requires_grad_()
    stack = (lvl0,) + tuple(mips[1:])
    if mesh is None:
        D.directional_march_multi(stack, DIRS[:2], grad_sched(),
                                  WS).sum().backward()
        return lvl0.grad
    B.sharded_directional_march_multi(stack, DIRS[:2], grad_sched(), WS,
                                      mesh, min_shard_rows=2).sum().backward()
    return comm.all_reduce(lvl0.grad, comm.axis(mesh, "model"))


def marches(mesh):
    gather = B.gather_x(B.sharded_directional_march_multi(
        make_mips(DIM, seed=1), DIRS, gather_sched(), WS, mesh,
        min_shard_rows=4), mesh)
    shadow = B.gather_x(B.sharded_directional_march_multi(
        make_mips(DIM, seed=2), LIGHT_DIR, shadow_sched(), WS, mesh,
        opacity_gain=4.0, transmittance_only=True, min_shard_rows=4), mesh)
    return gather, shadow


def four_ranks():
    mesh = ML.make_mesh(1, 4, device_type="cpu")
    gather, shadow = marches(mesh)
    placed = B.shard_mips(mesh, make_mips(DIM), n_min_rows=4)
    return dict(gather=gather, shadow=shadow, grad=grad_through_march(mesh),
                placed=[tuple(m.shape) for m in placed])


def two_ranks():
    mesh = ML.make_mesh(1, 2, device_type="cpu")
    gather, shadow = marches(mesh)
    cfg = field_cfg(2)
    _, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0),
                                       device="cpu")
    sharded = R.build_voxel_state(cfg, samples, mats, mesh=mesh)
    aniso = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, anisotropic=True))
    refused = {}
    for what, bad, error in (("aniso", aniso, NotImplementedError),
                             ("mismatch", field_cfg(4), ValueError)):
        try:
            R.build_voxel_state(bad, samples, mats, mesh=mesh)
            refused[what] = None
        except error as e:
            refused[what] = str(e)
    return dict(gather=gather, shadow=shadow, state=sharded,
                refused=refused)


@pytest.fixture(scope="module")
def ranks4():
    return ML.spawn(four_ranks, 4)


@pytest.fixture(scope="module")
def ranks2():
    return ML.spawn(two_ranks, 2)


@pytest.fixture(scope="module")
def unsharded():
    gather = D.directional_march_multi(make_mips(DIM, seed=1), DIRS,
                                       gather_sched(), WS)
    shadow = D.directional_march_multi(
        make_mips(DIM, seed=2), LIGHT_DIR, shadow_sched(), WS,
        opacity_gain=4.0, transmittance_only=True)
    return dict(gather=gather, shadow=shadow)


@pytest.fixture(scope="module")
def jax_marches():
    """JAX's sharded marches on the 2 x 4 CPU mesh, on the port's mips,
    in the port's layout (under jax.jit: eager shard_map runs op by op)."""
    import jax
    import jax.numpy as jnp
    from vct_tpu.core import march as JM
    from vct_tpu.parallel import brick as JB
    from vct_tpu.parallel import mesh as jmesh

    mesh4 = jmesh.make_mesh(n_data=2, n_model=4)

    def jmips(seed, dim=DIM):
        return tuple(jnp.asarray(m.numpy()) for m in make_mips(dim, seed))

    gather = jax.jit(lambda m: JB.sharded_directional_march_multi(
        m, DIRS, JM.march_schedule(0.577, WS / DIM, 75.0, 12), WS,
        mesh4, min_shard_rows=4))(jmips(1))
    shadow = jax.jit(lambda m: JB.sharded_directional_march_multi(
        m, LIGHT_DIR, JM.march_schedule(0.2, WS / DIM, WS, 12,
                                        step_factor=0.5), WS,
        mesh4, opacity_gain=4.0, transmittance_only=True,
        min_shard_rows=4))(jmips(2))
    # (B, df, df, df, C) -> (df, df, df, B*C)
    return {k: np.moveaxis(np.asarray(v), 0, -2).reshape(DIM, DIM, DIM, -1)
            for k, v in (("gather", gather), ("shadow", shadow))}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("what", ["gather", "shadow"])
def test_sharded_march_equals_unsharded(ranks2, ranks4, unsharded, world,
                                        what):
    for rank in (ranks2 if world == 2 else ranks4):
        np.testing.assert_allclose(rank[what].numpy(),
                                   unsharded[what].numpy(), **MARCH)
        assert torch.equal(rank[what], unsharded[what])   # same arithmetic


@pytest.mark.parametrize("what", ["gather", "shadow"])
def test_sharded_march_equals_jax(ranks4, jax_marches, what):
    np.testing.assert_allclose(ranks4[0][what].numpy(), jax_marches[what],
                               **MARCH)


def test_halo_and_shard_decisions_equal_jax():
    """The port's per-level halos and shard decisions are the JAX
    package's (_halo_for_level over the steps touching each level, and
    its shard rule), and level 0 shards at 32^3 over 4 ranks."""
    from vct_tpu.parallel import brick as JB
    for dirs, sched, rows in ((DIRS, gather_sched(), 4),
                              (LIGHT_DIR, shadow_sched(), 4),
                              (DIRS[:2], grad_sched(), 2)):
        dims = [DIM >> i for i in range(6)] if rows == 4 else \
            [16 >> i for i in range(5)]
        halos, sharded = B.shard_plan(dirs, sched, dims, WS, 4, rows)
        plan, _ = D.plan_groups(sched.lods, len(dims))
        for lvl, dl in enumerate(dims):
            steps = [k for k, (l0, l1, w) in enumerate(plan)
                     if l0 == lvl or (w > 0.0 and l1 == lvl and l1 != l0)]
            if not steps:
                assert not sharded[lvl]
                continue
            h = JB._halo_for_level(dirs, sched.dists, steps, dl, WS)
            assert B._halo_for_level(dirs, sched.dists, steps, dl, WS) == h
            ok = dl % 4 == 0 and dl // 4 >= max(rows, h + 1)
            assert sharded[lvl] == ok
            assert halos[lvl] == (h if ok else 0)
        assert sharded[0], "level 0 must shard (not the whole-level fallback)"


def test_gradient_through_exchange(ranks4):
    """The gradient through the halo exchange (its backward sends the halo
    rows' gradients back) equals autograd's unsharded gradient and JAX's
    jax.grad of its sharded march."""
    import jax
    import jax.numpy as jnp
    from vct_tpu.core import march as JM
    from vct_tpu.parallel import brick as JB
    from vct_tpu.parallel import mesh as jmesh

    ref = grad_through_march()
    for rank in ranks4:
        assert torch.isfinite(rank["grad"]).all()
        np.testing.assert_allclose(rank["grad"].numpy(), ref.numpy(), **GRAD)

    mips = tuple(jnp.asarray(m.numpy()) for m in make_mips(16, seed=4))
    mesh4 = jmesh.make_mesh(n_data=2, n_model=4)
    sched = JM.march_schedule(0.577, WS / 16, 75.0, 8)

    def loss(lvl0):
        return jnp.sum(JB.sharded_directional_march_multi(
            (lvl0,) + mips[1:], DIRS[:2], sched, WS, mesh4,
            min_shard_rows=2))

    np.testing.assert_allclose(ranks4[0]["grad"].numpy(),
                               np.asarray(jax.jit(jax.grad(loss))(mips[0])),
                               **GRAD)


def test_shard_mips_placement(ranks4):
    # 32 and 16 rows over 4: 8- and 4-row slabs; 8 and below: whole
    assert ranks4[0]["placed"][:3] == [(8, 32, 32, 4), (4, 16, 16, 4),
                                        (8, 8, 8, 4)]
    assert ranks4[0]["placed"][-1] == (1, 1, 1, 4)


@pytest.mark.parametrize("field", ["light_volume", "diffuse_field",
                                   "specular_field", "radiance"])
def test_build_voxel_state_sharded_equals_unsharded(ranks2, field):
    cfg = field_cfg(1)
    _, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0),
                                       device="cpu")
    ref = R.build_voxel_state(cfg, samples, mats)
    for rank in ranks2:
        state = rank["state"]
        if field == "radiance":
            for a, b in zip(state.radiance_mips, ref.radiance_mips):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **BUILD)
        else:
            np.testing.assert_allclose(getattr(state, field).numpy(),
                                       getattr(ref, field).numpy(), **BUILD)


def test_anisotropic_raises(ranks2):
    for rank in ranks2:
        assert "anisotropic" in (rank["refused"]["aniso"] or "")


def test_model_axis_must_match_brick_parallel(ranks2):
    """brick_parallel=4 on a mesh whose model axis is 2 raises, as the
    JAX package's _use_brick_sharding does."""
    for rank in ranks2:
        assert "brick_parallel=4" in (rank["refused"]["mismatch"] or "")
