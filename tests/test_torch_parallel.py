"""The port's mesh, tile data parallelism and sharded steps
(vct_tpu_torch/parallel/mesh.py, tile_dp.py) on a 2 x 2 mesh of gloo CPU
ranks, against one rank and the JAX package, as tests/test_parallel.py
holds the JAX package's on its 8-device CPU mesh.

One spawn of 4 ranks serves every assertion.  Fixtures: test_parallel.py's
small_cfg (preset cornell64_full at 16^3, 32x32, the Cornell box from
(0, 0, 140)), with the sharding set to the mesh (data 2, model 2), so
the samples shard over 'model' and the light volume marches
brick-sharded.  Bounds: renders rtol 2e-4 / atol 2e-5 (test_parallel.py);
the splat's partials reduced over two ranks atol 1e-6; the padded build
rtol 1e-5 / atol 1e-6; the train step's loss and gradients 1e-5
relative to one rank's (measured 4e-7): a gradient counted once per
model rank would be 2x off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vct_tpu_torch.core import grid as G
from vct_tpu_torch.diff import inverse as I
from vct_tpu_torch.parallel import comm
from vct_tpu_torch.parallel import mesh as ML
from vct_tpu_torch.parallel import tile_dp as T
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import voxelize as V

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

SIZE, DIM, CHUNK = 32, 16, 256
RENDER = dict(rtol=2e-4, atol=2e-5)
STEP_REL = 1e-5
STEPS = 5


def setup(sharded=True):
    cfg, ds, mats, samples, origins, dirs, cam_pos = T._tiny_setup(
        SIZE, SIZE, DIM, torch.device("cpu"))
    n = 2 if sharded else 1
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, data_parallel=n, brick_parallel=n))
    return cfg, ds, mats, samples, origins, dirs, cam_pos


def start_params(mats):
    """test_parallel.py's perturbed start: albedo * 0.5 + 0.2, light 0.7."""
    return {"albedo": I._leaf(mats.albedo * 0.5 + 0.2),
            "light": I._leaf(torch.full((3,), 0.7))}


def splat_inputs(samples):
    rng = np.random.default_rng(0)
    n = samples.positions.shape[0]
    values = torch.as_tensor(rng.uniform(0.0, 1.0, (n, 3)),
                             dtype=torch.float32)
    weights = torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=torch.float32)
    return samples.positions, values, weights


def mesh_cases():
    """Shapes and refusals of make_mesh on 4 ranks."""
    whole = ML.make_mesh(device_type="cpu")
    cases = {"whole": (tuple(whole.mesh.shape), whole.mesh_dim_names)}
    for name, kw in (("too_many", dict(n_data=8, n_model=1)),
                     ("not_divisible", dict(n_model=3))):
        try:
            ML.make_mesh(device_type="cpu", **kw)
            cases[name] = None
        except ValueError as e:
            cases[name] = str(e)
    axis = comm.whole(whole)
    cases["whole_axis"] = (axis.index, axis.size, axis.ranks)
    try:
        comm.whole(ML.make_mesh(1, 2, device_type="cpu"))
        cases["partial_axis"] = None
    except ValueError as e:
        cases["partial_axis"] = str(e)
    return cases


def four_ranks():
    cases = mesh_cases()
    mesh = ML.make_mesh(2, 2, device_type="cpu")
    out = dict(cases=cases, layout=mesh.mesh.tolist(),
               coord=(mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")))

    cfg, ds, mats, samples, origins, dirs, cam_pos = setup()
    # the splat's partial grids over this rank's share, reduced over model
    pos, values, weights = splat_inputs(samples)
    n = samples.positions.shape[0]
    share = ML.local_samples(dataclasses.replace(
        samples, normals=values, uvs=weights[:, None]), mesh)
    reduce = comm.reducer(comm.axis(mesh, "model"))
    out["splat"] = {mode: V.splat(share.positions, share.normals,
                                  share.uvs[:, 0], DIM, 150.0, mode=mode,
                                  reduce=reduce)
                    for mode in ("mean", "max")}
    out["share"] = share.positions.shape[0] / n

    # the sharded render, and the camera pass alone on one rank's build
    img = T.sharded_render_fn(cfg, ds, mesh, CHUNK)(origins, dirs, cam_pos,
                                                    samples, mats)
    out["render"] = T.gather_rows(img, mesh)
    voxels = R.build_voxel_state(setup(False)[0], samples, mats)
    camera = T.shardmap_camera_fn(cfg, ds, mesh, CHUNK)
    with comm.count_calls() as calls:
        rows = camera(origins, dirs, cam_pos, voxels, mats)
    out["camera_calls"] = dict(calls)
    out["camera"] = T.gather_rows(rows, mesh)

    # the train step
    step = T.sharded_train_step_fn(cfg, ds, mesh, chunk_size=CHUNK)
    params = start_params(mats)
    opt_state = I.adam(5e-2)(params)
    target = R.render_rays(setup(False)[0], ds, voxels, mats, origins, dirs,
                           cam_pos, chunk_size=CHUNK)
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, origins, dirs,
                                       cam_pos, samples, mats, target)
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in params.items()}
        losses.append(float(loss))
    out["losses"] = losses
    out["dryrun"] = T.dryrun_multichip(4, steps=3, device="cpu")
    return out


@pytest.fixture(scope="module")
def ranks():
    return ML.spawn(four_ranks, 4)


@pytest.fixture(scope="module")
def single():
    cfg, ds, mats, samples, origins, dirs, cam_pos = setup(False)
    voxels = R.build_voxel_state(cfg, samples, mats)
    img = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                        chunk_size=CHUNK)
    return dict(cfg=cfg, ds=ds, mats=mats, samples=samples, origins=origins,
                dirs=dirs, cam_pos=cam_pos, voxels=voxels, img=img)


def test_mesh_shapes_and_errors(ranks):
    for r, rank in enumerate(ranks):
        assert rank["cases"]["whole"] == ((4, 1), ("data", "model"))
        assert "need 8 ranks" in rank["cases"]["too_many"]
        assert "not divisible" in rank["cases"]["not_divisible"]
        # row-major, as the JAX package lays out devices: the model ranks
        # of one data row are neighbours
        assert rank["layout"] == [[0, 1], [2, 3]]
        assert rank["coord"] == divmod(r, 2)


def test_whole_mesh_axis(ranks):
    # the train step's one reduce over every rank of the mesh, which
    # must hold the whole world
    for r, rank in enumerate(ranks):
        assert rank["cases"]["whole_axis"] == (r, 4, (0, 1, 2, 3))
        assert "a mesh of 2 ranks in a world of 4" in \
            rank["cases"]["partial_axis"]


def old_splat(positions, values, weights, dim, world_size, mode="mean"):
    """voxelize.splat before it was split into partials and a finish."""
    idx = torch.floor(G.world_to_uvw(positions, world_size) * dim).long()
    inside = torch.all((idx >= 0) & (idx < dim), dim=-1)
    idx = idx.clamp(0, dim - 1)
    flat = (idx[:, 0] * dim + idx[:, 1]) * dim + idx[:, 2]
    w = torch.where(inside, weights, 0.0)
    n = dim ** 3
    c = values.shape[-1]
    order = torch.sort(flat, stable=True).indices
    cells, counts = torch.unique_consecutive(flat[order], return_counts=True)

    def segments(x, reduce):
        return torch.segment_reduce(x[order], reduce, lengths=counts, axis=0)

    wsum = torch.zeros((n,), dtype=values.dtype)
    wsum[cells] = segments(w, "sum")
    color = torch.zeros((n, c), dtype=values.dtype)
    if mode == "mean":
        color[cells] = segments(w[:, None] * values, "sum")
        color = color / torch.clamp_min(wsum[:, None], 1e-8)
    else:
        picked = torch.where(w[:, None] > 0, values, 0.0)
        color[cells] = torch.clamp_min(segments(picked, "max"), 0.0)
    alpha = (wsum > 0).to(values.dtype)
    out = torch.cat([color, alpha[:, None]], dim=-1)
    return out.reshape(dim, dim, dim, c + 1)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_splat_bits_unchanged(single, mode):
    args = splat_inputs(single["samples"])
    assert torch.equal(V.splat(*args, DIM, 150.0, mode=mode),
                       old_splat(*args, DIM, 150.0, mode=mode))


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_splat_partials_reduced_over_model(ranks, single, mode):
    ref = V.splat(*splat_inputs(single["samples"]), DIM, 150.0, mode=mode)
    for rank in ranks:
        assert 0.45 < rank["share"] < 0.55       # each splats half
        np.testing.assert_allclose(rank["splat"][mode].numpy(), ref.numpy(),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_image():
    """tests/test_parallel.py's replicated reference: JAX's build and
    render_rays on small_cfg."""
    import jax
    import jax.numpy as jnp
    from vct_tpu.config import GridConfig as JGrid
    from vct_tpu.config import preset as jpreset
    from vct_tpu.core import camera as jcam
    from vct_tpu.render import renderer as JR
    from vct_tpu.scene import cornell_box as jcornell

    cfg = jpreset("cornell64_full")
    cfg = dataclasses.replace(
        cfg, grid=JGrid(dim=DIM, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=SIZE, height=SIZE))
    camera = jcam.Camera(position=(0.0, 0.0, 140.0))
    ds, mats, samples = JR.prepare_scene(cfg, jcornell(size=100.0))
    origins, dirs = jcam.primary_rays(camera, SIZE, SIZE)
    cam_pos = jnp.asarray(camera.position, jnp.float32)

    @jax.jit
    def render(origins, dirs, cam_pos, samples, mats):
        voxels = JR.build_voxel_state(cfg, samples, mats)
        return JR.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                              chunk_size=CHUNK)

    return np.asarray(render(origins, dirs, cam_pos, samples, mats))


@pytest.mark.parametrize("fn", ["render", "camera"])
def test_sharded_render_matches_one_rank_and_jax(ranks, single, jax_image,
                                                 fn):
    img = ranks[0][fn]
    assert img.shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(img.numpy(), single["img"].numpy(), **RENDER)
    np.testing.assert_allclose(img.numpy(), jax_image, **RENDER)
    assert all(rank[fn] is None for rank in ranks[1:] if rank["coord"][0])


def test_camera_pass_makes_no_collective_call(ranks):
    for rank in ranks:
        assert rank["camera_calls"] == {}


def test_out_of_grid_padding_is_noop(single):
    s = single
    padded = T.pad_samples(s["samples"], 64)
    assert padded.positions.shape[0] % 64 == 0
    assert padded.positions.shape[0] > s["samples"].positions.shape[0]
    v2 = R.build_voxel_state(s["cfg"], padded, s["mats"])
    np.testing.assert_allclose(v2.radiance_mips[0].numpy(),
                               s["voxels"].radiance_mips[0].numpy(),
                               rtol=1e-5, atol=1e-6)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def test_train_step_equals_one_rank(ranks, single):
    """The first step's loss and parameter gradients on every rank equal
    one rank's make_loss_fn over the whole image; the losses fall."""
    s = single
    inv = I.InverseConfig(optimize=("albedo", "light"), chunk_size=CHUNK)
    params = start_params(s["mats"])
    loss = I.make_loss_fn(inv, s["cfg"], s["ds"], s["cam_pos"])(
        params, s["samples"], s["mats"], s["origins"], s["dirs"], s["img"])
    loss.backward()
    loss = float(loss.detach())
    for rank in ranks:
        assert abs(rank["losses"][0] - loss) <= STEP_REL * loss
        for k, p in params.items():
            assert rel(rank["grads"][k], p.grad) <= STEP_REL, k
        assert np.isfinite(rank["losses"]).all()
        assert rank["losses"][-1] < rank["losses"][0]
        assert rank["losses"] == ranks[0]["losses"]


def test_dryrun_multichip(ranks):
    """__graft_entry__.dryrun_multichip's counterpart on 4 ranks: a 2 x 2
    mesh, finite losses that fall over 3 steps, and the brick-sharded
    field build's render (its mean on rank 0)."""
    for rank in ranks:
        dry = rank["dryrun"]
        assert dry["mesh"] == (2, 2)
        assert np.isfinite(dry["losses"]).all()
        assert dry["losses"][-1] < dry["losses"][0]
        assert (dry["image_mean"] is not None) == (rank is ranks[0])
    assert 0.0 < ranks[0]["dryrun"]["image_mean"] < 1.0
