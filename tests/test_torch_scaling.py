"""The port's scaling sweep (vct_tpu_torch/bench_scaling.py) against
bench_scaling.py's set-up and work formulas and the JAX package's
shard_map camera pass, on gloo CPU ranks through parallel/mesh.spawn.

The set-up and the work counts at bench_scaling.py's own operating point
(64^3, 512 x 512); the ranks at a small cut (16^3, 32 x 32, one timed
call): one spawn of 2 ranks for the strong camera pass, the rows
gathered against JAX's tile_dp.shardmap_camera_fn on 2 of the conftest's
8 CPU devices within tests/test_parallel.py's bounds (rtol 2e-4, atol
2e-5) with 0 torch.distributed calls; one weak sweep over 1 and 2 ranks,
its march at 2 ranks bit-equal to one rank's over the tiled basis; and
the torchrun route, 2 processes through init_distributed, strong.  The
ranks import only torch and the port: jax is imported inside the tests.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vct_tpu_torch import bench_scaling as BS
from vct_tpu_torch.parallel import mesh as ML

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

SMALL = BS.Settings(dim=16, width=32, height=32, reps=1)
RENDER = dict(rtol=2e-4, atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scaling_r05_keys(mode):
    with open(os.path.join(ROOT, "SCALING_r05.json")) as f:
        recs = json.load(f)[mode]["records"]
    return {r["devices"]: set(r) for r in recs}


def jax_config(dim, width, height):
    """bench_scaling.py:87-92 through the JAX package."""
    from vct_tpu.config import preset as jpreset
    cfg0 = jpreset("sponza256")
    return dataclasses.replace(
        cfg0,
        grid=dataclasses.replace(cfg0.grid, dim=dim, compute="float32"),
        cones=dataclasses.replace(cfg0.cones, field_dim=dim),
        render=dataclasses.replace(cfg0.render, width=width, height=height))


def test_setup_matches_bench_scaling():
    """setup()'s config, rays and march directions at the defaults equal
    those bench_scaling.py:87-97 and :145-147 make."""
    from vct_tpu.core import camera as jcam
    from vct_tpu.core import dense as JD

    s = BS.Settings()
    assert (s.dim, s.width, s.height, s.reps) == (64, 512, 512, 3)
    st = BS.setup(s, device="cpu")
    assert dataclasses.asdict(st["cfg"]) == dataclasses.asdict(
        jax_config(64, 512, 512))
    origins, dirs = jcam.primary_rays(jcam.Camera(position=(3.0, 2.0, 140.0)),
                                      512, 512)
    np.testing.assert_array_equal(st["origins"].numpy(), np.asarray(origins))
    np.testing.assert_allclose(st["dirs"].numpy(), np.asarray(dirs),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(st["cam"].numpy(), [3.0, 2.0, 140.0])
    basis = JD.direction_basis(26)
    np.testing.assert_array_equal(BS.march_basis(st["cfg"], 4, "strong"),
                                  basis)
    np.testing.assert_array_equal(BS.march_basis(st["cfg"], 4, "weak"),
                                  np.tile(basis, (4, 1)))
    assert BS.COUNTS == (1, 2, 4, 8)


@pytest.mark.parametrize("mode", BS.MODES)
@pytest.mark.parametrize("n", [1, 2])
def test_work_equals_bench_scaling(mode, n):
    """rays = W * h_n, cone samples = B_n * steps * dim^3 with JAX's
    diffuse schedule and basis (bench_scaling.py:116, 140, 145-147,
    173)."""
    from vct_tpu.core import dense as JD
    from vct_tpu.render import shading as JS

    cfg = jax_config(64, 512, 512)
    h_n = 512 * n if mode == "weak" else 512
    basis = JD.direction_basis(cfg.cones.field_basis)
    if mode == "weak":
        basis = np.tile(basis, (n, 1))
    want = (512 * h_n, basis.shape[0]
            * JS.diffuse_schedule(cfg).num_steps * 64 ** 3)
    assert BS.work(BS.config(64, 512, 512), n, mode) == want


@pytest.fixture(scope="module")
def strong_two():
    return BS.sweep(2, "strong", SMALL, "cpu", check=True)


@pytest.fixture(scope="module")
def jax_camera_image():
    """bench_scaling.py:118-132 at the small cut on 2 virtual devices."""
    import jax
    import jax.numpy as jnp
    from vct_tpu.core import camera as jcam
    from vct_tpu.parallel import mesh as jmesh
    from vct_tpu.parallel import tile_dp as jtile
    from vct_tpu.render import renderer as JR
    from vct_tpu.scene.cornell import cornell_box as jcornell

    cfg0 = jax_config(SMALL.dim, SMALL.width, SMALL.height)
    camera = jcam.Camera(position=(3.0, 2.0, 140.0))
    ds, mats, samples = JR.prepare_scene(cfg0, jcornell(size=100.0))
    origins, dirs = jcam.primary_rays(camera, SMALL.width, SMALL.height)
    cam = jnp.asarray(camera.position, jnp.float32)
    cfg = dataclasses.replace(cfg0, sharding=dataclasses.replace(
        cfg0.sharding, data_parallel=2, brick_parallel=1))
    mesh = jmesh.make_mesh_for(cfg, devices=jax.devices()[:2])
    voxels = jtile.sharded_build_fn(cfg, mesh)(jtile.pad_samples(samples, 1),
                                               mats)
    render = jtile.shardmap_camera_fn(cfg, ds, mesh, chunk_size=BS.CHUNK)
    return np.asarray(render(origins, dirs, cam, voxels, mats))


def test_camera_pass_matches_jax_shard_map(strong_two, jax_camera_image):
    r0, r1 = strong_two
    assert r0["rows"] == r1["rows"] == (SMALL.height // 2, SMALL.width, 3)
    img = r0["image"]
    assert r1["image"] is None
    assert img.shape == jax_camera_image.shape == (SMALL.height,
                                                   SMALL.width, 3)
    np.testing.assert_allclose(img.numpy(), jax_camera_image, **RENDER)
    assert r0["collective_calls"] == r1["collective_calls"] == 0


@pytest.fixture(scope="module")
def weak_records():
    return BS.run(counts=(1, 2), mode="weak", device="cpu", settings=SMALL,
                  check=(2,))


def test_weak_march_bit_equal_to_one_rank(weak_records):
    """The 2 ranks' slabs of the march over the basis tiled twice,
    gathered, equal one rank's march of it bit for bit."""
    chk = weak_records[1]["march_check"]
    assert chk == {"max_abs_err": 0.0, "bit_equal": True,
                   "shape": [16, 16, 16, 2 * 26 * 4]}


def test_weak_records(weak_records):
    """The keys of SCALING_r05.json's weak records and the port's own;
    the work, the controls' arithmetic, 0 collectives and no staging on
    CPU ranks."""
    want = scaling_r05_keys("weak")
    cfg = BS.config(SMALL.dim, SMALL.width, SMALL.height)
    for rec in weak_records:
        n = rec["devices"]
        assert want[n] <= set(rec)
        assert (rec["rays"], rec["cone_samples"]) == BS.work(cfg, n, "weak")
        assert rec["collective_calls"] == 0
        assert rec["staged_bytes"] == [0] * n
        assert rec["card"] == "cpu" and rec["ranks_share_one_card"] is False
        assert all(np.isfinite(rec[k]) and rec[k] > 0 for k in (
            "rays_per_s", "cone_samples_per_s", "t_camera_ms",
            "t_march_ms"))
    one, two = weak_records
    assert one["rays_scaling_efficiency"] == 1.0
    assert "t_ctl_ms" not in one
    assert two["t_seq_ms"] == pytest.approx(2 * two["t_1x_ms"])
    assert two["serialization_gap_ms"] == pytest.approx(
        two["t_camera_ms"] - two["t_seq_ms"])
    assert two["rays_weak_overhead_efficiency"] == pytest.approx(
        two["t_ctl_ms"] / two["t_camera_ms"])


def test_efficiency_arithmetic():
    """bench_scaling.py:205-215 on fixed timings."""
    one = BS.record("weak", 1, 1000, 8000, 0.5, 2.0)
    assert one["rays_per_s"] == 2000.0 and one["cone_samples_per_s"] == 4000.0
    assert one["rays_scaling_efficiency"] == 1.0
    assert one["samples_scaling_efficiency"] == 1.0
    assert "rays_weak_overhead_efficiency" not in one
    four = BS.record("weak", 4, 4000, 32000, 0.8, 4.0, base=one,
                     t_ctl_s=1.6, t_ctl_march_s=6.0, t_1x_s=0.45)
    assert four["rays_per_s"] == 5000.0
    assert four["rays_scaling_efficiency"] == 5000.0 / (2000.0 * 4)
    assert four["cone_samples_per_s"] == 8000.0
    assert four["samples_scaling_efficiency"] == 8000.0 / (4000.0 * 4)
    assert four["rays_weak_overhead_efficiency"] == 1.6 / 0.8
    assert four["samples_weak_overhead_efficiency"] == 6.0 / 4.0
    assert four["t_camera_ms"] == 800.0 and four["t_march_ms"] == 4000.0
    assert four["t_seq_ms"] == pytest.approx(1800.0)
    assert four["serialization_gap_ms"] == pytest.approx(-1000.0)
    strong = BS.record("strong", 2, 1000, 8000, 0.25, 1.0, base=one)
    assert strong["rays_scaling_efficiency"] == 4000.0 / (2000.0 * 2)
    assert strong["samples_scaling_efficiency"] == 8000.0 / (4000.0 * 2)
    assert "t_ctl_ms" not in strong


def _fail_on_rank_one():
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()      # waits for a rank that never comes
    return "unreachable"


def test_failed_rank_fails_promptly():
    """A rank that raises makes spawn raise with its error at once, well
    inside SPAWN_TIMEOUT_S, and the waiting rank is ended: a failed rank
    cannot turn into a skipped count."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        ML.spawn(_fail_on_rank_one, 2)
    assert time.monotonic() - t0 < 60.0 < ML.SPAWN_TIMEOUT_S


def test_failed_rank_fails_the_sweep():
    """An image of 33 rows cannot split over 2 'data' ranks: both ranks
    raise, and so does run()."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="not divisible"):
        BS.run(counts=(2,), mode="strong", device="cpu",
               settings=BS.Settings(16, 32, 33, 1))
    assert time.monotonic() - t0 < 60.0


def test_unknown_mode_refused():
    with pytest.raises(ValueError, match="mode must be one of"):
        BS.run(mode="linear", device="cpu")


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["VCT_REPO"])
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from vct_tpu_torch import bench_scaling as BS
from vct_tpu_torch.parallel import mesh as ML
from vct_tpu_torch.parallel import mesh as ML

assert ML.init_distributed(backend="gloo") == 2
recs = BS.run(counts=(1, 2, 4), mode="strong", device="cpu",
              settings=BS.Settings(16, 32, 32, 1), check=(2,))
if dist.get_rank() == 0:
    print("RECORDS " + json.dumps(recs), flush=True)
else:
    assert recs == [], recs
assert "jax" not in sys.modules and "vct_tpu" not in sys.modules
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_torchrun_route(tmp_path):
    """Under torchrun's variables the sweep spans the world's 2 ranks (4
    is dropped): strong records with SCALING_r05.json's keys, the work,
    0 collectives, and the march at 2 ranks bit-equal to one rank's."""
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script)], env=dict(
            os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
            WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
            VCT_REPO=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    line = next(x for x in outs[0].splitlines() if x.startswith("RECORDS "))
    recs = json.loads(line[len("RECORDS "):])
    want = scaling_r05_keys("strong")
    cfg = BS.config(16, 32, 32)
    assert [r["devices"] for r in recs] == [1, 2]
    for rec in recs:
        assert want[rec["devices"]] <= set(rec)
        assert (rec["rays"], rec["cone_samples"]) == BS.work(
            cfg, rec["devices"], "strong")
        assert rec["collective_calls"] == 0
        assert rec["ranks_share_one_card"] is False
    assert recs[1]["march_check"]["bit_equal"] is True
