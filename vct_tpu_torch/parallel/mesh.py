"""The ('data', 'model') device mesh (port of vct_tpu/parallel/mesh.py).

Axes:
  data  — image-row (ray) tiles: each rank renders its own block of rows
  model — the surface samples of the voxel build, and the x-bricks of the
          dense marches (parallel/brick.py)

Ranks are processes of `torch.distributed`, laid out row-major as the JAX
package lays out devices: rank = d * n_model + m, so the model ranks of
one data row are neighbours.  JAX's shardings (`replicated`,
`rays_sharding`, `samples_sharding`) have no PyTorch counterpart: each
rank holds whole tensors, and `local_rows` and `local_samples` give it
its block.  `spawn` starts the ranks of one host on a gloo group (tests,
chip_smoke); runs across cards join through `init_distributed` under
torchrun.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
SPAWN_TIMEOUT_S = 600.0        # spawn raises when a rank runs longer


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda"):
    """A ('data', 'model') DeviceMesh over the first n_data * n_model
    ranks of the process group; n_data=None takes the whole world."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if n_data is None:
        if world % n_model:
            raise ValueError(
                f"{world} ranks not divisible by n_model={n_model}")
        n_data = world // n_model
    need = n_data * n_model
    if need > world:
        raise ValueError(f"need {need} ranks, have {world}")
    return DeviceMesh(device_type,
                      torch.arange(need).reshape(n_data, n_model),
                      mesh_dim_names=AXES)


def make_mesh_for(cfg, device_type: str = "cuda"):
    """Mesh from VCTConfig.sharding: data_parallel x brick_parallel."""
    return make_mesh(n_data=cfg.sharding.data_parallel,
                     n_model=cfg.sharding.brick_parallel,
                     device_type=device_type)


def init_distributed(backend: str = "cpu:gloo,cuda:nccl") -> int:
    """Multi-process entry, in torchrun's terms: reads MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, binds this process to
    cuda:LOCAL_RANK where there is a card and the backend serves CUDA
    tensors, and joins the process group.  With none of them set it is a
    single-process run and touches nothing.  Returns the world size."""
    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    if not any(k in os.environ for k in keys):
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.cuda.is_available() and "nccl" in backend:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return dist.get_world_size()


def axis_size(mesh, name: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad `axis` with zeros to a multiple; returns (padded, orig_len)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths), n


def local_rows(x: torch.Tensor, mesh, axis_name: str = "data"
               ) -> torch.Tensor:
    """This rank's block of axis 0 (image rows) over `axis_name`: the rows
    a ('data',)-sharded array holds there.  The ranks of one model group
    get the same block.  Axis 0 must divide evenly, as in the JAX
    package."""
    n = axis_size(mesh, axis_name)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows not divisible by {n} "
                         f"'{axis_name}' ranks")
    rows = x.shape[0] // n
    i = mesh.get_local_rank(axis_name)
    return x[i * rows:(i + 1) * rows]


def local_samples(samples, mesh, axis_name: str = "model"):
    """This rank's contiguous share of every per-sample array (a
    SamplesDevice) over `axis_name`.  Shares may differ by one sample:
    the splat's partial grids have the grid's shape whatever the count."""
    n = axis_size(mesh, axis_name)
    i = mesh.get_local_rank(axis_name)
    return dataclasses.replace(samples, **{
        f.name: getattr(samples, f.name).tensor_split(n)[i]
        for f in dataclasses.fields(samples)})


def _rank_main(rank, fn, world, init_method, results, args):
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    # bytes, not tensors: the queue's own pickler would pass tensors as
    # shared memory that dies with this process.  A rank that raises exits
    # without destroying the group (which would wait for the others), and
    # spawn ends the rest
    results.put((rank, pickle.dumps(fn(*args))))
    dist.destroy_process_group()


def spawn(fn, world: int, *args) -> list:
    """Run fn(*args) in `world` fresh processes joined in one gloo process
    group (rendezvous through a file in a temporary directory), each rank
    on one torch thread and, where there is a card, on cuda:(rank %
    cards); returns each rank's result, in rank order.  The group is gloo
    because NCCL refuses two ranks on one card; parallel/comm.py stages
    its collectives on CUDA tensors through the host.  fn must be
    importable (a module-level function) and its result picklable.  A
    rank that raises, or runs past SPAWN_TIMEOUT_S, makes spawn raise;
    every process is ended before spawn returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, init, results, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        done = False
        try:
            while not (done and len(out) == world):
                try:
                    rank, value = results.get(timeout=0.1)
                    out[rank] = pickle.loads(value)
                except queue.Empty:
                    pass
                # every pass, so that a rank that exits with an error
                # raises here at once (join ends the other ranks)
                done = done or procs.join(timeout=0)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: ranks still running after "
                                       f"{SPAWN_TIMEOUT_S} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world)]
