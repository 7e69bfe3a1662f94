"""Two real processes join through the port's init_distributed
(vct_tpu_torch/parallel/mesh.py) from torchrun's environment variables,
and run an all-gather and a sum over a mesh, as
tests/test_distributed_smoke.py does for the JAX package's
init_distributed.  The workers import only torch and the port."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch.distributed as dist

from vct_tpu_torch.parallel import mesh as ML

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["VCT_REPO"])
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from vct_tpu_torch.parallel import comm
from vct_tpu_torch.parallel import mesh as ML

n = ML.init_distributed(backend="gloo")
assert n == 2 and dist.get_world_size() == 2, n
rank = dist.get_rank()
assert rank == int(os.environ["RANK"])
mesh = ML.make_mesh(n_data=2, n_model=1, device_type="cpu")
data = comm.axis(mesh, "data")
got = comm.all_gather(torch.tensor([rank], dtype=torch.int32), data)
assert [int(g) for g in got] == [0, 1], got
total = comm.all_reduce(torch.tensor([1.0 + rank]), data)
assert float(total) == 3.0, total
rows = ML.local_rows(torch.arange(6.0).reshape(6, 1), mesh)
assert rows.flatten().tolist() == [3.0 * rank, 3.0 * rank + 1, 3.0 * rank + 2]
assert "jax" not in sys.modules and "vct_tpu" not in sys.modules
dist.destroy_process_group()
print(f"proc {rank} OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_collective(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   VCT_REPO=repo)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"proc {rank} OK" in out, out


def test_single_process_run_touches_nothing(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert ML.init_distributed() == 1
    assert not dist.is_initialized()


def test_pad_to_multiple_equals_jax():
    from vct_tpu.parallel import mesh as jmesh
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    for multiple, axis in ((4, 0), (5, 0), (2, 1)):
        ours, n = ML.pad_to_multiple(x, multiple, axis)
        theirs, m = jmesh.pad_to_multiple(x, multiple, axis)
        assert n == m and np.array_equal(ours, np.asarray(theirs))
