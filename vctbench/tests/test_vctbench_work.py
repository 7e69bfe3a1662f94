"""The benchmark's frozen dense-march work count (the reference's copy of
ops/dense.march_work over its plain march's steps) against the port's
count of its own plain march, at a small grid."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vct_tpu_torch.core import dense as PD
from vct_tpu_torch.ops import dense as POD
from vct_tpu_torch.ops import mip as PMIP
from vctbench.reference.core import dense as RD
from vctbench.reference.core import march as RM
from vctbench.reference.ops import dense as ROD
from vctbench.reference.ops import mip as RMIP
from vct_tpu_torch.core import march as PM


def _grid(seed, dim=16):
    g = torch.Generator().manual_seed(seed)
    rgb = torch.rand((dim, dim, dim, 3), generator=g)
    a = (torch.rand((dim, dim, dim, 1), generator=g) > 0.8).float()
    return torch.cat([rgb * a, a], dim=-1)


@pytest.mark.parametrize("trans", [True, False])
def test_work_count_equals_the_plain_march_steps(trans):
    grid = _grid(3)
    mips_r = RMIP.build_mips(grid, 5, alpha_mode="max")
    mips_p = PMIP.build_mips(grid, 5, alpha_mode="max")
    dirs = np.array([[0.3, 0.9, 0.2], [-0.6, 0.1, 0.7]])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    kw = dict(field_dim=16, transmittance_only=trans,
              opacity_gain=4.0 if trans else 1.0,
              compute_dtype=torch.bfloat16)
    sched_r = RM.march_schedule(0.03 if trans else 0.577, 150 / 16, 75.0)
    sched_p = PM.march_schedule(0.03 if trans else 0.577, 150 / 16, 75.0)
    plan_r = RD.march_plan(mips_r, dirs, sched_r, 150.0, **kw)
    plan_p = PD.march_plan(mips_p, dirs, sched_p, 150.0, **kw)
    w_r = torch.empty(plan_r.shape + (plan_r.nb,), dtype=torch.int32)
    w_p = torch.empty_like(w_r)
    out_r = ROD.dense_march_plain(mips_r, plan_r, w_r)
    out_p = POD.dense_march_plain(mips_p, plan_p, w_p)
    assert torch.equal(out_r, out_p) and torch.equal(w_r, w_p)
    assert ROD.march_work(mips_r, plan_r, w_r) == \
        POD.march_work(mips_p, plan_p, w_p)
    # the count is of the steps taken: every step taken by every cell
    # gives the count of the whole march, fewer give less
    nbytes, ops = ROD.march_work(mips_r, plan_r, w_r)
    full = ROD.march_work(mips_r, plan_r, None)[1]
    assert nbytes > 0 and 0 < ops <= full
    if not trans:
        assert ops < full                 # some cells stop early
