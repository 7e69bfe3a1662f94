"""Checkpoint/resume for inverse-rendering optimization (port of
vct_tpu/diff/checkpoint.py, which uses Orbax).

Layout: <dir>/step_<N>, one `torch.save` of {params, the optimizer's
state_dict, step}, written to a temporary name and renamed into place;
restore_latest picks the highest step.  Loading uses
`torch.load(weights_only=True)`: tensors, numbers, strings and
containers only.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from vct_tpu_torch.diff.inverse import OptimState

_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save(directory: str, state: OptimState) -> str:
    """Write one checkpoint; returns its path."""
    path = _step_path(directory, state.step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "opt_state": state.opt_state.state_dict(),
        "step": int(state.step),
    }
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def restore(directory: str, step: int, template: OptimState) -> OptimState:
    """Restore one checkpoint into `template`: its parameters are
    overwritten in place (so its optimizer stays bound to them) and its
    optimizer loads the saved state."""
    payload = torch.load(_step_path(directory, step), map_location="cpu",
                         weights_only=True)
    with torch.no_grad():
        for k, v in template.params.items():
            v.copy_(payload["params"][k])
    template.opt_state.load_state_dict(payload["opt_state"])
    return OptimState(params=template.params, opt_state=template.opt_state,
                      step=int(payload["step"]))


def restore_latest(directory: str,
                   template: OptimState) -> Optional[OptimState]:
    """Latest checkpoint in `directory`, or None if there is none."""
    steps = available_steps(directory)
    if not steps:
        return None
    return restore(directory, steps[-1], template)
