"""Differentiable / inverse rendering (BASELINE.json config 4)."""

from vct_tpu_torch.diff.inverse import (  # noqa: F401
    InverseConfig, OptimState, init_params, make_loss_fn, make_step_fn,
    optimize, voxel_state_from_radiance)
