"""Inverse rendering of the textured atrium's albedo textures through the
port's fast camera pass (the material fetch's backward, the bump normal,
and the alpha re-cast through the streamed raycast, whose inputs need no
gradient), against the JAX package's, on the CPU.

test_torch_inverse_fast.py's config (tests/test_inverse_fast.py's
overrides at 32^3 and 32x32) on the atrium (1,122 triangles, 8
materials, a 256^2 atlas) from the bench camera (48, -10, 0), yaw 180,
optimize=("textures",).  The port's "fast" loss and gradient are held to
jax.value_and_grad of the JAX package's "fast" loss at that file's
gradient bounds (cosine >= 0.999, norm within 2%), the loss within 3e-3:
the JAX material kernel rounds its bilinear weights to bfloat16 in its
forward (ops/material.py), which the port's plain version does not.
Not to the "xla"
pass: the JAX package's own fast texture gradient is 17 times smaller
than its xla one there (ROADMAP Queue 3, scripts/jax_inverse_pairing.py).
The JAX side takes about 40 s.
"""

import torch

from test_torch_inverse_fast import assert_like_jax, fast_cfg, setups
from vct_tpu.config import preset as jpreset
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu_torch.config import preset
from vct_tpu_torch.scene.atrium import atrium

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)   # bench.py:122
LOSS_REL = 3e-3


def test_fast_textures_match_jax():
    s = setups(fast_cfg(jpreset), fast_cfg(preset), jatrium(), atrium(),
               CAMERA)
    assert s["port"][2].atlas is not None
    assert_like_jax(s, "textures", LOSS_REL)
