"""vct_tpu_torch — the PyTorch/CUDA port of vct_tpu's voxel cone tracer.

The JAX package `vct_tpu` stays the reference.  This package imports
nothing of it: it keeps its own copies of the host modules it needs
(`config`, `scene.mesh`, `scene.cornell`, `scene.atrium`, tested equal
to the JAX ones) and re-implements the rest in PyTorch, with hand-written
CUDA kernels for the Pallas kernels on the ported path (`ops/csrc/`).

Ported so far: the voxel build (`render.renderer.build_voxel_state`) and
the fast frame path (`render.fast`) for scenes of up to 2**24 triangles
(the whole-table raycast up to 2048 triangles, the binned raycast above),
textured ones of up to 2**23 included (texture atlas, material fetch,
alpha re-cast); larger scenes raise ValueError.
Entry points put their tensors on the card unless given
`device="cpu"`; every function then works on the device its tensors are
on: on CUDA tensors the `ops` wrappers launch their kernels, on CPU
tensors they run the plain PyTorch versions beside them.
"""

import torch

# float32 matmuls and convolutions stay full float32 on the card: TF32
# keeps ~3 decimal digits and would flip ray hits the way the TPU's
# default-precision matmuls once did.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
