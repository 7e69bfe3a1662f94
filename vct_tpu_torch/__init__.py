"""vct_tpu_torch — the PyTorch/CUDA port of vct_tpu's voxel cone tracer.

The JAX package `vct_tpu` stays the reference.  This package reuses its
jax-free host modules as they are (`vct_tpu.config`, `vct_tpu.scene.*`,
`vct_tpu.utils.image`, `vct_tpu.native`) and re-implements the rest in
PyTorch, with hand-written CUDA kernels for the Pallas kernels on the
ported path (`ops/csrc/`).  It never imports jax.

Ported so far: the voxel build (`render.renderer.build_voxel_state`) and
the fast frame path (`render.fast`) for untextured scenes of at most 2048
triangles.  Every function takes tensors on one device; on CUDA tensors
the `ops` wrappers launch their kernels, on CPU tensors they run the
plain PyTorch versions beside them.
"""

import torch

# float32 matmuls and convolutions stay full float32 on the card: TF32
# keeps ~3 decimal digits and would flip ray hits the way the TPU's
# default-precision matmuls once did.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
