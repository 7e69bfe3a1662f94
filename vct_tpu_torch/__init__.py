"""vct_tpu_torch — the PyTorch/CUDA port of vct_tpu's voxel cone tracer.

The JAX package `vct_tpu` stays the reference.  This package imports
nothing of it: it keeps its own copies of the host modules it needs
(`config`, `scene.mesh`, `scene.cornell`, `scene.atrium`, `scene.obj`,
`utils.image`, and the C++ of `native`, tested equal to the JAX ones)
and re-implements the rest
in PyTorch, with hand-written CUDA kernels for the Pallas kernels
(`ops/csrc/`).

It does what the JAX package does: the voxel build
(`render.renderer.build_voxel_state`), the fast frame path (`render.fast`)
for scenes of up to 2**24 triangles (textured ones up to 2**23; larger
ones raise ValueError) and its exact-specular mode, the per-cone oracle
renderer (`render.renderer.render_rays`) with the shadow map and the
anisotropic mips, inverse rendering (`diff`), the sharded build, camera
pass and train step over a ('data', 'model') mesh of torch.distributed
ranks (`parallel`), the CLI (`python -m vct_tpu_torch`), the native OBJ
parser and surface sampler (`native`) and the asset path at the
reference's scale (`python -m vct_tpu_torch.asset_path`).  It leaves out
the JAX package's staged-jit splits.

Entry points put their tensors on the card unless given `device="cpu"`
(the CLI: `--cpu`), and raise where CUDA is missing; every function then
works on the device its tensors are on: on CUDA tensors the `ops`
wrappers launch their kernels, on CPU tensors they run the plain PyTorch
versions beside them.  `diff.optimize(device=None)` takes its target's
device.
"""

import torch

# float32 matmuls and convolutions stay full float32 on the card: TF32
# keeps ~3 decimal digits and would flip ray hits the way the TPU's
# default-precision matmuls once did.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
