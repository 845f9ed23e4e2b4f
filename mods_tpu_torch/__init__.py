"""mods_tpu_torch — the PyTorch/CUDA port of ``mods_tpu`` for one NVIDIA
H100.

The package mirrors the JAX package's module paths and function names;
``mods_tpu`` stays the reference each piece is checked against.  It
imports neither JAX nor anything of ``mods_tpu``.

Every Pallas kernel of the JAX package has a hand-written Hopper
counterpart under ``csrc/``.  A kernel's wrapper runs the kernel for
CUDA tensors and its plain PyTorch version only for CPU tensors; there
is no fallback from one to the other.
"""

__version__ = "0.1.0"

import torch as _torch

# All compute is float32 at full precision, as the JAX package forces
# (mods_tpu/__init__.py:22-28): TF32 corrupts the blurs, the samplers and
# the Hessian responses.  cuDNN convolutions default to TF32, so that
# flag has to be cleared too.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from mods_tpu_torch.regions import Regions  # noqa: E402,F401
