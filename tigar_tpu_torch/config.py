"""Configuration of the PyTorch/CUDA port (counterpart of tigar_tpu/config.py).

float64 is the default dtype of assembly and solves, as in the JAX package;
it is passed explicitly to every constructor (the port never changes
torch's global default dtype).  float32 matrix products and convolutions run
in full float32: TF32 keeps ~3 decimal digits, which is the Hopper form of
the reduced-precision matmul passes the JAX package pins against
(solvers/newton_stencil.py, the coarse-grid ``Precision.HIGHEST`` matmul).
"""

import numpy as np
import torch

# Index dtype for connectivity / DoF arrays (reference: INDEX_TYPE='int32').
INDEX_TYPE = np.int32
TORCH_INDEX_TYPE = torch.int32

# Default real dtype for assembly and solves.
DEFAULT_REAL_TYPE = torch.float64

# Default Newton solver parameters (as tigar_tpu/config.py).
DEFAULT_MAX_ITERS = 20
DEFAULT_RELATIVE_TOLERANCE = 1e-5

# Tolerance used when comparing knots for equality (see tigar_tpu.config).
KNOT_NEAR_EPS = 100.0 * np.finfo(np.float64).eps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda():
    """Raise unless a CUDA device is present (entry points that measure or
    launch kernels never fall back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("tigar_tpu_torch: this entry point needs a CUDA "
                           "device and none is available")
    return torch.device("cuda")


def resolve_device(device):
    """The ``torch.device`` of a constructor's ``device`` argument.  Entry
    points default to ``"cuda"``; without a card that raises, and the CPU
    is used only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    return device
