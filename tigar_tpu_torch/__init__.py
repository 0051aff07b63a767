"""tigar_tpu_torch: the PyTorch/CUDA port of tigar_tpu.

Ported paths: the Kirchhoff-Love shell (the numpy spline core, the
extracted spline's volume assembler, the SVK shell adjoint density,
sliding-window stencil tangents and the mixed-precision stencil-multigrid
Newton solver; the space-agnostic SANewton with element tangents and
smoothed aggregation); the multi-patch shell (multi-patch bases,
interface forms on non-matching interfaces, the penalty and the
consistent Nitsche couplings, the multi-patch stencil Newton solver); the
matrix-free 3D Poisson solve (sum-factorized operators, fixed-iteration
CG, a geometric V-cycle, mixed-precision refinement); and the generic
linear form path (per-point densities assembled with torch.func,
ExtractedSpline's linear solvers, the f32 fast-path apply, two-level and
multilevel smoothed-aggregation CG); penalty self-contact;
sum-factorized forms; and the Rhino Bezier-extraction T-splines with the
star-T-spline shell point.  Sixteen hand-written CUDA kernels (``csrc/``,
K1-K16) carry the device work.  Each has a plain PyTorch
twin in the same module; tensors on the CPU go to the twin, CUDA tensors
to the kernel.  Entry points put their tensors on the card unless the
caller asks for the CPU.

The package imports torch and numpy only, never jax or tigar_tpu.
"""

from . import config  # noqa: F401  (TF32 switches)

from .ops.knots import uniform_knots, KnotVector  # noqa: F401
from .models.bspline import (TensorBSplineBasis,  # noqa: F401
                             ExplicitBSplineControlMesh)
from .models.space import SplineSpace, EqualOrderSpline  # noqa: F401
from .models.extracted import ExtractedSpline  # noqa: F401
from .models.shell import (SVKShellAdjoint,  # noqa: F401
                           precompute_shell_reference, svk_shell_adjoint)
from .solvers.newton_stencil import StencilNewton  # noqa: F401
from .models.multipatch import (MultiPatchBSplineBasis,  # noqa: F401
                                MultiPatchControlMesh)
from .coupling import ShellInterfaceCoupling  # noqa: F401
from .interface import EnergyNitscheCoupling  # noqa: F401
from .solvers.newton_stencil_mp import MultiPatchStencilNewton  # noqa: F401
