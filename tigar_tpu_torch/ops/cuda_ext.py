"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``tigar_tpu_torch/csrc``: ten ``.cu`` files with
plain C++ launchers (no PyTorch headers) and one binding file,
``bindings.cpp``, the only one that includes ``torch/extension.h``.
``load()`` compiles all eleven (ninja runs the compilers in parallel) with
``torch.utils.cpp_extension.load`` for ``sm_90a`` on first use, into
``build/tigar_kernels/`` under the repository root, and caches the module
for the process.  Nothing is built at import time.

Each kernel wrapper calls ``count(name)`` right after it launches its
kernel, so a run can prove which kernels its main path went through.
"""

from __future__ import annotations

import os
import time

KERNELS = ("shell_residual", "tangent_stencil", "stencil_apply",
           "sumfac_apply", "iface_block", "shell_iface_residual",
           "shell_iface_tangent", "nitsche_iface_residual",
           "nitsche_iface_tangent", "tangent_elements", "elem_tangent_apply",
           "elem_tangent_diagonal", "ell_spmv", "laplace_apply")

_launches = {k: 0 for k in KERNELS}
_ext = None
build_seconds = None

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("bindings.cpp", "shell_residual.cu", "tangent_stencil.cu",
           "stencil_apply.cu", "sumfac_apply.cu", "iface_block.cu",
           "shell_interface.cu", "shell_nitsche.cu", "elem_tangent.cu",
           "ell_spmv.cu", "laplace_apply.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build",
                         "tigar_kernels")


def load(verbose=False):
    """The compiled extension module (built on first call).  With
    ``TIGAR_BOUNDS_CHECK=1`` in the environment the kernels are built with
    ``-DTIGAR_BOUNDS_CHECK`` (device-side index checks of K8/K9) as a
    separate module in ``build/tigar_kernels_checked/``."""
    global _ext, build_seconds
    if _ext is None:
        import torch
        from torch.utils.cpp_extension import load as _load
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        checked = os.environ.get("TIGAR_BOUNDS_CHECK") == "1"
        name = "tigar_kernels_checked" if checked else "tigar_kernels"
        build_dir = os.path.join(os.path.dirname(BUILD_DIR), name)
        os.makedirs(build_dir, exist_ok=True)
        t0 = time.time()
        _ext = _load(
            name=name,
            sources=[os.path.join(_CSRC, s) for s in SOURCES],
            build_directory=build_dir,
            extra_cflags=["-O3"],
            extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
            + (["-DTIGAR_BOUNDS_CHECK"] if checked else []),
            verbose=verbose)
        build_seconds = time.time() - t0
    return _ext


def count(name):
    _launches[name] += 1


def reset_counts():
    for k in _launches:
        _launches[k] = 0


def counts():
    return dict(_launches)
