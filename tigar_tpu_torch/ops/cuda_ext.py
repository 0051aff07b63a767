"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``tigar_tpu_torch/csrc``: twelve ``.cu`` files with
plain C++ launchers (no PyTorch headers) and one binding file,
``bindings.cpp``, the only one that includes ``torch/extension.h``.
``load()`` compiles all thirteen (ninja runs the compilers in parallel) with
``torch.utils.cpp_extension.load`` for ``sm_90a`` on first use, into
``build/tigar_kernels/`` under the repository root, and caches the module
for the process.  Nothing is built at import time.

Each kernel wrapper calls ``count(name)`` right after it launches its
kernel, so a run can prove which kernels its main path went through; K3's
also gives its grid, K4's its grid and type, K2's its type and point
count (and, in element mode, its local functions), K9's its type and point
count and K13 / K14's their type, so a run can count its launches by
multigrid level, type and mode.
"""

from __future__ import annotations

import os
import time

KERNELS = ("shell_residual", "tangent_stencil", "stencil_apply",
           "sumfac_apply", "iface_block", "shell_iface_residual",
           "shell_iface_tangent", "nitsche_iface_residual",
           "nitsche_iface_tangent", "tangent_elements", "elem_tangent_apply",
           "elem_tangent_diagonal", "ell_spmv", "laplace_apply",
           "contact_residual", "contact_tangent", "sumfac_jets",
           "sumfac_scatter_jets")

_launches = {k: 0 for k in KERNELS}
_by_key = {}
_ext = None
build_seconds = None

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("bindings.cpp", "shell_residual.cu", "tangent_stencil.cu",
           "stencil_apply.cu", "sumfac_apply.cu", "iface_block.cu",
           "shell_interface.cu", "shell_nitsche.cu", "elem_tangent.cu",
           "ell_spmv.cu", "laplace_apply.cu", "contact_pairs.cu",
           "sumfac_jets.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build",
                         "tigar_kernels")


def load(verbose=False):
    """The compiled extension module (built on first call)."""
    global _ext, build_seconds
    if _ext is None:
        import torch
        from torch.utils.cpp_extension import load as _load
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.time()
        _ext = _load(
            name="tigar_kernels",
            sources=[os.path.join(_CSRC, s) for s in SOURCES],
            build_directory=BUILD_DIR,
            extra_cflags=["-O3"],
            extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
            # A compiler that links libstdc++ statically would export that
            # copy's symbols, which then mix with the process's shared
            # libstdc++: formatting a number in a check message (its
            # num_put facet) ended the process (ROADMAP C3).  Keep any
            # static library's symbols inside the extension.
            extra_ldflags=["-Wl,--exclude-libs,ALL"],
            verbose=verbose)
        build_seconds = time.time() - t0
    return _ext


def count(name, key=None):
    """One launch of kernel ``name``; ``key`` (a shape, say) also tallies
    it apart, for ``counts_by``."""
    _launches[name] += 1
    if key is not None:
        _by_key[name, key] = _by_key.get((name, key), 0) + 1


def short_dtype(dt):
    """"f32" / "f64" for a tally key."""
    return {"torch.float32": "f32", "torch.float64": "f64"}.get(str(dt),
                                                               str(dt))


def reset_counts():
    for k in _launches:
        _launches[k] = 0
    _by_key.clear()


def counts():
    return dict(_launches)


def counts_by(name):
    """The launches of ``name`` since the last reset, by the key its
    wrapper gave."""
    return {k: c for (n, k), c in _by_key.items() if n == name}
