"""One refused call per check site of the CUDA extension's bindings.

Every binding in ``csrc/bindings.cpp`` checks device, dtype, shape and
contiguity with ``TORCH_CHECK`` before it launches, and a refused check
must reach Python as a ``RuntimeError`` (not end the process).  Each call
below passes arguments that one of those checks refuses: a check at the
top of the binding, a shape check (whose message formats both shapes),
a check whose message carries an integer, and, for the interface kernels
K6-K9, the per-side helpers (``iface_side``, ``nitsche_side``) that run
while the launcher's argument list is evaluated.  No kernel is launched.

    python -m tigar_tpu_torch.ops.refusals

prints one line per call and a summary, and exits 1 unless every call
raised RuntimeError; a call that ends the process ends this one, so
``run`` makes the calls in a child.  It needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

# the directory that holds the package, for the children's ``-m``
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _calls():
    """{name: fn(ext)}: each fn makes one refused call."""
    import torch
    dev = torch.device("cuda")

    def z(*shape, dt=torch.float64):
        return torch.zeros(shape, dtype=dt, device=dev)

    def i32(*shape):
        return z(*shape, dt=torch.int32)

    f32 = torch.float32
    bad = i32(1)                        # an int tensor where floats go
    shell = [bad] * 11                  # K1/K2: check_float(U) refuses

    def shellv(nen=9, nq=4, nel=2):     # K1/K2: every shape valid
        return [z(16), i32(nel, 3 * nen), z(nel, nq, nen),
                z(nel, nq, nen, 2), z(nel, nq, nen, 2, 2), z(nel, nq),
                z(nel, nq, 3, 2), z(nel, nq, 3, 2, 2), z(nel, nq, 2, 2),
                z(nel, nq, 2, 2), z(nel, nq, 2, 2)]

    nq, m, ndof = 4, 8, 16
    pos = i32(nq, 3, 9)

    def iface(ok=True):                 # K6/K7 side (conn, R0, R1, DF)
        conn = pos if ok else i32(nq + 1, 3, 9)
        return [conn, z(nq, 3, 9), z(nq, 3, 9, 2), z(nq, 3, 2)]

    def nitsche(ok=True):               # K8/K9 side, 10 tensors
        conn = pos if ok else i32(nq + 1, 3, 9)
        return [conn, z(nq, 3, 9), z(nq, 3, 9, 2), z(nq, 3, 9, 2, 2),
                z(nq, 3, 9, 2, 2, 2), z(nq, 3, 2), z(nq, 3, 2, 2),
                z(nq, 3, 2, 2, 2), z(nq, 2, 3), z(nq, 2)]

    def ell(mode=0, n=4, ncols=4, tiles=None, starts=None, cols=None,
            vals=None, x=True, b=True, om=True):
        """K11 on one tile of 4 rows, 4 slots; every argument valid but
        the one given"""
        tiles = i32(1, 3) if tiles is None else tiles
        starts = z(2, dt=torch.int64) if starts is None else starts
        cols = i32(4) if cols is None else cols
        vals = z(4) if vals is None else vals
        x = z(ncols) if x is True else x
        return lambda e: e.ell_spmv(tiles, starts, cols, vals, n, ncols, x,
                                    z(n) if b else None,
                                    z(n) if om else None, mode)

    def jets_args(W, T=None):           # K15 on a 4x4 p=1 grid, nq 2
        T = T or [z(4, 2, 3, 2), z(4, 2, 3, 2)]
        return (W, T, [i32(0), i32(0)], [0, 0], [1, 1], [5, 5], 2, 0, 1, 25,
                1, z(64, 1), z(64, 1, 2), z(64, 1, 2, 2), 0)

    return {
        "shell_residual": lambda e: e.shell_residual(
            *shell, None, [0.0] * 7, 1),
        "shell_residual/nen": lambda e: e.shell_residual(
            *shellv(nen=4), None, [0.0] * 7, 16),
        "shell_residual/mask": lambda e: e.shell_residual(
            *shellv(nen=16), z(2, 9), [0.0] * 7, 16),
        "tangent_stencil": lambda e: e.tangent_stencil(
            *shell, [0.0] * 4, [1, 1], [3, 3]),
        "tangent_stencil/nen": lambda e: e.tangent_stencil(
            *shellv(nen=16), [0.0] * 4, [1, 2], [3, 4]),
        "tangent_elements": lambda e: e.tangent_elements(
            *shell, None, [0.0] * 4, None),
        "tangent_elements/nq": lambda e: e.tangent_elements(
            *shellv(nen=16, nq=17), None, [0.0] * 4, None),
        "tangent_elements/mask": lambda e: e.tangent_elements(
            *shellv(nen=16), z(2, 16, 1), [0.0] * 4, None),
        "tangent_elements/me": lambda e: e.tangent_elements(
            *shellv(nen=16), z(2, 16), [0.0] * 4, z(2, 27)),
        "elem_tangent_apply": lambda e: e.elem_tangent_apply(
            i32(1, 1), bad, bad, None),
        "elem_tangent_diagonal": lambda e: e.elem_tangent_diagonal(
            i32(1, 1), bad, 1),
        "elem_tangent_diagonal/shape": lambda e: e.elem_tangent_diagonal(
            i32(1, 1), z(2, 2, 2), 1),
        "elem_tangent_diagonal/int": lambda e: e.elem_tangent_diagonal(
            i32(1, 1), z(1, 1, 1), -1),
        "ell_spmv": ell(vals=bad),
        "ell_spmv/mode": ell(mode=5),
        "ell_spmv/size": ell(n=-1),
        "ell_spmv/starts": ell(starts=z(3, dt=torch.int64)),
        "ell_spmv/tiles": ell(tiles=z(1, 3, dt=torch.int64)),
        "ell_spmv/tile count": ell(tiles=i32(5, 3)),
        "ell_spmv/cols": ell(cols=i32(2, 2)),
        "ell_spmv/vals": ell(vals=z(5)),
        "ell_spmv/square": ell(mode=2, ncols=5),
        "ell_spmv/x": ell(x=None),
        "ell_spmv/x0": ell(mode=3),
        "ell_spmv/b": ell(mode=1, b=None),
        "ell_spmv/om_dinv": ell(mode=2, om=None),
        "ell_spmv/x shape": ell(x=z(3)),
        "laplace_apply": lambda e: e.laplace_apply(
            z(1, 1), i32(1, 1), z(1), z(1)),
        "laplace_apply/Ke": lambda e: e.laplace_apply(
            z(10, 1), i32(4, 1), z(1, dt=f32), z(1, dt=f32)),
        "laplace_apply/shape": lambda e: e.laplace_apply(
            z(9, 1, dt=f32), i32(4, 1), z(1, dt=f32), z(1, dt=f32)),
        "contact_residual": lambda e: e.contact_residual(
            i32(1, 1), z(1, 1, dt=torch.uint8), bad, z(1), 1.0, 1.0),
        "contact_residual/words": lambda e: e.contact_residual(
            i32(2, 1), z(1, 1, dt=torch.uint8), z(1, 3), z(1), 1.0, 1.0),
        "contact_tangent": lambda e: e.contact_tangent(
            i32(1, 1), z(1, 1, dt=torch.uint8), bad, z(1, 3), z(1), 1.0,
            1.0),
        "stencil_apply": lambda e: e.stencil_apply(
            z(1), bad, None, None, None, 1.0, 0, None, 0, 1),
        "sumfac_apply": lambda e: e.sumfac_apply(
            bad, [], [], [], [], None, None, None, [1, 1], 1.0, 0.0),
        "iface_block": lambda e: e.iface_block(
            z(2, 2), i32(2), None, bad, 1.0, z(1)),
        "shell_iface_residual": lambda e: e.shell_iface_residual(
            iface(), iface(), z(nq), bad, [0.0] * 3),
        "shell_iface_residual/side": lambda e: e.shell_iface_residual(
            iface(), iface(False), z(nq), z(ndof), [0.0] * 3),
        "shell_iface_residual/count": lambda e: e.shell_iface_residual(
            iface(), iface()[:3], z(nq), z(ndof), [0.0] * 3),
        "shell_iface_tangent": lambda e: e.shell_iface_tangent(
            iface(), iface(), pos, pos, z(nq), bad, [0.0] * 3),
        "shell_iface_tangent/side": lambda e: e.shell_iface_tangent(
            iface(False), iface(), pos, pos, z(nq), z(m), [0.0] * 3),
        "nitsche_iface_residual": lambda e: e.nitsche_iface_residual(
            nitsche(), nitsche(), z(nq), z(nq), bad, [0.0] * 8),
        "nitsche_iface_residual/side": lambda e: e.nitsche_iface_residual(
            nitsche(), nitsche(False), z(nq), z(nq), z(ndof), [0.0] * 8),
        "nitsche_iface_tangent": lambda e: e.nitsche_iface_tangent(
            nitsche(), nitsche(), pos, pos, z(nq), z(nq), bad, [0.0] * 8),
        "nitsche_iface_tangent/pos": lambda e: e.nitsche_iface_tangent(
            nitsche(), nitsche(), pos, i32(nq // 2, 3, 9), z(nq), z(nq),
            z(m), [0.0] * 8),
        "sumfac_jets": lambda e: e.sumfac_jets(*jets_args(bad)),
        "sumfac_jets/table": lambda e: e.sumfac_jets(*jets_args(
            z(25), [z(4, 2, 3, 2), z(4, 2, 2, 2)])),
        "sumfac_jets/int": lambda e: e.sumfac_jets(*jets_args(
            z(25))[:6], 3, *jets_args(z(25))[7:]),
        "sumfac_scatter_jets": lambda e: e.sumfac_scatter_jets(
            bad, z(64, 1, 2), None, [z(4, 2, 2, 2)] * 2, [i32(0), i32(0)],
            [0, 0], [1, 1], [5, 5], 1, 0, 1, 25, 1, z(25), 0),
    }


def run(timeout=600):
    """This module in a child process: (exit code, its output lines)."""
    p = subprocess.run([sys.executable, "-m", __name__],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=_ROOT)
    return p.returncode, (p.stdout + p.stderr).strip().splitlines()


def main():
    from . import cuda_ext
    ext = cuda_ext.load()
    calls = _calls()
    failed = []
    for name, call in calls.items():
        print(f"{name}: ...", flush=True)
        try:
            call(ext)
        except RuntimeError as err:
            print(f"{name}: RuntimeError: {str(err).splitlines()[0]}",
                  flush=True)
            continue
        print(f"{name}: the binding accepted the call", flush=True)
        failed.append(name)
    print(f"refused calls: {len(calls) - len(failed)} of {len(calls)} "
          f"raised RuntimeError" + (f"; failed {failed}" if failed else ""),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
