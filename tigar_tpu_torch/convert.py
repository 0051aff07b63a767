"""Carry assembler and stencil state across as numpy arrays.

``assembler_arrays(asm)`` reads the arrays of a shell volume assembler —
of this package, or of tigar_tpu (duck-typed through ``np.asarray``, so
no jax import here) — into a dict of numpy arrays:

    conn [nel, nen] int32 (the shared scalar-basis connectivity),
    cat_conn [nel, nf*nen], offsets, ndof,
    N [nel, nq, nen], dN [.., d], d2N [.., d, d], scale [nel, nq],
    DF [nel, nq, nsd, d], d2F [.., d, d],
    shell_ref_a / shell_ref_b / shell_ref_ea [nel, nq, 2, 2]

``assembler_from_numpy(arrays, device, dtype)`` builds this package's
``DomainAssembler`` from such a dict, and ``stencil_from_numpy`` does the
same for stencils.  Tests use them to feed identical inputs to the JAX
functions and to this package's kernels and twins, independent of either
package's own preprocessing.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .config import INDEX_TYPE, resolve_device
from .forms import QP
from .models.shell import ShellReference
from .ops.assembly import DomainAssembler
from .ops.stencil import StencilOperator


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assembler_arrays(asm):
    """numpy arrays of an equal-order shell volume assembler (see module
    docstring).  Raises unless all fields share one tabulation."""
    for f in range(1, asm.nfields):
        for name in ("conns", "Ns", "dNs", "d2Ns"):
            if not np.array_equal(_np(getattr(asm, name)[f]),
                                  _np(getattr(asm, name)[0])):
                raise ValueError("assembler_arrays needs equal-order fields")
    out = {
        "conn": _np(asm.conns[0]).astype(INDEX_TYPE),
        "cat_conn": _np(asm.cat_conn).astype(INDEX_TYPE),
        "offsets": np.asarray(asm.offsets, dtype=np.int64),
        "ndof": int(asm.ndof),
        "N": _np(asm.Ns[0]), "dN": _np(asm.dNs[0]), "d2N": _np(asm.d2Ns[0]),
        "scale": _np(asm.scale),
        "DF": _np(asm.ctx.DF), "d2F": _np(asm.ctx.d2F),
    }
    sref = (asm.ctx.aux or {}).get("shell_ref")
    if sref is not None:
        out.update(shell_ref_a=_np(sref.a), shell_ref_b=_np(sref.b),
                   shell_ref_ea=_np(sref.ea))
    return out


def assembler_from_numpy(arrays, device="cuda", dtype=torch.float64):
    """This package's DomainAssembler from ``assembler_arrays`` output."""
    device = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    offsets = np.asarray(arrays["offsets"], dtype=np.int64)
    nf = len(offsets) - 1
    tab = types.SimpleNamespace(conn=np.asarray(arrays["conn"]),
                                N=arrays["N"], dN=arrays["dN"],
                                d2N=arrays["d2N"], mask=None)
    aux = None
    if "shell_ref_a" in arrays:
        aux = {"shell_ref": ShellReference(a=t("shell_ref_a"),
                                           b=t("shell_ref_b"),
                                           ea=t("shell_ref_ea"))}
    ctx = QP(xi=None, x=None, w=None, wg=None, wh=None, DF=t("DF"),
             d2F=t("d2F"), g=None, ginv=None, sqrtJ=None, pinv=None,
             aux=aux)
    asm = DomainAssembler([tab] * nf, offsets, int(arrays["ndof"]), ctx,
                          t("scale"))
    if "cat_conn" in arrays and not np.array_equal(
            asm.cat_conn.cpu().numpy(), np.asarray(arrays["cat_conn"])):
        raise ValueError("cat_conn does not match conn and offsets")
    return asm


def stencil_from_numpy(S, grid_shape, degrees, nf, device="cuda",
                       dtype=torch.float64):
    """This package's StencilOperator from a numpy stencil array."""
    return StencilOperator(torch.as_tensor(np.array(S), dtype=dtype,
                                           device=resolve_device(device)),
                           grid_shape, degrees, nf)
