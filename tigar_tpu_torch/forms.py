"""Pointwise form containers: field 2-jets and quadrature-point context.

Port of the ``Jet`` and ``QP`` containers of tigar_tpu/forms.py.  Leaves are
torch tensors with any number of leading batch dimensions (element,
quadrature point), so a density written with trailing-axis indexing runs
on the whole batch at once, or per point under ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Any

import torch


class Jet(NamedTuple):
    """2-jet of a (possibly vector-valued) field in parametric coordinates.

    val : [...] or [..., m]
    g   : [..., d] or [..., m, d]          parametric gradient
    h   : [..., d, d] or [..., m, d, d]    parametric Hessian (or None)
    """
    val: Any
    g: Any
    h: Optional[Any] = None


class QP(NamedTuple):
    """Geometric context at quadrature points (see tigar_tpu.forms.QP).

    xi [d], x [nsd], w [], wg [d], wh [d,d], DF [nsd,d], d2F [nsd,d,d],
    g [d,d], ginv [d,d], sqrtJ [], pinv [d,nsd], nref/normal/surfJ (boundary
    points only), aux: dict of model-specific precomputed data (e.g. the
    shell reference frame under ``"shell_ref"``).  Each with leading batch
    dimensions.
    """
    xi: Any
    x: Any
    w: Any
    wg: Any
    wh: Optional[Any]
    DF: Any
    d2F: Optional[Any]
    g: Any
    ginv: Any
    sqrtJ: Any
    pinv: Any
    nref: Optional[Any] = None
    normal: Optional[Any] = None
    surfJ: Optional[Any] = None
    aux: Optional[Any] = None

    def map(self, fn):
        """Apply ``fn`` to every tensor leaf (aux included); None stays."""
        def go(v):
            if v is None:
                return None
            if isinstance(v, dict):
                return {k: go(x) for k, x in v.items()}
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*[go(x) for x in v])
            return fn(v)
        return QP(*[go(v) for v in self])


def taylor_eval(val, g, h, delta):
    """The 2-jet (val, g, h) as a truncated Taylor polynomial at parametric
    offset ``delta`` [d] (see tigar_tpu.forms.taylor_eval); the jet's
    trailing axes are parametric, its leading ones are kept."""
    out = val + torch.tensordot(g, delta, dims=([-1], [0]))
    if h is not None:
        out = out + 0.5 * torch.einsum("...cd,c,d->...", h, delta, delta)
    return out
