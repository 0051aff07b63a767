"""Geometry precomputation at quadrature points (port of
tigar_tpu/ops/geometry.py: ``_geom_point`` and ``precompute_geometry``).

The rational geometry map and its derived quantities are evaluated once at
every quadrature point of every Bezier element, as batched tensor
expressions over the leading [nel, nq] dimensions (the JAX package vmaps a
per-point function; here the per-point formulas index trailing axes)."""

from __future__ import annotations

import numpy as np
import torch

from ..forms import QP
from .smallmat import det_small, inv_small


def eval_jet_arrays(tab, coeffs, device, dtype):
    """Jets of a multi-component coefficient field coeffs [ncp, m] on a
    Tabulation: (val [nel,nq,m], g [nel,nq,m,d], h [nel,nq,m,d,d] or
    None)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    conn = torch.as_tensor(np.asarray(tab.conn, dtype=np.int64),
                           device=device)
    ce = t(coeffs)[conn]                                # [nel, nen, m]
    if tab.mask is not None:
        ce = ce * t(tab.mask)[..., None]
    val = torch.einsum("eqa,eam->eqm", t(tab.N), ce)
    g = None if tab.dN is None else torch.einsum(
        "eqad,eam->eqmd", t(tab.dN), ce)
    h = None if tab.d2N is None else torch.einsum(
        "eqadc,eam->eqmdc", t(tab.d2N), ce)
    return val, g, h


def _geom_point(xi, H, Hg, Hh):
    """QP from the homogeneous-geometry jet (volume points), batched over
    leading dimensions.

    H [..., nsd+1] (w x, w); Hg [..., nsd+1, d]; Hh [..., nsd+1, d, d] or
    None."""
    nsd = H.shape[-1] - 1
    w = H[..., -1]
    dw = Hg[..., -1, :]
    F = H[..., :nsd] / w[..., None]
    DF = (Hg[..., :nsd, :] - F[..., :, None] * dw[..., None, :]) \
        / w[..., None, None]
    d2F = None
    wh = None
    if Hh is not None:
        wh = Hh[..., -1, :, :]
        d2F = (Hh[..., :nsd, :, :]
               - DF[..., :, :, None] * dw[..., None, None, :]
               - DF[..., :, None, :] * dw[..., None, :, None]
               - F[..., :, None, None] * wh[..., None, :, :]) \
            / w[..., None, None, None]
    g = DF.transpose(-1, -2) @ DF
    detg = det_small(g)
    ginv = inv_small(g, detg)
    sqrtJ = torch.sqrt(detg)
    pinv = ginv @ DF.transpose(-1, -2)
    return QP(xi=xi, x=F, w=w, wg=dw, wh=wh, DF=DF, d2F=d2F, g=g, ginv=ginv,
              sqrtJ=sqrtJ, pinv=pinv)


def precompute_geometry(ctrl_tab, bnet, device, dtype):
    """Geometry QP at every quadrature point of the control tabulation
    ``ctrl_tab`` for the homogeneous control net ``bnet`` [ncp, nsd+1];
    leaves have leading dims [nel, nq]."""
    if ctrl_tab.normal is not None:
        raise NotImplementedError("boundary geometry is not ported yet")
    val, gg, hh = eval_jet_arrays(ctrl_tab, bnet, device, dtype)
    xi = torch.as_tensor(np.asarray(ctrl_tab.qp), dtype=dtype, device=device)
    return _geom_point(xi, val, gg, hh)
