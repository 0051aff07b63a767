"""Nonlocal (self-)contact through pointwise penalty forces (port of
tigar_tpu/contact.py).

Collocation points (the Greville abscissae of the displacement basis)
carry lumped quadrature weights and interact through a pair potential
phi(r) = k/2 (r_max - r)^2 for r < r_max; pairs closer than r_self in the
reference configuration are excluded.  Interactions are all pairs under a
static bool mask.  The forces and their tangent action are the exact
derivatives of the total pair energy through the spline point-evaluation
operator P (positions x = X + P U): ``residual`` = P^T g and
``tangent_action`` = P^T H P W, with the point-space pair work in
ops/contact.py (kernels K13 and K14 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.basis import eval_basis
from .ops.contact import (contact_forces, contact_hvp, default_row_chunk,
                          padded_pair_mask, pair_bits, pair_energy,
                          pair_penalty_energy)

__all__ = ["PointContact", "pair_penalty_energy"]


class PointContact:
    """Penalty contact between the collocation points of an equal-order
    displacement spline (nsd fields sharing one tensor-product basis).

    ``row_chunk``: the plain versions and ``energy`` work in row blocks of
    this size, bounding their memory to O(row_chunk * n); 2048 rows by
    default when n > 4096.  A custom potential ``phi`` runs on CPU tensors
    only: on the card the kernels implement ``pair_penalty_energy`` and
    anything else raises.  The state lives on the spline's device.
    """

    def __init__(self, spline, k, r_max, r_self, phi=None, row_chunk=None):
        self.spline = spline
        self.k = float(k)
        self.r_max = float(r_max)
        self.r_self = float(r_self)
        self.custom_phi = phi
        self.phi = pair_penalty_energy(self.k, self.r_max) if phi is None \
            else phi

        space = spline.space
        basis = space.fields[0]
        for f in space.fields:
            if f is not basis:
                raise ValueError("PointContact requires an equal-order space")
        self.nsd = space.nsd
        if space.nfields != self.nsd:
            raise ValueError("displacement space must have nsd fields")
        if not hasattr(basis, "kvs"):
            raise NotImplementedError("PointContact currently supports "
                                      "tensor-product displacement bases")

        gp = basis.greville_points()           # [n, dim]
        n = gp.shape[0]
        # the point-evaluation rows: supported functions and their values
        nodes_d, vals_d = [], []
        for d, kv in enumerate(basis.kvs):
            nd, ders = eval_basis(kv, gp[:, d], 0)
            nodes_d.append(nd)
            vals_d.append(ders[:, 0, :])
        conn, vals = nodes_d[0], vals_d[0]
        stride = basis.kvs[0].ncp
        for d in range(1, basis.dim):
            conn = (conn[:, :, None]
                    + stride * nodes_d[d][:, None, :]).reshape(n, -1)
            vals = (vals[:, :, None] * vals_d[d][:, None, :]).reshape(n, -1)
            stride *= basis.kvs[d].ncp

        # control weights at the points (homogeneous -> physical)
        bnet = np.asarray(spline.bnet)
        wts = basis.evaluate(bnet[:, -1], gp)
        X = np.stack([basis.evaluate(bnet[:, j], gp)
                      for j in range(self.nsd)], axis=-1) / wts[:, None]

        # lumped quadrature weights: the integral of each rationalized
        # basis function
        def Lones(ctx, v):
            return torch.sum(torch.atleast_1d(ctx.rationalize(v).val))
        W = spline.assemble_vector(Lones, apply_bcs=False)

        # the static exclusion mask (r_self and self-pairs), built in row
        # blocks so the f64 distance transient stays O(block * n)
        mask = np.empty((n, n), dtype=bool)
        blk = max(1, min(n, (1 << 22) // max(n, 1)))
        for i0 in range(0, n, blk):
            d2 = np.sum((X[i0:i0 + blk, None, :] - X[None, :, :]) ** 2,
                        axis=-1)
            mask[i0:i0 + blk] = d2 > self.r_self ** 2
        self._set_arrays(conn, vals, X, wts,
                         W[space.field_slice(0)], mask, spline.device,
                         spline.dtype, row_chunk)

    def _set_arrays(self, conn, vals, X, w_ctrl, quad_w, pair_mask, device,
                    dtype, row_chunk):
        def t(a):
            return torch.as_tensor(np.array(a) if not isinstance(
                a, torch.Tensor) else a, device=device).to(dtype)

        self.conn = torch.as_tensor(np.array(conn), dtype=torch.int64,
                                    device=device)
        self.vals, self.X, self.w_ctrl, self.quad_w = (
            t(vals), t(X), t(w_ctrl), t(quad_w))
        self.pair_mask = padded_pair_mask(pair_mask, device)
        self.pair_bits = pair_bits(self.pair_mask)
        self.row_chunk = default_row_chunk(self.X.shape[0], row_chunk)
        space = self.spline.space
        self._offsets = [int(space.offsets[f]) for f in range(self.nsd)]
        self._rows = torch.cat([self.conn + o for o in self._offsets])

    def astype(self, dtype):
        """A copy with the floating state cast to ``dtype`` (the mask, its
        bits and the indices shared): the f32 contact of the mixed-
        precision CG."""
        obj = PointContact.__new__(PointContact)
        obj.__dict__.update(self.__dict__)
        for name in ("vals", "X", "w_ctrl", "quad_w"):
            setattr(obj, name, getattr(self, name).to(dtype))
        return obj

    # -- kinematics -----------------------------------------------------------

    def _apply_P(self, U):
        """[n, nsd] point values of the DoF vector U (no reference X)."""
        n, nen = self.conn.shape
        cf = U[self._rows].reshape(self.nsd, n, nen)
        return (torch.sum(self.vals[None] * cf, dim=-1) / self.w_ctrl).t()

    def _apply_PT(self, g):
        """DoF vector of the point-space covector g [n, nsd]: P^T g."""
        gw = (g / self.w_ctrl[:, None]).t()            # [nsd, n]
        contrib = self.vals[None] * gw[:, :, None]     # [nsd, n, nen]
        out = torch.zeros(self.spline.ndof, dtype=g.dtype, device=g.device)
        return out.index_add_(0, self._rows.reshape(-1), contrib.reshape(-1))

    def positions(self, U):
        """Deformed collocation-point positions x = X + disp(U)."""
        return self.X + self._apply_P(U)

    # -- energy / residual / tangent ------------------------------------------

    def energy(self, U):
        """The total pair energy (a plain torch reduction in row blocks)."""
        return pair_energy(self.positions(U), self.quad_w, self.pair_mask,
                           self.phi, self.r_max, self.row_chunk)

    def residual(self, U):
        """The contact residual: the gradient of ``energy``, P^T g with g
        the pair forces (K13 on the card)."""
        g = contact_forces(self.positions(U).contiguous(), self.quad_w,
                           self.pair_mask, self.k, self.r_max,
                           phi=self.custom_phi, row_chunk=self.row_chunk,
                           bits=self.pair_bits)
        return self._apply_PT(g)

    def tangent_action(self, U, W):
        """The contact tangent at U applied to W: P^T H (P W), H the pair
        Hessian (K14 on the card)."""
        hv = contact_hvp(self.positions(U).contiguous(),
                         self._apply_P(W).contiguous(), self.quad_w,
                         self.pair_mask, self.k, self.r_max,
                         phi=self.custom_phi, row_chunk=self.row_chunk,
                         bits=self.pair_bits)
        return self._apply_PT(hv)
