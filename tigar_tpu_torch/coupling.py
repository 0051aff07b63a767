"""Penalty coupling of non-matching multi-patch interfaces (port of
tigar_tpu/coupling.py: ``_deformed_unit_normal``, ``_penalty_density``,
``PenaltyInterfaceCoupling``, ``_shell_penalty_density`` and
``ShellInterfaceCoupling``).

Each coupling is a density on ``interface.InterfaceForm``.  The shell
penalty density has hand kernels for the card: K6 (``csrc/
shell_interface.cu``), the interface residual, and K7, the dense interface
tangent block; their plain versions are the InterfaceForm ones
(``iform_residual_ref``, ``iform_tangent_block_ref``).  The RT and
Laplace-Nitsche couplings are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .interface import InterfaceForm
from .models.shell import _cross
from .ops import cuda_ext


def _deformed_unit_normal(DF, ug):
    G = DF + ug
    n = _cross(G[..., :, 0], G[..., :, 1])
    return n / torch.sqrt((n * n).sum(-1, keepdim=True))


def _penalty_density(ua, ub, qp, params):
    """E = penalty/2 |u_a - u_b|^2 per unit physical interface measure."""
    j = ua.val - ub.val
    return 0.5 * params["penalty"] * (j * j).sum(-1)


class PenaltyInterfaceCoupling(InterfaceForm):
    """Penalty coupling of the fields of one ExtractedSpline across a
    non-matching interface between two patches of its multi-patch basis
    (see tigar_tpu.coupling.PenaltyInterfaceCoupling)."""

    def __init__(self, spline, patch_a, side_a, patch_b, side_b, penalty,
                 flips=None, fields=None, quad_degree=None, geom_tol=1e-8,
                 _density=None, _params=None, _nders=1):
        super().__init__(
            spline, patch_a, side_a, patch_b, side_b,
            _penalty_density if _density is None else _density,
            params={"penalty": float(penalty)} if _params is None
            else _params,
            nders=_nders, fields=fields, quad_degree=quad_degree,
            flips=flips, geom_tol=geom_tol)

    @property
    def penalty(self):
        return float(self.params["penalty"])


def _shell_penalty_density(ua, ub, qp, params):
    """Displacement + rotation penalty for two KL shell patches:
    pd/2 |[u]|^2 + pr/2 |(n_A(U)-n_A(0)) - s (n_B(U)-n_B(0))|^2 with the
    deformed unit normals built from the side jets."""
    jump = ua.val - ub.val
    e_d = (jump * jump).sum(-1)
    za = torch.zeros_like(ua.g)
    na = _deformed_unit_normal(qp.a.DF, ua.g)
    n0a = _deformed_unit_normal(qp.a.DF, za)
    nb = _deformed_unit_normal(qp.b.DF, ub.g)
    n0b = _deformed_unit_normal(qp.b.DF, za)
    dn = (na - n0a) - params["sign"] * (nb - n0b)
    return 0.5 * (params["penalty"] * e_d
                  + params["penalty_rot"] * (dn * dn).sum(-1))


class ShellInterfaceCoupling(PenaltyInterfaceCoupling):
    """Displacement + rotation penalty coupling of two Kirchhoff-Love
    shell patches (2D patches in 3D, equal-order 3-field displacement
    space) across a non-matching interface:

        E(U) = 1/2 sum_q w_q [ pd |u_A - u_B|^2
                             + pr |(n_A(U) - n_A(0)) - s (n_B(U) - n_B(0))|^2 ]

    with n(U) the deformed unit normal from the side jets and s = +-1
    aligning the two sides' reference orientations (detected here).  On
    CUDA tensors the residual runs kernel K6 and the tangent block K7."""

    def __init__(self, spline, patch_a, side_a, patch_b, side_b,
                 penalty_disp, penalty_rot, flips=None, quad_degree=None,
                 geom_tol=1e-8):
        if spline.space.nfields != 3:
            raise ValueError("shell coupling requires a 3-field "
                             "displacement space")
        pa = spline.space.fields[0].patches[patch_a]
        if pa.dim != 2 or np.asarray(spline.bnet).shape[1] != 4:
            raise NotImplementedError("shell coupling requires 2D patches "
                                      "in 3D physical space")
        super().__init__(
            spline, patch_a, side_a, patch_b, side_b,
            penalty=penalty_disp, flips=flips, fields=None,
            quad_degree=quad_degree, geom_tol=geom_tol,
            _density=_shell_penalty_density,
            _params={"penalty": float(penalty_disp),
                     "penalty_rot": float(penalty_rot),
                     "sign": 1.0})

        def ref_normals(qp):
            DF = qp.DF.cpu().numpy()
            n = np.cross(DF[:, :, 0], DF[:, :, 1])
            return n / np.linalg.norm(n, axis=-1, keepdims=True)

        dots = np.einsum("qc,qc->q", ref_normals(self.side_a.qp),
                         ref_normals(self.side_b.qp))
        if not (np.all(dots > 0) or np.all(dots < 0)):
            raise ValueError("inconsistent relative orientation of the "
                             "two shell patches along the interface")
        self.params["sign"] = 1.0 if dots[0] > 0 else -1.0

    @property
    def penalty_rot(self):
        return float(self.params["penalty_rot"])

    @property
    def orient_sign(self):
        return float(self.params["sign"])

    def rotation_jump_norm(self, U):
        """L2 norm of the relative-rotation (normal-change jump)
        diagnostic."""
        ua = self._jets(U, self.side_a)
        ub = self._jets(U, self.side_b)
        qa, qb = self.side_a.qp, self.side_b.qp
        za = torch.zeros_like(ua.g)
        dn = ((_deformed_unit_normal(qa.DF, ua.g)
               - _deformed_unit_normal(qa.DF, za))
              - self.params["sign"] * (_deformed_unit_normal(qb.DF, ub.g)
                                       - _deformed_unit_normal(qb.DF, za)))
        return torch.sqrt(torch.sum(self.wq * (dn * dn).sum(-1)))

    # -- kernels K6 / K7 --------------------------------------------------------

    def _kernel_args(self, x, params):
        """Check what K6/K7 take and return (side_a, side_b, consts)."""
        if self.density is not _shell_penalty_density:
            raise self._no_kernel()
        if not (x.is_cuda and self.wq.is_cuda):
            raise ValueError("the shell interface kernels need CUDA tensors")
        if x.dtype != self.dtype or x.dtype not in (torch.float32,
                                                    torch.float64):
            raise TypeError(f"state {x.dtype} vs interface form "
                            f"{self.dtype}")
        nq = self.wq.shape[0]

        def side(sd):
            t = (sd.conn, sd.R0, sd.R1, sd.qp.DF)
            shapes = ((nq, 3, 9), (nq, 3, 9), (nq, 3, 9, 2), (nq, 3, 2))
            if any(tuple(a.shape) != s for a, s in zip(t, shapes)):
                raise ValueError("the shell interface kernels take 3 fields "
                                 "of 9 biquadratic functions per side in 3D")
            return [a.contiguous() for a in t]

        consts = [float(params["penalty"]), float(params["penalty_rot"]),
                  float(params["sign"])]
        return side(self.side_a), side(self.side_b), consts

    def residual_cuda(self, U, params):
        """Kernel K6: one thread per interface quadrature point."""
        sa, sb, consts = self._kernel_args(U, params)
        if U.shape != (self.ndof,):
            raise ValueError(f"U shape {tuple(U.shape)} != ({self.ndof},)")
        r = cuda_ext.load().shell_iface_residual(
            sa, sb, self.wq.contiguous(), U.contiguous(), consts)
        cuda_ext.count("shell_iface_residual")
        return r

    def tangent_block_cuda(self, u_sub, pos_a, pos_b, params):
        """Kernel K7: one block per interface quadrature point."""
        sa, sb, consts = self._kernel_args(u_sub, params)
        if u_sub.shape != (len(self.support),):
            raise ValueError(f"u_sub shape {tuple(u_sub.shape)}, support "
                             f"{len(self.support)}")
        K = cuda_ext.load().shell_iface_tangent(
            sa, sb, pos_a.contiguous(), pos_b.contiguous(),
            self.wq.contiguous(), u_sub.contiguous(), consts)
        cuda_ext.count("shell_iface_tangent")
        return K
