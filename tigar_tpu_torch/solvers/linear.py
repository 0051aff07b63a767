"""Matrix-free Krylov building blocks (port of ``jacobi_preconditioner`` and
``cg_fixed_iters`` of tigar_tpu/solvers/linear.py).

The CG loop is a plain Python loop of device work with a fixed iteration
count: the step lengths stay device scalars behind ``torch.where`` guards,
so nothing inside the loop waits for the host.
"""

from __future__ import annotations

import torch


def jacobi_preconditioner(diag):
    dinv = torch.where(diag != 0.0, 1.0 / diag, torch.ones_like(diag))
    return lambda r: dinv * r


def cg_fixed_iters(action, b, n_iters, M=None):
    """Preconditioned CG from a zero initial guess with a fixed iteration
    count (no data-dependent exit).  Returns (x, r) with r the final
    recurrence residual."""
    if M is None:
        M = lambda r: r  # noqa: E731
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b - action(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(int(n_iters)):
        Ap = action(p)
        pAp = torch.dot(p, Ap)
        alpha = torch.where(pAp != 0.0, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz != 0.0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x, r
