"""Mixed-precision iterative refinement (port of
tigar_tpu/solvers/refinement.py): float32 CG sweeps inside, float64
residuals outside, converging to f64 backward accuracy while each f32
solve reduces the error by a constant factor."""

from __future__ import annotations

import torch

from .linear import cg_fixed_iters


def refine_solve(action_f64, action_f32, b, tol=1e-12, max_sweeps=40,
                 inner_iters=50, M_f32=None, x0=None):
    """Solve A x = b to f64 accuracy with f32 inner CG sweeps.

    action_f64 : W -> A @ W in float64 (accurate residual path)
    action_f32 : W -> A @ W in float32 (fast path; same operator)
    tol        : relative residual target in f64
    inner_iters: fixed CG iterations per sweep; keep it near the f32
                 stagnation point of the problem, past which more
                 iterations degrade the correction
    M_f32      : optional f32 preconditioner of the inner CG
    x0         : optional f64 initial guess (zero by default)

    Returns (x, n_sweeps, rel_residual).  The relative residual is read
    on the host once per sweep (the exit test).
    """
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.linalg.norm(b)
    rel = 1.0
    for sweep in range(max_sweeps):
        r = b - action_f64(x)
        rel = float(torch.linalg.norm(r) / bnorm)
        if rel < tol:
            return x, sweep, rel
        d32, _ = cg_fixed_iters(action_f32, r.to(torch.float32), inner_iters,
                                M=M_f32)
        x = x + d32.to(b.dtype)
    return x, max_sweeps, rel
