"""Matrix-free Krylov building blocks (port of ``jacobi_preconditioner``,
``cg_fixed_iters``, ``cg_device_iters``, ``fcg_device_iters``,
``bicgstab_device_iters`` and the CG / BiCGStab state and step helpers of
tigar_tpu/solvers/linear.py).

The loops are plain Python loops of device work: the step lengths stay
device scalars behind ``torch.where`` guards, so nothing inside the loop
waits for the host.  The ``*_device_iters`` solvers take an optional
relative-residual exit ``tol``, read on the host every ``check_every``
iterations (one scalar fetch per check), as the JAX package's do.
"""

from __future__ import annotations

import torch


def jacobi_preconditioner(diag):
    dinv = torch.where(diag != 0.0, 1.0 / diag, torch.ones_like(diag))
    return lambda r: dinv * r


def _identity(r):
    return r


def _safe_div(num, den):
    """num / den where den != 0, else 0 (device scalars, no sync)."""
    return torch.where(den != 0.0, num / den, torch.zeros_like(num))


def cg_fixed_iters(action, b, n_iters, M=None):
    """Preconditioned CG from a zero initial guess with a fixed iteration
    count (no data-dependent exit).  Returns (x, r) with r the final
    recurrence residual."""
    M = _identity if M is None else M
    st = cg_state_init(action, M, b, None)
    for _ in range(int(n_iters)):
        st = cg_step(action, M, st)
    return st[0], st[1]


def cg_state_init(action, M, b, x0):
    """Initial PCG state (x, r, p, rz) for ``cg_step``."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - action(x)
    z = M(r)
    return (x, r, z, torch.dot(r, z))


def cg_step(action, M, st):
    """One preconditioned-CG iteration on the state (x, r, p, rz)."""
    x, r, p, rz = st
    Ap = action(p)
    alpha = _safe_div(rz, torch.dot(p, Ap))
    x = x + alpha * p
    r = r - alpha * Ap
    z = M(r)
    rz_new = torch.dot(r, z)
    beta = _safe_div(rz_new, rz)
    return (x, r, z + beta * p, rz_new)


def bicgstab_state_init(action, M, b, x0):
    """Initial BiCGStab state (x, r, rhat, rho, alpha, omega, v, p)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - action(x)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z = torch.zeros_like(b)
    return (x, r, r, one, one, one, z, z)


def bicgstab_step(action, M, st):
    """One preconditioned-BiCGStab iteration on the state of
    ``bicgstab_state_init``."""
    x, r, rhat, rho, alpha, omega, v, p = st
    rho_new = torch.dot(rhat, r)
    beta = torch.where(rho * omega != 0.0, (rho_new / rho) * (alpha / omega),
                       torch.zeros_like(rho))
    p = r + beta * (p - omega * v)
    phat = M(p)
    v = action(phat)
    alpha = _safe_div(rho_new, torch.dot(rhat, v))
    s = r - alpha * v
    shat = M(s)
    t = action(shat)
    omega = _safe_div(torch.dot(t, s), torch.dot(t, t))
    x = x + alpha * phat + omega * shat
    r = s - omega * t
    return (x, r, rhat, rho_new, alpha, omega, v, p)


def _converged(r, tol, bnorm, it, check_every):
    return (tol is not None and (it + 1) % int(check_every) == 0
            and float(torch.linalg.norm(r)) <= tol * bnorm)


def cg_device_iters(action, b, n_iters, M=None, x0=None, tol=None,
                    check_every=20):
    """Preconditioned CG for at most ``n_iters`` iterations, with the
    optional host-checked relative-residual exit.  Returns (x, r)."""
    M = _identity if M is None else M
    bnorm = float(torch.linalg.norm(b)) if tol is not None else None
    st = cg_state_init(action, M, b, x0)
    for it in range(int(n_iters)):
        st = cg_step(action, M, st)
        if _converged(st[1], tol, bnorm, it, check_every):
            break
    return st[0], st[1]


def fcg_device_iters(action, b, n_iters, M=None, x0=None, tol=None,
                     check_every=20):
    """FLEXIBLE preconditioned CG (Polak-Ribiere beta, clipped at 0): the
    recurrence that stays convergent under a slightly varying
    preconditioner such as an f32 V-cycle inside an f64 solve.
    Returns (x, r)."""
    M = _identity if M is None else M
    bnorm = float(torch.linalg.norm(b)) if tol is not None else None
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - action(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    for it in range(int(n_iters)):
        Ap = action(p)
        alpha = _safe_div(rz, torch.dot(p, Ap))
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = torch.dot(r_new, z)
        beta = torch.clamp(_safe_div(torch.dot(r_new - r, z), rz), min=0.0)
        p = z + beta * p
        r, rz = r_new, rz_new
        if _converged(r, tol, bnorm, it, check_every):
            break
    return x, r


def bicgstab_device_iters(action, b, n_iters, M=None, x0=None, tol=None,
                          check_every=20):
    """Preconditioned BiCGStab (nonsymmetric tangents) for at most
    ``n_iters`` iterations, with the optional host-checked exit.
    Returns (x, r)."""
    M = _identity if M is None else M
    bnorm = float(torch.linalg.norm(b)) if tol is not None else None
    st = bicgstab_state_init(action, M, b, x0)
    for it in range(int(n_iters)):
        st = bicgstab_step(action, M, st)
        if _converged(st[1], tol, bnorm, it, check_every):
            break
    return st[0], st[1]
