"""Kirchhoff-Love shell: reference frame and the SVK adjoint density.

Port of the parts of tigar_tpu/models/shell.py that the production shell
paths run: ``ShellReference``, ``cartesian_frame_matrix``,
``shell_reference``, ``precompute_shell_reference``, ``svk_shell_residual``
and ``svk_shell_adjoint``, and the energy the consistent interface
coupling differentiates: ``configuration_fn``, ``midsurface_geometry`` and
``svk_psi_surface``.  Every function indexes trailing axes only, so it
evaluates a whole [nel, nq] batch in one call and also runs per point
under ``torch.func.vmap``/``jacfwd`` (the tangent twin).

``SVKShellAdjoint`` bundles the adjoint density with its material
constants and a constant load: it is the object the CUDA kernels recognise
(csrc/svk_adjoint.cuh carries the same pointwise formulas, templated over
the scalar type).
"""

from __future__ import annotations

from typing import NamedTuple, Any

import torch

from ..forms import Jet, taylor_eval
from ..ops.smallmat import inv_small


def _cross(u, v, dim=-1):
    """Cross product along ``dim`` (length 3), broadcasting elsewhere."""
    u0, u1, u2 = u.unbind(dim)
    v0, v1, v2 = v.unbind(dim)
    return torch.stack([u1 * v2 - u2 * v1,
                        u2 * v0 - u0 * v2,
                        u0 * v1 - u1 * v0], dim)


def _trace(A):
    return A[..., 0, 0] + A[..., 1, 1]


def _tr(A):
    return A.transpose(-1, -2)


def _unit(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


class ShellReference(NamedTuple):
    """Geometry-only Kirchhoff-Love reference data at quadrature points:
    the reference metric/curvature and the curvilinear-to-local-Cartesian
    transformation matrix (each [..., 2, 2])."""
    a: Any
    b: Any
    ea: Any


def _midsurface(G, H):
    """Covariant basis, unit normal, its parametric derivatives, metric and
    curvature of the midsurface with Jacobian G [..., 3, 2] and Hessian
    H [..., 3, 2, 2] (tigar_tpu.models.shell.midsurface_geometry)."""
    a0, a1 = G[..., :, 0], G[..., :, 1]
    n = _cross(a0, a1)
    nn = torch.sqrt((n * n).sum(-1))
    a2 = n / nn[..., None]
    dn = (_cross(H[..., :, 0, :], a1[..., :, None], -2)
          + _cross(a0[..., :, None], H[..., :, 1, :], -2))
    a2dn = (a2[..., :, None] * dn).sum(-2)
    deriv_a2 = (dn - a2[..., :, None] * a2dn[..., None, :]) \
        / nn[..., None, None]
    a = _tr(G) @ G
    b = -(_tr(G) @ deriv_a2)
    b = 0.5 * (b + _tr(b))
    return a0, a1, a2, deriv_a2, a, b


class MidsurfaceGeometry(NamedTuple):
    """Covariant midsurface data in one configuration: basis vectors a0,
    a1 [..., 3], unit normal a2 [..., 3] and its parametric derivatives
    deriv_a2 [..., 3, 2], metric a and curvature b [..., 2, 2]."""
    a0: Any
    a1: Any
    a2: Any
    deriv_a2: Any
    a: Any
    b: Any


def configuration_fn(ctx, y=None):
    """Taylor polynomial (in the parametric offset) of the shell
    configuration: the reference midsurface X = F, deformed by the
    displacement jet ``y`` when given (per point)."""
    def xfun(delta):
        X = taylor_eval(ctx.x, ctx.DF, ctx.d2F, delta)
        if y is None:
            return X
        return X + taylor_eval(y.val, y.g, y.h, delta)
    return xfun


def midsurface_geometry(ctx, y=None):
    """MidsurfaceGeometry of the reference midsurface, or of the one
    deformed by the displacement jet ``y``: Jacobian DF + y.g, Hessian
    d2F + y.h (closed form, as tigar_tpu.models.shell)."""
    G = ctx.DF if y is None else ctx.DF + y.g
    H = ctx.d2F if y is None else ctx.d2F + y.h
    return MidsurfaceGeometry(*_midsurface(G, H))


def cartesian_frame_matrix(a, a0, a1):
    """The (e_i . a^j) matrix of the curvilinear-to-local-Cartesian map."""
    ac = inv_small(a)
    a0c = ac[..., 0, 0, None] * a0 + ac[..., 0, 1, None] * a1
    a1c = ac[..., 1, 0, None] * a0 + ac[..., 1, 1, None] * a1
    e0 = _unit(a0)
    e1 = _unit(a1 - e0 * (a1 * e0).sum(-1, keepdim=True))
    return torch.stack([
        torch.stack([(e0 * a0c).sum(-1), (e0 * a1c).sum(-1)], -1),
        torch.stack([(e1 * a0c).sum(-1), (e1 * a1c).sum(-1)], -1)], -2)


def shell_reference(ctx):
    """ShellReference of the reference configuration (batched)."""
    a0, a1, _, _, a, b = _midsurface(ctx.DF, ctx.d2F)
    return ShellReference(a=a, b=b, ea=cartesian_frame_matrix(a, a0, a1))


def precompute_shell_reference(spline, domain="dx"):
    """Attach ShellReference data to the spline's assembler ctx (under
    ``ctx.aux['shell_ref']``).  Registered as a ctx hook, so assemblers
    created later (the reduced-quadrature tangent-build assembler of
    StencilNewton(build_quad_degree=...)) get their own shell_ref."""
    def attach(dom, asm):
        if dom != domain:
            return
        aux = dict(asm.ctx.aux or {})
        aux["shell_ref"] = shell_reference(asm.ctx)
        asm.ctx = asm.ctx._replace(aux=aux)

    for quad_key in list(spline._assemblers.keys()):
        attach(quad_key[0], spline._assemblers[quad_key])
    spline._ctx_hooks.append(attach)
    return spline


def _svk_contract(S, lam_ps, mu):
    """lam tr(S)^2 + 2 mu S:S as [..., 1]: per-point scalars keep a
    trailing axis while they meet Python floats, because torch.func's
    forward mode turns the tangent of (0-dim tensor) * (Python float) into
    float64 (torch 2.13), which f32 matmuls downstream refuse."""
    trS = _trace(S)[..., None]
    return (lam_ps * trS * trS
            + 2.0 * mu * (S * S).sum((-2, -1))[..., None])


def svk_psi_surface(ctx, y, E_mod, nu, h_th):
    """St. Venant-Kirchhoff Kirchhoff-Love shell energy per unit reference
    midsurface area, integrated through the thickness: 1/2 (h A:eps:eps +
    h^3/12 A:kappa:kappa) with the local-Cartesian membrane strain eps,
    curvature change kappa and the plane-stress tensor A.

    The reference geometry is read from ``ctx.aux['shell_ref']`` when
    present, else recomputed from ``ctx`` (the interface coupling's
    shifted points carry no aux)."""
    if ctx.aux is not None and "shell_ref" in ctx.aux:
        sref = ctx.aux["shell_ref"]
        ref_a, ref_b, ea = sref.a, sref.b, sref.ea
    else:
        ref = midsurface_geometry(ctx)
        ref_a, ref_b = ref.a, ref.b
        ea = cartesian_frame_matrix(ref.a, ref.a0, ref.a1)
    cur = midsurface_geometry(ctx, y)
    eps = ea @ (0.5 * (cur.a - ref_a)) @ _tr(ea)
    kappa = ea @ (cur.b - ref_b) @ _tr(ea)
    lam_ps = E_mod * nu / (1.0 - nu ** 2)
    mu = E_mod / (2.0 * (1.0 + nu))
    return (0.5 * (h_th * _svk_contract(eps, lam_ps, mu)
                   + h_th ** 3 / 12.0 * _svk_contract(kappa, lam_ps,
                                                      mu)))[..., 0]


def svk_shell_energy(ctx, u, params):
    """``svk_psi_surface`` with the material in ``params`` ({"E", "nu",
    "h"}): the energy density of bench.py's consistent two-patch
    coupling, and the one density whose Nitsche coupling has CUDA kernels
    (K8/K9; ``interface.EnergyNitscheCoupling`` recognises it by
    identity)."""
    return svk_psi_surface(ctx, u, params["E"], params["nu"], params["h"])


def _svk_primal(ctx, y, E_mod, nu, h_th):
    """The v-independent chain shared by the residual and its adjoint:
    geometry of the deformed midsurface and the covariant stress
    resultants Nb, Mb."""
    sref = ctx.aux["shell_ref"]
    ref_a, ref_b, ea = sref.a, sref.b, sref.ea
    G = ctx.DF + y.g                                  # [..., 3, 2]
    H = ctx.d2F + y.h                                 # [..., 3, 2, 2]
    a0, a1 = G[..., :, 0], G[..., :, 1]
    n = _cross(a0, a1)
    nn = torch.sqrt((n * n).sum(-1))
    a2 = n / nn[..., None]
    dn = (_cross(H[..., :, 0, :], a1[..., :, None], -2)
          + _cross(a0[..., :, None], H[..., :, 1, :], -2))
    a2dn = (a2[..., :, None] * dn).sum(-2)            # [..., 2]
    deriv_a2 = (dn - a2[..., :, None] * a2dn[..., None, :]) \
        / nn[..., None, None]
    cur_a = _tr(G) @ G
    b_uns = -(_tr(G) @ deriv_a2)
    cur_b = 0.5 * (b_uns + _tr(b_uns))
    eps = ea @ (0.5 * (cur_a - ref_a)) @ _tr(ea)
    kap = ea @ (cur_b - ref_b) @ _tr(ea)
    lam_ps = E_mod * nu / (1.0 - nu ** 2)
    mu = E_mod / (2.0 * (1.0 + nu))
    I2 = torch.eye(2, dtype=G.dtype, device=G.device)
    Nm = h_th * (lam_ps * _trace(eps)[..., None, None] * I2
                 + 2.0 * mu * eps)
    Mm = h_th ** 3 / 12.0 * (lam_ps * _trace(kap)[..., None, None] * I2
                             + 2.0 * mu * kap)
    Nb = _tr(ea) @ Nm @ ea
    Mb = _tr(ea) @ Mm @ ea
    return G, H, a0, a1, n, nn, a2, dn, a2dn, deriv_a2, Nb, Mb


def svk_shell_residual(ctx, y, v, E_mod, nu, h_th):
    """First variation dW(y; v) of the SVK shell energy density (the
    residual density; linear in the test jet ``v``)."""
    (G, H, a0, a1, n, nn, a2, dn, a2dn, deriv_a2, Nb,
     Mb) = _svk_primal(ctx, y, E_mod, nu, h_th)
    dG = v.g
    dH = v.h
    da0, da1 = dG[..., :, 0], dG[..., :, 1]
    dnt = _cross(da0, a1) + _cross(a0, da1)
    dnn = (n * dnt).sum(-1) / nn
    da2 = (dnt - a2 * dnn[..., None]) / nn[..., None]
    ddn = (_cross(dH[..., :, 0, :], a1[..., :, None], -2)
           + _cross(H[..., :, 0, :], da1[..., :, None], -2)
           + _cross(da0[..., :, None], H[..., :, 1, :], -2)
           + _cross(a0[..., :, None], dH[..., :, 1, :], -2))
    nn2 = nn[..., None, None]
    dderiv_a2 = ((ddn - da2[..., :, None] * a2dn[..., None, :]
                  - a2[..., :, None]
                  * (da2[..., :, None] * dn).sum(-2)[..., None, :]
                  - a2[..., :, None]
                  * (a2[..., :, None] * ddn).sum(-2)[..., None, :]) / nn2
                 - deriv_a2 * (dnn / nn)[..., None, None])
    d_cur_a = _tr(dG) @ G + _tr(G) @ dG
    db_uns = -(_tr(dG) @ deriv_a2 + _tr(G) @ dderiv_a2)
    d_cur_b = 0.5 * (db_uns + _tr(db_uns))
    return ((Nb * (0.5 * d_cur_a)).sum((-2, -1))
            + (Mb * d_cur_b).sum((-2, -1)))


def svk_shell_adjoint(ctx, y, E_mod, nu, h_th):
    """Adjoint jet F = (Fval, Fg, Fh) of the SVK shell residual:
    svk_shell_residual(ctx, y, v) == sum(F.g * v.g) + sum(F.h * v.h) for
    every test jet v (Fval = 0; loads go on top).  The derivation is in
    the docstring of tigar_tpu.models.shell.svk_shell_adjoint."""
    (G, H, a0, a1, n, nn, a2, dn, a2dn, deriv_a2, Nb,
     Mb) = _svk_primal(ctx, y, E_mod, nu, h_th)
    nn1 = nn[..., None]
    nn2 = nn[..., None, None]
    S = -(G @ Mb)                                     # [..., 3, 2]
    Sa2 = (a2[..., :, None] * S).sum(-2)              # [..., 2]
    R = (S - a2[..., :, None] * Sa2[..., None, :]) / nn2
    Q = -((S * a2dn[..., None, :]).sum(-1)
          + (dn * Sa2[..., None, :]).sum(-1)) / nn1   # [..., 3]
    rho = -(S * deriv_a2).sum((-2, -1)) / nn
    t = (Q - a2 * (a2 * Q).sum(-1, keepdim=True)) / nn1 + rho[..., None] * a2

    Fg = G @ Nb - deriv_a2 @ Mb                       # [..., 3, 2]
    H0, H1 = H[..., :, 0, :], H[..., :, 1, :]
    Fg0 = Fg[..., :, 0] + _cross(a1, t) + _cross(H1, R, -2).sum(-1)
    Fg1 = Fg[..., :, 1] + _cross(t, a0) + _cross(R, H0, -2).sum(-1)
    Fg = torch.stack([Fg0, Fg1], -1)
    Fh = torch.stack([_cross(a1[..., :, None], R, -2),
                      _cross(R, a0[..., :, None], -2)], -2)  # [..., 3, 2, 2]
    val = torch.zeros(G.shape[:-1], dtype=G.dtype, device=G.device)
    return Jet(val, Fg, Fh)


class SVKShellAdjoint:
    """Adjoint-jet residual density of the SVK Kirchhoff-Love shell under a
    constant load per unit reference area: ``F = svk_shell_adjoint(ctx, u,
    ...)`` with ``load`` added to F.val (e.g. ``load=(0, 0, -q)`` for the
    pressure q of the production shell problem).

    Its ``__call__`` is the plain PyTorch density (CPU twins); on CUDA the
    residual and tangent kernels read ``E_mod``, ``nu``, ``h_th`` and
    ``load`` and evaluate the same formulas in csrc/svk_adjoint.cuh.
    """

    def __init__(self, E_mod, nu, h_th, load=(0.0, 0.0, 0.0)):
        self.E_mod = float(E_mod)
        self.nu = float(nu)
        self.h_th = float(h_th)
        self.load = tuple(float(x) for x in load)
        if len(self.load) != 3:
            raise ValueError("load needs one value per displacement field")

    def __call__(self, ctx, u):
        F = svk_shell_adjoint(ctx, u, self.E_mod, self.nu, self.h_th)
        load = torch.as_tensor(self.load, dtype=F.val.dtype,
                               device=F.val.device)
        return F._replace(val=F.val + load)

    def kernel_constants(self):
        """(lam_ps, 2 mu, h, h^3/12, load) in double precision, the
        material constants as the kernels consume them."""
        lam_ps = self.E_mod * self.nu / (1.0 - self.nu ** 2)
        two_mu = 2.0 * (self.E_mod / (2.0 * (1.0 + self.nu)))
        return (lam_ps, two_mu, self.h_th, self.h_th ** 3 / 12.0) \
            + self.load
