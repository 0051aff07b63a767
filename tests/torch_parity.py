"""Shared helpers of the tigar_tpu_torch parity tests: the same clamped SVK
shell plate built by the JAX package and by the port, and the error
measure the tolerances are stated in.  Inputs are made with numpy and
handed to both packages as arrays."""

import numpy as np
import torch

E_MOD, NU, H_TH = 1.0e7, 0.3, 0.03

# The parity tests' tensors are small, and the tier-1 run shares the
# machine's cores among its xdist workers: one intra-op thread per worker
# keeps the torch tests from oversubscribing the cores the JAX tests use.
torch.set_num_threads(1)


def build_jax(nel, p=2, clamp=True):
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import precompute_shell_reference
    return _build(nel, p, clamp, uniform_knots, ExplicitBSplineControlMesh,
                  EqualOrderSpline, precompute_shell_reference,
                  lambda sp: ExtractedSpline(sp, quad_degree=2 * p, nders=2))


def build_torch(nel, p=2, clamp=True, device="cpu"):
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu_torch.models.space import EqualOrderSpline
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    from tigar_tpu_torch.models.shell import precompute_shell_reference
    return _build(nel, p, clamp, uniform_knots, ExplicitBSplineControlMesh,
                  EqualOrderSpline, precompute_shell_reference,
                  lambda sp: ExtractedSpline(sp, quad_degree=2 * p, nders=2,
                                             device=device))


def _build(nel, p, clamp, uniform_knots, ControlMesh, EqualOrderSpline,
           precompute_shell_reference, extracted):
    kvecs = [uniform_knots(p, -1.0, 1.0, nel)] * 2
    cm = ControlMesh([p, p], kvecs, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    if clamp:
        basis = cm.scalar_basis()
        for side in (0, 1):
            for direction in (0, 1):
                dofs = basis.side_dofs(direction, side, n_layers=2)
                for i in range(3):
                    sp.add_zero_dofs(i, dofs)
    return precompute_shell_reference(extracted(sp))


def jax_density(q):
    """tigar_tpu's shell adjoint density with the load q on Fval[2]."""
    from tigar_tpu.models.shell import svk_shell_adjoint

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_MOD, NU, H_TH)
        return F._replace(val=F.val.at[2].add(-q))
    return res_adj


def torch_density(q):
    from tigar_tpu_torch.models.shell import SVKShellAdjoint
    return SVKShellAdjoint(E_MOD, NU, H_TH, load=(0.0, 0.0, -q))


def as_np(x):
    try:
        return x.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(x)


def rel(a, b):
    """max |a - b| / max |b| (b the reference)."""
    a, b = as_np(a).astype(np.float64), as_np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# -- multi-patch shells (tests/test_newton_mp.py) ------------------------------


def _mp_modules(pkg):
    if pkg == "jax":
        from tigar_tpu.ops.knots import uniform_knots
        from tigar_tpu.models.bspline import TensorBSplineBasis
        from tigar_tpu.models.multipatch import (MultiPatchBSplineBasis,
                                                 MultiPatchControlMesh)
        from tigar_tpu.models.space import EqualOrderSpline
        from tigar_tpu.models.extracted import ExtractedSpline
        from tigar_tpu.models.shell import precompute_shell_reference
        from tigar_tpu.coupling import ShellInterfaceCoupling
    else:
        from tigar_tpu_torch.ops.knots import uniform_knots
        from tigar_tpu_torch.models.bspline import TensorBSplineBasis
        from tigar_tpu_torch.models.multipatch import (MultiPatchBSplineBasis,
                                                       MultiPatchControlMesh)
        from tigar_tpu_torch.models.space import EqualOrderSpline
        from tigar_tpu_torch.models.extracted import ExtractedSpline
        from tigar_tpu_torch.models.shell import precompute_shell_reference
        from tigar_tpu_torch.coupling import ShellInterfaceCoupling
    return (uniform_knots, TensorBSplineBasis, MultiPatchBSplineBasis,
            MultiPatchControlMesh, EqualOrderSpline, ExtractedSpline,
            precompute_shell_reference, ShellInterfaceCoupling)


def multipatch_shell(pkg, nels, offsets, device="cpu", p=2,
                     clamps=((0, 0, 0),)):
    """A clamped multi-patch KL plate of tigar_tpu ("jax") or of the port
    ("torch"): patch i has nels[i] = (nx, ny) elements on the unit square
    shifted by offsets[i]; each (patch, direction, side) of ``clamps`` is
    clamped (2 layers), by default patch 0 at x = 0."""
    (uk, TB, MPB, MPC, EOS, ES, psr, _) = _mp_modules(pkg)
    basis = MPB([TB([p, p], [uk(p, 0.0, 1.0, nx), uk(p, 0.0, 1.0, ny)])
                 for nx, ny in nels])

    def bnet(patch, off):
        g = patch.greville_points()
        B = np.zeros((g.shape[0], 4))
        B[:, 0] = g[:, 0] + off[0]
        B[:, 1] = g[:, 1] + off[1]
        B[:, 3] = 1.0
        return B

    cm = MPC(basis, [bnet(pt, off) for pt, off in zip(basis.patches,
                                                      offsets)])
    sp = EOS(3, cm)
    for patch, direction, side in clamps:
        dofs = basis.patch_side_dofs(patch, direction, side, n_layers=2)
        for i in range(3):
            sp.add_zero_dofs(i, dofs)
    kw = {} if pkg == "jax" else {"device": device}
    return psr(ES(sp, quad_degree=2 * p, nders=2, **kw))


# every outer side of the two-patch plate (the clamping of bench.py's
# two-patch point)
ALL_SIDES = ((0, 0, 0), (1, 0, 1), (0, 1, 0), (0, 1, 1), (1, 1, 0),
             (1, 1, 1))


def two_patch(pkg, nx, nay, nby, device="cpu", clamps=((0, 0, 0),)):
    """The two-patch plate of tests/test_newton_mp.py: A = [0,1]^2 with
    nx x nay elements, B = [1,2] x [0,1] with nx x nby, interface x = 1."""
    return multipatch_shell(pkg, [(nx, nay), (nx, nby)],
                            [(0.0, 0.0), (1.0, 0.0)], device, clamps=clamps)


def l_shell(pkg, nels, device="cpu"):
    """The three-patch L of tests/test_newton_mp.py::_l_shell."""
    return multipatch_shell(pkg, nels, [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0)],
                            device)


def shell_coupling(pkg, sp, pd, pr, which=0):
    """Interface 0: patch 0 (x = 1 side) to patch 1 (x = 0 side); interface
    1 (the L): patch 1 (y = 1) to patch 2 (y = 0)."""
    C = _mp_modules(pkg)[-1]
    if which == 0:
        return C(sp, 0, (0, 1), 1, (0, 0), penalty_disp=pd, penalty_rot=pr)
    return C(sp, 1, (1, 1), 2, (1, 0), penalty_disp=pd, penalty_rot=pr)


# the two-patch Newton setting of tests/test_newton_mp.py (nel=8): levels
# (16,16,20), (8,8,10), (4,4,5); E=1e7, h=0.05, q=0.05; pd, pr = 1e2 E h /
# h_el, 1e2 E h^3 / h_el; cg_iters=25, polish_cg_iters=40
MP_E, MP_H, MP_Q, MP_NEL = 1.0e7, 0.05, 0.05, 8
MP_PD = 1e2 * MP_E * MP_H * MP_NEL
MP_PR = 1e2 * MP_E * MP_H ** 3 * MP_NEL
MP_LEVELS = [(2 * MP_NEL, 2 * MP_NEL, 2 * MP_NEL + 4),
             (MP_NEL, MP_NEL, MP_NEL + 2),
             (MP_NEL // 2, MP_NEL // 2, MP_NEL // 2 + 1)]


def mp_density(pkg):
    """The shell adjoint density with the load q of the two-patch setting."""
    if pkg == "torch":
        from tigar_tpu_torch.models.shell import SVKShellAdjoint
        return SVKShellAdjoint(MP_E, NU, MP_H, load=(0.0, 0.0, -MP_Q))
    from tigar_tpu.models.shell import svk_shell_adjoint

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, MP_E, NU, MP_H)
        return F._replace(val=F.val.at[2].add(-MP_Q))
    return res_adj


def mp_solver(pkg, clamps=ALL_SIDES):
    """MultiPatchStencilNewton of either package in the two-patch setting
    (every outer side clamped by default, as bench.py's two-patch point)."""
    if pkg == "jax":
        from tigar_tpu.solvers.newton_stencil_mp import MultiPatchStencilNewton
    else:
        from tigar_tpu_torch.solvers.newton_stencil_mp import (
            MultiPatchStencilNewton)
    sps = [two_patch(pkg, *lv, clamps=clamps) for lv in MP_LEVELS]
    cps = [shell_coupling(pkg, s, MP_PD, MP_PR) for s in sps]
    return MultiPatchStencilNewton(sps[0], mp_density(pkg), cps[0],
                                   mg_splines=sps[1:], mg_couplings=cps[1:],
                                   cg_iters=25, polish_cg_iters=40)


def mp_smooth_state(ns):
    """Seeded coarsest-level coefficients of a port solver prolonged to its
    fine space, BC-masked (numpy)."""
    import torch
    U = torch.as_tensor(1e-3 * np.random.default_rng(3).normal(
        size=ns.mg_splines[-1].ndof))
    for P in reversed(ns._Ps):
        U = P.up(U)
    return (ns.mask64 * U).numpy()


# -- the scalar generic form path (tests/test_poisson.py, test_refinement.py) -


def scalar_spline(pkg, p, nel, lo=0.0, layers=1, nders=1, quad_degree=None):
    """Unit-square (or [lo, 1]^2) scalar spline, homogeneous Dirichlet on
    ``layers`` control-point layers of every side."""
    if pkg == "jax":
        import jax.numpy as xp  # noqa: F401
        from tigar_tpu.ops.knots import uniform_knots as knots
        from tigar_tpu.models.bspline import ExplicitBSplineControlMesh as Mesh
        from tigar_tpu.models.space import EqualOrderSpline as Space
        from tigar_tpu.models.extracted import ExtractedSpline as Spline
    else:
        from tigar_tpu_torch.ops.knots import uniform_knots as knots
        from tigar_tpu_torch.models.bspline import (
            ExplicitBSplineControlMesh as Mesh)
        from tigar_tpu_torch.models.space import EqualOrderSpline as Space
        from tigar_tpu_torch.models.extracted import ExtractedSpline as Spline
    cm = Mesh([p, p], [knots(p, lo, 1.0, nel)] * 2)
    sp = Space(1, cm)
    basis = sp.get_scalar_spline()
    for d in (0, 1):
        for s in (0, 1):
            sp.add_zero_dofs(0, basis.side_dofs(d, s, n_layers=layers))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    qd = 2 * p if quad_degree is None else quad_degree
    return Spline(sp, quad_degree=qd, nders=nders, **kw)


def scalar_forms(pkg):
    """Poisson (a, L), a nonlinear residual with params, a functional and
    the exact solution, as per-point densities of package ``pkg``."""
    if pkg == "jax":
        import jax.numpy as xp
    else:
        xp = torch

    def soln(x):
        return xp.sin(xp.pi * x[0]) * xp.sin(xp.pi * x[1])

    def a(ctx, u, v):
        return xp.sum(ctx.grad(u) * ctx.grad(v))

    def L(ctx, v):
        return 2.0 * xp.pi ** 2 * soln(ctx.x) * v.val

    def res(ctx, u, v, params):
        k = 1.0 + params["c"] * u.val ** 2
        return (k * xp.sum(ctx.grad(u) * ctx.grad(v))
                + params["s"] * u.val ** 3 * v.val
                - (1.0 + ctx.x[0]) * v.val)

    def energy(ctx, u):
        return 0.5 * xp.sum(ctx.grad(u) ** 2) + xp.cos(u.val) * ctx.x[1]

    return dict(soln=soln, a=a, L=L, res=res, energy=energy)
