"""Hand-written CUDA kernels of tigar_tpu_torch against their plain PyTorch
twins, on the card (K1-K3 on the nel=8 clamped SVK shell plate, K4 on
small 2D/3D sum-factorized operators; K3's patch mode, K2 on a patch's
element range and K5-K9 on the small two-patch plate and the three-patch
L of the CPU tests).  Every test skips without a CUDA device; run them on
a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances (relative to the largest entry of the twin's result): f64
1e-12; f32 1e-5, and 1e-4 on tangent stencils (f32 atomics add in a
nondeterministic order, and the stencil entries sum 4-36 element
contributions of mixed sign); 1e-6 on the f32 interface block apply (no
atomics, one dot product of m terms per row).
"""

import numpy as np
import pytest
import torch

from tigar_tpu_torch.ops.knots import uniform_knots
from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu_torch.models.space import EqualOrderSpline
from tigar_tpu_torch.models.extracted import ExtractedSpline
from tigar_tpu_torch.models.shell import (precompute_shell_reference,
                                          SVKShellAdjoint)
from tigar_tpu_torch.ops import cuda_ext
from tigar_tpu_torch.ops.assembly import residual_vector_adjoint_ref
from tigar_tpu_torch.ops.stencil import (build_stencil, build_stencil_ref,
                                         stencil_apply, stencil_apply_ref)
from tigar_tpu_torch.ops import sumfac
from tigar_tpu_torch.solvers.newton_stencil import StencilNewton

pytestmark = pytest.mark.cuda

E_mod, nu, h_th, q = 1.0e7, 0.3, 0.03, 100.0
DENSITY = SVKShellAdjoint(E_mod, nu, h_th, load=(0.0, 0.0, -q))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _build(nel, device, p=2):
    kvecs = [uniform_knots(p, -1.0, 1.0, nel)] * 2
    cm = ExplicitBSplineControlMesh([p, p], kvecs, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    basis = cm.scalar_basis()
    for side in (0, 1):
        for direction in (0, 1):
            dofs = basis.side_dofs(direction, side, n_layers=2)
            for i in range(3):
                sp.add_zero_dofs(i, dofs)
    return precompute_shell_reference(
        ExtractedSpline(sp, quad_degree=2 * p, nders=2, device=device))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _state(spline, seed=0, amp=0.1):
    g = torch.Generator().manual_seed(seed)
    U = amp * torch.randn(spline.ndof, generator=g, dtype=torch.float64)
    return U.to(spline.device)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_shell_residual_kernel(cuda, dtype, tol):
    spline = _build(8, cuda)
    asm = spline._assembler("dx").astype(dtype)
    U = _state(spline).to(dtype)
    r_k = asm.residual_vector_adjoint(DENSITY, U)
    r_t = residual_vector_adjoint_ref(asm, DENSITY, U)
    torch.cuda.synchronize()
    assert r_k.dtype == dtype and r_k.is_cuda
    assert _rel(r_k, r_t) <= tol


@pytest.mark.parametrize("quad_degree", [None, 2])
def test_tangent_stencil_kernel(cuda, quad_degree):
    spline = _build(8, cuda)
    asm = (spline._assembler("dx") if quad_degree is None
           else spline._assembler("dx", quad_degree=quad_degree))
    asm = asm.astype(torch.float32)
    basis = spline.space.fields[0]
    U = _state(spline, seed=1).to(torch.float32)
    S_k = build_stencil(asm, DENSITY, U, basis, 3).S
    S_t = build_stencil_ref(asm, DENSITY, U, basis, 3).S
    torch.cuda.synchronize()
    assert _rel(S_k, S_t) <= 1e-4


def test_tangent_stencil_kernel_f64(cuda):
    spline = _build(8, cuda)
    asm = spline._assembler("dx", quad_degree=2)
    basis = spline.space.fields[0]
    U = _state(spline, seed=2)
    S_k = build_stencil(asm, DENSITY, U, basis, 3).S
    S_t = build_stencil_ref(asm, DENSITY, U, basis, 3).S
    assert _rel(S_k, S_t) <= 1e-12


@pytest.mark.parametrize("nel", [8, 4])
@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_stencil_apply_kernel(cuda, nel, mode, dtype, tol):
    spline = _build(nel, cuda)
    asm = spline._assembler("dx").astype(dtype)
    U = _state(spline, seed=3, amp=0.05).to(dtype)
    st = build_stencil(asm, DENSITY, U, spline.space.fields[0], 3)
    g = torch.Generator().manual_seed(4)
    x, b = (torch.randn(spline.ndof, generator=g, dtype=torch.float64)
            .to(cuda, dtype) for _ in range(2))
    mask = spline.mask.to(dtype)
    d = mask * st.diagonal() + (1.0 - mask)
    dinv = 1.0 / d
    for m in (None, mask):
        args = dict(mask=m, b=b, dinv=dinv, omega=0.7, mode=mode)
        y_k = stencil_apply(st, x, **args)
        y_t = stencil_apply_ref(st, x, **args)
        assert _rel(y_k, y_t) <= tol, (m is None, _rel(y_k, y_t))


def test_main_path_runs_through_kernels(cuda):
    """One production step and one polish step launch every kernel."""
    spline = _build(8, cuda)
    ns = StencilNewton(spline, DENSITY, mg_splines=[_build(4, cuda)],
                       cg_iters=15, polish_tangent="cast",
                       build_quad_degree=2, rebuild_rel=0.1)
    cuda_ext.reset_counts()
    U = torch.zeros(spline.ndof, dtype=torch.float64, device=cuda)
    U1, rn, _ = ns.step(U)
    U2, rn64, _ = ns.polish_step(U1, rebuild=True)
    torch.cuda.synchronize()
    c = cuda_ext.counts()
    assert c["shell_residual"] == 2 and c["tangent_stencil"] == 2
    assert c["stencil_apply"] > 100
    assert np.isfinite(float(rn)) and np.isfinite(float(rn64))
    assert float(torch.linalg.norm(U2)) > 0.0


# K4 cases: (dim, p, nel, periodic directions), at the CPU tests' sizes
SUMFAC_CASES = {
    "3d_open_p2": (3, 2, 4, (False,) * 3),
    "2d_open_p3": (2, 3, 5, (False,) * 2),
    "2d_periodic_tf_p3": (2, 3, 5, (True, False)),
    "3d_periodic_p2": (3, 2, 4, (True,) * 3),
}


def _sumfac_data(name, cuda, dtype, metric):
    """Sum-factorization tables of a case, with a seeded SPD metric G and
    mass weight Gm when ``metric``."""
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    dim, p, nel, per = SUMFAC_CASES[name]
    basis = TensorBSplineBasis([p] * dim, [uniform_knots(p, 0.0, 1.0, nel,
                                                         periodic=q)
                                           for q in per])
    data = sumfac.build_sumfac_data(basis, None, 2 * p, cuda, dtype)
    if metric:
        rng = np.random.default_rng(5)
        npt = (p + 1) ** dim
        A = rng.normal(size=(basis.nel, npt, dim, dim))
        G = A @ np.swapaxes(A, -1, -2) + dim * np.eye(dim)
        data.G = torch.as_tensor(G, dtype=dtype, device=cuda)
        data.Gm = torch.as_tensor(rng.uniform(0.5, 1.5, (basis.nel, npt)),
                                  dtype=dtype, device=cuda)
    mask = np.ones(basis.ncp)
    if not per[0]:
        mask[basis.side_dofs(0, 0)] = 0.0
    return data, torch.as_tensor(mask, dtype=dtype, device=cuda)


@pytest.mark.parametrize("metric", [False, True], ids=["identity", "metric"])
@pytest.mark.parametrize("name", list(SUMFAC_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_sumfac_apply_kernel(cuda, name, metric, dtype, tol):
    data, mask = _sumfac_data(name, cuda, dtype, metric)
    W = torch.as_tensor(np.random.default_rng(6).normal(size=data.ndof),
                        dtype=dtype, device=cuda)
    for m in (None, mask):
        n0 = cuda_ext.counts()["sumfac_apply"]
        r_k = sumfac.sumfac_apply(data, W, 1.0, 0.7, m)
        r_t = sumfac.sumfac_apply_ref(data, W, 1.0, 0.7, m)
        torch.cuda.synchronize()
        assert cuda_ext.counts()["sumfac_apply"] == n0 + 1
        assert r_k.dtype == dtype and r_k.is_cuda
        assert _rel(r_k, r_t) <= tol, (m is None, _rel(r_k, r_t))


def test_sumfac_kernel_refuses_what_it_cannot_take(cuda):
    data, _ = _sumfac_data("3d_open_p2", cuda, torch.float64, False)
    W = torch.zeros(data.ndof, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        sumfac.sumfac_apply(data, W.to(torch.float16), 1.0, 0.0)
    with pytest.raises(ValueError):
        sumfac.sumfac_apply(data, torch.zeros(2 * data.ndof,
                                              device=cuda)[::2], 1.0, 0.0)
    data.degrees = (4, 4, 4)
    with pytest.raises(ValueError):
        sumfac.sumfac_apply(data, W, 1.0, 0.0)


# -- the two-patch path: K3 patch mode, per-patch K2, K5, K6, K7 --------------

MP_PD, MP_PR = 1e2 * E_mod * h_th * 8, 1e2 * E_mod * h_th ** 3 * 8


def _two_patch(cuda, dims=(4, 4, 6)):
    from torch_parity import ALL_SIDES, shell_coupling, two_patch
    sp = two_patch("torch", *dims, device=cuda, clamps=ALL_SIDES)
    return sp, shell_coupling("torch", sp, MP_PD, MP_PR)


def _mp_solver(cuda):
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        MultiPatchStencilNewton)
    (sp, cp), (sc, cc) = _two_patch(cuda, (8, 8, 12)), _two_patch(cuda)
    return MultiPatchStencilNewton(sp, DENSITY, cp, mg_splines=[sc],
                                   mg_couplings=[cc], cg_iters=15,
                                   polish_cg_iters=20, build_quad_degree=2,
                                   rebuild_rel=0.1)


@pytest.mark.parametrize("what", ["residual", "tangent_block"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_shell_interface_kernels(cuda, what, dtype, tol):
    from tigar_tpu_torch.interface import (iform_residual_ref,
                                           iform_tangent_block_ref)
    sp, cp = _two_patch(cuda)
    cp = cp.astype(dtype)
    U = _state(sp, seed=7, amp=0.01).to(dtype)
    name = {"residual": "shell_iface_residual",
            "tangent_block": "shell_iface_tangent"}[what]
    n0 = cuda_ext.counts()[name]
    if what == "residual":
        y_k, y_t = cp.residual(U), iform_residual_ref(cp, U)
    else:
        idx, pa, pb = cp.support_positions()
        y_k = cp.tangent_block(U)[1]
        y_t = iform_tangent_block_ref(cp, U[idx.long()], pa, pb, cp.params)
    torch.cuda.synchronize()
    assert cuda_ext.counts()[name] == n0 + 1
    assert y_k.dtype == dtype and y_k.is_cuda
    assert _rel(y_k, y_t) <= tol


def _iface_blocks(cuda, dtype, nblocks):
    """Dense blocks of one (two-patch) or two interfaces (the L, whose
    supports share corner DoFs) at a seeded state."""
    from torch_parity import l_shell, shell_coupling
    if nblocks == 1:
        sp, cp = _two_patch(cuda)
        cps = [cp]
    else:
        sp = l_shell("torch", ((4, 6), (5, 7), (6, 4)), device=cuda)
        cps = [shell_coupling("torch", sp, MP_PD, MP_PR, w) for w in (0, 1)]
    U = _state(sp, seed=8, amp=0.01)
    blocks = []
    for c in cps:
        idx = c.support_positions()[0]
        blocks.append((c.tangent_block(U)[1].to(dtype), idx))
    return sp, blocks


@pytest.mark.parametrize("nblocks", [1, 2])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_iface_block_kernel(cuda, nblocks, dtype, tol):
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        iface_block_apply, iface_block_apply_ref)
    sp, blocks = _iface_blocks(cuda, dtype, nblocks)
    g = torch.Generator().manual_seed(9)
    v, out = (torch.randn(sp.ndof, generator=g, dtype=torch.float64)
              .to(cuda, dtype) for _ in range(2))
    mask = sp.mask.to(dtype)
    for m in (None, mask):
        for alpha in (1.0, -1.0):
            y_k, y_t = out.clone(), out.clone()
            for B, idx in blocks:
                iface_block_apply(B, idx, v, y_k, m, alpha)
                iface_block_apply_ref(B, idx, v, y_t, m, alpha)
            torch.cuda.synchronize()
            assert _rel(y_k - out, y_t - out) <= tol


@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_stencil_apply_patch_mode(cuda, mode, dtype, tol):
    """K3 reading and writing one patch in place of the field-major
    multi-patch vector, against the copy-out/copy-back plain version."""
    ns = _mp_solver(cuda)
    op = ns._build(ns.asm_b32, _state(ns.spline, seed=10,
                                      amp=0.01).float()).astype(dtype)
    g = torch.Generator().manual_seed(11)
    x, b, dinv = (torch.randn(op.ndof, generator=g, dtype=torch.float64)
                  .to(cuda, dtype) for _ in range(3))
    mask = ns.mask64.to(dtype)
    for p, st in enumerate(op.sts):
        kw = dict(mask=mask, b=b, dinv=dinv, omega=0.7, mode=mode,
                  base=op.doffsets[p], fstride=op.doffsets[-1])
        y_k = stencil_apply(st, x, out=torch.zeros_like(x), **kw)
        y_t = stencil_apply_ref(st, x, out=torch.zeros_like(x), **kw)
        assert _rel(y_k, y_t) <= tol
    with pytest.raises(ValueError):
        stencil_apply(op.sts[0], x, mode="apply", out=x,
                      base=0, fstride=op.doffsets[-1])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_tangent_stencil_patch_range(cuda, dtype, tol):
    """K2 on one patch's element range of the concatenated assembler."""
    sp, _ = _two_patch(cuda, (8, 8, 12))
    asm = sp._assembler("dx", quad_degree=2).astype(dtype)
    U = _state(sp, seed=12, amp=0.01).to(dtype)
    e0 = 0
    for pt in sp.space.fields[0].patches:
        sub = asm.elements(e0, e0 + pt.nel)
        S_k = build_stencil(sub, DENSITY, U, pt, 3).S
        S_t = build_stencil_ref(sub, DENSITY, U, pt, 3).S
        assert _rel(S_k, S_t) <= tol
        e0 += pt.nel


def test_multipatch_path_runs_through_kernels(cuda):
    """One production step and one polish step of the two-patch solver
    launch K1, K2, K3, K5, K6 and K7."""
    ns = _mp_solver(cuda)
    cuda_ext.reset_counts()
    U = torch.zeros(ns.spline.ndof, dtype=torch.float64, device=cuda)
    U1, rn, _ = ns.step(U)
    U2, rn64, _ = ns.polish_step(U1, rebuild=True)
    torch.cuda.synchronize()
    c = cuda_ext.counts()
    for k in ("shell_residual", "tangent_stencil", "stencil_apply",
              "iface_block", "shell_iface_residual", "shell_iface_tangent"):
        assert c[k] > 0, (k, c)
    assert np.isfinite(float(rn)) and np.isfinite(float(rn64))


def test_interface_kernels_refuse_what_they_cannot_take(cuda):
    from tigar_tpu_torch.coupling import PenaltyInterfaceCoupling
    sp, cp = _two_patch(cuda)
    U = torch.zeros(sp.ndof, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        cp.residual(U.float())                  # f64 form, f32 state
    with pytest.raises(ValueError):
        cp.residual(U[:-1])
    pen = PenaltyInterfaceCoupling(sp, 0, (0, 1), 1, (0, 0), penalty=1e3)
    with pytest.raises(NotImplementedError, match="_penalty_density"):
        pen.residual(U)
    with pytest.raises(NotImplementedError, match="_penalty_density"):
        pen.tangent_block(U)


# -- the consistent (Nitsche) coupling: K8, K9 ---------------------------------


def _nitsche(sp, nx, weights=(0.5, 0.5), energy=None, w_order=2):
    """bench.py's Nitsche coupling of the SVK energy on a level with nx
    elements across (``energy`` replaces the density)."""
    from tigar_tpu_torch.interface import EnergyNitscheCoupling
    from tigar_tpu_torch.models.shell import svk_shell_energy
    D, h = E_mod * h_th ** 3 / 12.0 / (1 - nu ** 2), 1.0 / nx
    return EnergyNitscheCoupling(
        sp, 0, (0, 1), 1, (0, 0), energy or svk_shell_energy,
        beta_d=10.0 * (D / h ** 3 + E_mod * h_th / h), beta_r=10.0 * D / h,
        w_order=w_order, weights=weights,
        params={"E": E_mod, "nu": nu, "h": h_th})


@pytest.mark.parametrize("weights", [(0.5, 0.5), (1.0, 0.0)],
                         ids=["symmetric", "one-sided"])
@pytest.mark.parametrize("what", ["residual", "tangent_block"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_nitsche_interface_kernels(cuda, what, dtype, tol, weights):
    """K8/K9 against the plain versions (torch.func grad / hessian of the
    Nitsche density) at a seeded state of the small two-patch plate."""
    from tigar_tpu_torch.interface import (iform_residual_ref,
                                           iform_tangent_block_ref)
    sp, _ = _two_patch(cuda)
    cp = _nitsche(sp, 4, weights).astype(dtype)
    U = _state(sp, seed=8, amp=0.01).to(dtype)
    name = {"residual": "nitsche_iface_residual",
            "tangent_block": "nitsche_iface_tangent"}[what]
    n0 = cuda_ext.counts()[name]
    if what == "residual":
        y_k, y_t = cp.residual(U), iform_residual_ref(cp, U)
    else:
        idx, pa, pb = cp.support_positions()
        y_k = cp.tangent_block(U)[1]
        y_t = iform_tangent_block_ref(cp, U[idx.long()], pa, pb, cp.params)
    torch.cuda.synchronize()
    assert cuda_ext.counts()[name] == n0 + 1
    assert y_k.dtype == dtype and y_k.is_cuda
    assert _rel(y_k, y_t) <= tol


def test_nitsche_path_runs_through_kernels(cuda):
    """One production step and one polish step of the two-patch solver
    with Nitsche couplings launch K1, K2, K3, K5, K8 and K9."""
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        MultiPatchStencilNewton)
    (sp, _), (sc, _) = _two_patch(cuda, (8, 8, 12)), _two_patch(cuda)
    ns = MultiPatchStencilNewton(sp, DENSITY, _nitsche(sp, 8),
                                 mg_splines=[sc], mg_couplings=[
                                     _nitsche(sc, 4)],
                                 cg_iters=15, polish_cg_iters=20,
                                 polish_tangent="f64", build_quad_degree=2,
                                 rebuild_rel=0.1)
    cuda_ext.reset_counts()
    U = torch.zeros(sp.ndof, dtype=torch.float64, device=cuda)
    U1, rn, _ = ns.step(U)
    U2, rn64, _ = ns.polish_step(U1, rebuild=True)
    torch.cuda.synchronize()
    c = cuda_ext.counts()
    for k in ("shell_residual", "tangent_stencil", "stencil_apply",
              "iface_block", "nitsche_iface_residual",
              "nitsche_iface_tangent"):
        assert c[k] > 0, (k, c)
    assert np.isfinite(float(rn)) and np.isfinite(float(rn64))


def test_nitsche_kernels_refuse_other_densities(cuda):
    """A Nitsche form whose density K8/K9 do not evaluate raises on the
    card (no fallback), as does a state of another type."""
    from tigar_tpu_torch.models.shell import svk_shell_energy
    sp, _ = _two_patch(cuda)
    U = torch.zeros(sp.ndof, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="w_order=1"):
        _nitsche(sp, 4, w_order=1).residual(U)
    user = _nitsche(sp, 4, energy=lambda ctx, u, p: svk_shell_energy(
        ctx, u, p))
    with pytest.raises(NotImplementedError, match="lambda"):
        user.tangent_block(U)
    with pytest.raises(TypeError):
        _nitsche(sp, 4).residual(U.float())
