"""Hand-written CUDA kernels of tigar_tpu_torch against their plain PyTorch
twins, on the card (K1-K3 on the nel=8 clamped SVK shell plate, K4 on
small 2D/3D sum-factorized operators; K3's patch mode, K2 on a patch's
element range and K5-K9 on the small two-patch plate and the three-patch
L of the CPU tests; K3 also on the grids of the shell's V-cycle levels
and on two-patch plates up to 64 x 96 elements; K2's element mode, K10
and K11, and the SANewton path through them, on the nel=8 plate; K1, K2's
element mode and K10 at 48 local functions (9 and 16 points) on the small
star T-spline and a ragged extraction, the symmetry of the element
matrices K10 takes as symmetric, and the star's SANewton solve through
them; K12 on small 2D/3D Poisson splines and
the two-level SA cycle through K11, with the generic form path's
refinement and sa_cg solves through them; K13/K14 on contact strips of
36, 1,024 and 1,089 points, and the reef-knot demo's step at NEL=6
through them; K15/K16 on the sum-factorized jets of the shell's fields
and control net, a strided 3D field, a periodic field, an RT pair, a 3D
Hessian field of mixed degrees and a p=3 field of 40 elements a row, and
the sumfac shell residual and tangent action through them; one refused
call per binding check site, which must raise).  Every test skips
without a CUDA device; run them on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances (relative to the largest entry of the twin's result): f64
1e-12; f32 1e-5, and 1e-4 on tangent stencils (f32 atomics add in a
nondeterministic order, and the stencil entries sum 4-36 element
contributions of mixed sign); 1e-6 on the f32 interface block apply (no
atomics, one dot product of m terms per row); K12 (f32 only) 1e-6, and
2e-6 against the f64 AD tangent action (tests/test_fastpath.py); K13/K14
f64 1e-12, f32 1e-5 (no atomics: each row is one warp's sum); K15/K16
f64 1e-12, f32 1e-5 (no atomics, another sum order than the plain
chains).  K10 reads E's upper triangle for both halves, so it differs from
the full-E plain version by E's asymmetry as well: measured on the card
at 1.0e-15 (f64) and 6.7e-7 (f32) of max |E| (PERF.md), far inside
its 1e-12 / 1e-5; E_ASYM_TOL bounds that asymmetry.
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
# max |E - E^T| / max |E| allowed of the element matrices K10 takes as
# symmetric (PERF.md: measured on the card at both SANewton paths)
E_ASYM_TOL = {"f64": 1e-13, "f32": 1e-5}


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


@pytest.mark.parametrize("nel", [8, 4, 16, 32, 64])
@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_stencil_apply_kernel(cuda, nel, mode, dtype, tol):
    """K3 on the grids of the shell's V-cycle levels (nel 64, 32, 16: 66^2,
    34^2, 18^2) and two smaller ones, every mode, with and without the BC
    mask."""
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


def _mp_solver(cuda, dims=(8, 8, 12)):
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        MultiPatchStencilNewton)
    (sp, cp), (sc, cc) = (_two_patch(cuda, dims),
                          _two_patch(cuda, tuple(d // 2 for d in dims)))
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


@pytest.mark.parametrize("offset", [False, True],
                         ids=["aligned", "offset"])
@pytest.mark.parametrize("m", [37, 1001, 12301])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_iface_block_kernel_sizes(cuda, m, offset, dtype, tol):
    """K5 on seeded blocks: m = 37 (rows split over several warps), 1,001
    (not a multiple of the vector width: scalar edges, unaligned rows) and
    12,301 (the gathered vector above 48 KB of shared memory in either
    type); B contiguous at its storage's start or one element after it
    (every row unaligned), with and without a mask, alpha = +1 and -1."""
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        iface_block_apply, iface_block_apply_ref)
    rng = np.random.default_rng(m)
    n = 3 * m
    store = torch.as_tensor(rng.normal(size=m * m + 1), dtype=dtype,
                            device=cuda)
    B = (store[1:] if offset else store[:-1]).view(m, m)
    assert B.is_contiguous()
    idx = torch.as_tensor(np.sort(rng.choice(n, m, replace=False)),
                          dtype=torch.int32, device=cuda)
    v, out = (torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda)
              for _ in range(2))
    mask = torch.as_tensor(rng.random(n) < 0.9, dtype=dtype, device=cuda)
    for mk in (None, mask):
        for alpha in (1.0, -1.0):
            y_k, y_t = out.clone(), out.clone()
            iface_block_apply(B, idx, v, y_k, mk, alpha)
            iface_block_apply_ref(B, idx, v, y_t, mk, alpha)
            torch.cuda.synchronize()
            assert _rel(y_k - out, y_t - out) <= tol


@pytest.mark.parametrize("nel", [8, 16, 32, 64])
@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_stencil_apply_patch_mode(cuda, nel, mode, dtype, tol):
    """K3 reading and writing one patch in place of the field-major
    multi-patch vector, against the copy-out/copy-back plain version, on
    two-patch plates of nel x nel and nel x 3 nel / 2 elements (patch
    grids up to 66 x 98)."""
    ns = _mp_solver(cuda, (nel, nel, nel + nel // 2))
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


def test_nitsche_tangent_refuses_another_levels_positions(cuda):
    """K9 given the support positions of another interface raises in the
    wrapper (the binding's own shape check ended the process instead)."""
    (sp, _), (sc, _) = _two_patch(cuda, (8, 8, 12)), _two_patch(cuda)
    fine, coarse = _nitsche(sp, 8), _nitsche(sc, 4)
    idx, pa, pb = fine.support_positions()
    _, pa_c, pb_c = coarse.support_positions()
    U = torch.zeros(sp.ndof, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="positions"):
        fine.tangent_block_cuda(U[idx.long()], pa_c, pb_c, fine.params)


# -- K2's element mode, K10 and K11: the space-agnostic Newton tier --------


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_tangent_elements_kernel(cuda, masked, dtype, tol):
    from tigar_tpu_torch.ops.assembly import element_matrices_adjoint_ref
    spline = _build(8, cuda)
    asm = spline._assembler("dx").astype(dtype)
    U = _state(spline, amp=0.01).to(dtype)
    me = spline.mask.to(dtype)[asm.cat_conn] if masked else None
    cuda_ext.reset_counts()
    E_k = asm.element_matrices_adjoint(DENSITY, U, me=me)
    assert cuda_ext.counts()["tangent_elements"] == 1
    E_t = element_matrices_adjoint_ref(asm, DENSITY, U, me)
    torch.cuda.synchronize()
    assert E_k.shape == (asm.nel, 27, 27) and E_k.dtype == dtype
    assert _rel(E_k, E_t) <= tol


def _elem_spline(cuda, case):
    """The spline, shell assembler, density and element BC mask (times the
    padding mask of ragged elements) of a SANewton path: the nel=8 plate
    (27 local functions), the star T-spline of make_star_extraction(3, 4)
    or the ragged extraction of tests/test_tsplines.py:144 (48)."""
    if case == "plate":
        spline = _build(8, cuda)
        asm = spline._assembler("dx")
        return spline, asm, DENSITY, spline.mask[asm.cat_conn]
    spline, asm = _tspline_asm(case, cuda)
    me = spline.mask[asm.cat_conn] * asm.masks[0].repeat(1, 3)
    return spline, asm, TS_DENSITY, me


def _elem_case(cuda, dtype, case="plate"):
    from tigar_tpu_torch.ops.assembly import element_matrices_adjoint_ref
    spline, asm, dens, me = _elem_spline(cuda, case)
    E = element_matrices_adjoint_ref(asm, dens, _state(spline, amp=0.01), me)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(spline.ndof, generator=g, dtype=torch.float64)
    return (asm.cat_conn.contiguous(), E.to(dtype), x.to(cuda, dtype),
            spline.mask.to(dtype))


@pytest.mark.parametrize("case", ["plate", "star", "ragged"])
@pytest.mark.parametrize("what", ["apply", "masked", "diagonal"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_elem_tangent_kernel(cuda, case, what, dtype, tol):
    """K10 (which reads E's upper triangle) against the full-E plain
    version at 27 and 48 local functions, padded elements included."""
    from tigar_tpu_torch.ops import sparse
    conn, E, x, m = _elem_case(cuda, dtype, case)
    cuda_ext.reset_counts()
    if what == "diagonal":
        y_k = sparse.elem_tangent_diagonal(conn, E, x.numel())
        y_t = sparse.elem_tangent_diagonal_ref(conn, E, x.numel())
        name = "elem_tangent_diagonal"
    else:
        mask = m if what == "masked" else None
        y_k = sparse.elem_tangent_apply(conn, E, x, mask)
        y_t = sparse.elem_tangent_apply_ref(conn, E, x, mask)
        name = "elem_tangent_apply"
    torch.cuda.synchronize()
    assert cuda_ext.counts()[name] == 1
    assert y_k.dtype == dtype and _rel(y_k, y_t) <= tol


@pytest.mark.parametrize("case", ["plate", "star", "ragged"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, E_ASYM_TOL["f64"]),
                                       (torch.float32, E_ASYM_TOL["f32"])])
def test_elem_tangents_are_symmetric(cuda, case, dtype, tol):
    """The premise of K10's upper-triangle read: the element matrices that
    K2's element mode builds for the SANewton paths are symmetric up to
    rounding, max |E - E^T| <= tol max |E|."""
    spline, asm, dens, me = _elem_spline(cuda, case)
    E = asm.astype(dtype).element_matrices_adjoint(
        dens, _state(spline, amp=0.01).to(dtype), me=me.to(dtype))
    torch.cuda.synchronize()
    assert float((E - E.transpose(1, 2)).abs().max()
                 / E.abs().max()) <= tol


def _sa_hierarchy(cuda, fine=False):
    """The multilevel SA hierarchy of the nel=8 plate's BC'd f32 tangent
    (coarse_size 50: three levels, linear near-kernel)."""
    from tigar_tpu_torch.solvers.newton_sa import SANewton
    ns = SANewton(_build(8, cuda), DENSITY, sa_kwargs={"coarse_size": 50})
    st = ns._build(ns.asm32, _state(ns.spline, amp=0.01).float())
    sa = ns._ensure_sa(st)
    if not fine:
        from tigar_tpu_torch.solvers.aggregation import level_ops
        sa._fine = None
        sa._ops = level_ops(sa._levels, sa._coarse_inv.shape[0])
    return ns, sa


ELL_MODES = ["apply", "residual", "jacobi", "jacobi0", "add"]


def _ell_case(op, om, mode, dtype, g, cuda):
    """(x, b, om_dinv) of one K11 call in ``mode`` on the card."""
    x, b = (torch.randn(k, generator=g, dtype=torch.float64).to(cuda, dtype)
            for k in (op.ncols, op.n))
    return ((None if mode == "jacobi0" else x), b,
            om.to(dtype) if mode in ("jacobi", "jacobi0") else None)


@pytest.mark.parametrize("mode", ELL_MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_ell_spmv_kernel(cuda, mode, dtype, tol):
    """K11 on the sliced layouts of every level's A, P and Pt (the square
    modes on A) against the carried arrays' plain version and the sliced
    layout's, one launch a call, tallied by op."""
    from tigar_tpu_torch.ops import sparse
    _, sa = _sa_hierarchy(cuda)
    g = torch.Generator().manual_seed(3)
    for ops, lv in zip(sa._ops, sa._levels):
        for op in ops:
            if mode in ("jacobi", "jacobi0") and op is not ops[0]:
                continue
            if dtype == torch.float64:
                op = sparse.EllOperator(op.cols, op.vals.double(), op.ncols,
                                        op.key)
            x, b, om = _ell_case(op, lv.om_dinv, mode, dtype, g, cuda)
            cuda_ext.reset_counts()
            y_k = op(x, b, om, mode)
            y_t = sparse.ell_spmv_ref(op.cols, op.vals, x, b, om, mode)
            y_s = sparse.sliced_ell_ref(op.card, x, b, om, mode)
            torch.cuda.synchronize()
            assert cuda_ext.counts()["ell_spmv"] == 1
            assert cuda_ext.counts_by("ell_spmv") == {(op.key, mode): 1}
            assert y_k.shape == (op.n,) and _rel(y_k, y_t) <= tol
            assert _rel(y_s, y_t) <= tol


def _ell_arrays(n, ncols, K, g, cuda, ragged=False):
    """Carried ELL arrays [n, K] with sorted distinct columns per row,
    every row K long, or (``ragged``) rows of 0..K entries."""
    cols = torch.argsort(torch.rand(n, ncols, generator=g), dim=1)[:, :K]
    cols = torch.sort(cols, dim=1).values.to(torch.int32)
    vals = torch.randn(n, K, generator=g, dtype=torch.float64)
    if ragged:
        keep = torch.arange(K)[None, :] < torch.randint(0, K + 1, (n, 1),
                                                        generator=g)
        cols = torch.where(keep, cols, 0).to(torch.int32)
        vals = torch.where(keep, vals, 0.0)
    return cols.to(cuda).contiguous(), vals.to(cuda).contiguous()


@pytest.mark.parametrize("K", [1, 25, 81, 324, "ragged Pt"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_ell_kernel_widths(cuda, K, dtype, tol):
    """K11 at the widths of the SA levels (1, 25, 81, 324 slots: 4, 4, 8
    and 32 lanes a row) and on a ragged transpose-like operator (rows of
    0-147 entries), in every mode (the square ones where it is square),
    against both plain versions."""
    from tigar_tpu_torch.ops import sparse
    g = torch.Generator().manual_seed(13)
    if K == "ragged Pt":
        n, ncols, cols, vals = 301, 1200, *_ell_arrays(301, 1200, 147, g,
                                                       cuda, ragged=True)
    else:
        n = ncols = 1000
        cols, vals = _ell_arrays(n, ncols, K, g, cuda)
    op = sparse.EllOperator(cols, vals.to(dtype), ncols)
    assert int(op.card.width.max()) % 4 == 0
    om = torch.rand(n, generator=g, dtype=torch.float64).to(cuda)
    for mode in ELL_MODES:
        if mode in ("jacobi", "jacobi0") and n != ncols:
            continue
        x, b, omd = _ell_case(op, om, mode, dtype, g, cuda)
        y_k = op(x, b, omd, mode)
        y_t = sparse.ell_spmv_ref(op.cols, op.vals, x, b, omd, mode)
        y_s = sparse.sliced_ell_ref(op.card, x, b, omd, mode)
        torch.cuda.synchronize()
        assert _rel(y_k, y_t) <= tol and _rel(y_s, y_t) <= tol, mode


def test_sa_cycle_runs_through_kernels(cuda):
    """One V-cycle with the f32 fine tangent: K10 on level 0, K11 below.
    The card's cycle and the plain versions' on the CPU are both held to
    the same cycle in f64 (on the CPU): an f32 cycle amplifies rounding,
    and over 240 random inputs both sat up to 2e-5 from it (K10's atomics
    alone move the card's result 1.5e-5 from run to run), so the bound is
    1e-4; each kernel is held to 1e-5 on its own above."""
    from tigar_tpu_torch.solvers.aggregation import (MultilevelSA, SALevel,
                                                     _mlsa_apply, level_ops)
    from tigar_tpu_torch.solvers.newton_sa import ElemTangent
    ns, sa = _sa_hierarchy(cuda, fine=True)
    fop, fmask = sa._fine
    levels = [SALevel(*(t.cpu() for t in lv)) for lv in sa._levels]
    fine = ElemTangent(fop.conn.cpu(), fop.E.cpu(), fop.ndof)
    cpu = MultilevelSA(levels, sa._coarse_inv.cpu(), sa._ndof, sa._n_smooth,
                       fine_op=fine, fine_mask=fmask.cpu())
    r = ns.mask32 * torch.randn(ns.spline.ndof, device=cuda)
    cuda_ext.reset_counts()
    z = sa(r)
    torch.cuda.synchronize()
    c = cuda_ext.counts()
    assert c["elem_tangent_apply"] > 0 and c["ell_spmv"] > 0, c
    lv64 = [SALevel(*(t.double() if t.is_floating_point() else t
                      for t in lv)) for lv in levels]
    z64 = _mlsa_apply(
        lv64, sa._coarse_inv.cpu().double(),
        (ElemTangent(fine.conn, fine.E.double(), fine.ndof),
         fmask.cpu().double()), r.cpu().double(), sa._n_smooth, 1,
        level_ops(lv64, sa._coarse_inv.shape[0], fine=True))
    err_card, err_cpu = _rel(z.cpu().double(), z64), _rel(cpu(r.cpu()), z64)
    assert err_card <= 1e-4 and err_cpu <= 1e-4, (err_card, err_cpu)


def test_sa_newton_path_runs_through_kernels(cuda):
    """SANewton's production and polish steps on the nel=8 plate launch
    K1, K2's element mode, K10 and K11, and the solve matches the CPU
    plain versions."""
    from tigar_tpu_torch.solvers.newton_sa import SANewton
    opts = dict(cg_iters=60, polish_cg_iters=80,
                sa_kwargs={"coarse_size": 100})
    ns = SANewton(_build(8, cuda), DENSITY, **opts)
    cuda_ext.reset_counts()
    U, rel64, nit, _ = ns.solve(rtol=1e-9)
    torch.cuda.synchronize()
    c = cuda_ext.counts()
    for k in ("shell_residual", "tangent_elements", "elem_tangent_apply",
              "ell_spmv"):
        assert c[k] > 0, (k, c)
    assert c["tangent_stencil"] == 0 and c["stencil_apply"] == 0
    ns_c = SANewton(_build(8, "cpu"), DENSITY, **opts)
    Uc, relc, itc, _ = ns_c.solve(rtol=1e-9)
    assert rel64 < 1e-9 and abs(nit - itc) <= 1
    assert _rel(U.cpu(), Uc) <= 1e-8


def test_sa_kernels_refuse_what_they_cannot_take(cuda):
    """A CUDA tensor of a shape or type the kernels do not take raises;
    nothing falls back to the plain versions."""
    from tigar_tpu_torch.ops import sparse
    conn, E, x, m = _elem_case(cuda, torch.float64)
    with pytest.raises(TypeError):
        sparse.elem_tangent_apply(conn, E, x.float())
    with pytest.raises(ValueError, match="do not match"):
        sparse.elem_tangent_apply(conn.long(), E, x)
    big = torch.zeros((1, 65), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="64"):
        sparse.elem_tangent_apply(big, torch.zeros((1, 65, 65), device=cuda,
                                                   dtype=torch.float64), x)
    cols = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    vals = torch.zeros((4, 3), device=cuda)
    op = sparse.EllOperator(cols, vals, 4)
    with pytest.raises(RuntimeError, match="needs b"):
        op(torch.zeros(4, device=cuda), mode="residual")
    with pytest.raises(ValueError, match="do not match"):
        sparse.EllOperator(cols, vals[:, :2].contiguous(), 4)
    with pytest.raises(ValueError, match="leave the"):
        sparse.EllOperator(cols + 5, vals, 4)
    with pytest.raises(RuntimeError, match="has shape"):
        op(torch.zeros(5, device=cuda))
    with pytest.raises(ValueError, match="unknown ELL mode"):
        op(torch.zeros(4, device=cuda), mode="sweep")
    spline = _build(8, cuda)
    asm = spline._assembler("dx")
    with pytest.raises(ValueError, match="me must be"):
        asm.element_matrices_adjoint(DENSITY, _state(spline),
                                     me=torch.ones((2, 27), device=cuda,
                                                   dtype=torch.float64))


# -- K1 and K2's element mode at bicubic extraction elements (T-splines) ----


def _tspline_asm(case, device, quad_degree=None):
    """The shell assembler of a T-spline case: the star of
    make_star_extraction(3, 4) (every element 16 functions, a mask of
    ones), the same with the mask dropped, or the ragged file of
    tests/test_tsplines.py:144 (padded elements)."""
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    sp = (demo.ragged_spline(device) if case == "ragged"
          else demo.star_spline(4, device))
    asm = sp._assembler("dx", quad_degree=quad_degree)
    if case == "star-unmasked":
        asm = asm._map_tensors(lambda x: x)
        asm.masks = [None] * 3
    return sp, asm


TS_CASES = ["star", "star-unmasked", "ragged"]
TS_DENSITY = SVKShellAdjoint(3.0e4, 0.3, 0.03, load=(0.0, 0.0, -0.4))


@pytest.mark.parametrize("case", TS_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_shell_residual_kernel_bicubic(cuda, case, dtype, tol):
    sp, asm = _tspline_asm(case, cuda)
    asm = asm.astype(dtype)
    assert asm.nens == (16, 16, 16) and asm.nq == 16
    U = _state(sp, amp=0.01).to(dtype)
    cuda_ext.reset_counts()
    r_k = asm.residual_vector_adjoint(TS_DENSITY, U)
    assert cuda_ext.counts()["shell_residual"] == 1
    r_t = residual_vector_adjoint_ref(asm, TS_DENSITY, U)
    torch.cuda.synchronize()
    assert _rel(r_k, r_t) <= tol


@pytest.mark.parametrize("case", TS_CASES)
@pytest.mark.parametrize("quad_degree", [4, None], ids=["nq9", "nq16"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_tangent_elements_kernel_bicubic(cuda, case, quad_degree, dtype,
                                         tol):
    from tigar_tpu_torch.ops.assembly import element_matrices_adjoint_ref
    sp, asm = _tspline_asm(case, cuda, quad_degree)
    asm = asm.astype(dtype)
    U = _state(sp, amp=0.01).to(dtype)
    me = sp.mask.to(dtype)[asm.cat_conn]
    if asm.masks[0] is not None:
        me = me * asm.masks[0].repeat(1, 3)
    cuda_ext.reset_counts()
    E_k = asm.element_matrices_adjoint(TS_DENSITY, U, me=me)
    assert cuda_ext.counts()["tangent_elements"] == 1
    E_t = element_matrices_adjoint_ref(asm, TS_DENSITY, U, me)
    torch.cuda.synchronize()
    assert E_k.shape == (asm.nel, 48, 48) and E_k.dtype == dtype
    assert _rel(E_k, E_t) <= tol
    if case == "ragged":
        assert float(E_k[asm.masks[0].repeat(1, 3) == 0].abs().max()) == 0.0


def test_tspline_kernels_refuse_what_they_cannot_take(cuda):
    """The stencil fold refuses bicubic elements; K2's element mode
    refuses more than 16 points; nothing falls back to the plain
    versions."""
    from tigar_tpu_torch.ops.assembly import element_matrices_cuda
    from tigar_tpu_torch.ops.stencil import build_stencil_cuda
    sp, asm = _tspline_asm("star", cuda)
    U = _state(sp)
    with pytest.raises(ValueError, match="got 16"):
        build_stencil_cuda(asm, TS_DENSITY, U, None, 3)
    with pytest.raises(ValueError, match="got 25"):
        element_matrices_cuda(sp._assembler("dx", quad_degree=8),
                              TS_DENSITY, U)


def test_star_sanewton_runs_through_kernels(cuda):
    """SANewton on the star shell at nel=4 (the bench's options plus
    coarse_size=50) through K1, K2's element mode, K10 and K11, against the
    CPU plain versions: steps within 1, U within 1e-8."""
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    kw = {"coarse_size": 50}
    ns_g, ns_c = (demo.build(4, d, kw) for d in (cuda, "cpu"))
    cuda_ext.reset_counts()
    Ug, relg, itg, dUg = ns_g.solve(rtol=demo.RTOL)
    c = cuda_ext.counts()
    for k in ("shell_residual", "tangent_elements", "elem_tangent_apply",
              "ell_spmv"):
        assert c[k] > 0, k
    Uc, relc, itc, _ = ns_c.solve(rtol=demo.RTOL)
    assert abs(itg - itc) <= 1 and relg <= 1e-10
    assert _rel(Ug.cpu(), Uc) <= 1e-8
    assert demo.certify(ns_g, Ug, relg, dUg)[2]


# -- K12 and the generic form path --------------------------------------------


def _poisson(nel, device, p=2, dim=2):
    cm = ExplicitBSplineControlMesh([p] * dim,
                                    [uniform_knots(p, 0.0, 1.0, nel)] * dim)
    sp = EqualOrderSpline(1, cm)
    basis = sp.get_scalar_spline()
    for d in range(dim):
        for side in (0, 1):
            sp.add_zero_dofs(0, basis.side_dofs(d, side))
    return ExtractedSpline(sp, quad_degree=2 * p, device=device)


def _poisson_a(ctx, u, v):
    return torch.sum(ctx.grad(u) * ctx.grad(v))


def _poisson_L(ctx, v):
    return (2.0 * torch.pi ** 2 * torch.sin(torch.pi * ctx.x[0])
            * torch.sin(torch.pi * ctx.x[1]) * v.val)


@pytest.mark.parametrize("p,dim,nel", [(1, 2, 12), (1, 3, 6), (2, 2, 12),
                                       (3, 2, 8), (2, 3, 5), (3, 3, 4)],
                         ids=["2d-p1", "3d-p1", "2d-p2", "2d-p3", "3d-p2",
                              "3d-p3"])
def test_laplace_apply_kernel(cuda, p, dim, nel):
    """K12 for nen 4, 8, 9, 16, 27 and 64: the element-matrix entry point
    and the JAX-layout entry point (which builds the element matrices) on
    the card against their plain versions, and the operator against the
    f64 AD tangent action."""
    from tigar_tpu_torch.ops import fastpath
    sp = _poisson(nel, cuda, p=p, dim=dim)
    asm = sp._assembler("dx")
    Ke = fastpath.laplace_element_matrices(asm)
    connT = asm.conns[0].t().contiguous()
    assert connT.shape[0] == (p + 1) ** dim
    W = torch.as_tensor(np.random.default_rng(0).normal(size=sp.ndof),
                        device=cuda)
    m32, W32 = sp.mask.float(), W.float()
    before = cuda_ext.counts()["laplace_apply"]
    yk = fastpath.laplace_apply_elem(Ke, connT, m32, W32)
    assert cuda_ext.counts()["laplace_apply"] == before + 1
    yt = fastpath.laplace_apply_elem_ref(Ke, connT, m32, W32)
    assert _rel(yk, yt) <= 1e-6
    A1, A2 = fastpath.laplace_layouts(asm)
    yl = fastpath.laplace_apply(A1, A2, connT, m32, W32)
    assert cuda_ext.counts()["laplace_apply"] == before + 2
    assert _rel(yl, fastpath.laplace_apply_ref(A1, A2, connT, m32,
                                               W32)) <= 1e-6
    ref = sp.tangent_action(_poisson_a, torch.zeros_like(W), W)
    out = fastpath.make_laplace_operator(asm, sp.mask)(W)
    assert out.dtype == torch.float64
    assert float((out - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


def test_laplace_apply_kernel_scrambled_connectivity(cuda):
    """A random DoF numbering of the 128^2 p=2 Poisson: every block's DoF
    range exceeds the kernel's shared window, so K12 adds straight to r
    with global atomics; it agrees with its plain version and with the
    unscrambled apply."""
    from tigar_tpu_torch.ops import cuda_ext, fastpath
    sp = _poisson(128, cuda)
    asm = sp._assembler("dx")
    Ke = fastpath.laplace_element_matrices(asm)
    connT = asm.conns[0].t().contiguous()
    perm = torch.as_tensor(np.random.default_rng(3).permutation(sp.ndof),
                           device=cuda)
    connS = perm[connT.long()].to(torch.int32).contiguous()
    nen, nel = connS.shape
    blocks = connS[:, :nel // 4 * 4].reshape(nen, -1, 4)
    ranges = blocks.amax((0, 2)) - blocks.amin((0, 2)) + 1
    assert int(ranges.min()) > cuda_ext.load().LAPLACE_WINDOW
    W = torch.as_tensor(np.random.default_rng(4).normal(size=sp.ndof),
                        dtype=torch.float32, device=cuda)
    m32 = sp.mask.float()
    WS, mS = torch.empty_like(W), torch.empty_like(m32)
    WS[perm], mS[perm] = W, m32
    yk = fastpath.laplace_apply_elem(Ke, connS, mS, WS)
    assert _rel(yk, fastpath.laplace_apply_elem_ref(Ke, connS, mS, WS)) \
        <= 1e-6
    assert _rel(yk[perm], fastpath.laplace_apply_elem(Ke, connT, m32, W)) \
        <= 1e-6


def test_laplace_apply_refuses_what_it_cannot_take(cuda):
    from tigar_tpu_torch.ops import fastpath
    sp = _poisson(4, cuda)
    asm = sp._assembler("dx")
    Ke = fastpath.laplace_element_matrices(asm)
    connT = asm.conns[0].t().contiguous()
    m32 = sp.mask.float()
    W = torch.zeros(sp.ndof, device=cuda)
    with pytest.raises(RuntimeError, match="Ke has dtype"):
        fastpath.laplace_apply_elem(Ke.double(), connT, m32, W)
    with pytest.raises(RuntimeError, match="Ke has shape"):
        fastpath.laplace_apply_elem(Ke[:-1].contiguous(), connT, m32, W)
    A1, A2 = fastpath.laplace_layouts(asm)
    with pytest.raises(TypeError):
        fastpath.laplace_apply(A1.double(), A2.double(), connT, sp.mask, W)
    with pytest.raises(ValueError):
        fastpath.laplace_apply(A1[:-1], A2[:-1], connT, m32, W)


def test_twolevel_cycle_runs_through_kernels(cuda):
    """The two-level SA cycle on the card runs K11 (sweeps and residual,
    no fallback) and agrees with the plain coo cycle to f32 1e-5."""
    from tigar_tpu_torch.solvers.aggregation import TwoLevelSA
    sp = _poisson(12, cuda)
    pre, _ = TwoLevelSA.from_spline(sp, _poisson_a)
    r = torch.as_tensor(np.random.default_rng(1).normal(size=sp.ndof),
                        dtype=torch.float32, device=cuda)
    cuda_ext.reset_counts()
    yk = pre.apply32(r)
    assert cuda_ext.counts()["ell_spmv"] == 2 * pre._n_smooth
    yp = pre.apply32_ref(r)
    assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())


@pytest.mark.parametrize("method", ["refine", "sa_cg"])
def test_generic_path_runs_through_kernels(cuda, method):
    """refine_solve with K12 inside and two-level sa_cg (K11) on the card
    agree with the CPU plain versions (U within 1e-10)."""
    from tigar_tpu_torch.ops.fastpath import make_laplace_operator
    from tigar_tpu_torch.solvers.linear import jacobi_preconditioner
    from tigar_tpu_torch.solvers.refinement import refine_solve
    out = {}
    for dev in (cuda, "cpu"):
        sp = _poisson(10, dev)
        cuda_ext.reset_counts()
        if method == "refine":
            b = sp.assemble_vector(_poisson_L)
            M32 = jacobi_preconditioner(
                sp.assemble_diagonal(_poisson_a).float())
            x, _, rel = refine_solve(
                sp.matrix_operator(_poisson_a),
                make_laplace_operator(sp._assembler("dx"), sp.mask), b,
                tol=1e-12, inner_iters=60, M_f32=M32)
            assert rel < 1e-12
            kern = "laplace_apply"
        else:
            sp.set_solver_options(linear_solver="sa_cg")
            x = sp.solve_linear_variational_problem(_poisson_a,
                                                    rhs_form=_poisson_L)
            kern = "ell_spmv"
        n = cuda_ext.counts()[kern]
        assert (n > 0) if dev is cuda else (n == 0)
        out[str(dev)] = x.cpu()
    assert float((out[str(cuda)] - out["cpu"]).abs().max()) <= \
        1e-10 * float(out["cpu"].abs().max())


# -- K13 / K14: all-pairs penalty contact (the reef-knot demo's contact) ----


def _contact(nel, device, **kw):
    """PointContact on the unit-square strip of tests/test_contact.py at
    nel^2 elements ((nel+2)^2 points), at its active parameters."""
    from tigar_tpu_torch.contact import PointContact
    cm = ExplicitBSplineControlMesh(
        [2, 2], [uniform_knots(2, 0.0, 1.0, nel)] * 2, extra_dim=1)
    sp = ExtractedSpline(EqualOrderSpline(3, cm), quad_degree=4, nders=2,
                         device=device)
    return PointContact(sp, **(kw or dict(k=1e4, r_max=0.3, r_self=0.05)))


# n = 36 and 1,089 are ragged against the 16-byte mask loads and the 32
# lanes; n = 1,024 is a whole number of warps' tiles
@pytest.mark.parametrize("nel", [4, 30, 31])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_contact_kernels_match_plain(cuda, nel, dtype):
    """K13 and K14 against their plain versions (torch.func of the
    row-blocked energy) at U = 0.01 N(0, 1) from numpy seed 0; f64 1e-12,
    f32 1e-5 of the largest entry."""
    from tigar_tpu_torch.ops import contact as oc
    c = _contact(nel, cuda)
    c = c if dtype == torch.float64 else c.astype(dtype)
    ndof = c.spline.ndof
    rng = np.random.default_rng(0)
    U = torch.as_tensor(rng.normal(size=ndof) * 0.01, device=cuda).to(dtype)
    W = torch.as_tensor(rng.normal(size=ndof), device=cuda).to(dtype)
    x = c.positions(U).contiguous()
    v = c._apply_P(W).contiguous()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    cuda_ext.reset_counts()
    gk = oc.contact_forces(x, c.quad_w, c.pair_mask, c.k, c.r_max)
    hk = oc.contact_hvp(x, v, c.quad_w, c.pair_mask, c.k, c.r_max)
    torch.cuda.synchronize()
    counts = cuda_ext.counts()
    assert counts["contact_residual"] == 1 == counts["contact_tangent"]
    gp = oc.contact_forces_ref(x, c.quad_w, c.pair_mask, c.phi, c.r_max)
    hp = oc.contact_hvp_ref(x, v, c.quad_w, c.pair_mask, c.phi, c.r_max)
    assert float(gp.abs().max()) > 0.0
    assert float((gk - gp).abs().max()) <= tol * float(gp.abs().max())
    assert float((hk - hp).abs().max()) <= tol * float(hp.abs().max())
    # the DoF-space residual and tangent action through the kernels
    assert float((c.residual(U).cpu() - c._apply_PT(gp).cpu()).abs().max()) \
        <= tol * float(c._apply_PT(gp).abs().max())


def test_contact_kernels_refuse_what_they_cannot_take(cuda):
    """A custom potential, an unpadded mask and a wrong type raise."""
    from tigar_tpu_torch.contact import PointContact
    from tigar_tpu_torch.ops import contact as oc
    c = _contact(4, cuda)
    U = torch.zeros(c.spline.ndof, dtype=torch.float64, device=cuda)
    custom = PointContact(c.spline, k=1e4, r_max=0.3, r_self=0.05,
                          phi=c.phi)
    with pytest.raises(NotImplementedError):
        custom.residual(U)
    with pytest.raises(NotImplementedError):
        custom.tangent_action(U, U)
    x = c.positions(U).contiguous()
    with pytest.raises(ValueError):
        oc.contact_forces(x, c.quad_w, c.pair_mask.contiguous(), c.k,
                          c.r_max)
    with pytest.raises(ValueError):
        oc.contact_forces(x.float(), c.quad_w, c.pair_mask, c.k, c.r_max)


@pytest.mark.parametrize("mixed", [False, True])
def test_reef_knot_step_runs_through_kernels(cuda, mixed):
    """One step of the reef-knot demo at NEL=6 without MG on the card:
    K13 and K14 launched, the Newton count of the CPU plain versions and
    U within 1e-10 (f64 CG) or 1e-5 (f32 CG: atomics in the shell
    scatter)."""
    from tigar_tpu_torch.demos.reef_knot_contact import run
    cuda_ext.reset_counts()
    Ug, hg, _ = run(6, 1, mixed=mixed, mg=False, cg_iters=10, device=cuda)
    counts = cuda_ext.counts()
    assert counts["contact_residual"] == len(hg[0])
    assert counts["contact_tangent"] > 0
    Uc, hc, _ = run(6, 1, mixed=mixed, mg=False, cg_iters=10, device="cpu")
    assert len(hg[0]) == len(hc[0])
    tol = 1e-5 if mixed else 1e-10
    assert float((Ug.cpu() - Uc).abs().max()) <= tol * float(Uc.abs().max())


# -- C3: a refused binding check raises -------------------------------------


def test_binding_refusals_raise(cuda):
    """One refused call per check site of every binding, in a child
    process (tigar_tpu_torch.ops.refusals): every one raises RuntimeError
    and none ends the process."""
    from tigar_tpu_torch.ops import refusals
    cuda_ext.load()
    rc, lines = refusals.run()
    assert rc == 0, "\n".join(lines)
    done = [ln for ln in lines if ": RuntimeError: " in ln]
    n = len(refusals._calls())
    assert len(done) == n
    assert f"refused calls: {n} of {n} raised RuntimeError" in lines


# -- K15 / K16: sum-factorized jets and their transpose ----------------------


def _jet_layout(case, device, dtype):
    """The layout of a K15/K16 case: the shell's three fields at
    nders 2, its control net's four interleaved columns, the strided 3D
    reduced-continuity field, a periodic (gather) field and the RT pair of
    per-field degrees."""
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    from tigar_tpu_torch.ops.sumfac_forms import (DevicePlan, FieldPlan,
                                                  JetGroup, JetLayout)

    def plan(basis, nders, npts=3):
        return DevicePlan(FieldPlan(basis, npts, nders), device, dtype)

    if case == "shell":
        p = plan(TensorBSplineBasis([2, 2], [uniform_knots(2, -1., 1., 5)]
                                    * 2), 2)
        return JetLayout([JetGroup(p, 0, 3, p.ncp, 1, 0)], 3 * p.ncp)
    if case == "bnet":
        p = plan(TensorBSplineBasis([2, 2], [uniform_knots(2, -1., 1., 5)]
                                    * 2), 2)
        return JetLayout([JetGroup(p, 0, 4, 1, 4, 0)], 4 * p.ncp)
    if case == "strided3d":
        kv = uniform_knots(2, 0., 1., 3, continuity_drop=1)
        p = plan(TensorBSplineBasis([2, 2, 2], [kv] * 3), 1)
        assert all(m[0] == "slide" and m[2] == 2 for m in p.metas)
        return JetLayout([JetGroup(p, 0, 1, p.ncp, 1, 0)], p.ncp)
    if case == "periodic":
        p = plan(TensorBSplineBasis([2, 2], [
            uniform_knots(2, 0., 1., 6, periodic=True),
            uniform_knots(2, 0., 1., 4)]), 2)
        assert p.metas[0][0] == "gather"
        return JetLayout([JetGroup(p, 0, 1, p.ncp, 1, 0)], p.ncp)
    if case == "3d-hessian":
        p = plan(TensorBSplineBasis([2, 3, 1], [
            uniform_knots(2, 0., 1., 3), uniform_knots(3, 0., 1., 2),
            uniform_knots(1, 0., 1., 4)]), 2, npts=4)
        return JetLayout([JetGroup(p, 0, 2, p.ncp, 1, 0)], 2 * p.ncp)
    if case == "gather-repeat":
        # a gather direction whose windows repeat coefficients: lists of
        # up to 8 (element, slot) pairs, past K16's 4 a direction in
        # registers
        g = np.random.default_rng(2)
        idx = torch.tensor([[0, 1, 0], [1, 0, 2], [0, 2, 1], [3, 0, 0],
                            [4, 3, 0], [0, 4, 3]], device=device)
        tabs = [torch.as_tensor(g.normal(size=s), device=device).to(dtype)
                for s in ((6, 3, 3, 3), (4, 3, 3, 3))]
        p = DevicePlan.from_tensors(tabs, [idx, None],
                                    [("gather", 0, 1, 6, 3),
                                     ("slide", 0, 1, 4, 3)], (5, 6), 2)
        return JetLayout([JetGroup(p, 0, 1, p.ncp, 1, 0)], p.ncp)
    if case == "p3-rows":
        p = plan(TensorBSplineBasis([3, 3], [uniform_knots(3, 0., 1., 40)]
                                    * 2), 2, npts=4)
        return JetLayout([JetGroup(p, 0, 5, p.ncp, 1, 0)], 5 * p.ncp)
    u = np.linspace(0.0, 1.0, 5)

    def kv(deg):
        return np.concatenate([[0.0] * deg, u, [1.0] * deg])

    p0 = plan(TensorBSplineBasis([2, 1], [kv(2), kv(1)]), 1, npts=3)
    p1 = plan(TensorBSplineBasis([1, 2], [kv(1), kv(2)]), 1, npts=3)
    return JetLayout([JetGroup(p0, 0, 1, p0.ncp, 1, 0),
                      JetGroup(p1, p0.ncp, 1, p1.ncp, 1, 1)],
                     p0.ncp + p1.ncp)


# K16's layout classes: 2D / 3D, nders 1 / 2, pp 2-4 (mixed across
# directions), slide at strides 1 and 2, gather (and gather windows that
# repeat coefficients), one and several groups and columns, interleaved
# columns (bnet), element rows longer than a block's run (p3-rows)
JET_CASES = ["shell", "bnet", "strided3d", "periodic", "rt", "3d-hessian",
             "p3-rows", "gather-repeat"]


@pytest.mark.parametrize("case", JET_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_sumfac_jets_kernels(cuda, case, dtype, tol):
    """K15 and K16 against their plain versions (the windowed chains and
    their vjp) on the card, the adjoint identity <E u, c> = <u, E^T c>,
    autograd through K15 (its backward is K16) and the launch counts:
    f64 1e-12, f32 1e-5 of the largest entry (another sum order, no
    atomics)."""
    from tigar_tpu_torch.ops import sumfac_forms as sf
    layout = _jet_layout(case, cuda, dtype)
    g = torch.Generator().manual_seed(3)
    W = torch.randn(layout.n, generator=g, dtype=torch.float64).to(
        cuda, dtype)
    cuda_ext.reset_counts()
    jk = sf.layout_jets(W, layout)
    jp = sf.jets_plain(W, layout)
    assert cuda_ext.counts()["sumfac_jets"] == len(layout.groups)
    assert (jk[2] is None) == (layout.nders < 2)
    for a, b in zip(jk, jp):
        if b is not None:
            assert a.shape == b.shape and _rel(a, b) <= tol
    cot = tuple(None if x is None else torch.randn(
        x.shape, generator=g, dtype=torch.float64).to(cuda, dtype)
        for x in jp)
    rk = sf.layout_scatter(cot, layout)
    rp = sf.scatter_jets_plain(cot, layout)
    assert cuda_ext.counts()["sumfac_scatter_jets"] == len(layout.groups)
    assert rk.shape == (layout.n,) and _rel(rk, rp) <= tol
    lhs = sum(float((a.double() * c.double()).sum())
              for a, c in zip(jk, cot) if c is not None)
    rhs = float((W.double() * rk.double()).sum())
    assert abs(lhs - rhs) <= 10 * tol * abs(rhs)
    Wg = W.clone().requires_grad_(True)
    out = sf.layout_jets(Wg, layout)
    loss = sum((a * c).sum() for a, c in zip(out, cot) if c is not None)
    (gW,) = torch.autograd.grad(loss, Wg)
    assert _rel(gW, rp) <= tol


def test_sumfac_jets_kernels_refuse_what_they_cannot_take(cuda):
    """A degree above 3, a CPU plan and a wrong type raise."""
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    from tigar_tpu_torch.ops import sumfac_forms as sf
    p4 = sf.DevicePlan(sf.FieldPlan(TensorBSplineBasis(
        [4, 4], [uniform_knots(4, 0., 1., 2)] * 2), 5, 1), cuda,
        torch.float64)
    lay = sf.JetLayout([sf.JetGroup(p4, 0, 1, p4.ncp, 1, 0)], p4.ncp)
    with pytest.raises(ValueError):
        sf.jets_cuda(torch.zeros(p4.ncp, dtype=torch.float64, device=cuda),
                     lay)
    lay = _jet_layout("shell", cuda, torch.float64)
    with pytest.raises(TypeError):
        sf.jets_cuda(torch.zeros(lay.n, dtype=torch.float16, device=cuda),
                     lay)
    with pytest.raises(ValueError):
        sf.jets_cuda(torch.zeros(lay.n, dtype=torch.float32, device=cuda),
                     lay)


def _sumfac_shell(device, nel=5):
    from tigar_tpu_torch.models.shell import shell_reference
    from tigar_tpu_torch.ops.sumfac_forms import make_sumfac_assembler
    sp = _build(nel, device)
    asm = make_sumfac_assembler(sp)
    asm.ctx = asm.ctx._replace(aux={"shell_ref": shell_reference(asm.ctx)})
    return sp, asm


def _shell_form(ctx, u, v):
    from tigar_tpu_torch.forms import deriv
    from tigar_tpu_torch.models.shell import svk_psi_surface
    return deriv(lambda y: svk_psi_surface(ctx, y, E_mod, nu, h_th), u, v) \
        - 1e-2 * v.val[2]


def test_sumfac_assembler_runs_through_kernels(cuda):
    """The sumfac shell residual and tangent action on the card (K15/K16
    launched) against the same assembler on the CPU (plain versions) and
    the card's generic assembler: 1e-12 / 1e-9."""
    spg, ag = _sumfac_shell(cuda)
    spc, ac = _sumfac_shell("cpu")
    g = torch.Generator().manual_seed(0)
    U = 1e-3 * torch.randn(spc.ndof, generator=g, dtype=torch.float64)
    W = torch.randn(spc.ndof, generator=g, dtype=torch.float64)
    cuda_ext.reset_counts()
    rg = ag.residual_vector(_shell_form, U.to(cuda))
    tg = ag.tangent_action(_shell_form, U.to(cuda), W.to(cuda))
    counts = cuda_ext.counts()
    assert counts["sumfac_jets"] == 3 and counts["sumfac_scatter_jets"] == 2
    rc = ac.residual_vector(_shell_form, U)
    tc = ac.tangent_action(_shell_form, U, W)
    assert _rel(rg.cpu(), rc) <= 1e-12 and _rel(tg.cpu(), tc) <= 1e-12
    r_gen = spg._assembler("dx").residual_vector(_shell_form, U.to(cuda))
    assert _rel(rg, r_gen) <= 1e-9


# -- the redesigned K2 and K4 at the edges of their blocks and shapes -------

@pytest.mark.parametrize("quad_degree", [1, 2, None, 6],
                         ids=["nq1", "nq4", "nq9", "nq16"])
@pytest.mark.parametrize("mode", ["stencil", "elements"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_tangent_kernel_ragged_blocks(cuda, quad_degree, mode, dtype, tol):
    """K2 on the nel=7 plate (49 elements: no multiple of a block's 8, 3
    or 1 elements) at 1, 4, 9 and 16 points (the stencil mode takes at
    most 9), against its plain versions, with its launches tallied by type
    and point count (element mode: and local functions)."""
    from tigar_tpu_torch.ops.assembly import element_matrices_adjoint_ref
    spline = _build(7, cuda)
    asm = spline._assembler("dx", quad_degree=quad_degree).astype(dtype)
    U = _state(spline, seed=3, amp=0.05).to(dtype)
    tag = {torch.float64: "f64", torch.float32: "f32"}[dtype]
    cuda_ext.reset_counts()
    if mode == "stencil":
        if asm.nq > 9:
            with pytest.raises(ValueError):
                build_stencil(asm, DENSITY, U, spline.space.fields[0], 3)
            return
        basis = spline.space.fields[0]
        got = build_stencil(asm, DENSITY, U, basis, 3).S
        want = build_stencil_ref(asm, DENSITY, U, basis, 3).S
        key = f"{tag} nq={asm.nq}"
    else:
        me = spline.mask.to(dtype)[asm.cat_conn]
        got = asm.element_matrices_adjoint(DENSITY, U, me=me)
        want = element_matrices_adjoint_ref(asm, DENSITY, U, me)
        key = f"{tag} nq={asm.nq} nen=9"
    torch.cuda.synchronize()
    name = "tangent_stencil" if mode == "stencil" else "tangent_elements"
    assert cuda_ext.counts_by(name) == {key: 1}
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("case", ["plate", "star", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tangent_elements_exactly_symmetric(cuda, case, dtype):
    """K2's element mode computes E's upper triangle and mirrors it: E is
    exactly symmetric in both types, padded elements included."""
    spline, asm, dens, me = _elem_spline(cuda, case)
    asm = asm.astype(dtype)
    E = asm.element_matrices_adjoint(dens, _state(spline, amp=0.01)
                                     .to(dtype), me=me.to(dtype))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(E).all()) and float(E.abs().max()) > 0.0
    assert torch.equal(E, E.transpose(1, 2))


# K4 at the edges of its shapes: (dim, p, nel, periodic, continuity_drop,
# extra points), each P1 / Q case of its dispatch
K4_EDGE_CASES = {
    "3d_p1_nel10": (3, 1, 10, False, 0, 0),
    "3d_p1_nq3_nel9": (3, 1, 9, False, 0, 1),
    "3d_p2_nel12": (3, 2, 12, False, 0, 0),
    "3d_p2_nq4_nel9": (3, 2, 9, False, 0, 1),
    "3d_p3_nel6": (3, 3, 6, False, 0, 0),
    "3d_p3_nq5_nel5": (3, 3, 5, False, 0, 1),
    "3d_drop1_p2_nel10": (3, 2, 10, False, 1, 0),
    "3d_periodic_p2_nel3": (3, 2, 3, True, 0, 0),
    "3d_periodic_p2_nel9": (3, 2, 9, True, 0, 0),
    "2d_p3_nel20": (2, 3, 20, False, 0, 0),
    "2d_drop2_p3_nel17": (2, 3, 17, False, 2, 1),
    "2d_periodic_p2_nel33": (2, 2, 33, True, 0, 1),
}


@pytest.mark.parametrize("metric", [False, True], ids=["identity", "metric"])
@pytest.mark.parametrize("name", list(K4_EDGE_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_sumfac_apply_kernel_edges(cuda, name, metric, dtype, tol):
    """K4 on grids of 3 to 33 elements a direction (none a multiple of its
    128-thread blocks), windows that wrap onto themselves (periodic, 3
    elements), reduced continuity and every P1 / Q case it dispatches,
    identity and general geometry, with and without the mask, against its
    plain version; its launches tallied by grid and type."""
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    dim, p, nel, per, drop, extra = K4_EDGE_CASES[name]
    basis = TensorBSplineBasis([p] * dim, [uniform_knots(
        p, 0.0, 1.0, nel, periodic=per, continuity_drop=drop)] * dim)
    data = sumfac.build_sumfac_data(basis, None, 2 * (p + extra), cuda,
                                    dtype)
    assert data.nq == p + 1 + extra
    rng = np.random.default_rng(8)
    if metric:
        npt = data.nq ** dim
        A = rng.normal(size=(basis.nel, npt, dim, dim))
        data.G = torch.as_tensor(A @ np.swapaxes(A, -1, -2)
                                 + dim * np.eye(dim), dtype=dtype,
                                 device=cuda)
        data.Gm = torch.as_tensor(rng.uniform(0.5, 1.5, (basis.nel, npt)),
                                  dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=data.ndof), dtype=dtype,
                        device=cuda)
    mask = torch.as_tensor((rng.uniform(size=data.ndof) > 0.2) * 1.0,
                           dtype=dtype, device=cuda)
    tag = {torch.float64: "f64", torch.float32: "f32"}[dtype]
    for m in (None, mask):
        cuda_ext.reset_counts()
        r_k = sumfac.sumfac_apply(data, W, 1.0, 0.7, m)
        r_t = sumfac.sumfac_apply_ref(data, W, 1.0, 0.7, m)
        torch.cuda.synchronize()
        assert cuda_ext.counts_by("sumfac_apply") == {
            f"{'x'.join(map(str, data.nel_d))} {tag}": 1}
        assert _rel(r_k, r_t) <= tol, (m is None, _rel(r_k, r_t))
