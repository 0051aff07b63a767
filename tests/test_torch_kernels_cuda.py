"""Hand-written CUDA kernels of tigar_tpu_torch against their plain PyTorch
twins, on the card (K1-K3 on the nel=8 clamped SVK shell plate, K4 on
small 2D/3D sum-factorized operators).  Every test skips without a CUDA
device; run them on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances (relative to the largest entry of the twin's result): f64
1e-12; f32 1e-5, and 1e-4 on tangent stencils (f32 atomics add in a
nondeterministic order, and the stencil entries sum 4-36 element
contributions of mixed sign).
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
