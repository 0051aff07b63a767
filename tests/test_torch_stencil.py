"""tigar_tpu_torch stencil operators against tigar_tpu on identical (random)
stencil arrays (f64): every mode of the stencil-apply twin (kernel K3) at the
nel=6 and nel=3 grids, and its patch mode on CPU tensors, the diagonal,
stencil_to_dense, and the knot-insertion transfers.
rel = max |port - jax| / max |jax| <= 1e-12.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.ops.stencil import (StencilOperator as JStencil,
                                   stencil_to_dense as jdense)
from tigar_tpu.solvers.newton_stencil import (_masked_apply as j_masked,
                                              TensorProlong as JProlong)
from tigar_tpu.solvers.multigrid import insertion_matrix_1d as jins
from tigar_tpu_torch.convert import stencil_from_numpy
from tigar_tpu_torch.ops.stencil import (stencil_apply, stencil_apply_ref,
                                         stencil_to_dense)
from tigar_tpu_torch.solvers.newton_stencil import TensorProlong

from torch_parity import build_jax, rel


def _stencil(nel, seed):
    """A random stencil on the grid of the nel x nel biquadratic plate
    (diagonal entries shifted positive), tigar_tpu's operator over it, the
    clamped plate's BC mask and random vectors (numpy)."""
    sj = build_jax(nel)
    rng = np.random.default_rng(seed)
    n = nel + 2
    S = rng.normal(size=(3, 3, 5, 5, n, n))
    for f in range(3):
        S[f, f, 2, 2] += 10.0
    stj = JStencil(jnp.asarray(S), (n, n), (2, 2), 3)
    vecs = [rng.normal(size=sj.ndof) for _ in range(2)]
    return stj, np.asarray(sj.mask), vecs


@pytest.fixture(scope="module", params=[6, 3])
def case(request):
    stj, mask, (x, b) = _stencil(request.param, seed=request.param)
    stt = stencil_from_numpy(np.asarray(stj.S), stj.grid_shape,
                             stj.degrees, stj.nf, device="cpu")
    return stj, stt, mask, x, b


def test_layout(case):
    stj, stt, _, _, _ = case
    assert stt.grid_shape == stj.grid_shape and stt.degrees == (2, 2)
    assert stt.ndof == stj.ndof


@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi"])
@pytest.mark.parametrize("masked", [False, True])
def test_stencil_apply_modes(case, mode, masked):
    stj, stt, mask, x, b = case
    m = jnp.asarray(mask)
    Ax = j_masked(stj, m, jnp.asarray(x)) if masked else stj(jnp.asarray(x))
    d = mask * np.asarray(stj.diagonal()) + (1.0 - mask)
    dinv = 1.0 / d
    ref = {"apply": Ax, "residual": b - Ax,
           "jacobi": x + (0.7 * dinv) * (b - Ax)}[mode]
    T = torch.as_tensor
    out = stencil_apply(stt, T(x), mask=T(mask) if masked else None,
                        b=T(b), dinv=T(dinv), omega=0.7, mode=mode)
    assert out.dtype == torch.float64
    assert rel(out, ref) <= 1e-12
    # CPU tensors dispatch to the twin
    out_ref = stencil_apply_ref(stt, T(x), mask=T(mask) if masked else None,
                                b=T(b), dinv=T(dinv), omega=0.7, mode=mode)
    assert torch.equal(out, out_ref)


@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi"])
def test_stencil_apply_patch_mode_cpu(case, mode):
    """Patch mode on CPU tensors (the plain version): the stencil's grid
    read and written in place at ``base + f * fstride`` of a longer
    vector, equal to the apply on the grid alone, the rest untouched."""
    _, stt, mask, x, b = case
    n = int(np.prod(stt.grid_shape))
    base, fstride = 5, n + 7
    rows = [slice(base + f * fstride, base + f * fstride + n)
            for f in range(3)]
    rng = np.random.default_rng(1)
    big = [torch.as_tensor(rng.normal(size=base + 3 * fstride))
           for _ in range(4)]
    d = mask * np.asarray(stt.diagonal()) + (1.0 - mask)
    for v, small in zip(big, (x, mask, b, 1.0 / d)):
        for f, r in enumerate(rows):
            v[r] = torch.as_tensor(small.reshape(3, n)[f])
    X, M, B, D = big
    out = torch.full_like(X, 3.0)
    got = stencil_apply(stt, X, mask=M, b=B, dinv=D, omega=0.7, mode=mode,
                        out=out, base=base, fstride=fstride)
    T = torch.as_tensor
    ref = stencil_apply(stt, T(x), mask=T(mask), b=T(b), dinv=T(1.0 / d),
                        omega=0.7, mode=mode)
    assert got is out
    assert torch.equal(torch.cat([out[r] for r in rows]), ref)
    keep = torch.ones_like(out, dtype=torch.bool)
    for r in rows:
        keep[r] = False
    assert bool((out[keep] == 3.0).all())


def test_call_and_diagonal(case):
    stj, stt, _, x, _ = case
    assert rel(stt(torch.as_tensor(x)), stj(jnp.asarray(x))) <= 1e-12
    assert np.array_equal(stt.diagonal().numpy(), np.asarray(stj.diagonal()))
    assert stt.astype(torch.float32).S.dtype == torch.float32


def test_stencil_to_dense(case):
    stj, stt, _, x, _ = case
    A = stencil_to_dense(stt)
    assert np.array_equal(A, jdense(stj))
    # and the dense matrix is the operator
    assert rel(A @ x, np.asarray(stj(jnp.asarray(x)))) <= 1e-12


def test_unknown_mode(case):
    _, stt, _, x, _ = case
    with pytest.raises(ValueError, match="mode"):
        stencil_apply(stt, torch.as_tensor(x), mode="sor")


def test_tensor_prolong():
    from tigar_tpu.ops.knots import KnotVector as JKV, uniform_knots as juk
    from tigar_tpu_torch.solvers.multigrid import insertion_matrix_1d
    from tigar_tpu_torch.ops.knots import KnotVector, uniform_knots
    kf = [KnotVector(2, uniform_knots(2, -1.0, 1.0, n)) for n in (8, 5)]
    kc = [KnotVector(2, uniform_knots(2, -1.0, 1.0, n)) for n in (4, 5)]
    jkf = [JKV(2, juk(2, -1.0, 1.0, n)) for n in (8, 5)]
    jkc = [JKV(2, juk(2, -1.0, 1.0, n)) for n in (4, 5)]
    shape_f = tuple(k.ncp for k in reversed(kf))
    shape_c = tuple(k.ncp for k in reversed(kc))
    Pt = TensorProlong([torch.as_tensor(insertion_matrix_1d(c, f))
                        for c, f in zip(reversed(kc), reversed(kf))],
                       3, shape_f, shape_c)
    Pj = JProlong([jnp.asarray(jins(c, f))
                   for c, f in zip(reversed(jkc), reversed(jkf))],
                  3, shape_f, shape_c)
    rng = np.random.default_rng(2)
    xc = rng.normal(size=3 * int(np.prod(shape_c)))
    xf = rng.normal(size=3 * int(np.prod(shape_f)))
    assert rel(Pt.up(torch.as_tensor(xc)), Pj.up(jnp.asarray(xc))) <= 1e-14
    assert rel(Pt.down(torch.as_tensor(xf)),
               Pj.down(jnp.asarray(xf))) <= 1e-14
