"""tigar_tpu_torch assembly twins against tigar_tpu on identical inputs
(the JAX assembler's arrays carried across with convert.py):

  - residual_vector_adjoint (twin of kernel K1) at nel=6, U ~ 0.1 N(0,1):
    rel <= 1e-12 in f64, rel <= 1e-5 in f32 with f32 inputs;
  - element_matrices_adjoint and the folded stencil (twin of kernel K2)
    at both quadrature rules: rel <= 1e-11;
  - the adjoint identity of the port's SVK density against its residual.

rel = max |port - jax| / max |jax|.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.ops.stencil import stencil_from_element_matrices as jfold
from tigar_tpu_torch.convert import assembler_arrays, assembler_from_numpy
from tigar_tpu_torch.forms import Jet
from tigar_tpu_torch.models.bspline import TensorBSplineBasis
from tigar_tpu_torch.ops.knots import uniform_knots
from tigar_tpu_torch.models.shell import svk_shell_adjoint, svk_shell_residual
from tigar_tpu_torch.ops.assembly import residual_vector_adjoint_ref
from tigar_tpu_torch.ops.stencil import (build_stencil, build_stencil_ref,
                                         stencil_from_element_matrices)

from torch_parity import (build_jax, jax_density, torch_density, rel,
                          E_MOD, NU, H_TH)

Q = 100.0


@pytest.fixture(scope="module")
def shell6():
    sj = build_jax(6)
    U = 0.1 * np.random.default_rng(0).normal(size=sj.ndof)
    return sj, U


@jax.jit
def _jit_residual(aj, U):
    return aj.residual_vector_adjoint(jax_density(Q), U)


def _pair(sj, quad_degree=None, dtype=torch.float64):
    kw = {} if quad_degree is None else {"quad_degree": quad_degree}
    aj = sj._assembler("dx", **kw)
    if dtype == torch.float32:
        aj = aj.astype(jnp.float32)
    return aj, assembler_from_numpy(assembler_arrays(aj), device="cpu",
                                    dtype=dtype)


def test_residual_f64(shell6):
    sj, U = shell6
    aj, at = _pair(sj)
    rj = _jit_residual(aj, jnp.asarray(U))
    rt = at.residual_vector_adjoint(torch_density(Q), torch.as_tensor(U))
    assert rt.dtype == torch.float64
    assert rel(rt, rj) <= 1e-12


def test_residual_f32(shell6):
    sj, U = shell6
    aj, at = _pair(sj, dtype=torch.float32)
    U32 = U.astype(np.float32)
    rj = _jit_residual(aj, jnp.asarray(U32))
    rt = residual_vector_adjoint_ref(at, torch_density(Q),
                                     torch.as_tensor(U32))
    assert rt.dtype == torch.float32 and np.asarray(rj).dtype == np.float32
    assert rel(rt, rj) <= 1e-5


@pytest.mark.parametrize("quad_degree", [None, 2])
def test_element_matrices_and_stencil(shell6, quad_degree):
    sj, U = shell6
    aj, at = _pair(sj, quad_degree)
    Ej = jax.jit(lambda a, u: a.element_matrices_adjoint(jax_density(Q), u))(
        aj, jnp.asarray(U))
    Et = at.element_matrices_adjoint(torch_density(Q), torch.as_tensor(U))
    assert rel(Et, Ej) <= 1e-11
    basis_j = sj.space.fields[0]
    Sj = jfold(basis_j, Ej, nf=3).S
    # the port's fold of the port's element matrices, and the build twin
    basis_t = TensorBSplineBasis([2, 2], [uniform_knots(2, -1.0, 1.0, 6)] * 2)
    St = stencil_from_element_matrices(basis_t, Et, 3).S
    assert rel(St, Sj) <= 1e-11
    Sb = build_stencil(at, torch_density(Q), torch.as_tensor(U), basis_t,
                       3).S
    assert rel(Sb, Sj) <= 1e-11
    Sr = build_stencil_ref(at, torch_density(Q), torch.as_tensor(U),
                           basis_t, 3).S
    assert torch.equal(Sb, Sr)


def test_adjoint_identity():
    """sum(F.g v.g) + sum(F.h v.h) == svk_shell_residual(ctx, u, v) on
    random jets, batched over the points of an assembler."""
    from torch_parity import build_torch
    st = build_torch(4, clamp=False)
    asm = st._assembler("dx")
    rng = np.random.default_rng(5)
    U = torch.as_tensor(0.05 * rng.normal(size=st.ndof))
    V = torch.as_tensor(rng.normal(size=st.ndof))
    u, v = asm.jets(U), asm.jets(V)
    F = svk_shell_adjoint(asm.ctx, u, E_MOD, NU, H_TH)
    lhs = (F.g * v.g).sum((-2, -1)) + (F.h * v.h).sum((-3, -2, -1))
    rhs = svk_shell_residual(asm.ctx, u, v, E_MOD, NU, H_TH)
    assert rel(lhs, rhs) <= 1e-12
    assert torch.all(F.val == 0)


def test_density_matches_jax_pointwise(shell6):
    """The port's SVKShellAdjoint (load included) at every point of the
    nel=6 assembler equals tigar_tpu's density vmapped over the points."""
    sj, U = shell6
    aj, at = _pair(sj)
    uj = aj.jets(jnp.asarray(U))
    Fj = jax.jit(jax.vmap(jax.vmap(jax_density(Q))))(aj.ctx, uj)
    ut = at.jets(torch.as_tensor(U))
    Ft = torch_density(Q)(at.ctx, ut)
    for a, b in zip(Ft, Fj):
        assert rel(a, b) <= 1e-12
    assert isinstance(ut, Jet)
