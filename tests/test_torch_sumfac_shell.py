"""The SVK Kirchhoff-Love shell through tigar_tpu_torch's sum-factorized
assembler against tigar_tpu's, on the CPU (tests/test_sumfac_forms.py:63:
p=2, 5x5 elements on [-1, 1]^2 in 3D, three displacement fields, quadrature
degree 4, nders 2; E=1e7, nu=0.3, h=0.03, load 1e-2; U = 1e-3 N(0, 1)).

  - the residual and the tangent action (JVP) against JAX's
    SumfacAssembler, run under ``jax.jit`` once: 1e-12 of the largest
    entry;
  - the port's sumfac residual and tangent action, with the shell
    reference attached to its ctx as scripts/bench_shell_sumfac.py does,
    against the port's generic assembler: 1e-12.

Few cases, so that the tier-1 run's loadfile scheduling runs this file
beside its tail.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import rel

E_MOD, NU, H_TH, LOAD = 1e7, 0.3, 0.03, 1e-2


def _spline(pkg):
    if pkg == "jax":
        from tigar_tpu.ops.knots import uniform_knots
        from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
        from tigar_tpu.models.space import EqualOrderSpline
        from tigar_tpu.models.extracted import ExtractedSpline
        kw = {}
    else:
        from tigar_tpu_torch.ops.knots import uniform_knots
        from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
        from tigar_tpu_torch.models.space import EqualOrderSpline
        from tigar_tpu_torch.models.extracted import ExtractedSpline
        kw = {"device": "cpu"}
    cm = ExplicitBSplineControlMesh([2, 2], [uniform_knots(2, -1., 1., 5)]
                                    * 2, extra_dim=1)
    return ExtractedSpline(EqualOrderSpline(3, cm), quad_degree=4, nders=2,
                           **kw)


def j_shell(ctx, u, v):
    from tigar_tpu.forms import deriv
    from tigar_tpu.models.shell import svk_psi_surface
    return deriv(lambda y: svk_psi_surface(ctx, y, E_MOD, NU, H_TH), u, v) \
        - LOAD * v.val[2]


def t_shell(ctx, u, v):
    from tigar_tpu_torch.forms import deriv
    from tigar_tpu_torch.models.shell import svk_psi_surface
    return deriv(lambda y: svk_psi_surface(ctx, y, E_MOD, NU, H_TH), u, v) \
        - LOAD * v.val[2]


@pytest.fixture(scope="module")
def shell():
    from tigar_tpu.ops.sumfac_forms import make_sumfac_assembler as jmake
    from tigar_tpu_torch.ops.sumfac_forms import make_sumfac_assembler
    jsp = _spline("jax")
    rng = np.random.default_rng(7)
    U = rng.normal(size=jsp.ndof) * 1e-3
    W = rng.normal(size=jsp.ndof)

    @jax.jit
    def ref(asm, U, W):
        return (asm.residual_vector(j_shell, U),
                asm.tangent_action(j_shell, U, W))

    r, t = ref(jmake(jsp), jnp.asarray(U), jnp.asarray(W))
    tsp = _spline("torch")
    return dict(tsp=tsp, asm=make_sumfac_assembler(tsp), U=U, W=W,
                r=np.asarray(r), t=np.asarray(t))


def test_shell_residual_and_tangent_match_jax(shell):
    U, W = torch.as_tensor(shell["U"]), torch.as_tensor(shell["W"])
    asm = shell["asm"]
    assert asm.layout.M == 3 and len(asm.layout.groups) == 1
    assert rel(asm.residual_vector(t_shell, U), shell["r"]) <= 1e-12
    assert rel(asm.tangent_action(t_shell, U, W), shell["t"]) <= 1e-12


def test_shell_sumfac_matches_generic(shell):
    """With the shell reference attached (read instead of recomputed), as
    the bench script and chip_smoke.py run it."""
    from tigar_tpu_torch.models.shell import shell_reference
    from tigar_tpu_torch.forms import tree_jvp
    asm, tsp = shell["asm"], shell["tsp"]
    ctx = asm.ctx._replace(aux={"shell_ref": shell_reference(asm.ctx)})
    asm = asm.to(torch.float64)
    asm.ctx = ctx
    U, W = torch.as_tensor(shell["U"]), torch.as_tensor(shell["W"])
    gen = tsp._assembler("dx")
    r_gen, t_gen = tree_jvp(lambda a: gen.residual_vector(t_shell, a), U, W)
    assert rel(asm.residual_vector(t_shell, U), r_gen) <= 1e-12
    assert rel(asm.tangent_action(t_shell, U, W), t_gen) <= 1e-12
