"""tigar_tpu_torch's interface forms against tigar_tpu's, on the same
multi-patch plates (host numpy inputs to both, f64 unless stated):

  - the merged-breakpoint interface quadrature and its data (jet rows,
    connectivity, wq, nu, surfJ, the orientation sign, the support) on the
    two-patch plate (14 x 14 against 14 x 18 elements) and on the second
    interface of the three-patch L: 1e-13;
  - ShellInterfaceCoupling's energy, residual, tangent block and jump
    diagnostics at a seeded nonzero state: f64 1e-11, f32 1e-5 (relative
    to the largest entry; f32 sums in another order);
  - the forms carried across with ``convert`` (same residual as JAX);
  - the two-patch assembler (jets and the K1-twin residual): 1e-12; the
    port keeps mask None where the JAX package builds an all-ones mask.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu import interface as jax_interface
from tigar_tpu.solvers.newton_stencil_mp import _cast_pytree
from tigar_tpu_torch import convert
from tigar_tpu_torch.coupling import (ShellInterfaceCoupling,
                                      _shell_penalty_density)
from tigar_tpu_torch.interface import (iform_tangent_block_ref,
                                       merged_breakpoints)

from torch_parity import (as_np, jax_density, l_shell, rel, shell_coupling,
                          torch_density, two_patch)

PD, PR = 4.0e8, 1.0e4
CASES = {"two_patch": ((14, 14, 18), 0), "l_shell": (((4, 6), (5, 7),
                                                      (6, 4)), 1)}


def _pair(case):
    dims, which = CASES[case]
    if case == "two_patch":
        sj, st = two_patch("jax", *dims), two_patch("torch", *dims)
    else:
        sj, st = l_shell("jax", dims), l_shell("torch", dims)
    return (sj, st, shell_coupling("jax", sj, PD, PR, which),
            shell_coupling("torch", st, PD, PR, which))


@pytest.fixture(scope="module")
def pairs():
    return {c: _pair(c) for c in CASES}


def _state(ndof, seed=0, amp=1e-2):
    return amp * np.random.default_rng(seed).normal(size=ndof)


@pytest.mark.parametrize("what", ["rows", "weights", "conormal",
                                  "sign_support"])
@pytest.mark.parametrize("case", list(CASES))
def test_interface_data_matches_jax(pairs, case, what):
    sj, st, cj, ct = pairs[case]
    if what == "rows":
        for sj_, st_ in ((cj.side_a, ct.side_a), (cj.side_b, ct.side_b)):
            assert np.array_equal(as_np(st_.conn), np.asarray(sj_.conn))
            for k in ("R0", "R1"):
                assert rel(getattr(st_, k), getattr(sj_, k)) <= 1e-13
            assert rel(st_.qp.DF, sj_.qp.DF) <= 1e-13
            assert rel(st_.qp.pinv, sj_.qp.pinv) <= 1e-13
    elif what == "weights":
        # the free direction's knots of both sides, merged
        pa, pb, d = (0, 1, 1) if case == "two_patch" else (1, 2, 0)
        kv_t, kv_j = ([sp.space.fields[0].patches[i].kvs[d] for i in (pa, pb)]
                      for sp in (st, sj))
        assert rel(merged_breakpoints(*kv_t),
                   jax_interface.merged_breakpoints(*kv_j)) == 0.0
        for k in ("wq", "w_param", "surfJ"):
            assert rel(getattr(ct, k), getattr(cj, k)) <= 1e-13
        assert abs(ct.area - float(cj.area)) <= 1e-13 * float(cj.area)
    elif what == "conormal":
        assert rel(ct.nu, cj.nu) <= 1e-13
    else:
        assert ct.orient_sign == cj.orient_sign
        assert np.array_equal(ct.support, cj.support)
        idx_t, pa_t, pb_t = ct.support_positions()
        idx_j, pa_j, pb_j = cj.support_positions()
        for a, b in ((idx_t, idx_j), (pa_t, pa_j), (pb_t, pb_j)):
            assert np.array_equal(as_np(a), np.asarray(b))


@pytest.mark.parametrize("what", ["energy", "residual", "tangent_block",
                                  "jumps"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-5)])
def test_shell_coupling_matches_jax(pairs, what, dtype, tol):
    sj, st, cj, ct = pairs["two_patch"]
    U = _state(st.ndof)
    if dtype == torch.float32:
        cj, ct = _cast_pytree(cj, jnp.float32), ct.astype(dtype)
    Uj = jnp.asarray(U, dtype=jnp.float32 if dtype == torch.float32
                     else jnp.float64)
    Ut = torch.as_tensor(U, dtype=dtype)
    if what == "energy":
        e_t, e_j = float(ct.energy(Ut)), float(cj.energy(Uj))
        assert abs(e_t - e_j) <= tol * abs(e_j)
    elif what == "residual":
        r_t = ct.residual(Ut)
        assert r_t.dtype == dtype
        assert rel(r_t, cj.residual(Uj)) <= tol
    elif what == "tangent_block":
        idx_t, K_t = ct.tangent_block(Ut)
        idx_j, K_j = cj.tangent_block(Uj)
        assert np.array_equal(idx_t, idx_j) and K_t.dtype == dtype
        assert rel(K_t, K_j) <= tol
        assert rel(K_t, K_t.T) <= tol         # a Hessian
    else:
        for fn in ("jump_norm", "rotation_jump_norm"):
            a, b = float(getattr(ct, fn)(Ut)), float(getattr(cj, fn)(Uj))
            assert abs(a - b) <= tol * abs(b), fn


def test_forms_carried_across_match_jax(pairs):
    """convert: the JAX form's arrays in a port form give JAX's residual
    and tangent block (the kernels' plain versions on identical data)."""
    sj, st, cj, _ = pairs["l_shell"]
    arrays = convert.interface_arrays(cj)
    form = convert.interface_from_numpy(arrays, ShellInterfaceCoupling,
                                        _shell_penalty_density, st.ndof,
                                        device="cpu")
    U = _state(st.ndof, seed=1)
    assert rel(form.residual(torch.as_tensor(U)),
               cj.residual(jnp.asarray(U))) <= 1e-11
    idx, pa, pb = form.support_positions()
    K = iform_tangent_block_ref(form, torch.as_tensor(U)[idx.long()], pa,
                                pb, form.params)
    assert rel(K, cj.tangent_block(jnp.asarray(U))[1]) <= 1e-11


@pytest.mark.parametrize("what", ["jets", "residual"])
def test_multipatch_assembler_matches_jax(pairs, what):
    sj, st, _, _ = pairs["two_patch"]
    asm_j, asm_t = sj._assembler("dx"), st._assembler("dx")
    # equal-degree patches: the port leaves the mask out (K1/K2 take
    # unmasked tabulations), the JAX package carries all ones
    assert all(m is None for m in asm_t.masks)
    assert np.all(np.asarray(asm_j.masks[0]) == 1.0)
    assert np.array_equal(as_np(asm_t.cat_conn), np.asarray(asm_j.cat_conn))
    U = _state(st.ndof, seed=2)
    if what == "jets":
        jt, jj = asm_t.jets(torch.as_tensor(U)), asm_j.jets(jnp.asarray(U))
        for a, b in zip(jt, jj):
            assert rel(a, b) <= 1e-12
    else:
        r_t = asm_t.residual_vector_adjoint(torch_density(1.0),
                                            torch.as_tensor(U))
        r_j = asm_j.residual_vector_adjoint(jax_density(1.0), jnp.asarray(U))
        assert rel(r_t, r_j) <= 1e-12


def test_no_kernel_density_raises_on_card_only(pairs):
    """A form whose density has no kernel names it (checked through the
    dispatch; the CPU path runs the plain version)."""
    st = pairs["two_patch"][1]
    from tigar_tpu_torch.coupling import PenaltyInterfaceCoupling
    pen = PenaltyInterfaceCoupling(st, 0, (0, 1), 1, (0, 0), penalty=1e3)
    with pytest.raises(NotImplementedError, match="_penalty_density"):
        pen.residual_cuda(torch.zeros(st.ndof), pen.params)
    assert torch.isfinite(pen.residual(torch.as_tensor(_state(st.ndof)))
                          ).all()
