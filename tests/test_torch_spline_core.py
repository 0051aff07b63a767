"""tigar_tpu_torch's host spline core and preprocessing against tigar_tpu:
knots, tabulations, BC masks, knot-insertion transfers, geometry and the
shell reference frame (max abs diff <= 1e-14 on the spline core, 1e-13
relative on derived geometry), plus the jax-free import of the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tigar_tpu.ops.knots as jknots
import tigar_tpu.solvers.multigrid as jmg
import tigar_tpu_torch.ops.knots as tknots
import tigar_tpu_torch.solvers.multigrid as tmg
from tigar_tpu.ops.tabulation import tabulate_tensor_bspline as jtab
from tigar_tpu_torch.ops.tabulation import tabulate_tensor_bspline as ttab
from tigar_tpu_torch.convert import assembler_arrays

from torch_parity import build_jax, build_torch, rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("p,nel", [(2, 6), (3, 5), (1, 4)])
def test_knot_vectors(p, nel):
    kj = jknots.KnotVector(p, jknots.uniform_knots(p, -1.0, 1.0, nel))
    kt = tknots.KnotVector(p, tknots.uniform_knots(p, -1.0, 1.0, nel))
    for name in ("knots", "unique_knots", "multiplicities", "ghost_knots"):
        assert np.max(np.abs(getattr(kj, name) - getattr(kt, name))) <= 1e-14
    assert np.max(np.abs(kj.greville() - kt.greville())) <= 1e-14
    assert np.array_equal(kj.element_nodes(), kt.element_nodes())
    assert (kj.ncp, kj.nel) == (kt.ncp, kt.nel)


@pytest.mark.parametrize("npts", [3, 2])
def test_tabulation(npts):
    kv = lambda mod: [mod.KnotVector(2, mod.uniform_knots(2, -1.0, 1.0, 6)),
                      mod.KnotVector(2, mod.uniform_knots(2, 0.0, 1.0, 5))]
    tj = jtab(kv(jknots), npts, 2)
    tt = ttab(kv(tknots), npts, 2)
    assert np.array_equal(tj.conn, tt.conn)
    for name in ("N", "dN", "d2N", "qp", "qw"):
        assert np.max(np.abs(getattr(tj, name) - getattr(tt, name))) <= 1e-14


def test_masks_and_side_dofs():
    sj, st = build_jax(6), build_torch(6)
    bj, bt = sj.space.fields[0], st.space.fields[0]
    for direction in (0, 1):
        for side in (0, 1):
            assert np.array_equal(bj.side_dofs(direction, side, n_layers=2),
                                  bt.side_dofs(direction, side, n_layers=2))
    assert np.array_equal(np.asarray(sj.mask), st.mask.numpy())
    assert sj.ndof == st.ndof == 3 * 8 * 8


def test_transfers():
    for nel in (8, 6):
        kf = [m.KnotVector(2, m.uniform_knots(2, -1.0, 1.0, nel))
              for m in (jknots, tknots)]
        cj = jmg.coarsen_knots(kf[0])
        ct = tmg.coarsen_knots(kf[1])
        assert np.array_equal(cj, ct)
        Pj = jmg.insertion_matrix_1d(jknots.KnotVector(2, cj), kf[0])
        Pt = tmg.insertion_matrix_1d(tknots.KnotVector(2, ct), kf[1])
        assert np.max(np.abs(Pj - Pt)) <= 1e-14


@pytest.mark.parametrize("quad_degree", [None, 2])
def test_preprocessing_reproduces_jax_arrays(quad_degree):
    """The port's own geometry and shell-reference preprocessing gives the
    arrays that the JAX assembler holds (what convert.assembler_from_numpy
    would otherwise carry across)."""
    sj, st = build_jax(6), build_torch(6)
    kw = {} if quad_degree is None else {"quad_degree": quad_degree}
    aj = assembler_arrays(sj._assembler("dx", **kw))
    at = assembler_arrays(st._assembler("dx", **kw))
    assert set(aj) == set(at)
    for k in ("conn", "cat_conn", "offsets"):
        assert np.array_equal(aj[k], at[k]), k
    for k in ("N", "dN", "d2N"):
        assert np.max(np.abs(aj[k] - at[k])) <= 1e-14, k
    for k in ("scale", "DF", "shell_ref_a", "shell_ref_ea"):
        assert rel(at[k], aj[k]) <= 1e-13, k
    # the flat plate's second derivatives and reference curvature are
    # roundoff around zero: compare absolutely
    for k in ("d2F", "shell_ref_b"):
        assert np.max(np.abs(at[k] - aj[k])) <= 1e-13, k


def test_import_without_jax():
    """tigar_tpu_torch imports with jax blocked (sys.modules['jax'] = None
    makes every ``import jax`` fail) and pulls in neither jax nor
    tigar_tpu."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import tigar_tpu_torch, tigar_tpu_torch.convert, "
            "tigar_tpu_torch.ops.cuda_ext; "
            "assert 'tigar_tpu' not in sys.modules; "
            "assert not any(m.startswith('jax.') for m in sys.modules); "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_tf32_disabled():
    import tigar_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
