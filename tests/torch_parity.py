"""Shared helpers of the tigar_tpu_torch parity tests: the same clamped SVK
shell plate built by the JAX package and by the port, and the error
measure the tolerances are stated in.  Inputs are made with numpy and
handed to both packages as arrays."""

import numpy as np

E_MOD, NU, H_TH = 1.0e7, 0.3, 0.03


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
