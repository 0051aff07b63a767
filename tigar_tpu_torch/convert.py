"""Carry assembler and stencil state across as numpy arrays.

``assembler_arrays(asm)`` reads the arrays of a shell volume assembler —
of this package, or of tigar_tpu (duck-typed through ``np.asarray``, so
no jax import here) — into a dict of numpy arrays:

    conn [nel, nen] int32 (the shared scalar-basis connectivity),
    cat_conn [nel, nf*nen], offsets, ndof,
    N [nel, nq, nen], dN [.., d], d2N [.., d, d], scale [nel, nq],
    mask [nel, nen] (the padding mask of a ragged basis) or None,
    DF [nel, nq, nsd, d], d2F [.., d, d],
    shell_ref_a / shell_ref_b / shell_ref_ea [nel, nq, 2, 2]

``assembler_from_numpy(arrays, device, dtype)`` builds this package's
``DomainAssembler`` from such a dict, and ``stencil_from_numpy`` does the
same for stencils.  ``mp_operator_arrays``/``mp_operator_from_numpy`` carry
a multi-patch operator (per-patch stencils, interface blocks idx, K, Sinv)
and ``interface_arrays``/``interface_from_numpy`` an interface form (both
sides' SideData, wq, nu, w_param, surfJ, params), ``mlsa_arrays``/
``mlsa_from_numpy`` a smoothed-aggregation hierarchy,
``twolevel_sa_arrays``/``twolevel_sa_from_numpy`` a two-level one,
``elem_tangent_from_numpy`` an element-batch tangent,
``laplace_layouts_from_numpy`` the layouts of the f32 fast-path apply and
``point_contact_arrays``/``point_contact_from_numpy`` the state of a
penalty contact (points, evaluation rows, weights, pair mask) and
``sumfac_assembler_arrays``/``sumfac_assembler_from_numpy`` a
sum-factorized assembler (1D tables, windows, ctx leaves, scale) and
``tspline_arrays``/``tspline_from_numpy`` a T-spline extraction (nodes,
operators, ncp) with its homogeneous control net.
Tests use them to feed
identical inputs to the JAX functions and to this package's kernels and
twins, independent of either package's own preprocessing.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .config import INDEX_TYPE, resolve_device
from .forms import QP
from .models.shell import ShellReference
from .ops.assembly import DomainAssembler
from .ops.stencil import StencilOperator


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assembler_arrays(asm):
    """numpy arrays of an equal-order shell volume assembler (see module
    docstring).  Raises unless all fields share one tabulation."""
    for f in range(1, asm.nfields):
        for name in ("conns", "Ns", "dNs", "d2Ns", "masks"):
            a, b = getattr(asm, name)[f], getattr(asm, name)[0]
            if (a is None) != (b is None) or (
                    a is not None and not np.array_equal(_np(a), _np(b))):
                raise ValueError("assembler_arrays needs equal-order fields")
    mask = asm.masks[0]
    out = {
        "conn": _np(asm.conns[0]).astype(INDEX_TYPE),
        "cat_conn": _np(asm.cat_conn).astype(INDEX_TYPE),
        "offsets": np.asarray(asm.offsets, dtype=np.int64),
        "ndof": int(asm.ndof),
        "N": _np(asm.Ns[0]), "dN": _np(asm.dNs[0]), "d2N": _np(asm.d2Ns[0]),
        "scale": _np(asm.scale),
        "mask": None if mask is None else _np(mask),
        "DF": _np(asm.ctx.DF), "d2F": _np(asm.ctx.d2F),
    }
    sref = (asm.ctx.aux or {}).get("shell_ref")
    if sref is not None:
        out.update(shell_ref_a=_np(sref.a), shell_ref_b=_np(sref.b),
                   shell_ref_ea=_np(sref.ea))
    return out


def assembler_from_numpy(arrays, device="cuda", dtype=torch.float64):
    """This package's DomainAssembler from ``assembler_arrays`` output."""
    device = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    offsets = np.asarray(arrays["offsets"], dtype=np.int64)
    nf = len(offsets) - 1
    tab = types.SimpleNamespace(conn=np.asarray(arrays["conn"]),
                                N=arrays["N"], dN=arrays["dN"],
                                d2N=arrays["d2N"],
                                mask=arrays.get("mask"))
    aux = None
    if "shell_ref_a" in arrays:
        aux = {"shell_ref": ShellReference(a=t("shell_ref_a"),
                                           b=t("shell_ref_b"),
                                           ea=t("shell_ref_ea"))}
    ctx = QP(xi=None, x=None, w=None, wg=None, wh=None, DF=t("DF"),
             d2F=t("d2F"), g=None, ginv=None, sqrtJ=None, pinv=None,
             aux=aux)
    asm = DomainAssembler([tab] * nf, offsets, int(arrays["ndof"]), ctx,
                          t("scale"))
    if "cat_conn" in arrays and not np.array_equal(
            asm.cat_conn.cpu().numpy(), np.asarray(arrays["cat_conn"])):
        raise ValueError("cat_conn does not match conn and offsets")
    return asm


def stencil_from_numpy(S, grid_shape, degrees, nf, device="cuda",
                       dtype=torch.float64):
    """This package's StencilOperator from a numpy stencil array."""
    return StencilOperator(torch.as_tensor(np.array(S), dtype=dtype,
                                           device=resolve_device(device)),
                           grid_shape, degrees, nf)


def mp_operator_arrays(op):
    """numpy arrays of a multi-patch stencil operator (this package's or
    tigar_tpu's): per patch S, grid_shape, degrees; per interface block
    idx, K and Sinv (None when absent); the layout offsets."""
    return {
        "S": [_np(st.S) for st in op.sts],
        "grid_shape": [tuple(st.grid_shape) for st in op.sts],
        "degrees": [tuple(st.degrees) for st in op.sts],
        "idx": [_np(b.idx).astype(INDEX_TYPE) for b in op.ifaces],
        "K": [_np(b.K) for b in op.ifaces],
        "Sinv": [None if b.Sinv is None else _np(b.Sinv)
                 for b in op.ifaces],
        "foffsets": tuple(op.foffsets), "doffsets": tuple(op.doffsets),
        "nf": int(op.nf)}


def mp_operator_from_numpy(arrays, device="cuda", dtype=torch.float64):
    """This package's MultiPatchStencilOperator from ``mp_operator_arrays``
    output (S and K in ``dtype``; Sinv keeps its arrays' type, the
    preconditioner's float32 when it comes from an operator build)."""
    from .solvers.newton_stencil_mp import IfaceBlock, MultiPatchStencilOperator
    device = resolve_device(device)
    nf = arrays["nf"]
    sts = [stencil_from_numpy(S, g, d, nf, device, dtype)
           for S, g, d in zip(arrays["S"], arrays["grid_shape"],
                              arrays["degrees"])]
    blocks = [IfaceBlock(
        torch.as_tensor(np.array(i, dtype=INDEX_TYPE), device=device),
        torch.as_tensor(np.array(K), dtype=dtype, device=device),
        None if Si is None else torch.as_tensor(np.array(Si),
                                                device=device))
        for i, K, Si in zip(arrays["idx"], arrays["K"], arrays["Sinv"])]
    return MultiPatchStencilOperator(sts, blocks, arrays["foffsets"],
                                     arrays["doffsets"], nf)


_SIDE_QP = ("xi", "x", "DF", "d2F", "d3F", "w0", "w1", "w2", "w3", "pinv",
            "nu_flat")


def _float_params(p):
    """A parameter dict (nested dicts allowed, e.g. the Nitsche form's
    {"beta_d", "beta_r", "w": {...}}) with every leaf as a Python float."""
    return {k: (_float_params(v) if isinstance(v, dict) else float(v))
            for k, v in p.items()}


def interface_arrays(form):
    """numpy arrays of an interface form (this package's or tigar_tpu's):
    per side conn, R0..R3 and the SideQP leaves (None stays None), plus
    wq, nu, w_param, surfJ, params, fields and the jet order."""
    def side(sd):
        out = {k: (None if getattr(sd, k) is None else _np(getattr(sd, k)))
               for k in ("conn", "R0", "R1", "R2", "R3")}
        out["conn"] = out["conn"].astype(INDEX_TYPE)
        out["qp"] = {k: (None if getattr(sd.qp, k) is None
                         else _np(getattr(sd.qp, k))) for k in _SIDE_QP}
        return out
    return {"side_a": side(form.side_a), "side_b": side(form.side_b),
            "wq": _np(form.wq), "nu": _np(form.nu),
            "w_param": _np(form.w_param), "surfJ": _np(form.surfJ),
            "params": _float_params(form.params),
            "fields": list(form.fields), "nders": int(form._nders)}


def interface_from_numpy(arrays, cls, density, ndof, device="cuda",
                         dtype=torch.float64):
    """An interface form of class ``cls`` (an InterfaceForm subclass, e.g.
    coupling.ShellInterfaceCoupling, or interface.EnergyNitscheCoupling
    with an ``interface.NitscheDensity``) with ``density`` over ``ndof``
    DoFs from ``interface_arrays`` output, without a spline."""
    from .interface import SideData, SideQP
    device = resolve_device(device)

    def t(a, dt=dtype):
        return None if a is None else torch.as_tensor(np.array(a), dtype=dt,
                                                      device=device)

    def side(d):
        qp = SideQP(**{k: t(d["qp"][k]) for k in _SIDE_QP})
        return SideData(conn=t(d["conn"], torch.int32), R0=t(d["R0"]),
                        R1=t(d["R1"]), R2=t(d["R2"]), R3=t(d["R3"]), qp=qp)

    form = cls.__new__(cls)
    form.density = density
    form.ndof = int(ndof)
    form.params = _float_params(arrays["params"])
    form.fields = list(arrays["fields"])
    form._nders = int(arrays["nders"])
    form.side_a, form.side_b = side(arrays["side_a"]), side(arrays["side_b"])
    for k in ("wq", "nu", "w_param", "surfJ"):
        setattr(form, k, t(arrays[k]))
    form._support = None
    form._pos = None
    return form



_SA_LEVEL = ("A_cols", "A_vals", "om_dinv", "P_cols", "P_vals", "Pt_cols",
             "Pt_vals")


def mlsa_arrays(sa):
    """numpy arrays of a multilevel SA hierarchy (this package's or
    tigar_tpu's ``MultilevelSA``): per level the ELL operator,
    prolongation and transpose (cols, vals) and om_dinv; the coarsest
    inverse, n_smooth, the cycle and ndof.  The fine operator, when the
    hierarchy has one, is not carried."""
    return {"levels": [{k: _np(a) for k, a in zip(_SA_LEVEL, lv)}
                       for lv in sa._levels],
            "coarse_inv": _np(sa._coarse_inv), "ndof": int(sa._ndof),
            "n_smooth": int(sa._n_smooth), "cycle": str(sa._cycle)}


def mlsa_from_numpy(arrays, device="cuda", fine_op=None, fine_mask=None):
    """This package's MultilevelSA from ``mlsa_arrays`` output (cols
    int32, values float32, as the cycle computes), with an optional BC'd
    fine operator for level 0."""
    from .solvers.aggregation import MultilevelSA
    device = resolve_device(device)

    def t(k, a):
        dt = torch.int32 if k.endswith("cols") else torch.float32
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    levels = [tuple(t(k, lv[k]) for k in _SA_LEVEL)
              for lv in arrays["levels"]]
    return MultilevelSA(levels, t("coarse_inv", arrays["coarse_inv"]),
                        arrays["ndof"], arrays["n_smooth"],
                        cycle=arrays["cycle"], fine_op=fine_op,
                        fine_mask=fine_mask)


def elem_tangent_from_numpy(conn, E, ndof, device="cuda",
                            dtype=torch.float64):
    """This package's ElemTangent from numpy connectivity [nel, nloc] and
    element matrices [nel, nloc, nloc]."""
    from .solvers.newton_sa import ElemTangent
    device = resolve_device(device)
    return ElemTangent(
        torch.as_tensor(np.array(conn, dtype=INDEX_TYPE), device=device),
        torch.as_tensor(np.array(E), dtype=dtype, device=device), ndof)


def laplace_layouts_from_numpy(A1, A2, connT, device="cuda"):
    """(A1, A2, connT) of the fast-path stiffness apply (ops/fastpath.py)
    from numpy: layouts float32 [nen * nq * d, nel], connT int32 [nen,
    nel]."""
    device = resolve_device(device)

    def t(a, dt):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    return (t(A1, torch.float32), t(A2, torch.float32),
            t(connT, torch.int32))


_TWOLEVEL = ("_rows", "_cols", "_vals", "_dinv", "_P", "_Ac_inv")


def twolevel_sa_arrays(pre):
    """numpy arrays of a two-level SA preconditioner (this package's or
    tigar_tpu's ``TwoLevelSA``): the coo operator, dinv, P, Ac_inv (as
    stored, float32), omega, n_smooth and ndof."""
    out = {k[1:]: _np(getattr(pre, k)) for k in _TWOLEVEL}
    out.update(omega=float(pre._omega), n_smooth=int(pre._n_smooth),
               ndof=int(pre._ndof))
    return out


def twolevel_sa_from_numpy(arrays, device="cuda"):
    """This package's TwoLevelSA from ``twolevel_sa_arrays`` output (rows
    and cols int64, values float32; the ELL copy built from the coo)."""
    from .solvers.aggregation import TwoLevelSA
    device = resolve_device(device)

    def t(k, dt):
        return torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)

    return TwoLevelSA(t("rows", torch.int64), t("cols", torch.int64),
                      t("vals", torch.float32), t("dinv", torch.float32),
                      t("P", torch.float32), t("Ac_inv", torch.float32),
                      omega=arrays["omega"], n_smooth=arrays["n_smooth"],
                      ndof=arrays["ndof"])


_CONTACT = ("conn", "vals", "X", "w_ctrl", "quad_w", "pair_mask")


def point_contact_arrays(contact, k=None):
    """numpy arrays of a PointContact (this package's or tigar_tpu's):
    conn, vals, X, w_ctrl, quad_w, pair_mask, and k / r_max / r_self /
    row_chunk.  ``k``: the penalty of a contact that does not keep it
    (tigar_tpu's keeps only its potential)."""
    out = {name: _np(getattr(contact, name)) for name in _CONTACT}
    out.update(k=float(contact.k if k is None else k),
               r_max=float(contact.r_max), r_self=float(contact.r_self),
               row_chunk=contact.row_chunk)
    return out


def point_contact_from_numpy(arrays, spline, device="cuda",
                             dtype=torch.float64):
    """This package's PointContact on ``spline`` (the port's spline of the
    same space) from ``point_contact_arrays`` output, with the default
    potential."""
    from .contact import PointContact, pair_penalty_energy
    device = resolve_device(device)
    obj = PointContact.__new__(PointContact)
    obj.spline = spline
    obj.k, obj.r_max, obj.r_self = (float(arrays[k])
                                    for k in ("k", "r_max", "r_self"))
    obj.custom_phi = None
    obj.phi = pair_penalty_energy(obj.k, obj.r_max)
    obj.nsd = spline.space.nsd
    obj._set_arrays(arrays["conn"], arrays["vals"], arrays["X"],
                    arrays["w_ctrl"], arrays["quad_w"], arrays["pair_mask"],
                    device, dtype, arrays["row_chunk"])
    return obj


def sumfac_assembler_arrays(asm):
    """numpy arrays of a sum-factorized assembler (this package's or
    tigar_tpu's): per field its 1D tables ``tabs`` [[nel, nq, nders+1,
    pp] per direction], gather windows ``idxs`` (int32, None for slide
    directions), ``metas``, ``ncp_ds`` and ``nders``; ``offsets``, ``ndof``,
    ``scale`` [NQ], the ctx leaves ``ctx`` {name: [NQ, ...] or None} and the
    shell reference under shell_ref_a / _b / _ea when the ctx carries
    one."""
    ctx = {k: None if v is None else _np(v)
           for k, v in asm.ctx._asdict().items() if k != "aux"}
    out = {
        "offsets": np.asarray(asm.offsets, dtype=np.int64),
        "ndof": int(asm.ndof),
        "scale": _np(asm.scale),
        "ctx": ctx,
        "tabs": [[_np(t) for t in tf] for tf in asm.tabs],
        "idxs": [[None if i is None else _np(i).astype(INDEX_TYPE)
                  for i in f] for f in asm.idxs],
        "metas": [tuple(tuple(m) for m in f) for f in asm.metas],
        "ncp_ds": [tuple(int(n) for n in f) for f in asm.ncp_ds],
        "nders": [int(n) for n in asm.nders],
    }
    sref = (asm.ctx.aux or {}).get("shell_ref")
    if sref is not None:
        out.update(shell_ref_a=_np(sref.a), shell_ref_b=_np(sref.b),
                   shell_ref_ea=_np(sref.ea))
    return out


def sumfac_assembler_from_numpy(arrays, device="cuda", dtype=torch.float64):
    """This package's SumfacAssembler from ``sumfac_assembler_arrays``
    output; consecutive fields with identical tables share one plan (one
    K15/K16 launch)."""
    from .ops.sumfac_forms import DevicePlan, SumfacAssembler
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.array(a), dtype=dtype, device=device)

    plans = []
    for f, (tabs, idxs, metas, ncp_d, nders) in enumerate(zip(
            arrays["tabs"], arrays["idxs"], arrays["metas"],
            arrays["ncp_ds"], arrays["nders"])):
        prev = f and (arrays["metas"][f - 1], arrays["ncp_ds"][f - 1],
                      arrays["nders"][f - 1])
        if f and prev == (metas, ncp_d, nders) and all(
                np.array_equal(a, b) for a, b in zip(
                    tabs, arrays["tabs"][f - 1])) and all(
                (a is None and b is None) or (
                    a is not None and b is not None
                    and np.array_equal(a, b))
                for a, b in zip(idxs, arrays["idxs"][f - 1])):
            plans.append(plans[-1])
            continue
        plans.append(DevicePlan.from_tensors(
            [t(x) for x in tabs],
            [None if i is None else torch.as_tensor(
                np.asarray(i, dtype=np.int64), device=device)
             for i in idxs],
            [tuple(m) for m in metas], tuple(ncp_d), int(nders)))
    aux = None
    if "shell_ref_a" in arrays:
        aux = {"shell_ref": ShellReference(a=t(arrays["shell_ref_a"]),
                                           b=t(arrays["shell_ref_b"]),
                                           ea=t(arrays["shell_ref_ea"]))}
    ctx = QP(**{k: t(v) for k, v in arrays["ctx"].items()}, aux=aux)
    return SumfacAssembler(plans, arrays["offsets"], arrays["ndof"], ctx,
                           t(arrays["scale"]))


def tspline_arrays(basis, bnet):
    """numpy arrays of a T-spline extraction (this package's TSplineBasis or
    tigar_tpu's): the per-element node lists and [nshl, 16] extraction
    operators, ncp, and the homogeneous control net bnet [ncp, 4]."""
    return {"nodes_list": [np.asarray(n, dtype=np.int64)
                           for n in basis.nodes_list],
            "ops_list": [np.asarray(C, dtype=np.float64)
                         for C in basis.ops_list],
            "ncp": int(basis.ncp), "bnet": np.asarray(bnet, np.float64)}


def tspline_from_numpy(arrays):
    """(TSplineBasis, bnet) of this package from ``tspline_arrays``
    output."""
    from .models.tsplines import TSplineBasis
    basis = TSplineBasis(nodes_list=arrays["nodes_list"],
                         ops_list=arrays["ops_list"], ncp=arrays["ncp"])
    return basis, np.array(arrays["bnet"], dtype=np.float64)
