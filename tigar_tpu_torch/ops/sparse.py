"""Unstructured sparse operator applies of the space-agnostic Newton tier
(solvers/newton_sa.py) and its smoothed-aggregation V-cycle
(solvers/aggregation.py).

Two hand kernels live behind this module:
  - K10 (csrc/elem_tangent.cu), ``elem_tangent_apply`` and
    ``elem_tangent_diagonal`` on CUDA tensors: the element-batch tangent
    y = scatter(conn, E x[conn]), fused with the BC mask (m * A(m * x) +
    (1 - m) x), reading E's upper triangle only (E is the Hessian of an
    energy), and its diagonal.  Replaces tigar_tpu/solvers/newton_sa.py
    ElemTangent.__call__ / .diagonal and _masked_act.  Plain versions:
    the ``*_ref`` functions (gather, einsum, index_add_).
  - K11 (csrc/ell_spmv.cu), ``ell_spmv`` on CUDA tensors: the padded-row
    (ELL) product y_i = sum_k vals[i, k] x[cols[i, k]], its residual
    b - A x, or the weighted-Jacobi update x + om_dinv (b - A x).
    Replaces the gather-contracts of tigar_tpu/solvers/aggregation.py
    _mlsa_apply.  Plain version: ``ell_spmv_ref``.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_ext

ELL_MODES = {"apply": 0, "residual": 1, "jacobi": 2}
_FLOATS = (torch.float32, torch.float64)


def elem_tangent_apply(conn, E, x, mask=None):
    """Element-batch operator action (conn [nel, nloc] global DoF indices
    into x, E [nel, nloc, nloc]): scatter(conn, E (m x)[conn]) m +
    (1 - m) x, the BC'd action, or the plain scatter(conn, E x[conn])
    when ``mask`` is None.  CUDA tensors run kernel K10, which reads E's
    upper triangle and so takes E as symmetric (the SANewton tangents are
    Hessians); CPU tensors run ``elem_tangent_apply_ref``."""
    if E.is_cuda:
        return elem_tangent_apply_cuda(conn, E, x, mask)
    return elem_tangent_apply_ref(conn, E, x, mask)


def elem_tangent_diagonal(conn, E, ndof):
    """scatter(conn, diag E) over ``ndof`` DoFs: K10's diagonal kernel on
    CUDA tensors, ``elem_tangent_diagonal_ref`` on CPU tensors."""
    if E.is_cuda:
        return elem_tangent_diagonal_cuda(conn, E, ndof)
    return elem_tangent_diagonal_ref(conn, E, ndof)


def elem_tangent_apply_ref(conn, E, x, mask=None):
    """Plain PyTorch version of K10's apply."""
    u = x if mask is None else mask * x
    y = torch.einsum("eab,eb->ea", E, u[conn])
    y = torch.zeros_like(x).index_add_(0, conn.reshape(-1), y.reshape(-1))
    return y if mask is None else mask * y + (1.0 - mask) * x


def elem_tangent_diagonal_ref(conn, E, ndof):
    """Plain PyTorch version of K10's diagonal."""
    d = torch.diagonal(E, dim1=1, dim2=2)
    return torch.zeros(ndof, dtype=E.dtype, device=E.device).index_add_(
        0, conn.reshape(-1), d.reshape(-1))


def _check_elem(conn, E):
    nel, nloc = conn.shape
    if E.dtype not in _FLOATS:
        raise TypeError(f"E has dtype {E.dtype}")
    if tuple(E.shape) != (nel, nloc, nloc) or conn.dtype != torch.int32:
        raise ValueError(f"conn {tuple(conn.shape)} {conn.dtype} and E "
                         f"{tuple(E.shape)} do not match")
    if nloc > 64:
        raise ValueError(f"K10 takes at most 64 local functions, got {nloc}")
    for name, t in (("conn", conn), ("E", E)):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")


def elem_tangent_apply_cuda(conn, E, x, mask=None):
    """Kernel K10: E's upper triangles (E is symmetric) copied into shared
    memory, several elements a block, one thread per (element, local row)
    summing its row from the triangle, atomicAdd of the masked row sums
    into y, whose (1 - m) x part a first launch writes."""
    _check_elem(conn, E)
    for name, t in (("x", x), ("mask", mask)):
        if t is None:
            continue
        if t.dtype != E.dtype:
            raise TypeError(f"{name} {t.dtype} vs E {E.dtype}")
        if t.dim() != 1 or not (t.is_cuda and t.is_contiguous()) or \
                t.shape != x.shape:
            raise ValueError(f"{name}: a contiguous CUDA vector of shape "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
    y = cuda_ext.load().elem_tangent_apply(conn, E, x, mask)
    cuda_ext.count("elem_tangent_apply")
    return y


def elem_tangent_diagonal_cuda(conn, E, ndof):
    """K10's diagonal: one thread per (element, local row), atomicAdd."""
    _check_elem(conn, E)
    d = cuda_ext.load().elem_tangent_diagonal(conn, E, int(ndof))
    cuda_ext.count("elem_tangent_diagonal")
    return d


def ell_spmv(cols, vals, x, b=None, om_dinv=None, mode="apply"):
    """Padded-row (ELL) sparse product (cols [n, K] int32, vals [n, K];
    padding slots carry value 0):

      "apply"    : A x
      "residual" : b - A x
      "jacobi"   : x + om_dinv (b - A x)   (square A)

    CUDA tensors run kernel K11; CPU tensors run ``ell_spmv_ref``."""
    if vals.is_cuda:
        return ell_spmv_cuda(cols, vals, x, b, om_dinv, mode)
    return ell_spmv_ref(cols, vals, x, b, om_dinv, mode)


def ell_spmv_ref(cols, vals, x, b=None, om_dinv=None, mode="apply"):
    """Plain PyTorch version of K11 (the einsum gather-contract)."""
    Ax = torch.einsum("ik,ik->i", vals, x[cols])
    if mode == "apply":
        return Ax
    if mode == "residual":
        return b - Ax
    if mode == "jacobi":
        return x + om_dinv * (b - Ax)
    raise ValueError(f"unknown ELL mode {mode!r}")


def ell_spmv_cuda(cols, vals, x, b=None, om_dinv=None, mode="apply"):
    """Kernel K11: one warp per row, the lanes striding over the row's
    slots (coalesced reads of cols and vals), a shuffle reduction and the
    mode's epilogue; no atomics."""
    if mode not in ELL_MODES:
        raise ValueError(f"unknown ELL mode {mode!r}")
    n, K = cols.shape
    need = {"apply": (), "residual": ("b",),
            "jacobi": ("b", "om_dinv")}[mode]
    if vals.dtype not in _FLOATS or x.dtype != vals.dtype:
        raise TypeError(f"vals {vals.dtype} and x {x.dtype}: one float type")
    if tuple(vals.shape) != (n, K) or cols.dtype != torch.int32:
        raise ValueError(f"cols {tuple(cols.shape)} {cols.dtype} and vals "
                         f"{tuple(vals.shape)} do not match")
    vecs = {"b": b, "om_dinv": om_dinv}
    for k in need:
        v = vecs[k]
        if v is None or v.shape != (n,) or v.dtype != x.dtype:
            raise ValueError(f"mode {mode!r} needs {k} of shape ({n},)")
    if mode == "jacobi" and x.shape != (n,):
        raise ValueError("the Jacobi mode needs a square operator")
    for name, t in (("cols", cols), ("vals", vals), ("x", x)) + tuple(
            (k, vecs[k]) for k in need):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    ext = cuda_ext.load()
    y = ext.ell_spmv(cols, vals, x, vecs["b"] if need else None,
                     om_dinv if mode == "jacobi" else None, ELL_MODES[mode])
    cuda_ext.count("ell_spmv")
    return y
