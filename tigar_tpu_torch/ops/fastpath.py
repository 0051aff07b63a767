"""f32 fast-path stiffness apply for scalar spaces with explicit element
connectivity (port of tigar_tpu/ops/fastpath.py: ``laplace_layouts``,
``_laplace_apply``, ``make_laplace_operator``).

The operator is W -> mask * A (mask * W) + (1 - mask) * W, A the scalar
stiffness matrix.  The JAX package computes it per element from two
precomputed layouts (element axis last): A1 the trial gradients and A2
the test gradients weighted by qw * sqrtJ * ginv, each [nen * nq * d, nel]
in float32; ``laplace_layouts`` and ``laplace_apply_ref`` keep that form.
On the card the operator streams the element stiffness matrices instead
(``laplace_element_matrices``, computed once by ``make_laplace_operator``;
their upper triangles [nen (nen + 1) / 2, nel] are 1/7 of the layouts'
bytes at 2D p=2).  Paired with solvers/refinement.refine_solve it gives
f64 accuracy.

Kernel K12 (csrc/laplace_apply.cu) carries the element-matrix apply on
CUDA tensors (``laplace_apply_elem_cuda``); ``laplace_apply_elem_ref`` is
its plain version and runs for CPU tensors.
"""

from __future__ import annotations

import torch

from . import cuda_ext

F32 = torch.float32


def laplace_layouts(asm):
    """(A1, A2) of a scalar assembler: A1 = trial gradients, A2 = qw *
    sqrtJ * ginv-weighted test gradients, each [nen * nq * d, nel]
    float32, row (a * nq + q) * d + c."""
    if asm.nfields != 1:
        raise ValueError("fused Laplace apply expects a scalar space")
    dN = asm.dNs[0]                                   # [nel, nq, nen, d]
    nel, nq, nen, d = dN.shape
    G = asm.ctx.ginv * asm.scale[..., None, None]     # [nel, nq, d, d]
    dNG = torch.einsum("eqac,eqdc->eqad", dN, G)
    A1 = dN.permute(2, 1, 3, 0).reshape(nen * nq * d, nel)
    A2 = dNG.permute(2, 1, 3, 0).reshape(nen * nq * d, nel)
    return A1.to(F32).contiguous(), A2.to(F32).contiguous()


def _pack(K, dtype):
    """[nel, nen, nen] -> symmetric part's upper triangle [nen (nen + 1) /
    2, nel] in ``dtype``, rows row-major over a <= b."""
    nen = K.shape[-1]
    a, b = torch.triu_indices(nen, nen, device=K.device)
    Ks = 0.5 * (K + K.transpose(1, 2))
    return Ks[:, a, b].t().to(dtype).contiguous()


def _unpack_index(nen, device):
    """[nen, nen] row of K_e[a][b] in the packed upper triangle."""
    a, b = torch.triu_indices(nen, nen, device=device)
    P = torch.empty((nen, nen), dtype=torch.long, device=device)
    k = torch.arange(a.numel(), device=device)
    P[a, b] = k
    P[b, a] = k
    return P


def laplace_element_matrices(asm, dtype=F32):
    """Element stiffness matrices K_e = sum_q dN^T (ginv * scale) dN of a
    scalar assembler, summed in float64 from the data of
    ``laplace_layouts``, as their upper triangles [nen (nen + 1) / 2, nel]
    in ``dtype`` (row a nen - a (a - 1) / 2 + b - a holds K_e[a][b])."""
    if asm.nfields != 1:
        raise ValueError("fused Laplace apply expects a scalar space")
    dN = asm.dNs[0].to(torch.float64)                 # [nel, nq, nen, d]
    G = (asm.ctx.ginv * asm.scale[..., None, None]).to(torch.float64)
    K = torch.einsum("eqac,eqdc,eqbd->eab", dN, G, dN)
    return _pack(K, dtype)


def laplace_element_matrices_from_layouts(A1, A2, nen, dtype=F32):
    """The packed K_e of ``laplace_element_matrices`` from the layouts
    (A1, A2) [nen * M, nel]: K_e[a][b] = sum_m A2[a M + m] A1[b M + m],
    summed in float64, symmetrized."""
    if A1.dtype != F32 or A2.dtype != F32:
        raise TypeError(f"layouts must be float32, got {A1.dtype}, "
                        f"{A2.dtype}")
    if A1.shape != A2.shape or A1.dim() != 2 or A1.shape[0] % nen:
        raise ValueError(f"layouts {tuple(A1.shape)}, {tuple(A2.shape)} do "
                         f"not split into {nen} local functions")
    M, nel = A1.shape[0] // nen, A1.shape[1]
    K = torch.einsum("amn,bmn->nab",
                     A2.reshape(nen, M, nel).to(torch.float64),
                     A1.reshape(nen, M, nel).to(torch.float64))
    return _pack(K, dtype)


def laplace_apply(A1, A2, connT, mask, W):
    """mask * A (mask * W) + (1 - mask) * W in float32, returned in W's
    type, from the JAX package's layouts.  connT [nen, nel] int32.  CUDA
    tensors build the element matrices and run kernel K12; CPU tensors run
    ``laplace_apply_ref``."""
    if A1.is_cuda:
        Ke = laplace_element_matrices_from_layouts(A1, A2, connT.shape[0])
        return laplace_apply_elem_cuda(Ke, connT, mask, W)
    return laplace_apply_ref(A1, A2, connT, mask, W)


def laplace_apply_ref(A1, A2, connT, mask, W):
    """The JAX package's ``_laplace_apply`` on its layouts: gather, two
    contractions, scatter-add, BC epilogue."""
    nen = connT.shape[0]
    c = connT.long()
    Wm = (mask * W).to(F32)
    ue = Wm[c]                                         # [nen, nel]
    m = A1.shape[0] // nen
    g = torch.einsum("amn,an->mn", A1.reshape(nen, m, -1), ue)
    re = torch.einsum("amn,mn->an", A2.reshape(nen, m, -1), g)
    r = torch.zeros(W.shape[0], dtype=F32, device=W.device).index_add_(
        0, c.reshape(-1), re.reshape(-1))
    return (mask * r + (1.0 - mask) * W).to(W.dtype)


def laplace_apply_elem(Ke, connT, mask, W):
    """mask * A (mask * W) + (1 - mask) * W in float32, returned in W's
    type, from the packed element matrices Ke.  CUDA tensors run kernel
    K12; CPU tensors run ``laplace_apply_elem_ref``."""
    if Ke.is_cuda:
        return laplace_apply_elem_cuda(Ke, connT, mask, W)
    return laplace_apply_elem_ref(Ke, connT, mask, W)


def laplace_apply_elem_ref(Ke, connT, mask, W):
    """Plain PyTorch version of K12: gather, the element matrices' product,
    scatter-add, BC epilogue."""
    nen = connT.shape[0]
    c = connT.long()
    ue = (mask * W).to(F32)[c]                         # [nen, nel]
    K = Ke[_unpack_index(nen, Ke.device)]              # [nen, nen, nel]
    re = torch.einsum("abn,bn->an", K, ue)
    r = torch.zeros(W.shape[0], dtype=F32, device=W.device).index_add_(
        0, c.reshape(-1), re.reshape(-1))
    return (mask * r + (1.0 - mask) * W).to(W.dtype)


def laplace_apply_elem_cuda(Ke, connT, mask, W):
    """Kernel K12 (csrc/laplace_apply.cu): a block of consecutive elements,
    one thread per (element, local row), Ke staged in shared memory, the
    results summed in a shared window over the block's DoFs and flushed
    with one atomic a DoF.  The binding checks device, type and shape."""
    if W.dtype != F32 or mask.dtype != F32:
        return laplace_apply_elem_cuda(Ke, connT, mask.to(F32),
                                       W.to(F32)).to(W.dtype)
    r = cuda_ext.load().laplace_apply(Ke, connT, mask, W)
    cuda_ext.count("laplace_apply")
    return r


def make_laplace_operator(asm, mask):
    """Matrix-free f32 stiffness operator W -> mask A (mask W) + (1 - mask)
    W of a scalar assembler (element matrices computed once)."""
    Ke = laplace_element_matrices(asm)
    connT = asm.conns[0].t().contiguous()             # [nen, nel] int32
    mask32 = mask.to(F32).contiguous()

    def op(W):
        return laplace_apply_elem(Ke, connT,
                                  mask32 if W.dtype == F32 else mask, W)

    return op
