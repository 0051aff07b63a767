"""f32 fast-path stiffness apply for scalar spaces with explicit element
connectivity (port of tigar_tpu/ops/fastpath.py: ``laplace_layouts``,
``_laplace_apply``, ``make_laplace_operator``).

The operator is W -> mask * A (mask * W) + (1 - mask) * W, A the scalar
stiffness matrix, computed per element from two precomputed layouts
(element axis last): A1 the trial gradients and A2 the test gradients
weighted by qw * sqrtJ * ginv, each [nen * nq * d, nel] in float32.
Paired with solvers/refinement.refine_solve it gives f64 accuracy.

Kernel K12 (csrc/laplace_apply.cu) carries the apply on CUDA tensors
(``laplace_apply_cuda``); ``laplace_apply_ref`` is its plain version and
runs for CPU tensors.
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


def laplace_apply(A1, A2, connT, mask, W):
    """mask * A (mask * W) + (1 - mask) * W in float32, returned in W's
    type.  connT [nen, nel] int32.  CUDA tensors run kernel K12; CPU
    tensors run ``laplace_apply_ref``."""
    if A1.is_cuda:
        return laplace_apply_cuda(A1, A2, connT, mask, W)
    return laplace_apply_ref(A1, A2, connT, mask, W)


def laplace_apply_ref(A1, A2, connT, mask, W):
    """Plain PyTorch version of K12 (tigar_tpu's ``_laplace_apply``):
    gather, two contractions, scatter-add, BC epilogue."""
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


def laplace_apply_cuda(A1, A2, connT, mask, W):
    """Kernel K12: one thread per element, the element's gathered masked
    coefficients and its local result in registers, coalesced reads of
    A1/A2 (element axis last), atomicAdd of the masked local result into
    r, whose (1 - mask) W part a first pass writes.  Float32 throughout;
    W and the result in W's type."""
    nen, nel = connT.shape
    ndof = W.shape[0]
    if A1.dtype != F32 or A2.dtype != F32:
        raise TypeError("K12 takes float32 layouts")
    if A1.shape != A2.shape or A1.shape[1] != nel or A1.shape[0] % nen:
        raise ValueError(f"layouts {tuple(A1.shape)}, {tuple(A2.shape)} do "
                         f"not match connT {tuple(connT.shape)}")
    if connT.dtype != torch.int32:
        raise TypeError("connT must be int32")
    if W.dim() != 1 or tuple(mask.shape) != (ndof,):
        raise ValueError("W and mask must be vectors of one length")
    for name, t in (("A1", A1), ("A2", A2), ("connT", connT),
                    ("mask", mask), ("W", W)):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    r = cuda_ext.load().laplace_apply(A1, A2, connT, mask.to(F32),
                                      W.to(F32))
    cuda_ext.count("laplace_apply")
    return r.to(W.dtype)


def make_laplace_operator(asm, mask):
    """Matrix-free f32 stiffness operator W -> mask A (mask W) + (1 - mask)
    W of a scalar assembler (layouts computed once)."""
    A1, A2 = laplace_layouts(asm)
    connT = asm.conns[0].t().contiguous()             # [nen, nel] int32
    mask32 = mask.to(F32).contiguous()

    def op(W):
        return laplace_apply(A1, A2, connT,
                             mask32 if W.dtype == F32 else mask, W)

    return op
