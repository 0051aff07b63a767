"""Batched assembly over Bezier elements: adjoint-form residuals and
element tangents (port of the ``DomainAssembler`` parts of
tigar_tpu/ops/assembly.py that the production shell path runs).

Layout: per-field tabulations N [nel, nq, nen], dN [.., d], d2N [.., d, d],
concatenated global connectivity ``cat_conn`` [nel, nloc] (field-major
local ordering), the geometry context ``ctx`` (QP with leaves [nel, nq, ..])
and ``scale`` [nel, nq] = quadrature weight x Jacobian.

Kernel K1 (csrc/shell_residual.cu) replaces ``residual_vector_adjoint``
on CUDA tensors; ``residual_vector_adjoint_ref`` is its plain twin and
runs for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TORCH_INDEX_TYPE
from ..forms import Jet, QP
from . import cuda_ext


class DomainAssembler:
    """Assembly over one element batch (the volume).

    Parameters
    ----------
    field_tabs : list of Tabulation (numpy), one per field; fields that
                 share one Tabulation object share its tensors
    offsets    : [nfields+1] global DoF offsets
    ndof       : total DoFs
    ctx        : QP with tensor leaves [nel, nq, ...]
    scale      : [nel, nq] tensor
    """

    def __init__(self, field_tabs, offsets, ndof, ctx, scale, device=None,
                 dtype=None):
        self.nfields = len(field_tabs)
        self.offsets = tuple(int(o) for o in offsets)
        self.ndof = int(ndof)
        self.ctx = ctx
        self.scale = torch.as_tensor(scale, dtype=dtype, device=device)
        dtype = self.scale.dtype
        device = self.scale.device

        def t(a, dt=dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dt, device=device)

        memo = {}
        self.conns, self.Ns, self.dNs, self.d2Ns, self.masks = \
            [], [], [], [], []
        for tab in field_tabs:
            if id(tab) not in memo:
                memo[id(tab)] = (t(tab.conn, TORCH_INDEX_TYPE), t(tab.N),
                                 t(tab.dN), t(tab.d2N), t(tab.mask))
            conn, N, dN, d2N, mask = memo[id(tab)]
            self.conns.append(conn)
            self.Ns.append(N)
            self.dNs.append(dN)
            self.d2Ns.append(d2N)
            self.masks.append(mask)
        self.nens = tuple(int(c.shape[1]) for c in self.conns)
        self.nloc = int(sum(self.nens))
        # concatenated element connectivity in global numbering
        self.cat_conn = torch.cat(
            [self.conns[f] + self.offsets[f] for f in range(self.nfields)],
            dim=1).contiguous()
        self._cat_conn_long = self.cat_conn.long()

    @property
    def nel(self):
        return self.scale.shape[0]

    @property
    def nq(self):
        return self.scale.shape[1]

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def device(self):
        return self.scale.device

    def _map_tensors(self, fn):
        """Copy with ``fn`` applied to every floating tensor (shared
        tensors stay shared) and indices moved alongside."""
        memo = {}

        def go(x):
            if x is None:
                return None
            if id(x) not in memo:
                memo[id(x)] = fn(x)
            return memo[id(x)]

        obj = DomainAssembler.__new__(DomainAssembler)
        obj.__dict__.update(self.__dict__)
        obj.ctx = self.ctx.map(go)
        obj.scale = go(self.scale)
        obj.Ns = [go(x) for x in self.Ns]
        obj.dNs = [go(x) for x in self.dNs]
        obj.d2Ns = [go(x) for x in self.d2Ns]
        obj.masks = [go(x) for x in self.masks]
        dev = obj.scale.device
        obj.conns = [c.to(dev) for c in self.conns]
        obj.cat_conn = self.cat_conn.to(dev)
        obj._cat_conn_long = self._cat_conn_long.to(dev)
        return obj

    def astype(self, dtype):
        """Copy with all floating tensors cast to ``dtype`` (the
        mixed-precision fast path)."""
        return self._map_tensors(lambda x: x.to(dtype))

    def elements(self, e0, e1):
        """View of the element range [e0, e1) (a patch of a multi-patch
        batch): every per-element tensor sliced along its leading axis,
        connectivity still in global numbering; no copies."""
        obj = self._map_tensors(lambda x: x[e0:e1])
        obj.conns = [c[e0:e1] for c in self.conns]
        obj.cat_conn = self.cat_conn[e0:e1]
        obj._cat_conn_long = self._cat_conn_long[e0:e1]
        return obj

    def to(self, device):
        """Copy with all tensors on ``device``."""
        return self._map_tensors(lambda x: x.to(device))

    # -- field evaluation -------------------------------------------------------

    def _gather_local(self, U):
        """Global DoF vector -> [nel, nloc] element coefficients."""
        return U[self._cat_conn_long]

    def _split_local(self, uloc):
        parts = []
        s = 0
        for f in range(self.nfields):
            parts.append(uloc[..., s:s + self.nens[f]])
            s += self.nens[f]
        return parts

    def _local_jets(self, uloc, Ns, dNs, d2Ns, masks):
        """Jets at the quadrature points of local coefficients uloc
        [..., nloc], tabulations with matching leading dims ([..., nq,
        nen]); fields stacked on the axis after nq."""
        parts = self._split_local(uloc)
        vals, gs, hs = [], [], []
        for f in range(self.nfields):
            ce = parts[f]
            if masks[f] is not None:
                ce = ce * masks[f]
            vals.append(torch.einsum("...qa,...a->...q", Ns[f], ce))
            gs.append(None if dNs[f] is None else
                      torch.einsum("...qad,...a->...qd", dNs[f], ce))
            hs.append(None if d2Ns[f] is None else
                      torch.einsum("...qadc,...a->...qdc", d2Ns[f], ce))
        if self.nfields == 1:
            return Jet(vals[0], gs[0], hs[0])
        val = torch.stack(vals, dim=-1)
        g = None if gs[0] is None else torch.stack(gs, dim=-2)
        h = None if hs[0] is None else torch.stack(hs, dim=-3)
        return Jet(val, g, h)

    def jets(self, U):
        """Multi-field jets of global vector U: leaves [nel, nq, nf],
        [nel, nq, nf, d], [nel, nq, nf, d, d]."""
        return self._local_jets(self._gather_local(U), self.Ns, self.dNs,
                                self.d2Ns, self.masks)

    def _contract_adjoint(self, F, scale, Ns, dNs, d2Ns, masks):
        """Transpose of ``_local_jets``: contract a weighted adjoint jet
        F (leaves [..., nq, nf, ...]) with the tabulations -> [..., nloc]."""
        parts = []
        for f in range(self.nfields):
            if self.nfields == 1:
                Fval, Fg, Fh = F.val, F.g, F.h
            else:
                Fval = None if F.val is None else F.val[..., f]
                Fg = None if F.g is None else F.g[..., f, :]
                Fh = None if F.h is None else F.h[..., f, :, :]
            r = torch.zeros(Ns[f].shape[:-2] + Ns[f].shape[-1:],
                            dtype=scale.dtype, device=scale.device)
            if Fval is not None:
                r = r + torch.einsum("...q,...qa->...a", scale * Fval, Ns[f])
            if Fg is not None and dNs[f] is not None:
                r = r + torch.einsum("...qd,...qad->...a",
                                     scale[..., None] * Fg, dNs[f])
            if Fh is not None and d2Ns[f] is not None:
                r = r + torch.einsum("...qdc,...qadc->...a",
                                     scale[..., None, None] * Fh, d2Ns[f])
            if masks[f] is not None:
                r = r * masks[f]
            parts.append(r)
        return torch.cat(parts, dim=-1)

    # -- adjoint-form assembly --------------------------------------------------

    def element_residuals_adjoint(self, adjoint_density, U):
        """[nel, nloc] element residuals from an adjoint-jet density
        ``adjoint_density(ctx, u) -> Jet`` evaluated on the whole
        [nel, nq] batch (no assembly-level AD)."""
        uj = self.jets(U)
        F = adjoint_density(self.ctx, uj)
        return self._contract_adjoint(F, self.scale, self.Ns, self.dNs,
                                      self.d2Ns, self.masks)

    def scatter_vector(self, r_e):
        """Scatter-add [nel, nloc] element vectors into a global vector."""
        out = torch.zeros(self.ndof, dtype=r_e.dtype, device=r_e.device)
        return out.index_add_(0, self._cat_conn_long.reshape(-1),
                              r_e.reshape(-1))

    def residual_vector_adjoint(self, adjoint_density, U):
        """Assembled residual of an adjoint-jet density.  CUDA tensors run
        kernel K1 (the density must be a models.shell.SVKShellAdjoint);
        CPU tensors run the plain twin."""
        if U.is_cuda:
            return shell_residual_cuda(self, adjoint_density, U)
        return residual_vector_adjoint_ref(self, adjoint_density, U)

    def local_basis(self):
        """B [nel, nq, J, nloc]: the exact linear map from local
        coefficients to the ravelled jet (Jet ravel order: val[nf],
        g[nf, d], h[nf, d, d], row-major), i.e. d(u_flat)/d(uloc)."""
        nel, nq = self.nel, self.nq
        nf = self.nfields
        d = self.dNs[0].shape[-1]
        J = nf * (1 + d + d * d)
        B = torch.zeros((nel, nq, J, self.nloc), dtype=self.dtype,
                        device=self.device)
        s = 0
        for f in range(nf):
            cols = slice(s, s + self.nens[f])
            m = 1.0 if self.masks[f] is None else self.masks[f][:, None, :]
            B[:, :, f, cols] = self.Ns[f] * m
            for dd in range(d):
                B[:, :, nf + f * d + dd, cols] = self.dNs[f][..., dd] * m
                for c in range(d):
                    B[:, :, nf + nf * d + f * d * d + dd * d + c, cols] = \
                        self.d2Ns[f][..., dd, c] * m
            s += self.nens[f]
        return B

    def element_matrices_adjoint(self, adjoint_density, U, me=None):
        """[nel, nloc, nloc] element tangent matrices of an adjoint-jet
        density (tigar_tpu's ``element_matrices_adjoint``), masked on both
        sides by the element mask ``me`` [nel, nloc] when given
        (E * me[:, :, None] * me[:, None, :]).  CUDA tensors run kernel
        K2's element mode (the density must be a
        models.shell.SVKShellAdjoint); CPU tensors run
        ``element_matrices_adjoint_ref``."""
        if U.is_cuda:
            return element_matrices_cuda(self, adjoint_density, U, me)
        return element_matrices_adjoint_ref(self, adjoint_density, U, me)


def element_matrices_adjoint_ref(asm, adjoint_density, U, me=None):
    """Plain version of kernel K2 (its stencil fold and its element mode):
    element matrices via the pointwise jet-Jacobian of an adjoint-jet
    density,

        K[q] = d(F_flat)/d(u_flat)  [J, J]   (torch.func.jacfwd)
        E    = sum_q w_q B[q]^T K[q] B[q],

    masked by ``me`` on both sides when given."""
    uj = asm.jets(U)
    nel, nq = asm.nel, asm.nq
    npt = nel * nq
    nf = asm.nfields
    d = uj.g.shape[-1]
    u_flat = torch.cat([uj.val.reshape(npt, nf),
                        uj.g.reshape(npt, nf * d),
                        uj.h.reshape(npt, nf * d * d)], dim=1)
    ctx_pts = _ctx_points(asm.ctx, npt)

    def point_F(uf, ctx_d):
        ctx_q = QP(**{k: ctx_d.get(k) for k in QP._fields})
        u = Jet(uf[:nf], uf[nf:nf + nf * d].reshape(nf, d),
                uf[nf + nf * d:].reshape(nf, d, d))
        F = adjoint_density(ctx_q, u)
        return torch.cat([F.val.reshape(-1), F.g.reshape(-1),
                          F.h.reshape(-1)])

    K = torch.func.vmap(torch.func.jacfwd(point_F))(u_flat, ctx_pts)
    K = K.reshape(nel, nq, K.shape[-2], K.shape[-1])
    B = asm.local_basis()
    KB = torch.einsum("eqJK,eqKb->eqJb", K, B)
    E = torch.einsum("eqJa,eqJb,eq->eab", B, KB, asm.scale)
    return E if me is None else E * me[:, :, None] * me[:, None, :]


def _ctx_points(ctx, npt):
    """ctx as a dict of tensors flattened to [npt, ...] (None fields
    dropped, aux kept): the vmap-able form of a QP batch."""
    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[flat(v) for v in x])
        return x.reshape((npt,) + tuple(x.shape[2:]))
    return {k: flat(v) for k, v in ctx._asdict().items() if v is not None}


def residual_vector_adjoint_ref(asm, adjoint_density, U):
    """Plain PyTorch twin of kernel K1: gather, jets, batched adjoint
    density, contraction with the tabulations, scatter-add."""
    return asm.scatter_vector(asm.element_residuals_adjoint(adjoint_density,
                                                            U))


def shell_kernel_args(asm, density, U):
    """Check what K1/K2 take -- the SVK shell density on an equal-order
    3-field biquadratic surface assembler, CUDA tensors of one dtype --
    and return their shared tensor arguments, contiguous."""
    from ..models.shell import SVKShellAdjoint
    if not isinstance(density, SVKShellAdjoint):
        raise TypeError("the CUDA shell kernels evaluate the SVK shell "
                        "density only (models.shell.SVKShellAdjoint); got "
                        f"{type(density).__name__}")
    if not (U.is_cuda and asm.scale.is_cuda):
        raise ValueError("U and the assembler must be CUDA tensors")
    if U.dtype != asm.dtype or U.dtype not in (torch.float32,
                                               torch.float64):
        raise TypeError(f"U dtype {U.dtype} vs assembler {asm.dtype}")
    if asm.nfields != 3 or any(n != 9 for n in asm.nens):
        raise ValueError("shell kernels need 3 fields of 9 local "
                         "functions (biquadratic)")
    if any(x is not asm.Ns[0] for x in asm.Ns) or \
            any(m is not None for m in asm.masks):
        raise ValueError("shell kernels need one shared, unmasked "
                         "tabulation for all fields")
    if asm.d2Ns[0] is None or tuple(asm.ctx.DF.shape[-2:]) != (3, 2):
        raise ValueError("shell kernels need nders=2 on a 2D surface in 3D")
    if U.shape != (asm.ndof,):
        raise ValueError(f"U shape {tuple(U.shape)} != ({asm.ndof},)")
    if "shell_ref" not in (asm.ctx.aux or {}):
        raise ValueError("precompute_shell_reference has not run on this "
                         "assembler")
    sref = asm.ctx.aux["shell_ref"]
    return [t.contiguous() for t in (
        asm.cat_conn, asm.Ns[0], asm.dNs[0], asm.d2Ns[0], asm.scale,
        asm.ctx.DF, asm.ctx.d2F, sref.a, sref.b, sref.ea)]


def shell_residual_cuda(asm, density, U):
    """Kernel K1: fused gather -> jets -> SVK adjoint (+ load) ->
    contraction -> atomic scatter-add, one thread per quadrature point."""
    args = shell_kernel_args(asm, density, U)
    ext = cuda_ext.load()
    r = ext.shell_residual(U.contiguous(), *args,
                           list(density.kernel_constants()), asm.ndof)
    cuda_ext.count("shell_residual")
    return r


def element_matrices_cuda(asm, density, U, me=None):
    """Kernel K2's element mode: K2's jet-Jacobians and element matrices
    (steps 1-2), each entry masked by me[a] me[b] when ``me`` is given and
    written to E [nel, 27, 27] instead of folded into a stencil."""
    args = shell_kernel_args(asm, density, U)
    if asm.nq > 9:
        raise ValueError("the tangent kernel takes at most 9 quadrature "
                         f"points, got {asm.nq}")
    if me is not None and (tuple(me.shape) != (asm.nel, 27) or
                           me.dtype != U.dtype or not me.is_cuda):
        raise ValueError(f"me must be [{asm.nel}, 27] of U's type on the "
                         "card")
    ext = cuda_ext.load()
    E = ext.tangent_elements(U.contiguous(), *args,
                             list(density.kernel_constants()[:4]),
                             None if me is None else me.contiguous())
    cuda_ext.count("tangent_elements")
    return E


def apply_bc_matrix(A, mask, diag=1.0):
    """Zero constrained rows/columns and set the diagonal
    (zeroRowsColumns semantics)."""
    A = A * mask[:, None] * mask[None, :]
    return A + torch.diag(diag * (1.0 - mask))
