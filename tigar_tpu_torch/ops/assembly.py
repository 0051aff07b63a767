"""Batched assembly over Bezier elements (port of ``DomainAssembler`` and
the BC helpers of tigar_tpu/ops/assembly.py): adjoint-form residuals and
element tangents of the shell path, and the generic form path.

Layout: per-field tabulations N [nel, nq, nen], dN [.., d], d2N [.., d, d],
concatenated global connectivity ``cat_conn`` [nel, nloc] (field-major
local ordering), the geometry context ``ctx`` (QP with leaves [nel, nq, ..])
and ``scale`` [nel, nq] = quadrature weight x Jacobian.

Kernel K1 (csrc/shell_residual.cu) replaces ``residual_vector_adjoint``
on CUDA tensors; ``residual_vector_adjoint_ref`` is its plain twin and
runs for CPU tensors.

The generic path (``functional``, ``element_residuals``,
``element_matrices`` and the vectors and scatters built on them) maps a
per-element function over the element batch with ``torch.func.vmap``, in
chunks of 8,192 elements when the batch is larger (the JAX package's
``lax.map`` chunks, tigar_tpu/config.py DEFAULT_ASSEMBLY_CHUNK), and the
per-point density over the element's quadrature points: densities are
written for one point, as in the JAX package.  Residuals are gradients
of the element form with respect to the local test coefficients
(``torch.func.grad``), element matrices their forward Jacobians.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TORCH_INDEX_TYPE
from ..forms import Jet, QP, tree_vmap
from . import cuda_ext

# elements per vmap batch of the generic path (tigar_tpu/config.py:48)
DEFAULT_ASSEMBLY_CHUNK = 8192


def _vmap_density(density, params):
    """Map a pointwise density over the quadrature axis of its jet/ctx
    arguments; ``params`` (if given) is passed unbatched as the last
    argument."""
    if params is None:
        return tree_vmap(density)
    return tree_vmap(lambda *args: density(*args, params))


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
        """Global DoF vector (or dict of vectors) -> [nel, nloc] element
        coefficients (or a dict of them)."""
        if isinstance(U, dict):
            return {k: self._gather_local(v) for k, v in U.items()}
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

    # -- the generic form path (per-element maps) -----------------------------

    def _tree_local_jets(self, Ue, Ns, dNs, d2Ns, masks):
        """Local jets of a tensor or dict of tensors of local
        coefficients."""
        if isinstance(Ue, dict):
            return {k: self._local_jets(v, Ns, dNs, d2Ns, masks)
                    for k, v in Ue.items()}
        return self._local_jets(Ue, Ns, dNs, d2Ns, masks)

    def _elem_xs(self, Ue=None):
        base = (self.ctx, self.scale, tuple(self.Ns), tuple(self.dNs),
                tuple(self.d2Ns), tuple(self.masks))
        return base if Ue is None else (Ue,) + base

    def _map_elements(self, fn, xs):
        """``fn`` mapped over the element axis of every tensor leaf of
        ``xs``: one vmap, or vmaps over chunks of DEFAULT_ASSEMBLY_CHUNK
        elements concatenated (bounds the per-point intermediates of one
        batch)."""
        mapped = tree_vmap(fn)
        nel, chunk = self.nel, DEFAULT_ASSEMBLY_CHUNK
        if nel <= chunk:
            return mapped(*xs)
        parts = []
        for s in range(0, nel, chunk):
            sl = slice(s, min(s + chunk, nel))
            parts.append(mapped(*torch.utils._pytree.tree_map(
                lambda x, sl=sl: x[sl] if isinstance(x, torch.Tensor)
                else x, xs)))
        return torch.cat(parts, dim=0)

    def functional(self, density, u_jets=None, params=None):
        """Integral of density(ctx[, u][, params]) over the batch.
        ``u_jets``: global DoF vector or dict of vectors."""
        dens = _vmap_density(density, params)

        def elem(*args):
            if u_jets is None:
                ctx_e, scale_e = args[:2]
                d = dens(ctx_e)
            else:
                Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
                uj = self._tree_local_jets(Ue_e, Ns_e, dNs_e, d2Ns_e,
                                           masks_e)
                d = dens(ctx_e, uj)
            return torch.sum(d * scale_e)

        if u_jets is None:
            xs = self._elem_xs()
        else:
            xs = self._elem_xs(self._gather_local(u_jets))
        return torch.sum(self._map_elements(elem, xs)).to(self.dtype)

    def element_residuals(self, density, U=None, params=None):
        """[nel, nloc] element residuals: the gradient of the element form
        with respect to the local test coefficients.  ``U``: global DoF
        vector or dict of vectors (None for a linear form)."""
        dens = _vmap_density(density, params)
        dtype, device, nloc = self.dtype, self.device, self.nloc

        def elem(*args):
            if U is None:
                ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
                uj = None
            else:
                Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
                uj = self._tree_local_jets(Ue_e, Ns_e, dNs_e, d2Ns_e,
                                           masks_e)

            def R(vloc):
                v = self._local_jets(vloc, Ns_e, dNs_e, d2Ns_e, masks_e)
                d = dens(ctx_e, v) if uj is None else dens(ctx_e, uj, v)
                return torch.sum(d * scale_e)

            return torch.func.grad(R)(torch.zeros(nloc, dtype=dtype,
                                                  device=device))

        xs = self._elem_xs(None if U is None else self._gather_local(U))
        return self._map_elements(elem, xs)

    def linear_vector(self, density, params=None):
        """b_i = L(N_i) for density(ctx, v[, params]) linear in v."""
        return self.scatter_vector(self.element_residuals(density, None, params))

    def residual_vector(self, density, U, params=None):
        """r_i = res(u; N_i) for density(ctx, u, v[, params]) linear in
        v."""
        return self.scatter_vector(self.element_residuals(density, U, params))

    def element_matrices(self, density, U, params=None):
        """[nel, nloc, nloc] element tangent matrices of density(ctx, u, v)
        linearized about U (forward Jacobian of the local residual).  ``U``:
        global vector, or a dict with the unknown under "u" (the other
        entries are held fixed)."""
        dens = _vmap_density(density, params)
        dtype, device, nloc = self.dtype, self.device, self.nloc
        is_dict = isinstance(U, dict)

        def elem(Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e):
            aux = ({k: self._local_jets(v, Ns_e, dNs_e, d2Ns_e, masks_e)
                    for k, v in Ue_e.items() if k != "u"} if is_dict else {})

            def local_residual(ul):
                def R(vloc):
                    uj = self._local_jets(ul, Ns_e, dNs_e, d2Ns_e, masks_e)
                    u = {"u": uj, **aux} if is_dict else uj
                    v = self._local_jets(vloc, Ns_e, dNs_e, d2Ns_e, masks_e)
                    return torch.sum(dens(ctx_e, u, v) * scale_e)
                return torch.func.grad(R)(torch.zeros(nloc, dtype=dtype,
                                                      device=device))

            uloc = Ue_e["u"] if is_dict else Ue_e
            return torch.func.jacfwd(local_residual)(uloc)

        return self._map_elements(elem, self._elem_xs(self._gather_local(U)))

    def scatter_dense(self, A_e):
        """Scatter element matrices into a dense [ndof, ndof] matrix."""
        nel, nloc = self.cat_conn.shape
        c = self._cat_conn_long
        rows = c[:, :, None].expand(nel, nloc, nloc).reshape(-1)
        cols = c[:, None, :].expand(nel, nloc, nloc).reshape(-1)
        A = torch.zeros((self.ndof, self.ndof), dtype=A_e.dtype,
                        device=A_e.device)
        return A.index_put((rows, cols), A_e.reshape(-1), accumulate=True)

    def scatter_diag(self, A_e):
        """Scatter only the element-matrix diagonals (Jacobi)."""
        return self.scatter_vector(torch.diagonal(A_e, dim1=1, dim2=2))

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
        """Scatter-add [nel, nloc] element vectors into a global vector
        (out of place, so it also runs under torch.func transforms)."""
        return torch.zeros(self.ndof, dtype=r_e.dtype,
                           device=r_e.device).index_add(
            0, self._cat_conn_long.reshape(-1), r_e.reshape(-1))

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


# local functions a field the shell kernels take: the biquadratic B-spline
# element and the bicubic Bezier extraction element (T-splines)
SHELL_NENS = (9, 16)
# quadrature points an element K2's element mode takes (dynamic shared
# memory; the stencil fold takes at most 9)
TANGENT_ELEMENTS_MAXQ = 16


def shell_padding_mask(asm):
    """The padding mask [nel, nen] the shell kernels take (the one shared by
    all fields of a ragged basis), or None when no field is padded."""
    m = asm.masks[0]
    if any(x is not m for x in asm.masks):
        raise ValueError("shell kernels need one padding mask shared by "
                         "all fields")
    if m is not None and tuple(m.shape) != (asm.nel, asm.nens[0]):
        raise ValueError(f"padding mask shape {tuple(m.shape)} != "
                         f"({asm.nel}, {asm.nens[0]})")
    return m


def shell_kernel_args(asm, density, U):
    """Check what K1/K2 take -- the SVK shell density on an equal-order
    3-field surface assembler with 9 (biquadratic) or 16 (bicubic
    extraction element) local functions a field, one shared tabulation and
    at most one shared padding mask, CUDA tensors of one dtype -- and
    return their shared tensor arguments, contiguous (the padding mask is
    ``shell_padding_mask(asm)``).  A shape the kernels do not take raises
    ValueError naming it."""
    from ..models.shell import SVKShellAdjoint
    if not isinstance(density, SVKShellAdjoint):
        raise TypeError("the CUDA shell kernels evaluate the SVK shell "
                        "density only (models.shell.SVKShellAdjoint); got "
                        f"{type(density).__name__}")
    if asm.nfields != 3 or len(set(asm.nens)) != 1 or \
            asm.nens[0] not in SHELL_NENS:
        raise ValueError("shell kernels need 3 fields of 9 (biquadratic) or "
                         f"16 (bicubic) local functions; got {asm.nfields} "
                         f"fields of {asm.nens}")
    if any(x is not asm.Ns[0] for x in asm.Ns):
        raise ValueError("shell kernels need one shared tabulation for all "
                         "fields")
    shell_padding_mask(asm)
    if asm.d2Ns[0] is None or tuple(asm.ctx.DF.shape[-2:]) != (3, 2):
        raise ValueError("shell kernels need nders=2 on a 2D surface in 3D")
    if U.shape != (asm.ndof,):
        raise ValueError(f"U shape {tuple(U.shape)} != ({asm.ndof},)")
    if not (U.is_cuda and asm.scale.is_cuda):
        raise ValueError("U and the assembler must be CUDA tensors")
    if U.dtype != asm.dtype or U.dtype not in (torch.float32,
                                               torch.float64):
        raise TypeError(f"U dtype {U.dtype} vs assembler {asm.dtype}")
    if "shell_ref" not in (asm.ctx.aux or {}):
        raise ValueError("precompute_shell_reference has not run on this "
                         "assembler")
    sref = asm.ctx.aux["shell_ref"]
    return [t.contiguous() for t in (
        asm.cat_conn, asm.Ns[0], asm.dNs[0], asm.d2Ns[0], asm.scale,
        asm.ctx.DF, asm.ctx.d2F, sref.a, sref.b, sref.ea)]


def _contiguous(t):
    return None if t is None else t.contiguous()


def shell_residual_cuda(asm, density, U):
    """Kernel K1: fused gather -> jets -> SVK adjoint (+ load) ->
    contraction -> atomic scatter-add, one thread per quadrature point;
    padded slots of ragged elements add nothing."""
    args = shell_kernel_args(asm, density, U)
    ext = cuda_ext.load()
    r = ext.shell_residual(U.contiguous(), *args,
                           _contiguous(shell_padding_mask(asm)),
                           list(density.kernel_constants()), asm.ndof)
    cuda_ext.count("shell_residual")
    return r


def element_matrices_cuda(asm, density, U, me=None):
    """Kernel K2's element mode: K2's jet-Jacobians and element matrices
    (steps 1-2) for 9 or 16 local functions a field and at most 16
    quadrature points, each entry masked by the padding mask on both sides
    and by me[a] me[b] when ``me`` is given, written to E [nel, nloc,
    nloc] (its upper triangle computed, mirrored: E is exactly symmetric)
    instead of folded into a stencil.  Its launches are tallied by dtype,
    point count and local functions (``cuda_ext.counts_by``)."""
    if asm.nq > TANGENT_ELEMENTS_MAXQ:
        raise ValueError("the tangent kernel takes at most "
                         f"{TANGENT_ELEMENTS_MAXQ} quadrature points, got "
                         f"{asm.nq}")
    if me is not None and (tuple(me.shape) != (asm.nel, asm.nloc) or
                           me.dtype != U.dtype or not me.is_cuda):
        raise ValueError(f"me must be [{asm.nel}, {asm.nloc}] of U's type "
                         f"on the card; got shape {tuple(me.shape)}, "
                         f"{me.dtype}")
    args = shell_kernel_args(asm, density, U)
    ext = cuda_ext.load()
    E = ext.tangent_elements(U.contiguous(), *args,
                             _contiguous(shell_padding_mask(asm)),
                             list(density.kernel_constants()[:4]),
                             _contiguous(me))
    cuda_ext.count("tangent_elements",
                   f"{cuda_ext.short_dtype(U.dtype)} nq={asm.nq} "
                   f"nen={asm.nens[0]}")
    return E


def apply_bc_matrix(A, mask, diag=1.0):
    """Zero constrained rows/columns and set the diagonal
    (zeroRowsColumns semantics)."""
    A = A * mask[:, None] * mask[None, :]
    return A + torch.diag(diag * (1.0 - mask))


def apply_bc_vector(b, mask):
    """Zero constrained entries of an assembled vector."""
    return b * mask


def bc_operator(action, mask, diag=1.0):
    """Matrix-free ``apply_bc_matrix`` of an operator W -> A W."""
    def op(w):
        return mask * action(mask * w) + diag * (1.0 - mask) * w
    return op


def scatter_bcoo(asm, A_e):
    """Element matrices assembled into a coalesced (duplicates summed)
    torch sparse COO matrix [ndof, ndof] (the JAX package's BCOO)."""
    ndof = asm.ndof
    nel, nloc, _ = A_e.shape
    c = asm._cat_conn_long
    rows = c[:, :, None].expand(nel, nloc, nloc).reshape(-1)
    cols = c[:, None, :].expand(nel, nloc, nloc).reshape(-1)
    return torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                   A_e.reshape(-1), (ndof, ndof),
                                   check_invariants=False).coalesce()
