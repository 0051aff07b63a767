"""Mixed-precision stencil-multigrid Newton for multi-patch spaces (port of
tigar_tpu/solvers/newton_stencil_mp.py: ``IfaceBlock``,
``MultiPatchStencilOperator``, ``MultiPatchProlong``, ``_as_coupling_list``,
``_lam_max_jacobi``, ``mp_stencil_to_dense`` and
``MultiPatchStencilNewton``).

The assembled tangent of an equal-order multi-patch space whose patches
are weakly coupled by interface forms is a ``MultiPatchStencilOperator``:
one sliding-window stencil per patch plus one exact dense interface block
per interface form.  Level transfers are per-patch separable knot
insertions; every level operator includes its interface blocks, and the
V-cycle smoother adds one exact dense subspace (Schwarz) correction per
block, multiplicatively.  The driver (f32 production steps, f64 polish,
floor) is ``StencilNewton``'s.

Kernels on this path: K1 (residual over the concatenated patches), K2
(per-patch tangent stencils: the patch's element range of the assembler),
K3 (per-patch stencil action, reading and writing each patch in place in
the field-major multi-patch vector), K5 (the dense interface block apply,
``csrc/iface_block.cu``), K6/K7 (interface residual and tangent block of
the shell penalty coupling) or K8/K9 (those of the consistent Nitsche
coupling on the SVK energy).  CPU tensors run every kernel's plain
version.

Left out (TPU workarounds of the JAX package): the coarse-operator disk
cache, CPU-routed polish residuals, build chunking, nested iteration,
``hessian=`` tangents, the f64 elementwise branch and the HIGHEST-precision
pins (TF32 is off in the port).  The Schwarz inverses are taken with
``torch.linalg.inv`` in f64 on the operator's device and cast to f32.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .multigrid import insertion_matrix_1d
from .newton_stencil import (StencilNewton, make_stencil_mgcg,
                             make_stencil_mgcg_mixed, _grid_prolong,
                             _equal_order_basis)
from ..interface import _iform_tangent_block
from ..ops import cuda_ext
from ..ops.assembly import apply_bc_matrix
from ..ops.stencil import build_stencil, stencil_apply, stencil_to_dense

F32 = torch.float32
F64 = torch.float64


# -- kernel K5: dense interface block apply ------------------------------------


def iface_block_apply(B, idx, v, out, mask=None, alpha=1.0):
    """out[idx] += alpha * m * (B @ (m * v[idx])), m = mask[idx] (1 without
    a mask), in place on ``out``; returns ``out``.  ``idx`` [m] int32 is
    sorted and unique.  CUDA tensors run kernel K5; CPU tensors run
    ``iface_block_apply_ref``."""
    if v.is_cuda:
        return iface_block_apply_cuda(B, idx, v, out, mask, alpha)
    return iface_block_apply_ref(B, idx, v, out, mask, alpha)


def iface_block_apply_ref(B, idx, v, out, mask=None, alpha=1.0):
    """Plain version: index_add_ of B @ (m * v[idx]), as the JAX package's
    ``out.at[idx].add``."""
    il = idx.long()
    m = 1.0 if mask is None else mask[il]
    return out.index_add_(0, il, alpha * m * (B @ (m * v[il])))


def iface_block_apply_cuda(B, idx, v, out, mask=None, alpha=1.0):
    """Kernel K5 (csrc/iface_block.cu): rows split evenly over one wave of
    the card, 16-byte loads of B, the gathered masked vector in shared
    memory, each output written once.  B and idx come from an
    ``IfaceBlock`` (checked and made contiguous where the operator is
    built); the binding checks device, type and shape of every tensor."""
    cuda_ext.load().iface_block(B, idx, mask, v, float(alpha), out)
    cuda_ext.count("iface_block")
    return out


# -- the multi-patch operator ---------------------------------------------------


class IfaceBlock(NamedTuple):
    """One interface's dense tangent data inside a multi-patch operator.

    idx  : [m] int32 sorted global DoF indices of the interface support
    K    : [m, m] exact dense interface tangent block
    Sinv : [m, m] f32 inverse of the BC'd local interface operator (patch
           diagonals and the other blocks' diagonals at idx, plus K): the
           Schwarz correction of the V-cycle smoother; None on f64
           operator builds (preconditioning is always f32)."""
    idx: Any
    K: Any
    Sinv: Optional[Any] = None


def _checked_block(blk):
    """The block with idx int32 and K, Sinv [m, m] on idx's device, each
    contiguous: what K5's binding takes, checked once per operator."""
    idx, K, Sinv = blk
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be an int32 vector, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    m = idx.shape[0]
    for name, t in (("K", K), ("Sinv", Sinv)):
        if t is not None and (tuple(t.shape) != (m, m)
                              or t.device != idx.device):
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} vs idx "
                             f"[{m}] on {idx.device}")
    return IfaceBlock(idx.contiguous(), K.contiguous(),
                      None if Sinv is None else Sinv.contiguous())


class MultiPatchStencilOperator:
    """W -> A @ W for a multi-patch assembled tangent: per-patch
    StencilOperators over the field-major global layout (patch blocks
    contiguous within each field) plus one dense block per interface.

    ``apply(x, mask, b, dinv, omega, mode)`` is the level action of the
    multigrid solvers, with the modes of ``ops.stencil.stencil_apply``:
    each patch runs K3 in place, each block K5; the Jacobi mode folds the
    blocks into the right-hand side first (b' = b - m K (m x), then K3's
    fused sweep per patch gives x + omega dinv (b - A x) exactly)."""

    def __init__(self, sts, ifaces, foffsets, doffsets, nf):
        self.sts = tuple(sts)
        self.ifaces = tuple(_checked_block(blk) for blk in ifaces)
        self.foffsets = tuple(int(o) for o in foffsets)
        self.doffsets = tuple(int(o) for o in doffsets)
        self.nf = int(nf)
        ncp = self.doffsets[-1]
        if self.foffsets != tuple(f * ncp for f in range(self.nf)):
            raise ValueError("MultiPatchStencilOperator needs the equal-order "
                             "field-major layout")

    @property
    def has_schwarz(self):
        return any(blk.Sinv is not None for blk in self.ifaces)

    @property
    def ndof(self):
        return self.nf * self.doffsets[-1]

    def _blocks(self, x, out, mask, alpha):
        for blk in self.ifaces:
            iface_block_apply(blk.K, blk.idx, x, out, mask, alpha)

    def apply(self, x, mask=None, b=None, dinv=None, omega=0.0,
              mode="apply"):
        if mode == "jacobi":
            b = b.clone()
            self._blocks(x, b, mask, -1.0)
        out = torch.empty_like(x)
        for p, st in enumerate(self.sts):
            stencil_apply(st, x, mask, b, dinv, omega, mode, out=out,
                          base=self.doffsets[p], fstride=self.doffsets[-1])
        if mode == "apply":
            self._blocks(x, out, mask, 1.0)
        elif mode == "residual":
            self._blocks(x, out, mask, -1.0)
        return out

    def __call__(self, U):
        return self.apply(U)

    def schwarz(self, r, mask):
        """Exact interface-subspace corrections (f32 local solves), one per
        block, applied multiplicatively: the residual is refreshed between
        blocks, so DoFs shared by two supports (patches meeting at a
        corner) are not double-corrected."""
        c = None
        for blk in self.ifaces:
            if blk.Sinv is None:
                continue
            if c is None:
                rk, c = r, torch.zeros_like(r)
            else:
                rk = self.apply(c, mask=mask, b=r, mode="residual")
            iface_block_apply(blk.Sinv, blk.idx, rk, c, mask, 1.0)
        return torch.zeros_like(r) if c is None else c

    def diagonal(self):
        ncp = self.doffsets[-1]
        d = torch.empty(self.ndof, dtype=self.sts[0].S.dtype,
                        device=self.sts[0].S.device)
        dv = d.view(self.nf, ncp)
        for p, st in enumerate(self.sts):
            dv[:, self.doffsets[p]:self.doffsets[p + 1]] = \
                st.diagonal().view(self.nf, -1)
        for blk in self.ifaces:
            d.index_add_(0, blk.idx.long(), torch.diagonal(blk.K))
        return d

    def astype(self, dtype):
        """Same operator with cast values (Sinv stays the f32
        preconditioner)."""
        return MultiPatchStencilOperator(
            tuple(st.astype(dtype) for st in self.sts),
            tuple(IfaceBlock(blk.idx, blk.K.to(dtype), blk.Sinv)
                  for blk in self.ifaces),
            self.foffsets, self.doffsets, self.nf)


class MultiPatchProlong:
    """Per-patch separable knot-insertion prolongation between two
    multi-patch levels with identical patch layouts: ``up`` and its exact
    transpose ``down`` (the interface of newton_stencil.TensorProlong)."""

    def __init__(self, Ps, nf, shapes_f, shapes_c, doff_f, doff_c):
        self.Ps = tuple(tuple(p) for p in Ps)     # [patch][direction]
        self.PTs = tuple(tuple(P.T.contiguous() for P in p) for p in self.Ps)
        self.nf = int(nf)
        self.shapes_f = tuple(tuple(s) for s in shapes_f)
        self.shapes_c = tuple(tuple(s) for s in shapes_c)
        self.doff_f = tuple(int(o) for o in doff_f)
        self.doff_c = tuple(int(o) for o in doff_c)

    def _move(self, x, Ps_by_patch, shapes_in, doff_in, doff_out):
        xin = x.view(self.nf, doff_in[-1])
        out = torch.empty((self.nf, doff_out[-1]), dtype=x.dtype,
                          device=x.device)
        for p, Ps in enumerate(Ps_by_patch):
            y = _grid_prolong(tuple(P.to(x.dtype) for P in Ps),
                              xin[:, doff_in[p]:doff_in[p + 1]], self.nf,
                              shapes_in[p])
            out[:, doff_out[p]:doff_out[p + 1]] = y.view(self.nf, -1)
        return out.view(-1)

    def up(self, xc):
        return self._move(xc, self.Ps, self.shapes_c, self.doff_c,
                          self.doff_f)

    def down(self, rf):
        return self._move(rf, self.PTs, self.shapes_f, self.doff_f,
                          self.doff_c)


def _as_coupling_list(c):
    """Normalize a single coupling or a sequence of couplings to a list."""
    if c is None:
        return []
    if isinstance(c, (list, tuple)):
        return list(c)
    return [c]


# Weighted-Jacobi damping target: omega_eff * lam_max(D^-1 A) = 1.8 (see
# tigar_tpu/solvers/newton_stencil_mp.py: penalty-interface rows and
# anisotropic patches push lam_max(D^-1 A) past the 2/omega stability
# limit of the single-patch default).
_OMEGA_FAC = 1.8
_LAM_ITERS = 30


def _lam_max_jacobi(op, mask, x0):
    """Power-iteration estimate of lam_max(D^-1 A) for the BC'd operator
    (identity on masked rows): 30 steps, the generalized Rayleigh quotient
    at the end, returned as a device scalar."""
    d = op.diagonal()
    d = mask * d + (1.0 - mask)
    dinv = 1.0 / d

    def act(x):
        return op.apply(x, mask=mask)

    x = x0 / torch.linalg.norm(x0)
    for _ in range(_LAM_ITERS):
        y = dinv * act(x)
        x = y / torch.linalg.norm(y)
    return torch.dot(x, act(x)) / torch.dot(x, d * x)


def mp_stencil_to_dense(op: MultiPatchStencilOperator):
    """Densify on the host (numpy)."""
    n = op.ndof
    A = np.zeros((n, n), dtype=op.sts[0].S.detach().cpu().numpy().dtype)
    for p, st in enumerate(op.sts):
        dp = op.doffsets[p]
        ncp = op.doffsets[p + 1] - dp
        gidx = np.concatenate([of + dp + np.arange(ncp)
                               for of in op.foffsets])
        A[np.ix_(gidx, gidx)] += stencil_to_dense(st)
    for blk in op.ifaces:
        idx = blk.idx.cpu().numpy()
        A[np.ix_(idx, idx)] += blk.K.detach().cpu().numpy()
    return A


def _layout(spl):
    b = _equal_order_basis(spl)
    foff = tuple(int(o) for o in spl.space.offsets[:-1])
    doff = tuple(int(o) for o in b.doffsets)
    shapes = [tuple(kv.ncp for kv in reversed(pt.kvs)) for pt in b.patches]
    return b, foff, doff, shapes


class MultiPatchStencilNewton(StencilNewton):
    """StencilNewton over an equal-order multi-patch space with weak
    interface couplings (see the module docstring).  The driver (step,
    polish_step, solve) is StencilNewton's; the space-specific parts are
    built here.

    Parameters beyond StencilNewton
    -------------------------------
    coupling     : one interface form, or a sequence (one per interface)
    mg_couplings : one entry per entry of ``mg_splines``: the same
                   coupling(s) built on each coarser space
    """

    def __init__(self, spline, adjoint_res, coupling, mg_splines=(),
                 mg_couplings=(), cg_iters=15, n_smooth=2, omega=0.7,
                 polish_cg_iters=30, polish_tangent="f64",
                 build_quad_degree=None, rebuild_rel=1e-5):
        from ..models.multipatch import MultiPatchBSplineBasis

        if len(mg_couplings) != len(mg_splines):
            raise ValueError("need one mg_coupling entry per mg_spline")
        couplings = _as_coupling_list(coupling)
        if not couplings:
            raise ValueError("MultiPatchStencilNewton requires at least "
                             "one interface coupling")
        mg_coupling_lists = [_as_coupling_list(c) for c in mg_couplings]
        for i, cl in enumerate(mg_coupling_lists):
            if len(cl) != len(couplings):
                raise ValueError(f"mg_couplings[{i}] has {len(cl)} forms; "
                                 f"the fine level has {len(couplings)}")
        if not mg_splines:
            raise ValueError("MultiPatchStencilNewton requires at least "
                             "one coarser spline in mg_splines")
        self.spline = spline
        self.adjoint = adjoint_res
        self.couplings = couplings
        self.cg_iters = int(cg_iters)
        self.asm64 = spline._assembler("dx")
        self.asm32 = self.asm64.astype(F32)
        self._build_quad_degree = build_quad_degree
        asm64_b = (self.asm64 if build_quad_degree is None
                   else spline._assembler("dx",
                                          quad_degree=build_quad_degree))
        self.asm_b64 = asm64_b
        self.asm_b32 = asm64_b.astype(F32)
        self.mask64 = spline.mask
        self.mask32 = spline.mask.to(F32)
        self.basis = _equal_order_basis(spline)
        if not isinstance(self.basis, MultiPatchBSplineBasis):
            raise ValueError("MultiPatchStencilNewton requires a "
                             "MultiPatchBSplineBasis space; use "
                             "StencilNewton for single patches")
        degs0 = tuple(self.basis.patches[0].degrees)
        if any(tuple(pt.degrees) != degs0 for pt in self.basis.patches):
            raise NotImplementedError("all patches must share degrees")
        self.nf = spline.space.nfields
        self.mg_splines = list(mg_splines)
        self.mg_couplings = mg_coupling_lists
        self._n_smooth = int(n_smooth)
        self._omega = float(omega)
        self._polish_cg_iters = int(polish_cg_iters)
        self.polish_tangent = str(polish_tangent)
        self.rebuild_rel = float(rebuild_rel)
        self._st64 = None
        self._fine_omega_scale = 1.0
        dev = spline.mask.device

        self._c64 = tuple(couplings)
        self._c32 = tuple(c.astype(F32) for c in couplings)
        _, self._foff, self._doff, _ = _layout(spline)
        self._lam_x0 = torch.as_tensor(
            np.random.default_rng(0).normal(size=spline.ndof), dtype=F32,
            device=dev)

        # -- multigrid ladder --------------------------------------------------
        all_splines = [spline] + self.mg_splines
        layouts = [_layout(s) for s in all_splines]
        nlev = len(all_splines)
        self._mgcg = make_stencil_mgcg(nlev, n_smooth=n_smooth,
                                       omega=omega, n_iters=self.cg_iters)
        self._mgcg_mixed = make_stencil_mgcg_mixed(
            nlev, n_smooth=n_smooth, omega=omega,
            n_iters=int(polish_cg_iters))
        prolongs = []
        for i in range(nlev - 1):
            bf, _, doff_fi, shapes_fi = layouts[i]
            bc, _, doff_ci, shapes_ci = layouts[i + 1]
            Ps = [tuple(torch.as_tensor(insertion_matrix_1d(kc, kf),
                                        dtype=F32, device=dev)
                        for kc, kf in zip(reversed(pc.kvs),
                                          reversed(pf.kvs)))
                  for pf, pc in zip(bf.patches, bc.patches)]
            prolongs.append(MultiPatchProlong(Ps, self.nf, shapes_fi,
                                              shapes_ci, doff_fi, doff_ci))
        self._Ps = tuple(prolongs)

        # -- coarse operators (zero state, f32) -------------------------------
        coarse_sts, diags, masks = [], [], []
        dense_inv = None
        for i, (spl, cpls) in enumerate(zip(self.mg_splines,
                                            self.mg_couplings)):
            b_c, foff_c, doff_c, _ = layouts[i + 1]
            m32 = spl.mask.to(F32)
            op = self._mp_build(
                spl._assembler("dx").astype(F32),
                torch.zeros(spl.ndof, dtype=F32, device=dev),
                tuple(c.astype(F32) for c in cpls), m32, b_c, foff_c, doff_c,
                schwarz=True)
            m64 = spl.mask.to(F64)
            d = m64 * op.diagonal().to(F64) + (1.0 - m64)
            coarse_sts.append(op)
            # spectrum-safe per-level damping folded into the stored dinv
            lam_c = float(_lam_max_jacobi(op, m32, torch.as_tensor(
                np.random.default_rng(1 + i).normal(size=spl.ndof),
                dtype=F32, device=dev)))
            sc = min(1.0, _OMEGA_FAC / (self._omega * lam_c))
            diags.append((sc / d).to(F32))
            masks.append(m32)
            if i == len(self.mg_splines) - 1:
                A = apply_bc_matrix(
                    torch.as_tensor(mp_stencil_to_dense(op), dtype=F64,
                                    device=dev), m64)
                dense_inv = torch.linalg.inv(A).to(F32)
        self._coarse_sts = tuple(coarse_sts)
        self._coarse_dinvs = tuple(diags)
        self._coarse_masks = tuple(masks)
        self._coarse_inv = dense_inv

    # -- operator builds --------------------------------------------------------

    def _mp_build(self, asm, U, cpls, mask, basis, foff, doff, schwarz):
        """Per-patch tangent stencils (each patch's element range of
        ``asm``), one exact dense block per coupling, and with ``schwarz``
        the f32 inverses of the BC'd local interface operators: S_k sums
        the patch-stencil diagonal at its support, the other blocks'
        diagonals there, and its own K_k."""
        sts = []
        e0 = 0
        for pt in basis.patches:
            sts.append(build_stencil(asm.elements(e0, e0 + pt.nel),
                                     self.adjoint, U, pt, self.nf))
            e0 += pt.nel
        blocks = []
        for cpl in cpls:
            idx, pos_a, pos_b = cpl.support_positions()
            K = _iform_tangent_block(cpl, U[idx.long()], pos_a, pos_b,
                                     cpl.params)
            blocks.append(IfaceBlock(idx, K, None))
        op = MultiPatchStencilOperator(sts, blocks, foff, doff, self.nf)
        if not schwarz:
            return op
        d_tot = op.diagonal()
        sinvs = []
        for blk in blocks:
            il = blk.idx.long()
            Kd = torch.diagonal(blk.K)
            m_idx = mask[il].to(blk.K.dtype)
            S = blk.K + torch.diag(d_tot[il] - Kd)
            S = m_idx[:, None] * S * m_idx[None, :] + torch.diag(1.0 - m_idx)
            sinvs.append(torch.linalg.inv(S.to(F64)).to(F32))
        return MultiPatchStencilOperator(
            sts, [IfaceBlock(blk.idx, blk.K, Si)
                  for blk, Si in zip(blocks, sinvs)], foff, doff, self.nf)

    def _build(self, asm, U):
        f64 = U.dtype == F64
        op = self._mp_build(asm, U, self._c64 if f64 else self._c32,
                            self.mask64 if f64 else self.mask32, self.basis,
                            self._foff, self._doff, schwarz=not f64)
        if not f64:
            # spectrum-safe fine-level damping: one power iteration and one
            # scalar read per f32 tangent build
            lam = float(_lam_max_jacobi(op, self.mask32, self._lam_x0))
            self._fine_omega_scale = min(1.0,
                                         _OMEGA_FAC / (self._omega * lam))
        return op

    def _res(self, asm, mask, U):
        r = asm.residual_vector_adjoint(self.adjoint, U)
        for c in (self._c64 if U.dtype == F64 else self._c32):
            r = r + c.residual(U)
        return mask * r

    def prolong_solution(self, Uc):
        """Exact knot-insertion prolongation of a coarse solution
        (mg_splines[0] coefficients) into the fine space, re-masked."""
        dt = self.spline.dtype
        return self.mask64 * self._Ps[0].up(Uc.to(dt))
