"""Assembled sliding-window stencil operators for tensor-product spaces
(port of tigar_tpu/ops/stencil.py).

S [nf, nf, *(2p+1 per dir), *grid] couples output DoF (field f_out, grid
index I) to input DoF (f_in, I + offset - p); grid axes list the SLOWEST
direction first (direction 0 fastest <-> last axis).

Two hand kernels live behind this module:
  - K2 (csrc/tangent_stencil.cu), ``build_stencil`` on CUDA tensors: the
    SVK shell tangent at the current state folded straight into S, with
    no [nel, nloc, nloc] element matrices in device memory.  Twin:
    ``build_stencil_ref`` (jacfwd element matrices + the slice-add fold).
  - K3 (csrc/stencil_apply.cu), ``stencil_apply`` on CUDA tensors: the
    stencil action with optional BC mask (zeroRowsColumns, unit diagonal),
    the residual b - A x, or the weighted-Jacobi update
    x + omega dinv (b - A x).  Twin: ``stencil_apply_ref``.
"""

from __future__ import annotations

from itertools import product as _iproduct

import numpy as np
import torch

from . import cuda_ext

MODES = {"apply": 0, "residual": 1, "jacobi": 2}


def _check_uniform_support(basis):
    """Element i must support functions i..i+p per direction."""
    for kv in basis.kvs:
        spans = np.asarray(kv.element_spans())
        if kv.is_periodic:
            raise NotImplementedError(
                "stencil operators require open knot vectors")
        if not np.array_equal(spans - kv.p, np.arange(kv.nel)):
            raise NotImplementedError(
                "stencil operators require single-multiplicity interior "
                "knots (element i supporting functions i..i+p)")


class StencilOperator:
    """W -> A @ W with A stored in stencil form (see module docstring)."""

    def __init__(self, S, grid_shape, degrees, nf):
        self.S = S
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.degrees = tuple(int(p) for p in degrees)
        self.nf = int(nf)
        self._k3_checked = None         # the S that kernel K3 last accepted

    @property
    def ndof(self):
        return self.nf * int(np.prod(self.grid_shape))

    def __call__(self, U):
        return stencil_apply(self, U)

    def apply(self, x, mask=None, b=None, dinv=None, omega=0.0,
              mode="apply"):
        """The level action of the multigrid solvers (``stencil_apply``):
        the masked operator, its residual or a fused Jacobi sweep."""
        return stencil_apply(self, x, mask, b, dinv, omega, mode)

    def astype(self, dtype):
        """Same stencil with cast values (the f64 arithmetic of the mixed
        polish solve over an f32-assembled operator)."""
        return StencilOperator(self.S.to(dtype), self.grid_shape,
                               self.degrees, self.nf)

    def diagonal(self):
        """Operator diagonal (Jacobi smoothing): a view-based slice of
        S[f, f, p, ..., p]."""
        center = tuple(self.degrees)
        d = self.S[(slice(None),) * 2 + center]        # [nf, nf, *grid]
        idx = torch.arange(self.nf, device=self.S.device)
        return d[idx, idx].reshape(-1)


def stencil_apply(st, x, mask=None, b=None, dinv=None, omega=0.0,
                  mode="apply", out=None, base=0, fstride=None):
    """Stencil action in one of three modes (A = the masked operator
    mask*S(mask*x) + (1-mask)*x when ``mask`` is given, else S):

      "apply"    : A x
      "residual" : b - A x
      "jacobi"   : x + (omega * dinv) * (b - A x)

    Patch mode (``fstride`` given): x, mask, b, dinv and ``out`` are
    vectors of a larger field-major layout in which DoF (f, i) of this
    stencil's grid sits at ``base + f * fstride + i`` (one patch of a
    multi-patch space); the result is written into ``out`` at those
    positions only, and ``out`` is returned.

    CUDA tensors run kernel K3; CPU tensors run ``stencil_apply_ref``."""
    if x.is_cuda:
        return stencil_apply_cuda(st, x, mask, b, dinv, omega, mode, out,
                                  base, fstride)
    return stencil_apply_ref(st, x, mask, b, dinv, omega, mode, out, base,
                             fstride)


def _plain_apply(st, U):
    grid = U.reshape((st.nf,) + st.grid_shape)
    pad = []
    for p in reversed(st.degrees):
        pad += [p, p]
    Upad = torch.nn.functional.pad(grid, pad)
    out = torch.zeros_like(grid)
    for off in _iproduct(*[range(2 * p + 1) for p in st.degrees]):
        sl = tuple(slice(d, d + n) for d, n in zip(off, st.grid_shape))
        shifted = Upad[(slice(None),) + sl]
        Soff = st.S[(slice(None), slice(None)) + off]
        out = out + (Soff * shifted[None]).sum(1)
    return out.reshape(-1)


def _patch_rows(st, base, fstride):
    """(field-major) positions of the stencil's DoFs in a larger layout."""
    n = int(np.prod(st.grid_shape))
    return [slice(base + f * fstride, base + f * fstride + n)
            for f in range(st.nf)]


def stencil_apply_ref(st, x, mask=None, b=None, dinv=None, omega=0.0,
                      mode="apply", out=None, base=0, fstride=None):
    """Plain PyTorch twin of kernel K3 (zero padding at the boundary, the
    ``jnp.pad`` of the JAX stencil apply).  Patch mode copies the patch
    out and back, as the JAX package's multi-patch operator does."""
    if fstride is not None:
        rows = _patch_rows(st, base, fstride)

        def take(v):
            return None if v is None else torch.cat([v[r] for r in rows])
        y = stencil_apply_ref(st, take(x), take(mask), take(b), take(dinv),
                              omega, mode)
        for f, r in enumerate(rows):
            out[r] = y.view(st.nf, -1)[f]
        return out
    if mask is None:
        Ax = _plain_apply(st, x)
    else:
        Ax = mask * _plain_apply(st, mask * x) + (1.0 - mask) * x
    if mode == "apply":
        return Ax
    if mode == "residual":
        return b - Ax
    if mode == "jacobi":
        return x + (omega * dinv) * (b - Ax)
    raise ValueError(f"unknown stencil mode {mode!r}")


def _k3_stencil(st):
    """The operator's S for kernel K3, checked once per S (what the
    binding cannot see: nf, degrees and the grid; CUDA, float32 or
    float64, contiguous)."""
    S = st.S
    if st._k3_checked is not S:
        if not S.is_cuda:
            raise ValueError("stencil kernel needs CUDA tensors")
        if st.nf != 3 or st.degrees != (2, 2):
            raise ValueError("stencil kernel is built for nf=3, p=2 in 2D")
        if S.shape != (3, 3, 5, 5) + st.grid_shape:
            raise ValueError(f"stencil shape {tuple(S.shape)}")
        if S.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"stencil dtype {S.dtype}")
        if not S.is_contiguous():
            return S.contiguous()
        st._k3_checked = S
    return S


def stencil_apply_cuda(st, x, mask=None, b=None, dinv=None, omega=0.0,
                       mode="apply", out=None, base=0, fstride=None):
    """Kernel K3: 9 threads a grid point (one per output and input field
    pair) over 2D tiles, the tile's mask * x staged once in shared memory
    (nf=3, p=2, 2D); in patch mode it reads and writes the patch in place
    through ``base`` and the field stride.  The checks that depend only on
    the stencil run once per S; the binding checks every vector (shape,
    dtype, device, contiguity) and the patch's fit, and raises
    RuntimeError."""
    code = MODES.get(mode)
    if code is None:
        raise ValueError(f"unknown stencil mode {mode!r}")
    S = _k3_stencil(st)
    if x.dtype != S.dtype:
        raise TypeError(f"x {x.dtype} vs stencil {S.dtype}")
    if code and b is None:
        raise ValueError(f"mode {mode!r} needs b")
    if code == 2 and dinv is None:
        raise ValueError(f"mode {mode!r} needs dinv")
    if fstride is None:
        if out is not None or base != 0:
            raise ValueError("out and base are patch-mode arguments")
        fstride = S.shape[4] * S.shape[5]
    elif out is None:
        raise ValueError("patch mode writes into out")
    else:
        p = out.data_ptr()
        for k, v in (("x", x), ("mask", mask), ("b", b), ("dinv", dinv)):
            if v is not None and v.data_ptr() == p:
                raise ValueError(f"out must not alias {k}")
    y = cuda_ext.load().stencil_apply(S, x, mask, b, dinv, float(omega), code,
                                      out, int(base), int(fstride))
    cuda_ext.count("stencil_apply", st.grid_shape)
    return y


def stencil_to_dense(st):
    """Densify a StencilOperator on the host (numpy) -- coarsest-level
    multigrid inverses."""
    S = st.S.detach().cpu().numpy()
    dim = len(st.grid_shape)
    n = int(np.prod(st.grid_shape))
    A = np.zeros((st.nf * n, st.nf * n), dtype=S.dtype)
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * st.grid_shape[d + 1]
    for off in _iproduct(*[range(2 * p + 1) for p in st.degrees]):
        out_sl, flat_shift = [], 0
        for d, (o, p, ng) in enumerate(zip(off, st.degrees,
                                           st.grid_shape)):
            s = o - p
            out_sl.append(slice(max(0, -s), min(ng, ng - s)))
            flat_shift += s * strides[d]
        rows_grid = np.arange(n).reshape(st.grid_shape)[tuple(out_sl)]
        rows = rows_grid.reshape(-1)
        cols = rows + flat_shift
        blk = S[(slice(None), slice(None)) + off + tuple(out_sl)]
        blk = blk.reshape(st.nf, st.nf, -1)
        for f in range(st.nf):
            for g in range(st.nf):
                A[f * n + rows, g * n + cols] = blk[f, g]
    return A


def _layout(basis):
    degrees = tuple(kv.p for kv in reversed(basis.kvs))       # slowest first
    grid_shape = tuple(kv.ncp for kv in reversed(basis.kvs))
    nel_shape = tuple(kv.nel for kv in reversed(basis.kvs))
    return degrees, grid_shape, nel_shape


def stencil_from_element_matrices(basis, E, nf):
    """Fold element matrices E [nel, nloc, nloc] (field-major local
    ordering, direction 0 fastest) into a StencilOperator over the scalar
    tensor-product ``basis`` shared by all ``nf`` fields: one slice-add per
    (local-row, local-col) pair at offset (col - row) + p."""
    _check_uniform_support(basis)
    degrees, grid_shape, nel_shape = _layout(basis)
    nen = int(np.prod([p + 1 for p in degrees]))
    nel = int(np.prod(nel_shape))
    if tuple(E.shape) != (nel, nf * nen, nf * nen):
        raise ValueError(f"E shape {tuple(E.shape)} does not match "
                         f"(nel={nel}, nloc={nf * nen})")
    Eg = E.reshape(nel_shape + (nf, nen, nf, nen))
    S = torch.zeros((nf, nf) + tuple(2 * p + 1 for p in degrees)
                    + grid_shape, dtype=E.dtype, device=E.device)
    local_tuples = list(_iproduct(*[range(p + 1) for p in degrees]))

    def flat_local(t):      # direction 0 fastest == last tuple slot fastest
        f = 0
        for td, pd in zip(t, degrees):
            f = f * (pd + 1) + td
        return f

    for a in local_tuples:
        for b in local_tuples:
            off = tuple(bb - aa + p for aa, bb, p in zip(a, b, degrees))
            blk = Eg[(Ellipsis, slice(None), flat_local(a),
                      slice(None), flat_local(b))]       # [*nel, nf, nf]
            blk = torch.movedim(blk, (-2, -1), (0, 1))   # [nf, nf, *nel]
            sl = tuple(slice(aa, aa + ne)
                       for aa, ne in zip(a, nel_shape))
            S[(slice(None), slice(None)) + off + sl] += blk
    return StencilOperator(S, grid_shape, degrees, nf)


def build_stencil(asm, adjoint_density, U, basis, nf):
    """Tangent stencil of an adjoint-jet density at state U.  CUDA tensors
    run kernel K2; CPU tensors run ``build_stencil_ref``."""
    if U.is_cuda:
        return build_stencil_cuda(asm, adjoint_density, U, basis, nf)
    return build_stencil_ref(asm, adjoint_density, U, basis, nf)


def build_stencil_ref(asm, adjoint_density, U, basis, nf):
    """Plain twin of K2: jacfwd/vmap element matrices, then the fold."""
    from .assembly import element_matrices_adjoint_ref
    return stencil_from_element_matrices(
        basis, element_matrices_adjoint_ref(asm, adjoint_density, U), nf=nf)


def build_stencil_cuda(asm, adjoint_density, U, basis, nf):
    """Kernel K2: per element, the 18x18 pointwise jet-Jacobian of the SVK
    adjoint at each quadrature point by forward-mode dual numbers (a block
    takes a few elements), the upper triangle of the 27x27 element matrix
    E = sum_q w_q B^T K B by register tiles, and an atomic fold of each
    entry and its mirror into S at offset (b - a) + p.  Its launches are
    tallied by dtype and point count (``cuda_ext.counts_by``)."""
    from .assembly import shell_kernel_args, shell_padding_mask
    if asm.nens[0] != 9 or shell_padding_mask(asm) is not None:
        raise ValueError("the stencil fold takes unpadded biquadratic "
                         "elements (9 local functions a field); got "
                         f"{asm.nens[0]}")
    args = shell_kernel_args(asm, adjoint_density, U)
    _check_uniform_support(basis)
    degrees, grid_shape, nel_shape = _layout(basis)
    if nf != 3 or degrees != (2, 2) or \
            int(np.prod(nel_shape)) != asm.nel or asm.nq > 9:
        raise ValueError("tangent kernel is built for nf=3, p=2 in 2D with "
                         "at most 9 quadrature points")
    ext = cuda_ext.load()
    S = ext.tangent_stencil(U.contiguous(), *args,
                            list(adjoint_density.kernel_constants()[:4]),
                            list(nel_shape), list(grid_shape))
    cuda_ext.count("tangent_stencil",
                   f"{cuda_ext.short_dtype(U.dtype)} nq={asm.nq}")
    return StencilOperator(S, grid_shape, degrees, nf)
