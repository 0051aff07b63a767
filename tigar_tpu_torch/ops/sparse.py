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
  - K11 (csrc/ell_spmv.cu), ``EllOperator`` on CUDA tensors: the
    padded-row (ELL) product y_i = sum_k vals[i, k]
    x[cols[i, k]], its residual b - A x, the weighted-Jacobi update
    x + om_dinv (b - A x), that update from x = 0 ("jacobi0", x0 =
    om_dinv b formed inside the gather) and the correction b + A x
    ("add"), over a sliced layout of the carried arrays that
    ``sliced_ell`` builds (and checks) once, where the operator reaches
    the card.  Replaces the gather-contracts of tigar_tpu/solvers/
    aggregation.py _mlsa_apply and the cycles' elementwise steps around
    them.  Plain versions: ``ell_spmv_ref`` (the carried arrays) and
    ``sliced_ell_ref`` (the sliced layout).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_ext

ELL_MODES = {"apply": 0, "residual": 1, "jacobi": 2, "jacobi0": 3, "add": 4}
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


def _ell_epilogue(Ax, x, b, om_dinv, mode):
    if mode == "apply":
        return Ax
    if mode == "residual":
        return b - Ax
    if mode in ("jacobi", "jacobi0"):
        return x + om_dinv * (b - Ax)
    if mode == "add":
        return b + Ax
    raise ValueError(f"unknown ELL mode {mode!r}")


def ell_spmv_ref(cols, vals, x, b=None, om_dinv=None, mode="apply"):
    """Plain PyTorch version of K11 on the carried arrays (the einsum
    gather-contract)."""
    if mode == "jacobi0":
        x = om_dinv * b
    Ax = torch.einsum("ik,ik->i", vals, x[cols])
    return _ell_epilogue(Ax, x, b, om_dinv, mode)


class SlicedEll(NamedTuple):
    """K11's layout of an n x ncols ELL operator: the rows in tiles of
    ELL_THREADS / lanes rows (one block each), tile t = tiles[t] = (row0,
    width, lanes) with 4 to 256 lanes a row, its rows' slots
    row-major at cols/vals[starts[t] + r width + k], the width its longest
    row (the last nonzero slot) rounded up to a multiple of 4, one 16-byte
    load of cols; padding slots carry column 0 and value 0."""
    tiles: torch.Tensor         # int32 [ntiles, 3]
    starts: torch.Tensor        # int64 [ntiles + 1]
    cols: torch.Tensor          # int32 [starts[-1]]
    vals: torch.Tensor          # [starts[-1]]
    n: int
    ncols: int

    @property
    def width(self):
        """[ntiles] the tiles' widths."""
        return self.tiles[:, 1]

    def fill(self):
        """(nonzero slots, slots of the layout): the share of the layout's
        slots that carry entries is their ratio."""
        return int((self.vals != 0).sum()), int(self.starts[-1])


def _tile_of_rows(chunks):
    """Per row, (its tile's first row, lanes) of K11's tiling: within each
    aligned run of 64 rows, the tallest aligned tiles of 64 >> l rows at
    4 << l lanes a row (l = 0..6, ELL_THREADS threads a tile) whose lanes
    read at most 4 chunks of 4 slots each, one row of 256 lanes past
    that."""
    n = chunks.shape[0]
    dev = chunks.device
    c = torch.nn.functional.pad(chunks, (0, -(-n // 64) * 64 - n))
    r = torch.arange(c.shape[0], device=dev)
    level = torch.full_like(r, 6)
    for lv in range(5, -1, -1):
        rows = 64 >> lv
        fits = c.view(-1, rows).amax(1) <= 16 << lv
        level = torch.where(fits[r // rows], lv, level)
    height = 64 >> level
    return ((r // height) * height)[:n], (4 << level)[:n]


def sliced_ell(cols, vals, ncols):
    """The sliced layout of carried ELL arrays (cols [n, K] int32, vals
    [n, K]) on their device; rows keep their slots' order, trailing
    zero-valued slots are dropped."""
    n, K = cols.shape
    dev = cols.device
    K4 = -(-K // 4) * 4
    last = (vals != 0).to(torch.int64) * torch.arange(1, K + 1, device=dev)
    rowlen = last.amax(dim=1) if K else torch.zeros(n, dtype=torch.int64,
                                                   device=dev)
    first, lanes = _tile_of_rows((rowlen + 3) // 4)
    r = torch.arange(n, device=dev)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = first[1:] != first[:-1]
    tile = torch.cumsum(head.to(torch.int64), 0) - 1
    nt = int(head.sum())
    width = torch.zeros(nt, dtype=torch.int64, device=dev).scatter_reduce(
        0, tile, (rowlen + 3) // 4 * 4, "amax")
    height = torch.zeros(nt, dtype=torch.int64, device=dev).index_add_(
        0, tile, torch.ones_like(tile))
    starts = torch.zeros(nt + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(width * height, 0)
    total = int(starts[-1])
    w = width[tile]
    rowstart = starts[tile] + (r - first) * w
    keep = torch.arange(K4, device=dev)[None, :] < w[:, None]
    dest = (rowstart[:, None] + torch.arange(K4, device=dev)[None, :])[keep]
    pad = (0, K4 - K)
    out_c = torch.zeros(total, dtype=torch.int32, device=dev)
    out_v = torch.zeros(total, dtype=vals.dtype, device=dev)
    out_c[dest] = torch.nn.functional.pad(cols, pad)[keep]
    out_v[dest] = torch.nn.functional.pad(vals, pad)[keep]
    tiles = torch.stack([first[head], width, lanes[head]], dim=1)
    return SlicedEll(tiles.to(torch.int32).contiguous(), starts, out_c,
                     out_v, int(n), int(ncols))


def sliced_ell_ref(sl, x, b=None, om_dinv=None, mode="apply"):
    """Plain PyTorch version of K11 on the sliced layout: its slots laid
    back out as padded rows [n, max width], then the gather-contract."""
    n = sl.n
    dev = sl.vals.device
    r = torch.arange(n, device=dev)
    t = sl.tiles.to(torch.int64)
    first = torch.zeros(n, dtype=torch.int64, device=dev)
    first[t[:, 0]] = 1
    tile = torch.cumsum(first, 0) - 1
    w = t[tile, 1]
    Kw = int(t[:, 1].max()) if t.shape[0] else 0
    k = torch.arange(Kw, device=dev)
    keep = k[None, :] < w[:, None]
    src = (sl.starts[tile] + (r - t[tile, 0]) * w)[:, None] + k[None, :]
    cols = torch.zeros((n, Kw), dtype=torch.int64, device=dev)
    vals = torch.zeros((n, Kw), dtype=sl.vals.dtype, device=dev)
    cols[keep] = sl.cols[src[keep]].to(torch.int64)
    vals[keep] = sl.vals[src[keep]]
    return ell_spmv_ref(cols, vals, x, b, om_dinv, mode)


class EllOperator:
    """One ELL operator of the SA cycles, n x ncols: the carried padded-row
    arrays (cols [n, K] int32, vals [n, K]; the plain version reads them)
    and, on the card, their sliced layout (kernel K11 reads it), built and
    checked once here.  ``op(x, b, om_dinv, mode)``:

      "apply"    : A x
      "residual" : b - A x
      "jacobi"   : x + om_dinv (b - A x)   (square A)
      "jacobi0"  : the same at x = om_dinv b (x unused; square A)
      "add"      : b + A x

    With a ``key`` its launches are tallied by (key, mode)
    (``cuda_ext.counts_by``)."""

    def __init__(self, cols, vals, ncols, key=None):
        if cols.dim() != 2 or tuple(vals.shape) != tuple(cols.shape) or \
                cols.dtype != torch.int32:
            raise ValueError(f"cols {tuple(cols.shape)} {cols.dtype} and "
                             f"vals {tuple(vals.shape)} do not match")
        if vals.dtype not in _FLOATS:
            raise TypeError(f"vals has dtype {vals.dtype}")
        self.cols, self.vals = cols, vals
        self.n, self.ncols = int(cols.shape[0]), int(ncols)
        self.key = key
        self.card = None
        if vals.is_cuda:
            if not (cols.is_cuda and cols.is_contiguous()
                    and vals.is_contiguous()):
                raise ValueError("cols and vals must be contiguous CUDA "
                                 "tensors")
            if cols.numel() and not (0 <= int(cols.min())
                                     and int(cols.max()) < self.ncols):
                raise ValueError(f"cols leave the {self.ncols} columns")
            self.card = sliced_ell(cols, vals, self.ncols)

    def __call__(self, x, b=None, om_dinv=None, mode="apply"):
        """Kernel K11 on the sliced layout (one block a tile, 4-256 lanes a
        row by the tile's rows, 16-byte loads of cols and vals, a shuffle
        and shared-memory reduction, the mode's epilogue; no atomics) when
        the operator lies on the card: the binding checks the vectors and
        raises RuntimeError.  The plain version on the CPU."""
        sl = self.card
        if sl is None:
            return ell_spmv_ref(self.cols, self.vals, x, b, om_dinv, mode)
        code = ELL_MODES.get(mode)
        if code is None:
            raise ValueError(f"unknown ELL mode {mode!r}")
        y = cuda_ext.load().ell_spmv(sl.tiles, sl.starts, sl.cols, sl.vals,
                                     sl.n, sl.ncols, x, b, om_dinv, code)
        cuda_ext.count("ell_spmv",
                       None if self.key is None else (self.key, mode))
        return y
