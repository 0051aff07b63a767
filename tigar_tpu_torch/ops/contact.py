"""All-pairs penalty contact in point space: the pair forces (the gradient
of the pair energy) and their tangent action (port of the pair work of
tigar_tpu/contact.py: ``_contact_residual`` :205, ``_contact_tangent``
:210).

Points x [n, nsd] carry lumped weights w [n]; pairs are live where the
static bool mask [n, n] holds (symmetric: reference distances above the
self-contact radius), and interact through phi(r) = k/2 (r_max - r)^2 for
r < r_max.  The energy is 1/2 sum_ij live_ij w_i w_j phi(|x_i - x_j|).

Kernels K13 (``contact_forces``) and K14 (``contact_hvp``),
csrc/contact_pairs.cu, carry the pair loop on CUDA tensors; they take the
mask as the [n, n] view of a zero-padded [n, ld] buffer with ld a multiple
of 16 (``padded_pair_mask``) and read its bits (``pair_bits``, built once
by ``PointContact``, else at each call), nsd = 3 and the default
potential.  The kernels skip each pair of 32-point tiles that
``culled_tile_pairs`` names.  The plain versions, ``contact_forces_ref``
and ``contact_hvp_ref``, are torch.func derivatives of the row-blocked
energy, for any potential; CPU tensors go to them.  A custom potential on
CUDA tensors raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_ext

# rows a block of the plain versions when n exceeds ROW_CHUNK_ABOVE (as
# tigar_tpu/contact.py:123-124)
ROW_CHUNK, ROW_CHUNK_ABOVE = 2048, 4096


def pair_penalty_energy(k, r_max):
    """phi(r) = k/2 (r_max - r)^2 for r < r_max, else 0."""
    def phi(r):
        return torch.where(r < r_max, 0.5 * k * (r_max - r) ** 2,
                           torch.zeros_like(r))
    return phi


def padded_pair_mask(mask, device):
    """The [n, n] bool view of a zero-padded [n, ld] buffer (ld the next
    multiple of 16) on ``device``: the layout K13/K14 read."""
    mask = torch.as_tensor(np.array(mask) if not isinstance(
        mask, torch.Tensor) else mask, dtype=torch.bool)
    n = mask.shape[0]
    ld = -(-max(n, 1) // 16) * 16
    buf = torch.zeros((n, ld), dtype=torch.bool, device=device)
    buf[:, :n] = mask.to(device)
    return buf[:, :n]


TILE = 32           # points a tile of the kernels' bits and culling


class PairBits(NamedTuple):
    """The pair mask as the kernels read it: ``words`` int32 [nt, n] (nt =
    ceil(n / 32)), bit b of words[J, i] the pair (i, 32 J + b), zero
    beyond n; ``tiles`` uint8 [nt, nt], 1 where a pair of tiles holds a
    live pair."""
    words: torch.Tensor
    tiles: torch.Tensor


def pair_bits(pair_mask, rows=1024):
    """``PairBits`` of a symmetric bool mask [n, n] (any strides), on its
    device, built ``rows`` rows at a time."""
    n = pair_mask.shape[0]
    nt = -(-n // TILE)
    dev = pair_mask.device
    words = torch.empty((nt, n), dtype=torch.int32, device=dev)
    weights = 2 ** torch.arange(TILE, dtype=torch.int64, device=dev)
    for i0 in range(0, n, rows):
        m = torch.zeros((min(rows, n - i0), nt * TILE), dtype=torch.int64,
                        device=dev)
        m[:, :n] = pair_mask[i0:i0 + rows]
        val = (m.view(-1, nt, TILE) * weights).sum(-1)       # < 2^32
        words[:, i0:i0 + rows] = (val - (val >= 2 ** 31) * 2 ** 32).t().to(
            torch.int32)
    pad = torch.zeros((nt, nt * TILE), dtype=torch.int32, device=dev)
    pad[:, :n] = words
    # tiles[I, J]: rows of tile I against the columns of tile J
    tiles = (pad.view(nt, nt, TILE) != 0).any(-1).t().contiguous()
    return PairBits(words, tiles.to(torch.uint8))


def tile_boxes(x):
    """[nt, 6] axis-aligned boxes (lo xyz, hi xyz) of the 32-point tiles
    of points x [n, 3]: the kernels' first launch."""
    n = x.shape[0]
    nt = -(-n // TILE)
    lo = torch.full((nt * TILE, 3), float("inf"), dtype=x.dtype,
                    device=x.device)
    hi = torch.full((nt * TILE, 3), float("-inf"), dtype=x.dtype,
                    device=x.device)
    lo[:n], hi[:n] = x, x
    return torch.cat([lo.view(nt, TILE, 3).amin(1),
                      hi.view(nt, TILE, 3).amax(1)], dim=1)


def culled_tile_pairs(x, bits, r_max):
    """bool [nt, nt]: the (row tile, column tile) pairs the kernels skip at
    points x: none of their pairs live, or boxes whose squared gap is at
    least r_max^2 (1 + eps), eps 1e-6 in float32 and 1e-14 in float64
    (the kernels' test, in x's type)."""
    b = tile_boxes(x)
    lo, hi = b[:, :3], b[:, 3:]
    gap = torch.clamp(torch.maximum(lo[None, :, :] - hi[:, None, :],
                                    lo[:, None, :] - hi[None, :, :]), min=0)
    g2 = (gap * gap).sum(-1)
    eps = 1e-6 if x.dtype == torch.float32 else 1e-14
    r2cull = torch.tensor(r_max * r_max * (1.0 + eps), dtype=x.dtype)
    return (bits.tiles == 0) | ~(g2 < r2cull.to(x.device))


def default_row_chunk(n, row_chunk=None):
    if row_chunk is None and n > ROW_CHUNK_ABOVE:
        return ROW_CHUNK
    return row_chunk


def _row_blocks(n, row_chunk):
    step = n if not row_chunk or row_chunk >= n else int(row_chunk)
    return [(i0, min(i0 + step, n)) for i0 in range(0, n, step)]


def rows_energy(x, w, pair_mask, phi, r_max, i0, i1):
    """Pair energy of rows [i0, i1) against all points: 1/2 sum_i w_i
    sum_j live_ij w_j phi(r_ij), masked pairs at a dummy distance so the
    sqrt stays differentiable."""
    diff = x[i0:i1, None, :] - x[None, :, :]
    r2 = torch.sum(diff * diff, dim=-1)
    m = pair_mask[i0:i1]
    r = torch.sqrt(torch.where(m, r2, torch.full_like(r2, 1.0 + r_max ** 2)))
    live = m.to(x.dtype)
    return 0.5 * torch.sum(w[i0:i1] * torch.sum(live * w * phi(r), dim=-1))


def pair_energy(x, w, pair_mask, phi, r_max, row_chunk=None):
    """The total pair energy, summed over row blocks."""
    return sum(rows_energy(x, w, pair_mask, phi, r_max, i0, i1)
               for i0, i1 in _row_blocks(x.shape[0], row_chunk))


def contact_forces_ref(x, w, pair_mask, phi, r_max, row_chunk=None):
    """Plain version of K13: d(energy)/dx [n, nsd], the gradient of each
    row block's energy by torch.func, summed."""
    g = torch.zeros_like(x)
    for i0, i1 in _row_blocks(x.shape[0], row_chunk):
        g = g + torch.func.grad(
            lambda y, i0=i0, i1=i1: rows_energy(y, w, pair_mask, phi, r_max,
                                                i0, i1))(x)
    return g


def contact_hvp_ref(x, v, w, pair_mask, phi, r_max, row_chunk=None):
    """Plain version of K14: the Hessian of the energy at x applied to v
    [n, nsd], forward over reverse by torch.func per row block."""
    out = torch.zeros_like(x)
    for i0, i1 in _row_blocks(x.shape[0], row_chunk):
        grad = torch.func.grad(
            lambda y, i0=i0, i1=i1: rows_energy(y, w, pair_mask, phi, r_max,
                                                i0, i1))
        out = out + torch.func.jvp(grad, (x,), (v,))[1]
    return out


def _check(x, w, pair_mask, v=None):
    n = x.shape[0]
    if x.dim() != 2 or x.shape[1] != 3:
        raise NotImplementedError("K13/K14 take 3D points [n, 3]")
    for name, t in (("x", x), ("w", w)) + ((("v", v),) if v is not None
                                           else ()):
        if not (t.is_cuda and t.is_contiguous() and t.dtype == x.dtype):
            raise ValueError(f"{name} must be a contiguous CUDA tensor of "
                             f"x's type")
    if tuple(w.shape) != (n,) or (v is not None and v.shape != x.shape):
        raise ValueError("w must be [n] and v [n, 3]")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError("K13/K14 take float32 or float64")
    if pair_mask.dtype != torch.bool or tuple(pair_mask.shape) != (n, n):
        raise ValueError("the pair mask must be bool [n, n]")
    ld = pair_mask.stride(0)
    if pair_mask.stride(1) != 1 or ld < n or ld % 16:
        raise ValueError("the pair mask must be the view of a padded "
                         "buffer (padded_pair_mask)")


def contact_forces(x, w, pair_mask, k, r_max, phi=None, row_chunk=None,
                   bits=None):
    """Pair forces d(energy)/dx.  CUDA tensors run K13 (the default
    potential only: a custom ``phi`` raises) on ``bits``, the mask's
    ``pair_bits`` (built here when None); CPU tensors run
    ``contact_forces_ref``."""
    if x.is_cuda:
        if phi is not None:
            raise NotImplementedError(
                "a custom contact potential has no CUDA kernel (K13/K14 "
                "implement pair_penalty_energy)")
        _check(x, w, pair_mask)
        bits = pair_bits(pair_mask) if bits is None else bits
        g = cuda_ext.load().contact_residual(bits.words, bits.tiles, x, w,
                                             float(k), float(r_max))
        cuda_ext.count("contact_residual", cuda_ext.short_dtype(x.dtype))
        return g
    phi = pair_penalty_energy(k, r_max) if phi is None else phi
    return contact_forces_ref(x, w, pair_mask, phi, r_max, row_chunk)


def contact_hvp(x, v, w, pair_mask, k, r_max, phi=None, row_chunk=None,
                bits=None):
    """Tangent action of the pair forces on point perturbations v.  CUDA
    tensors run K14 (default potential only) on ``bits`` as
    ``contact_forces``; CPU tensors run ``contact_hvp_ref``."""
    if x.is_cuda:
        if phi is not None:
            raise NotImplementedError(
                "a custom contact potential has no CUDA kernel (K13/K14 "
                "implement pair_penalty_energy)")
        _check(x, w, pair_mask, v)
        bits = pair_bits(pair_mask) if bits is None else bits
        out = cuda_ext.load().contact_tangent(bits.words, bits.tiles, x, v,
                                              w, float(k), float(r_max))
        cuda_ext.count("contact_tangent", cuda_ext.short_dtype(x.dtype))
        return out
    phi = pair_penalty_energy(k, r_max) if phi is None else phi
    return contact_hvp_ref(x, v, w, pair_mask, phi, r_max, row_chunk)
