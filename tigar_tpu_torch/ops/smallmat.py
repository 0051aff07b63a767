"""Closed-form determinants/inverses for 1x1..3x3 matrices (port of
tigar_tpu/ops/smallmat.py).  Batched over leading dimensions; the metric
and frame inverses of IGA are d x d with d <= 3, where the adjugate formula
is exact enough and avoids a batched LU."""

from __future__ import annotations

import torch


def det_small(A):
    """Determinant of a static-shape [..., n, n] matrix, n <= 3."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return (A[..., 0, 0] * A[..., 1, 1]
                - A[..., 0, 1] * A[..., 1, 0])
    if n == 3:
        return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                                - A[..., 1, 2] * A[..., 2, 1])
                - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                                  - A[..., 1, 2] * A[..., 2, 0])
                + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                                  - A[..., 1, 1] * A[..., 2, 0]))
    raise ValueError("det_small supports n <= 3")


def inv_small(A, det=None):
    """Inverse of a static-shape [..., n, n] matrix, n <= 3 (adjugate)."""
    n = A.shape[-1]
    if det is None:
        det = det_small(A)
    if n == 1:
        return (1.0 / A[..., 0, 0])[..., None, None]
    if n == 2:
        adj = torch.stack([
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    if n == 3:
        c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
        c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
        c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
        c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
        c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
        c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
        c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
        c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
        c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        adj = torch.stack([
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    raise ValueError("inv_small supports n <= 3")
