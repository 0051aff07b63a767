"""Gauss-Legendre quadrature rules.

The reference hard-codes 1-4 point rules on (-1,1) (calculusUtils.py:412-470)
for through-thickness shell integration and space-time DG, and otherwise
relies on FEniCS' ``quadrature_degree`` metadata for element integration
(tIGArMeasure, calculusUtils.py:379-381).  Here Gauss rules of arbitrary
order are generated directly and element quadrature is explicit: a rule of
``n`` points per direction integrates polynomial degree ``2n-1`` exactly.

Host-side numpy copy of tigar_tpu/ops/quadrature.py for the PyTorch port (which never
imports the JAX package).
"""

from __future__ import annotations

import numpy as np


def gauss_rule(n):
    """``n``-point Gauss-Legendre rule on (-1, 1): (points, weights)."""
    if n < 1:
        raise ValueError("need at least one quadrature point")
    pts, wts = np.polynomial.legendre.leggauss(int(n))
    return pts, wts


def gauss_rule_interval(n, L):
    """``n``-point rule on (-L/2, L/2) (reference: getQuadRuleInterval,
    calculusUtils.py:459-470)."""
    pts, wts = gauss_rule(n)
    return 0.5 * L * pts, 0.5 * L * wts


def npoints_for_degree(quad_deg):
    """Minimum Gauss points per direction to integrate polynomial degree
    ``quad_deg`` exactly (matches FEniCS' quadrature_degree semantics on
    quadrilateral/hexahedral elements)."""
    return (int(quad_deg) + 2) // 2
