"""Div- and curl-conforming (RT/N-type) compatible B-spline field spaces
(port of the field generators of tigar_tpu/models/compatible.py).

The compatible field spaces are built from the control mesh's unique knots
with the degree raised along (RT) or perpendicular to (N) each field's
direction (reference: compatibleSplines.py:21-65); velocities live in the
parametric domain and are pushed forward at quadrature points
(forms.QP.pushforward_RT / pushforward_N / pushforward_W).  The
iterated-penalty solver and the div-free projections are not ported yet
(ROADMAP item A9), nor are multi-patch compatible spaces.
"""

from __future__ import annotations

import numpy as np

from .bspline import ControlMesh, TensorBSplineBasis
from .space import FieldListSpline


def _compat_fields_one_patch(base: TensorBSplineBasis, rt_or_n, degrees,
                             periodicities=None):
    nvar = len(degrees)
    fields = []
    for i in range(nvar):       # field (velocity component) index
        kvecs = []
        field_degs = []
        for j in range(nvar):   # parametric direction
            degree = int(degrees[j])
            if (rt_or_n == "RT") == (j == i):
                degree += 1
            knots = np.asarray(base.kvs[j].unique_knots, dtype=np.float64)
            if periodicities is None or not periodicities[j]:
                knots = np.concatenate([np.full(degree, knots[0]), knots,
                                        np.full(degree, knots[-1])])
            kvecs.append(knots)
            field_degs.append(degree)
        fields.append(TensorBSplineBasis(field_degs, kvecs))
    return fields


def generate_fields_compat(control_mesh: ControlMesh, rt_or_n, degrees,
                           periodicities=None):
    """Scalar bases of the components of an RT- or N-type compatible spline
    (reference: generateFieldsCompat, compatibleSplines.py:21-65).
    ``degrees`` is k' in J.A. Evans's notation; the polynomial degree is
    raised by one along (RT) / perpendicular to (N) the field direction.
    Single-patch tensor-product control meshes only."""
    base = control_mesh.scalar_basis()
    if not isinstance(base, TensorBSplineBasis):
        raise TypeError("compatible splines require a tensor-product "
                        "B-spline control basis (multi-patch compatible "
                        "spaces are not ported yet)")
    return _compat_fields_one_patch(base, rt_or_n, degrees, periodicities)


class BSplineCompat(FieldListSpline):
    """Multi-field space with one compatible-spline component per parametric
    direction (reference: BSplineCompat, compatibleSplines.py:68-101)."""

    def __init__(self, control_mesh, rt_or_n, degrees, periodicities=None):
        fields = generate_fields_compat(control_mesh, rt_or_n, degrees,
                                        periodicities)
        super().__init__(control_mesh, fields)
        self.rt_or_n = rt_or_n
