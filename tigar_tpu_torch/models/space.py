"""Multi-field spline function spaces and their generators.

TPU-native counterpart of the reference's extraction-generator hierarchy
(AbstractExtractionGenerator / AbstractMultiFieldSpline / EqualOrderSpline /
FieldListSpline, tIGAr/common.py:130-503, 1794-1970).  A generator here does
not build an FE mesh or sparse extraction matrices; it only fixes the list
of scalar field bases over one control mesh, the global DoF layout (fields
concatenated, field offsets), and the homogeneous Dirichlet DoF set.

Host-side numpy copy (SplineSpace, EqualOrderSpline) for the PyTorch port.
"""

from __future__ import annotations

import numpy as np

from ..config import INDEX_TYPE
from .bspline import ControlMesh


class SplineSpace:
    """DoF layout for a list of scalar fields over one control mesh.

    Global DoF numbering concatenates fields: global = offset[field] + local
    (reference: globalDof, common.py:242-252).
    """

    def __init__(self, control_mesh: ControlMesh, fields):
        self.control_mesh = control_mesh
        self.fields = list(fields)
        self.offsets = np.concatenate(
            [[0], np.cumsum([f.ncp for f in self.fields])]).astype(np.int64)
        self.ndof = int(self.offsets[-1])
        self._zero_dofs = set()

    @property
    def nfields(self):
        return len(self.fields)

    @property
    def nsd(self):
        return self.control_mesh.nsd

    def field_slice(self, field):
        return slice(int(self.offsets[field]), int(self.offsets[field + 1]))

    # -- Dirichlet boundary conditions ----------------------------------------

    def add_zero_dofs(self, field, dofs):
        """Register homogeneous Dirichlet DoFs of ``field`` (local indices;
        reference: addZeroDofs, common.py:265-282)."""
        off = int(self.offsets[field])
        for d in np.atleast_1d(np.asarray(dofs, dtype=np.int64)):
            self._zero_dofs.add(off + int(d))

    def add_zero_dofs_global(self, dofs):
        for d in np.atleast_1d(np.asarray(dofs, dtype=np.int64)):
            self._zero_dofs.add(int(d))

    def add_zero_dofs_by_location(self, predicate, field):
        """Constrain DoFs of ``field`` whose associated control points satisfy
        ``predicate(x)`` with x the dehomogenized physical location.  Only
        meaningful for equal-order splines, where DoFs correspond one-to-one
        to geometry control points (reference: addZeroDofsByLocation,
        common.py:1916-1945)."""
        B = self.control_mesh.homogeneous_points()
        x = B[:, :-1] / B[:, -1:]
        for node in range(B.shape[0]):
            if predicate(x[node]):
                self.add_zero_dofs(field, [node])

    def zero_dofs(self):
        """Sorted global indices of constrained DoFs."""
        return np.asarray(sorted(self._zero_dofs), dtype=INDEX_TYPE)

    def bc_mask(self):
        """[ndof] float mask: 0 at constrained DoFs, 1 elsewhere."""
        m = np.ones(self.ndof)
        zd = self.zero_dofs()
        if len(zd):
            m[zd] = 0.0
        return m


class EqualOrderSpline(SplineSpace):
    """All unknown fields discretized with the control mesh's scalar basis
    (isoparametric; reference: common.py:1891-1945)."""

    def __init__(self, nfields, control_mesh: ControlMesh):
        basis = control_mesh.scalar_basis()
        super().__init__(control_mesh, [basis] * int(nfields))

    def get_scalar_spline(self, field=0):
        return self.fields[field]
