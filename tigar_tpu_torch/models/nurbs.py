"""NURBS control meshes (port of tigar_tpu/models/nurbs.py).

Counterpart of the reference's NURBSControlMesh (tIGAr/NURBS.py:13-77).
The control mesh is built from (degrees, knot vectors, homogeneous control
grid); the PetIGA ``.dat`` input path needs ``petiga_io``, which is not
ported yet (ROADMAP item A7b).
"""

from __future__ import annotations

import numpy as np

from .bspline import ControlMesh, TensorBSplineBasis


class NURBSControlMesh(ControlMesh):
    """Control mesh with rational (NURBS) geometry.

    Parameters
    ----------
    degrees   : per-direction polynomial degrees (a ``.dat`` filename, the
                PetIGA path, raises NotImplementedError)
    kvecs     : per-direction knot vectors
    ctrl_grid : homogeneous control net, shape (n0[, n1[, n2]], nsd+1) with
                entries (w*x_0, ..., w*x_{nsd-1}, w), indexed [i, j, k] in
                parametric directions (dir 0 = i, fastest in DoF order;
                the reference's bnet layout, NURBS.py:46-68).
    """

    def __init__(self, degrees, kvecs=None, ctrl_grid=None):
        if isinstance(degrees, str):
            raise NotImplementedError(
                "NURBSControlMesh from a PetIGA .dat file needs petiga_io, "
                "which is not ported yet (ROADMAP item A7b)")
        self._basis = TensorBSplineBasis(degrees, kvecs)
        ctrl = np.asarray(ctrl_grid, dtype=np.float64)
        dim = self._basis.dim
        if ctrl.ndim != dim + 1:
            raise ValueError("control grid rank must be dim+1")
        expect = tuple(self._basis.ncp_per_dir)
        if ctrl.shape[:-1] != expect:
            raise ValueError(
                f"control grid shape {ctrl.shape[:-1]} does not match "
                f"knot vectors (expected {expect})")
        # flatten with direction-0 index fastest: reverse spatial axes, then
        # C-order flatten
        spatial = tuple(range(dim))[::-1]
        self._bnet = ctrl.transpose(spatial + (dim,)).reshape(
            -1, ctrl.shape[-1])
        self._nsd = ctrl.shape[-1] - 1

    def scalar_basis(self):
        return self._basis

    @property
    def nsd(self):
        return self._nsd

    def homogeneous_points(self):
        return self._bnet


def quarter_annulus_control(r_in=1.0, r_out=2.0):
    """Exact quarter-annulus NURBS (quadratic x quadratic): degrees, knot
    vectors and homogeneous control grid; circular arcs with weights
    1/sqrt(2) at the corner points."""
    degrees = [2, 2]
    kvecs = [np.asarray([0.0, 0, 0, 1, 1, 1])] * 2
    s = 1.0 / np.sqrt(2.0)
    dirs = np.asarray([[1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    wang = np.asarray([1.0, s, 1.0])
    radii = np.asarray([r_in, 0.5 * (r_in + r_out), r_out])
    ctrl = np.zeros((3, 3, 3))
    for i in range(3):       # angular
        for j in range(3):   # radial
            w = wang[i]
            ctrl[i, j, :2] = w * radii[j] * dirs[i]
            ctrl[i, j, 2] = w
    return degrees, kvecs, ctrl
