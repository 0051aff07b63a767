"""Multi-patch B-spline bases and control meshes (host numpy copy of
tigar_tpu/models/multipatch.py: ``_pad_tab``, ``_concat_tabs``,
``MultiPatchBSplineBasis`` and ``MultiPatchControlMesh``).

A multi-patch basis is the concatenation of per-patch Bezier-element
batches (padded to a common element width) with per-patch global DoF
offsets; geometry and assembly run through the standard batched pipeline.
Control points are not merged between patches: patches are coupled weakly
by interface forms (``tigar_tpu_torch.interface``).

One difference from the JAX package: when no patch needs padding, the
concatenated tabulation keeps ``mask=None`` instead of an all-ones mask.
The values are the same (every slot is active either way), and the
shell kernels K1/K2, which take unmasked tabulations only, then accept
equal-degree multi-patch assemblers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import INDEX_TYPE
from ..ops.tabulation import Tabulation
from .bspline import ScalarBasis, TensorBSplineBasis, ControlMesh


def _pad_tab(tab: Tabulation, nen_max):
    """Pad a patch tabulation to ``nen_max`` local functions with zero-mask
    slots (ragged multi-patch support)."""
    pad = nen_max - tab.nen
    if pad == 0 and tab.mask is not None:
        return tab
    nel = tab.nel
    mask = np.ones((nel, nen_max))
    if tab.mask is not None:
        mask[:, :tab.nen] = tab.mask
    if pad > 0:
        mask[:, tab.nen:] = 0.0

    def padf(x, axis):
        if x is None or pad == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths)

    return dataclasses.replace(
        tab,
        conn=padf(tab.conn, 1),
        N=padf(tab.N, 2),
        dN=padf(tab.dN, 2),
        d2N=padf(tab.d2N, 2),
        mask=mask)


def _concat_tabs(tabs, ncp_total):
    """Concatenate per-patch tabulations along the element axis (mask None
    when every patch has the same width and none is masked)."""
    nen_max = max(t.nen for t in tabs)
    if any(t.nen != nen_max or t.mask is not None for t in tabs):
        tabs = [_pad_tab(t, nen_max) for t in tabs]

    def cat(getter):
        parts = [getter(t) for t in tabs]
        if any(p is None for p in parts):
            return None
        return np.concatenate(parts, axis=0)

    return Tabulation(
        conn=cat(lambda t: t.conn).astype(INDEX_TYPE),
        N=cat(lambda t: t.N),
        dN=cat(lambda t: t.dN),
        d2N=cat(lambda t: t.d2N),
        qp=cat(lambda t: t.qp),
        qw=cat(lambda t: t.qw),
        ncp=ncp_total,
        dim=tabs[0].dim,
        normal=tabs[0].normal,
        mask=cat(lambda t: t.mask))


class MultiPatchBSplineBasis(ScalarBasis):
    """Union of tensor-product B-spline patches with offset DoF numbering.
    Knot vectors are normalized to (0,1) per patch (on copies)."""

    def __init__(self, patches):
        if not patches:
            raise ValueError("need at least one patch")
        self.patches = [
            TensorBSplineBasis(p.degrees,
                               [kv.knots for kv in p.kvs]
                               ).normalize_knot_vectors()
            for p in patches]
        if len({p.dim for p in self.patches}) != 1:
            raise ValueError("all patches must share a parametric dimension")
        self.doffsets = np.concatenate(
            [[0], np.cumsum([p.ncp for p in self.patches])]).astype(np.int64)

    @property
    def n_patches(self):
        return len(self.patches)

    @property
    def dim(self):
        return self.patches[0].dim

    @property
    def ncp(self):
        return int(self.doffsets[-1])

    @property
    def nel(self):
        return sum(p.nel for p in self.patches)

    def degree(self):
        return max(p.degree() for p in self.patches)

    def tabulate(self, npts_per_dir, nders, rule=None):
        tabs = [p.tabulate(npts_per_dir, nders, rule=rule).with_offset(
                    int(self.doffsets[i]))
                for i, p in enumerate(self.patches)]
        return _concat_tabs(tabs, self.ncp)

    def patch_side_dofs(self, patch, direction, side, n_layers=1):
        """Side DoFs of one patch in global numbering."""
        local = self.patches[patch].side_dofs(direction, side, n_layers)
        return (local + int(self.doffsets[patch])).astype(INDEX_TYPE)

    def side_dofs(self, direction, side, n_layers=1):
        """Side DoFs of all patches."""
        return np.concatenate([
            self.patch_side_dofs(p, direction, side, n_layers)
            for p in range(self.n_patches)])

    def greville_points(self):
        """[ncp, dim] per-patch Greville abscissae (local coordinates)."""
        return np.concatenate([p.greville_points() for p in self.patches])

    def evaluate(self, coeffs, xi, patch=0):
        """Evaluate at parametric points of one patch."""
        coeffs = np.asarray(coeffs)
        lo, hi = int(self.doffsets[patch]), int(self.doffsets[patch + 1])
        return self.patches[patch].evaluate(coeffs[lo:hi], xi)


class MultiPatchControlMesh(ControlMesh):
    """Control mesh over a MultiPatchBSplineBasis: per-patch homogeneous
    control nets concatenated in the basis' global DoF order."""

    def __init__(self, basis: MultiPatchBSplineBasis, bnets):
        if len(bnets) != basis.n_patches:
            raise ValueError("one control net per patch required")
        self._basis = basis
        nets = [np.asarray(b, dtype=np.float64) for b in bnets]
        if len({b.shape[-1] for b in nets}) != 1:
            raise ValueError("all patches must share a physical dimension")
        flat = []
        for i, b in enumerate(nets):
            if b.ndim > 2:  # grid-shaped: flatten dir-0 fastest
                dim = b.ndim - 1
                spatial = tuple(range(dim))[::-1]
                b = b.transpose(spatial + (dim,)).reshape(-1, b.shape[-1])
            if b.shape[0] != basis.patches[i].ncp:
                raise ValueError(f"patch {i}: control net size mismatch")
            flat.append(b)
        self._bnet = np.concatenate(flat, axis=0)

    def scalar_basis(self):
        return self._basis

    @property
    def nsd(self):
        return self._bnet.shape[1] - 1

    def homogeneous_points(self):
        return self._bnet
