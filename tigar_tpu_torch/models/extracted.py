"""ExtractedSpline: the analysis object (port of the construction and
volume-assembler parts of tigar_tpu/models/extracted.py).

Construction tabulates the field bases and the control basis on the shared
Bezier-element grid (host numpy), evaluates the geometry at all quadrature
points on ``device`` in ``dtype``, and builds the volume assembler.
Dirichlet BCs are a mask (zeroRowsColumns semantics).  Assemblers for
other quadrature rules (``_assembler(domain, quad_degree)``) are cached;
ctx hooks (e.g. the shell reference frame) run on every new assembler.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_REAL_TYPE, resolve_device
from ..ops.quadrature import npoints_for_degree
from ..ops.geometry import precompute_geometry
from ..ops.assembly import DomainAssembler


class ExtractedSpline:
    """Analysis object over a SplineSpace.

    Parameters
    ----------
    space       : SplineSpace
    quad_degree : polynomial degree integrated exactly per direction
    nders       : derivative order to tabulate (2 for shells)
    geom_nders  : derivative order for the geometry (defaults to nders)
    device, dtype : where and in which precision the assembler tensors live
                  (the card unless the caller asks for ``"cpu"``)
    """

    def __init__(self, space, quad_degree, nders=1, geom_nders=None,
                 device="cuda", dtype=DEFAULT_REAL_TYPE):
        self.device = resolve_device(device)
        self.space = space
        self.quad_degree = int(quad_degree)
        self.npts = npoints_for_degree(quad_degree)
        self.nders = int(nders)
        self.geom_nders = self.nders if geom_nders is None else int(geom_nders)
        self.dtype = dtype

        self.control_basis = space.control_mesh.scalar_basis()
        self.bnet = np.asarray(space.control_mesh.homogeneous_points(),
                               dtype=np.float64)
        self.nsd = space.nsd
        self.dim = self.control_basis.dim
        self.ndof = space.ndof

        self._tab_cache = {}
        self._assemblers = {}
        self._ctx_hooks = []   # fns(domain, asm) run on new assemblers
        self.mask = torch.as_tensor(space.bc_mask(), dtype=dtype,
                                    device=self.device)
        self._assembler("dx")

    @property
    def geometry(self):
        """QP at volume quadrature points, leaves [nel, nq, ...]."""
        return self._assembler("dx").ctx

    def _field_tab(self, basis, domain, nders=None, npts=None):
        nders = self.nders if nders is None else nders
        npts = self.npts if npts is None else npts
        if domain != "dx":
            raise NotImplementedError("boundary assembly is not ported yet")
        key = (id(basis), domain, nders, npts)
        if key not in self._tab_cache:
            self._tab_cache[key] = basis.tabulate(npts, nders)
        return self._tab_cache[key]

    def _assembler(self, domain, quad_degree=None) -> DomainAssembler:
        npts = self.npts if quad_degree is None else \
            npoints_for_degree(quad_degree)
        akey = (domain, npts)
        if akey not in self._assemblers:
            self._assemblers[akey] = self._build_assembler(domain, npts)
        return self._assemblers[akey]

    def _build_assembler(self, domain, npts) -> DomainAssembler:
        ctrl_tab = self._field_tab(self.control_basis, domain,
                                   nders=self.geom_nders, npts=npts)
        geom = precompute_geometry(ctrl_tab, self.bnet, self.device,
                                   self.dtype)
        qw = torch.as_tensor(ctrl_tab.qw, dtype=self.dtype,
                             device=self.device)
        scale = qw * geom.sqrtJ
        tabs = [self._field_tab(f, domain, npts=npts)
                for f in self.space.fields]
        asm = DomainAssembler(tabs, self.space.offsets, self.ndof, geom,
                              scale)
        for hook in self._ctx_hooks:
            hook(domain, asm)
        return asm

    def evaluate(self, U, xi, rationalize=True, **kwargs):
        """Evaluate the solution at parametric points ``xi`` [n, dim] (host
        numpy): [n] for a scalar space, else [n, nfields].  With
        ``rationalize``, divides by the control weight function.  Extra
        kwargs go to the basis (``patch=`` for multi-patch)."""
        if isinstance(U, torch.Tensor):
            U = U.detach().cpu().numpy()
        U = np.asarray(U)
        xi = np.atleast_2d(np.asarray(xi, dtype=float))
        vals = [self.space.fields[f].evaluate(
                    U[self.space.field_slice(f)], xi, **kwargs)
                for f in range(self.space.nfields)]
        out = np.stack(vals, axis=-1)
        if rationalize:
            w = self.control_basis.evaluate(self.bnet[:, -1], xi, **kwargs)
            out = out / w[:, None]
        return out[:, 0] if self.space.nfields == 1 else out
