"""Bezier-extraction-format T-splines (Rhino T-spline plugin output).

Host-side numpy copy of tigar_tpu/models/tsplines.py for the PyTorch port
(counterpart of tIGAr/RhinoTSplines.py): bi-cubic Bezier elements on
(-1,1)^2, each with a ragged list of supported T-spline functions and an
extraction operator C whose rows express each function as a combination
of the 16 bi-cubic Bernstein polynomials.  Each element is one row of the
batched tabulation, padded to the largest per-element function count with
a 0/1 mask (padded slots: connectivity 0, mask 0).

File format (RhinoTSplines.py:78-111, 258-277):
  line 0:      header
  line 1:      "<tag> ncp"
  line 2:      "<tag> nelBez"
  lines 3...:  ncp control points: "<tag> x y z w"  (x,y,z NOT premultiplied)
  per element: "<tag> nshl"; a line of nshl node indices; nshl lines of 16
               extraction coefficients.

The boundary assemblers (the whole-boundary "dB" domain) are not ported
yet: ``tabulate_boundary`` and ``tabulate_whole_boundary`` raise.
"""

from __future__ import annotations

import numpy as np

from ..config import INDEX_TYPE
from ..ops.basis import bernstein_basis_ders, bspline_basis_ders
from ..ops.quadrature import gauss_rule
from ..ops.tabulation import Tabulation
from .bspline import ScalarBasis, ControlMesh, TensorBSplineBasis


def _parse_tspline_file(fname):
    """Parse a Rhino T-spline plugin Bezier-extraction export.

    Accepted grammar (the reference reader's, RhinoTSplines.py:78-111,
    258-277, made tolerant of layout):

      - Unix or Windows line endings; leading/trailing whitespace per line
        and blank lines anywhere are ignored.
      - line 0: header, arbitrary content (ignored).
      - line 1: ``<tag> ncp``; line 2: ``<tag> nelBez`` (token 1 is the
        count; tags are arbitrary, extra tokens ignored).
      - control points: ncp lines ``<tag> x y z w`` (not premultiplied by
        w; w must be > 0), starting right after line 2 ("files directly
        from rhino") or after ONE extra header line (the reference's
        "manually-modified format"); told apart by whether the first
        candidate line parses as ``<tag> + 4 floats``.
      - per element: ``<tag> nshl``; one line of exactly nshl node indices
        in [0, ncp); nshl lines of exactly 16 extraction coefficients.
        nshl may differ per element.
      - content after the last element is ignored.

    Violations raise ValueError naming the 1-based source line.  Returns
    (bnet [ncp, 4] homogenized (w*x, w), nodes_list, ops_list).
    """
    with open(fname) as f:
        raw = f.read()
    lines, lineno = [], []
    for i, ln in enumerate(raw.split("\n")):
        ln = ln.strip()
        if ln:
            lines.append(ln)
            lineno.append(i + 1)

    def fail(k, msg):
        where = lineno[k] if k < len(lineno) else "<eof>"
        got = f" (line: {lines[k]!r})" if k < len(lines) else ""
        raise ValueError(f"{fname}:{where}: {msg}{got}")

    def intfield(k, what):
        if k >= len(lines):
            fail(k, f"unexpected end of file reading {what}")
        toks = lines[k].split()
        if len(toks) < 2:
            fail(k, f"expected '<tag> {what}'")
        try:
            return int(toks[1])
        except ValueError:
            fail(k, f"{what} {toks[1]!r} is not an integer")

    if len(lines) < 3:
        raise ValueError(f"{fname}: not a T-spline extraction file "
                         f"(fewer than 3 non-blank lines)")
    ncp = intfield(1, "ncp")
    nel = intfield(2, "nelBez")
    if ncp <= 0:
        fail(1, f"ncp must be positive, got {ncp}")
    if nel <= 0:
        fail(2, f"nelBez must be positive, got {nel}")

    def try_cp(k):
        if k >= len(lines):
            return None
        toks = lines[k].split()
        if len(toks) < 5:
            return None
        try:
            return [float(s) for s in toks[1:5]]
        except ValueError:
            return None

    lc = 3
    if try_cp(lc) is None and try_cp(lc + 1) is not None:
        lc += 1          # manually-modified format: one extra header line
    bnet = np.zeros((ncp, 4))
    for i in range(ncp):
        vals = try_cp(lc + i)
        if vals is None:
            fail(lc + i, f"expected control point {i} as '<tag> x y z w'")
        w = vals[3]
        if not w > 0.0:
            fail(lc + i, f"nonpositive rational weight {w!r}")
        bnet[i, :3] = np.asarray(vals[:3]) * w
        bnet[i, 3] = w
    lc += ncp
    nodes_list = []
    ops_list = []
    for e in range(nel):
        nshl = intfield(lc, f"nshl of element {e}")
        if nshl <= 0:
            fail(lc, f"element {e}: nshl must be positive, got {nshl}")
        if lc + 1 >= len(lines):
            fail(lc + 1, f"element {e}: missing node-index line")
        try:
            nodes = np.asarray([int(s) for s in lines[lc + 1].split()],
                               dtype=np.int64)
        except ValueError:
            fail(lc + 1, f"element {e}: non-integer node index")
        if nodes.size != nshl:
            fail(lc + 1, f"element {e}: expected {nshl} node indices, "
                         f"got {nodes.size}")
        if int(nodes.min()) < 0 or int(nodes.max()) >= ncp:
            fail(lc + 1, f"element {e}: node index out of range "
                         f"[0, {ncp})")
        rows = []
        for j in range(nshl):
            k = lc + 2 + j
            if k >= len(lines):
                fail(k, f"element {e}: missing extraction row {j}")
            try:
                row = [float(s) for s in lines[k].split()]
            except ValueError:
                fail(k, f"element {e}: non-numeric extraction coefficient")
            if len(row) != 16:
                fail(k, f"element {e}: extraction row {j} has {len(row)} "
                        f"coefficients, expected 16 (bi-cubic Bernstein)")
            rows.append(row)
        nodes_list.append(nodes)
        ops_list.append(np.asarray(rows))
        lc += nshl + 2
    return bnet, nodes_list, ops_list


class TSplineBasis(ScalarBasis):
    """Scalar T-spline basis from element-by-element Bezier extraction
    (reference: RhinoTSplineScalarBasis, RhinoTSplines.py:67-240)."""

    def __init__(self, fname=None, *, nodes_list=None, ops_list=None,
                 ncp=None):
        if fname is not None:
            _, nodes_list, ops_list = _parse_tspline_file(fname)
        if ncp is None:
            ncp = max(int(np.max(n)) for n in nodes_list) + 1
        self.nodes_list = [np.asarray(n, dtype=np.int64) for n in nodes_list]
        self.ops_list = [np.asarray(C, dtype=np.float64) for C in ops_list]
        self._ncp = int(ncp)
        self.max_nshl = max(C.shape[0] for C in self.ops_list)
        # padded [nel, max_nshl, 16] operators, [nel, max_nshl] conn + mask
        nel = len(self.ops_list)
        self.C = np.zeros((nel, self.max_nshl, 16))
        self.conn = np.zeros((nel, self.max_nshl), dtype=INDEX_TYPE)
        self.mask = np.zeros((nel, self.max_nshl))
        for e, (nodes, C) in enumerate(zip(self.nodes_list, self.ops_list)):
            nshl = C.shape[0]
            self.C[e, :nshl] = C
            self.conn[e, :nshl] = nodes
            self.mask[e, :nshl] = 1.0

    @classmethod
    def from_file(cls, fname, ncp=None):
        return cls(fname, ncp=ncp)

    @property
    def ncp(self):
        return self._ncp

    @property
    def nel(self):
        return len(self.ops_list)

    @property
    def dim(self):
        return 2

    def degree(self):
        return 3  # bi-cubic (RhinoTSplines.py:236-240)

    # -- tabulation -------------------------------------------------------------

    def _bernstein_tab(self, npts, nders, rule=None):
        """Tensor-product bi-cubic Bernstein values/derivatives at Gauss
        points of (-1,1)^2.  Bernstein index b = j*4 + i with i along the
        first parametric direction (RhinoTSplines.py:50-53)."""
        if rule is not None:
            g, w = np.asarray(rule[0]), np.asarray(rule[1])
            npts = len(g)
        else:
            g, w = gauss_rule(npts)
        d1 = bernstein_basis_ders(3, g, nders, interval=(-1.0, 1.0))
        nq = npts * npts
        qi, qj = np.meshgrid(np.arange(npts), np.arange(npts), indexing="ij")
        qi = qi.reshape(-1, order="F")  # i fastest
        qj = qj.reshape(-1, order="F")
        bi, bj = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        bi = bi.reshape(-1, order="F")
        bj = bj.reshape(-1, order="F")

        def prod(ku, kv):
            return d1[qi][:, ku, :][:, bi] * d1[qj][:, kv, :][:, bj]

        B = prod(0, 0)                                # [nq, 16]
        dB = d2B = None
        if nders >= 1:
            dB = np.stack([prod(1, 0), prod(0, 1)], axis=-1)  # [nq,16,2]
        if nders >= 2:
            d2B = np.zeros((nq, 16, 2, 2))
            d2B[:, :, 0, 0] = prod(2, 0)
            d2B[:, :, 0, 1] = d2B[:, :, 1, 0] = prod(1, 1)
            d2B[:, :, 1, 1] = prod(0, 2)
        qw = w[qi] * w[qj]
        qp = np.stack([g[qi], g[qj]], axis=-1)
        return B, dB, d2B, qp, qw

    def tabulate(self, npts_per_dir, nders, rule=None):
        npts = int(np.max(npts_per_dir)) if not np.isscalar(npts_per_dir) \
            else int(npts_per_dir)
        B, dB, d2B, qp, qw = self._bernstein_tab(npts, nders, rule=rule)
        nel, nq = self.nel, B.shape[0]
        N = np.einsum("eab,qb->eqa", self.C, B)
        dN = None if dB is None else np.einsum("eab,qbd->eqad", self.C, dB)
        d2N = None if d2B is None else np.einsum("eab,qbdc->eqadc",
                                                 self.C, d2B)
        return Tabulation(
            conn=self.conn,
            N=N, dN=dN, d2N=d2N,
            qp=np.broadcast_to(qp, (nel, nq, 2)).copy(),
            qw=np.broadcast_to(qw, (nel, nq)).copy(),
            ncp=self._ncp, dim=2, mask=self.mask.copy())

    def tabulate_boundary(self, npts_per_dir, nders, direction, side):
        raise NotImplementedError(
            "a T-spline has no (direction, side) boundary structure, and "
            "its whole-boundary domain comes with the boundary assemblers "
            "(ROADMAP queue A, item A6b); apply BCs through "
            "boundary_dofs() or SplineSpace.add_zero_dofs_by_location")

    def tabulate_whole_boundary(self, npts_per_dir, nders):
        raise NotImplementedError(
            "the T-spline whole-boundary tabulation (the \"dB\" domain) "
            "comes with the boundary assemblers (ROADMAP queue A, item "
            "A6b)")

    # -- boundary topology from extraction data --------------------------------
    #
    # The Rhino file carries no boundary information (RhinoTSplines.py:113
    # "TODO: read in BC info"); the topology is recovered from the
    # extraction operators: the trace of the spline space on an element
    # edge is a set of (global node, cubic-Bernstein edge coefficients)
    # pairs, and two elements abut exactly when their edge traces agree (up
    # to edge orientation, and up to one de Casteljau half-subdivision at
    # 2:1 T-junctions).  An edge whose trace matches no other element's is a
    # domain boundary edge.

    _EDGE_COLS = ((0, 4, 8, 12), (3, 7, 11, 15),
                  (0, 1, 2, 3), (12, 13, 14, 15))
    # columns controlling value AND first normal derivative on each edge
    _EDGE_COLS2 = (
        tuple(j * 4 + i for j in range(4) for i in (0, 1)),
        tuple(j * 4 + i for j in range(4) for i in (2, 3)),
        tuple(j * 4 + i for j in (0, 1) for i in range(4)),
        tuple(j * 4 + i for j in (2, 3) for i in range(4)))
    _EDGE_NORMAL = ((-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))

    @staticmethod
    def _trace_entries(nodes, C, cols, tol=1e-10):
        out = []
        for a in range(C.shape[0]):
            c = C[a, list(cols)]
            if np.max(np.abs(c)) > tol:
                out.append((int(nodes[a]), c))
        return out

    @staticmethod
    def _sig(entries, ndig=9):
        fwd = tuple(sorted((n, tuple(np.round(c, ndig))) for n, c in
                           entries))
        rev = tuple(sorted((n, tuple(np.round(c[::-1], ndig))) for n, c in
                           entries))
        return min(fwd, rev)

    @staticmethod
    def _halves(entries):
        """De Casteljau subdivision of each cubic edge trace at the
        midpoint: (left entries, right entries)."""
        L, R = [], []
        for n, c in entries:
            c0, c1, c2, c3 = c
            l = np.asarray([c0, (c0 + c1) / 2, (c0 + 2 * c1 + c2) / 4,
                            (c0 + 3 * c1 + 3 * c2 + c3) / 8])
            r = np.asarray([l[3], (c1 + 2 * c2 + c3) / 4, (c2 + c3) / 2,
                            c3])
            L.append((n, l))
            R.append((n, r))
        return L, R

    def _boundary_topology(self):
        """Cached boundary edges: a list of (element, edge_k) with edge_k
        in 0..3 (u-, u+, v-, v+)."""
        if getattr(self, "_btopo", None) is not None:
            return self._btopo
        fulls = {}
        halves = {}
        edge_info = []
        for e, (nodes, C) in enumerate(zip(self.nodes_list, self.ops_list)):
            for k in range(4):
                entries = self._trace_entries(nodes, C, self._EDGE_COLS[k])
                sig = self._sig(entries)
                hl, hr = self._halves(entries)
                sigs_h = (self._sig(hl), self._sig(hr))
                fulls.setdefault(sig, []).append((e, k))
                for sh in sigs_h:
                    halves.setdefault(sh, []).append((e, k))
                edge_info.append((e, k, sig, sigs_h))
        boundary = []
        for e, k, sig, sigs_h in edge_info:
            mates = [x for x in fulls.get(sig, []) if x != (e, k)]
            if mates:
                continue
            # 2:1 T-junction cases: this edge matches a half of a bigger
            # neighbor, or both of this edge's halves match smaller
            # neighbors' full edges
            if any(x != (e, k) for x in halves.get(sig, [])):
                continue
            if all(any(x != (e, k) for x in fulls.get(sh, []))
                   for sh in sigs_h):
                continue
            boundary.append((e, k))
        self._btopo = boundary
        return boundary

    def boundary_edges(self):
        """Domain-boundary element edges [(element, edge_k)], recovered
        from the extraction operators (see _boundary_topology)."""
        return list(self._boundary_topology())

    def boundary_dofs(self, n_layers=1):
        """Global node indices supported on the domain boundary: with
        n_layers=1, nodes whose VALUE trace on some boundary edge is
        nonzero (Dirichlet); with n_layers=2, also nodes controlling the
        first normal derivative there (clamped shells)."""
        if n_layers not in (1, 2):
            raise ValueError("n_layers must be 1 or 2")
        cols = self._EDGE_COLS if n_layers == 1 else self._EDGE_COLS2
        out = set()
        for e, k in self._boundary_topology():
            for n, _c in self._trace_entries(self.nodes_list[e],
                                             self.ops_list[e], cols[k]):
                out.add(n)
        return np.asarray(sorted(out), dtype=np.int64)

    def evaluate(self, coeffs, xi, element=0):
        """Evaluate at local coordinates ``xi`` [n, 2] of one element."""
        coeffs = np.asarray(coeffs)
        xi = np.atleast_2d(xi)
        du = bernstein_basis_ders(3, xi[:, 0], 0)[:, 0, :]
        dv = bernstein_basis_ders(3, xi[:, 1], 0)[:, 0, :]
        # B[n, j*4+i] = du[n,i] dv[n,j]: C-order flatten of [n, j, i]
        B = (dv[:, :, None] * du[:, None, :]).reshape(len(xi), 16)
        vals = np.einsum("ab,qb->qa", self.C[element], B)
        ce = coeffs[self.conn[element]] * self.mask[element]
        return vals @ ce


class RhinoTSplineControlMesh(ControlMesh):
    """Control mesh from a Rhino T-spline file
    (reference: RhinoTSplineControlMesh, RhinoTSplines.py:242-286)."""

    def __init__(self, fname):
        bnet, nodes_list, ops_list = _parse_tspline_file(fname)
        self._basis = TSplineBasis(nodes_list=nodes_list, ops_list=ops_list,
                                   ncp=bnet.shape[0])
        self._bnet = bnet

    def scalar_basis(self):
        return self._basis

    @property
    def nsd(self):
        return 3

    def homogeneous_points(self):
        return self._bnet


def merge_extraction_nodes(nodes_list, ops_list, node_map):
    """Merge T-spline functions by identifying nodes: every node index is
    mapped through ``node_map`` (old -> new global index, not necessarily
    dense); functions of one element that land on the same new node have
    their extraction rows SUMMED (which keeps the partition of unity and
    makes per-element function counts ragged, as at extraordinary points,
    RhinoTSplines.py:93-97).

    Returns (nodes_list, ops_list, ncp, used) with dense renumbered nodes;
    ``used`` lists the surviving old node ids in the new order.
    """
    node_map = {int(k): int(v) for k, v in node_map.items()}
    new_nodes_list, new_ops_list = [], []
    for nodes, C in zip(nodes_list, ops_list):
        mapped = [node_map.get(int(n), int(n)) for n in nodes]
        uniq = []
        rows = {}
        for a, n in enumerate(mapped):
            if n not in rows:
                rows[n] = np.zeros(C.shape[1])
                uniq.append(n)
            rows[n] = rows[n] + C[a]
        new_nodes_list.append(np.asarray(uniq, dtype=np.int64))
        new_ops_list.append(np.stack([rows[n] for n in uniq]))
    # dense renumbering over the union of used node ids
    used = sorted({int(n) for nodes in new_nodes_list for n in nodes})
    renum = {n: i for i, n in enumerate(used)}
    new_nodes_list = [np.asarray([renum[int(n)] for n in nodes],
                                 dtype=np.int64)
                      for nodes in new_nodes_list]
    return new_nodes_list, new_ops_list, len(used), used


def bspline_extraction_data(basis):
    """(nodes_list, ops_list): element-by-element Bezier extraction of a
    bi-cubic tensor-product B-spline patch (TensorBSplineBasis with
    degrees [3, 3]), the building block of fabricated T-spline inputs and
    of the file exporter below."""
    if basis.degrees != [3, 3]:
        raise ValueError("Rhino format is bi-cubic only")

    # per-direction extraction: coefficients of each of the 4 supported
    # functions in the element-local cubic Bernstein basis, by collocation
    # at 4 points
    def extraction_1d(kv):
        ops = []
        spans = kv.element_spans()
        lefts = kv.unique_knots[:-1]
        h = kv.element_sizes()
        t = np.asarray([-1.0, -0.5, 0.5, 1.0])
        Bmat = bernstein_basis_ders(3, t, 0)[:, 0, :]      # [4, 4]
        for e in range(kv.nel):
            u = lefts[e] + (t + 1.0) * 0.5 * h[e]
            ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p,
                                      u, np.full(4, spans[e]), 0)
            Nvals = ders[:, 0, :]                          # [4 pts, 4 funcs]
            # solve B^T X^T = N  ->  rows of X are Bernstein coefficients
            X = np.linalg.solve(Bmat, Nvals).T             # [4 funcs, 4]
            ops.append(X)
        return ops

    ops_u = extraction_1d(basis.kvs[0])
    ops_v = extraction_1d(basis.kvs[1])
    nodes_u = basis.kvs[0].element_nodes()
    nodes_v = basis.kvs[1].element_nodes()
    M = basis.kvs[0].ncp

    nodes_list, ops_list = [], []
    # element flattening: dir-0 fastest (matches TensorBSplineBasis)
    for ev in range(basis.kvs[1].nel):
        for eu in range(basis.kvs[0].nel):
            nodes = [int(nodes_v[ev][j] * M + nodes_u[eu][i])
                     for j in range(4) for i in range(4)]
            # row a = j*4+i (function), col b = l*4+k (Bernstein, k along u):
            # C[a, b] = ops_u[i, k] * ops_v[j, l]
            C = np.einsum("ik,jl->jilk", ops_u[eu],
                          ops_v[ev]).reshape(16, 16)
            nodes_list.append(np.asarray(nodes, dtype=np.int64))
            ops_list.append(C)
    return nodes_list, ops_list


def bspline_to_rhino_extraction(basis, bnet, fname):
    """Export a bi-cubic tensor-product B-spline patch (``basis``, with the
    homogeneous control points ``bnet`` [ncp, 4]) as a Rhino-format
    T-spline extraction file."""
    nodes_list, ops_list = bspline_extraction_data(basis)
    write_rhino_extraction(fname, np.asarray(bnet), nodes_list, ops_list)


def make_star_extraction(n_sectors, nel, radius=1.0):
    """An extraordinary-point T-spline in Bezier-extraction form:
    ``n_sectors`` bi-cubic patches (nel x nel elements each) meeting at a
    central star vertex of valence ``n_sectors`` (any value != 4 is an
    extraordinary point), joined C0 along the spokes.

    Patch k maps the unit square bilinearly onto the quad (O, h_{2k},
    h_{2k+1}, h_{2k+2}) of a regular 2*n_sectors-gon, so physical-space
    linear fields stay exactly representable.  Control points coincide
    exactly along the spokes; they are merged by coordinate coincidence
    into one global numbering with the star vertex shared by all sectors.

    Returns (bnet [ncp, 4] homogeneous, nodes_list, ops_list).
    """
    from ..ops.knots import uniform_knots

    m = 2 * n_sectors
    hexv = np.stack([np.array([np.cos(2 * np.pi * j / m),
                               np.sin(2 * np.pi * j / m)]) * radius
                     for j in range(m)])
    basis = TensorBSplineBasis(
        [3, 3], [uniform_knots(3, 0.0, 1.0, nel)] * 2)
    gp = basis.greville_points()                      # [ncp_p, 2]
    nodes_p, ops_p = bspline_extraction_data(basis)
    ncp_p = basis.ncp

    pts = []
    nodes_list, ops_list = [], []
    for k in range(n_sectors):
        c00 = np.zeros(2)
        c10 = hexv[2 * k]
        c11 = hexv[(2 * k + 1) % m]
        c01 = hexv[(2 * k + 2) % m]
        u, v = gp[:, 0], gp[:, 1]
        xy = (np.outer((1 - u) * (1 - v), c00) + np.outer(u * (1 - v), c10)
              + np.outer(u * v, c11) + np.outer((1 - u) * v, c01))
        pts.append(xy)
        off = k * ncp_p
        nodes_list += [n + off for n in nodes_p]
        ops_list += [C.copy() for C in ops_p]
    pts = np.concatenate(pts)                         # [n_sectors*ncp_p, 2]

    # merge coincident control points (spokes + star vertex)
    keys = {}
    node_map = {}
    for i, (x, y) in enumerate(pts):
        key = (round(float(x) / 1e-9), round(float(y) / 1e-9))
        if key in keys:
            node_map[i] = keys[key]
        else:
            keys[key] = i
    nodes_list, ops_list, ncp, used = merge_extraction_nodes(
        nodes_list, ops_list, node_map)
    bnet = np.zeros((ncp, 4))
    bnet[:, :2] = pts[used]
    bnet[:, 3] = 1.0
    return bnet, nodes_list, ops_list


def write_rhino_extraction(fname, bnet, nodes_list, ops_list):
    """Write element-by-element Bezier extraction in the Rhino T-spline
    format that ``_parse_tspline_file`` reads (ragged per-element function
    counts allowed).  ``bnet``: [ncp, 4] homogeneous control points
    (w*x, w).  The text is the JAX package's writer's, byte for byte."""
    bnet = np.asarray(bnet)
    lines = ["tspline-extraction (generated by tigar_tpu)",
             f"nodeN {bnet.shape[0]}",
             f"elemN {len(nodes_list)}"]
    x = bnet[:, :3] / bnet[:, 3:4]
    for i in range(bnet.shape[0]):
        lines.append("n %.17g %.17g %.17g %.17g"
                     % (x[i, 0], x[i, 1], x[i, 2], bnet[i, 3]))
    for nodes, C in zip(nodes_list, ops_list):
        nshl = len(nodes)
        if C.shape != (nshl, 16):
            raise ValueError("extraction operator must be [nshl, 16]")
        lines.append(f"e {nshl}")
        lines.append(" ".join(str(int(n)) for n in nodes))
        for a in range(nshl):
            lines.append(" ".join("%.17g" % c for c in C[a]))
    with open(fname, "w") as f:
        f.write("\n".join(lines) + "\n")
