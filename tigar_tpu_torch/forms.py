"""Pointwise form language: field 2-jets and quadrature-point context
(port of tigar_tpu/forms.py).

A form is a plain PyTorch function of a quadrature-point context ``ctx``
(``QP``) and field jets ``u``/``v`` (``Jet``) that returns the physical
integrand density at ONE point; the assembler maps it over points and
elements with ``torch.func.vmap`` (ops/assembly.py), and residuals and
tangents come from ``torch.func`` derivatives.  Physical differential
operators are exact chain rules through the (rational) geometry map.

The containers also serve batched code: their leaves may carry leading
batch dimensions (element, quadrature point), which the shell kernels'
plain versions use.  ``curl``, the ``pushforward_*`` operators,
``dmetric`` and ``christoffel`` are not ported yet.

torch.func passes only tensors through its transforms, while a Jet or QP
may hold None leaves (no Hessian tabulated, no boundary data);
``tree_vmap``, ``tree_grad`` and ``tree_jvp`` carry such leaves around
the transforms unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Any

import torch
import torch.utils._pytree as pytree


class Jet(NamedTuple):
    """2-jet of a (possibly vector-valued) field in parametric coordinates.

    val : [...] or [..., m]
    g   : [..., d] or [..., m, d]          parametric gradient
    h   : [..., d, d] or [..., m, d, d]    parametric Hessian (or None)

    Linear arithmetic acts jet-wise (jets form a vector space).
    """
    val: Any
    g: Any
    h: Optional[Any] = None

    def _zip(self, other, op):
        if isinstance(other, Jet):
            h = None
            if self.h is not None and other.h is not None:
                h = op(self.h, other.h)
            return Jet(op(self.val, other.val), op(self.g, other.g), h)
        raise TypeError("Jet arithmetic requires another Jet; "
                        "scale with * for scalars")

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:  # sum()
            return self
        return self.__add__(other)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __neg__(self):
        return self * (-1.0)

    def __mul__(self, c):
        return Jet(self.val * c, self.g * c,
                   None if self.h is None else self.h * c)

    __rmul__ = __mul__

    def __truediv__(self, c):
        return self * (1.0 / c)

    def __getitem__(self, i):
        """Component extraction for vector-valued jets."""
        return Jet(self.val[i], self.g[i],
                   None if self.h is None else self.h[i])


class PhysField(NamedTuple):
    """A field already expressed in physical space: value and physical
    gradient; ``div_exact`` may carry an exactly-conservative
    divergence."""
    val: Any
    grad: Any
    div_exact: Optional[Any] = None

    def __add__(self, other):
        de = None
        if self.div_exact is not None and other.div_exact is not None:
            de = self.div_exact + other.div_exact
        return PhysField(self.val + other.val, self.grad + other.grad, de)

    def __sub__(self, other):
        return self.__add__(other * (-1.0))

    def __mul__(self, c):
        return PhysField(self.val * c, self.grad * c,
                         None if self.div_exact is None
                         else self.div_exact * c)

    __rmul__ = __mul__


def _trace(A):
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


class QP(NamedTuple):
    """Geometric context at a quadrature point (see tigar_tpu.forms.QP).

    xi [d], x [nsd], w [], wg [d], wh [d,d], DF [nsd,d], d2F [nsd,d,d],
    g [d,d], ginv [d,d], sqrtJ [], pinv [d,nsd], nref/normal/surfJ (boundary
    points only), aux: dict of model-specific precomputed data (e.g. the
    shell reference frame under ``"shell_ref"``).  Batched code gives each
    leaf leading batch dimensions.
    """
    xi: Any
    x: Any
    w: Any
    wg: Any
    wh: Optional[Any]
    DF: Any
    d2F: Optional[Any]
    g: Any
    ginv: Any
    sqrtJ: Any
    pinv: Any
    nref: Optional[Any] = None
    normal: Optional[Any] = None
    surfJ: Optional[Any] = None
    aux: Optional[Any] = None

    def map(self, fn):
        """Apply ``fn`` to every tensor leaf (aux included); None stays."""
        def go(v):
            if v is None:
                return None
            if isinstance(v, dict):
                return {k: go(x) for k, x in v.items()}
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*[go(x) for x in v])
            return fn(v)
        return QP(*[go(v) for v in self])

    # ---- differential operators (physical space, one point) ----------------

    def grad(self, u):
        """Physical gradient: scalar jet -> [nsd]; vector jet [m] ->
        [m, nsd]; PhysField -> its stored gradient."""
        if isinstance(u, PhysField):
            return u.grad
        return torch.tensordot(u.g, self.pinv, dims=([-1], [0]))

    def div(self, u):
        """Physical divergence of a vector field."""
        if isinstance(u, PhysField) and u.div_exact is not None:
            return u.div_exact
        return _trace(self.grad(u))

    def hess(self, u):
        """Physical (tangential) Hessian of a scalar or vector jet:
        u_,cd = DF^T H DF + grad_x(u) . d2F.  Needs derivative order 2."""
        if u.h is None or self.d2F is None:
            raise ValueError("hess() requires derivative order 2 "
                             "(construct the spline with nders=2)")
        gphys = self.grad(u)
        corr = torch.tensordot(gphys, self.d2F, dims=([-1], [0]))
        M = u.h - corr
        return torch.einsum("...cd,ck,dl->...kl", M, self.pinv, self.pinv)

    def lap(self, u):
        """Physical Laplacian: the trace of the physical Hessian."""
        return _trace(self.hess(u))

    def parametric_grad(self, u):
        """Gradient in parametric coordinates."""
        return u.g

    def rationalize(self, u):
        """Divide a homogeneous-representation jet by the control weight
        function, with the exact quotient rule for gradient and Hessian."""
        w, dw, d2w = self.w, self.wg, self.wh
        val = u.val / w
        g = (u.g - val[..., None] * dw) / w
        h = None
        if u.h is not None and d2w is not None:
            t1 = g[..., :, None] * dw
            t2 = t1.transpose(-1, -2)
            t3 = val[..., None, None] * d2w if val.dim() else val * d2w
            h = (u.h - t1 - t2 - t3) / w
        return Jet(val, g, h)


def taylor_eval(val, g, h, delta):
    """The 2-jet (val, g, h) as a truncated Taylor polynomial at parametric
    offset ``delta`` [d] (see tigar_tpu.forms.taylor_eval); the jet's
    trailing axes are parametric, its leading ones are kept."""
    out = val + torch.tensordot(g, delta, dims=([-1], [0]))
    if h is not None:
        out = out + 0.5 * torch.einsum("...cd,c,d->...", h, delta, delta)
    return out


# ---- torch.func over containers with None leaves ----------------------------


def _split(tree):
    """(tensor leaves, rebuild(tensors) -> tree): the tree's other leaves
    (None, Python numbers) are kept in place."""
    leaves, spec = pytree.tree_flatten(tree)
    pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

    def rebuild(ts):
        out = list(leaves)
        for i, t in zip(pos, ts):
            out[i] = t
        return pytree.tree_unflatten(out, spec)

    return [leaves[i] for i in pos], rebuild


def tree_vmap(fn):
    """``torch.func.vmap`` of ``fn(*args)`` over axis 0 of every tensor leaf
    of its arguments (JAX's vmap of a function of Jet/QP pytrees); None and
    non-tensor leaves of the arguments and of the result pass through."""
    def mapped(*args):
        ts, rebuild = _split(args)
        out_rebuild = []

        def inner(*ts_):
            ots, orb = _split(fn(*rebuild(ts_)))
            out_rebuild.append(orb)
            return tuple(ots)

        res = torch.func.vmap(inner)(*ts)
        return out_rebuild[-1](res)
    return mapped


def tree_grad(fn, x):
    """Gradient of the scalar ``fn(x)`` with respect to every tensor leaf
    of the tree ``x`` (a tree of the same structure)."""
    ts, rebuild = _split(x)
    gs = torch.func.grad(lambda *t: fn(rebuild(t)),
                         argnums=tuple(range(len(ts))))(*ts)
    return rebuild(gs)


def tree_jvp(fn, x, v):
    """(fn(x), d/de fn(x + e v) at e = 0) for trees ``x``, ``v`` of one
    structure; the result may be a tree with None leaves."""
    ts, rebuild = _split(x)
    vs, _ = _split(v)
    out_rebuild = []

    def inner(*t):
        ots, orb = _split(fn(rebuild(t)))
        out_rebuild.append(orb)
        return tuple(ots)

    prim, tan = torch.func.jvp(inner, tuple(ts), tuple(vs))
    return out_rebuild[-1](prim), out_rebuild[-1](tan)


def deriv(f, u, v):
    """Gateaux derivative of ``f`` at the jet (tree) ``u`` in direction
    ``v``: d/de f(u + e v) at e = 0, by forward-mode AD."""
    return tree_jvp(f, u, v)[1]


def _zero_test_jet(u):
    """Zero Jet with the structure of the unknown's jet."""
    uu = u["u"] if isinstance(u, dict) else u
    return pytree.tree_map(
        lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else x,
        uu)


def adjoint_of(density):
    """Adjoint-jet form of a residual density: ``adj(ctx, u[, params])``
    returns the Jet F with density(ctx, u, v) == sum(F.val*v.val) +
    sum(F.g*v.g) + sum(F.h*v.h) for every test jet v (exact, because a
    residual density is linear in v): the pointwise gradient with respect
    to a zero test jet."""
    def adj(ctx, u, *params):
        return tree_grad(lambda v: density(ctx, u, v, *params),
                         _zero_test_jet(u))
    return adj


# ---- UFL-flavoured helpers --------------------------------------------------


def _t(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(a)


def inner(a, b):
    """Full contraction of two equal-shape tensors (UFL ``inner``)."""
    return torch.sum(_t(a) * _t(b))


def dot(a, b):
    """numpy's ``dot`` for operands of rank <= 2 (a scalar operand
    scales)."""
    a, b = _t(a), _t(b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.matmul(a, b)


def outer(a, b):
    return torch.outer(_t(a).reshape(-1), _t(b).reshape(-1))


def sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def tr(A):
    return _trace(A)


def cross(a, b):
    return torch.linalg.cross(_t(a), _t(b))
