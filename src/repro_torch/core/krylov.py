"""Krylov vector backends + the solver components shared by every solver
(twin of ``repro/core/krylov.py``).

* ``TreeVectorBackend`` ("tree") — iterates stay parameter-shaped trees;
  every op maps over leaves (``tree_math``).
* ``FlatVectorBackend`` ("flat") — iterates are ravelled once per solve into
  one flat f32 buffer, and the recurrences run through the fused kernels of
  ``kernels.ops`` (CUDA on the card, their plain versions on the CPU). The
  operator still sees trees (``wrap_op`` unflattens at the boundary).

Shared components: the negative-curvature probe (``nc_init``/``nc_probe``),
free CG-backtracking (``phi_value``/``best_init``/``best_update``) and the
breakdown-guarded division (``guard_div``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from . import tree_math as tm
from ..kernels import ops as kops

EPS = 1e-20

Op = Callable[[Any], Any]


class TreeVectorBackend:
    """Tree backend: ``lift``/``lower`` are identities, every op a leaf-map."""

    name = "tree"

    def lift(self, tree):
        return tree

    def lower(self, vec):
        return vec

    def wrap_op(self, A: Op) -> Op:
        return A

    def dot(self, u, v):
        return tm.tree_dot(u, v)

    def dot2(self, u, v):
        """(<u,v>, <v,v>)."""
        return tm.tree_dot(u, v), tm.tree_dot(v, v)

    def norm(self, v):
        return tm.tree_norm(v)

    def sub(self, a, b):
        return tm.tree_sub(a, b)

    def axpy(self, alpha, x, y):
        return tm.tree_axpy(alpha, x, y)

    def scale(self, alpha, x):
        return tm.tree_scale(alpha, x)

    def mul(self, m, v):
        return tree_map(lambda mm, vv: mm * vv, m, v)

    def where(self, cond, a, b):
        return tm.tree_where(cond, a, b)

    def zeros_like(self, v):
        return tm.tree_zeros_like(v)

    def fused_update(self, y, u, v, a, g):
        """y + a*u + g*v  (the Bi-CG-STAB x/p updates)."""
        return tm.tree_axpy(g, v, tm.tree_axpy(a, u, y))

    def update_residual(self, s, As, gamma, r0s=None):
        """r = s − γ·As; returns (r, <r,r0s> or None, <r,r>)."""
        r = tm.tree_axpy(-gamma, As, s)
        d1 = None if r0s is None else tm.tree_dot(r, r0s)
        return r, d1, tm.tree_dot(r, r)


class FlatVectorBackend:
    """Flat-buffer backend over the fused kernels.

    Built from a *template* tree (in HF: the rhs b). ``lift`` ravels a tree
    into one flat f32 vector in leaf order; ``lower`` restores the tree as
    views of that vector.
    """

    name = "flat"

    def __init__(self, template):
        leaves, self._spec = tree_flatten(template)
        self._shapes = [l.shape for l in leaves]
        self._sizes = [l.numel() for l in leaves]

    def lift(self, tree):
        return torch.cat([l.float().reshape(-1) for l in tree_leaves(tree)])

    def lower(self, vec):
        parts = torch.split(vec, self._sizes)
        return tree_unflatten(
            [p.reshape(s) for p, s in zip(parts, self._shapes)], self._spec)

    def wrap_op(self, A: Op) -> Op:
        return lambda v: self.lift(A(self.lower(v)))

    def dot(self, u, v):
        return kops.dot2(u, v)[0]

    def dot2(self, u, v):
        return kops.dot2(u, v)

    def norm(self, v):
        return torch.sqrt(kops.dot2(v, v)[1])

    def sub(self, a, b):
        return a - b

    def axpy(self, alpha, x, y):
        return alpha * x + y

    def scale(self, alpha, x):
        return alpha * x

    def mul(self, m, v):
        return m * v

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    def zeros_like(self, v):
        return torch.zeros_like(v)

    def fused_update(self, y, u, v, a, g):
        return kops.bicgstab_x_update(y, u, v, a, g)

    def update_residual(self, s, As, gamma, r0s=None):
        r, d1, d2 = kops.bicgstab_residual_dots(
            s, As, s if r0s is None else r0s, gamma)
        return r, (None if r0s is None else d1), d2


BACKENDS = ("tree", "flat")

_TREE_BACKEND = TreeVectorBackend()


def get_backend(name: str, template=None):
    """Resolve a backend by name. ``template`` (a tree spanning the Krylov
    space, e.g. the rhs b) is required for "flat"."""
    if name == "tree":
        return _TREE_BACKEND
    if name == "flat":
        if template is None:
            raise ValueError("flat backend requires a template pytree")
        return FlatVectorBackend(template)
    raise ValueError(f"krylov backend must be one of {BACKENDS}, got {name!r}")


def _zeros(like, dtype=torch.float32):
    """A 0-dim tensor on the device of ``like``'s first leaf."""
    return torch.zeros((), dtype=dtype, device=tree_leaves(like)[0].device)


class NCState(NamedTuple):
    """Most-negative normalized raw-curvature direction seen so far."""
    found: torch.Tensor   # bool scalar
    dir: Any              # backend vector, unit norm (zeros if none)
    curv: torch.Tensor    # dᵀGd / ‖d‖² for `dir` (0 if none)


def nc_init(be, b) -> NCState:
    return NCState(_zeros(b, torch.bool), be.zeros_like(b), _zeros(b))


def nc_probe(be, d, dAd, d_sq, lam, st: NCState) -> NCState:
    """Update the NC state from a (direction, dᵀAd, dᵀd) triple the
    recurrence already computed; the raw curvature of the damped operator A
    is (dᵀAd − λ‖d‖²)/‖d‖²."""
    raw = (dAd - lam * d_sq) / torch.clamp_min(d_sq, EPS)
    is_nc = raw < 0.0
    better = torch.logical_and(is_nc, raw < st.curv)
    ndir = be.where(
        better, be.scale(1.0 / torch.sqrt(torch.clamp_min(d_sq, EPS)), d), st.dir)
    ncurv = torch.where(better, raw, st.curv)
    return NCState(torch.logical_or(st.found, is_nc), ndir, ncurv)


class BestState(NamedTuple):
    """Free CG-backtracking: argmin over the trajectory of φ(x)=½xᵀAx−bᵀx."""
    x: Any
    r: Any
    phi: torch.Tensor


def phi_value(be, b, x, r):
    """φ(x) = ½xᵀAx − bᵀx via A·x = b − r (two scalar dots, no operator)."""
    return -0.5 * be.dot(b, x) - 0.5 * be.dot(x, r)


def best_init(be, b, x0, r0) -> BestState:
    return BestState(x0, r0, phi_value(be, b, x0, r0))


def best_update(be, x, r, phi, valid, st: BestState) -> BestState:
    improved = torch.logical_and(phi < st.phi, valid)
    return BestState(
        be.where(improved, x, st.x),
        be.where(improved, r, st.r),
        torch.where(improved, phi, st.phi),
    )


def guard_div(num, den, eps: float = EPS):
    """num/den with breakdown detection: returns (quotient, |den|<eps)."""
    bad = torch.abs(den) < eps
    return num / torch.where(bad, torch.ones_like(den), den), bad
