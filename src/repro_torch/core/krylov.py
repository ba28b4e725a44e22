"""Krylov vector backends + the solver components shared by every solver
(twin of ``repro/core/krylov.py``).

* ``TreeVectorBackend`` ("tree") — iterates stay parameter-shaped trees;
  every op maps over leaves (``tree_math``).
* ``FlatVectorBackend`` ("flat") — iterates are ravelled once per solve into
  one flat f32 buffer, and the recurrences run through the fused kernels of
  ``kernels.ops`` (CUDA on the card, their plain versions on the CPU). The
  operator still sees trees (``wrap_op`` unflattens at the boundary).

Both backends also speak *blocks*, ordered stacks of s Krylov vectors
(tree: a tree with a leading s axis on every leaf; flat: an (s, n) f32
matrix): ``block_stack``/``block_col``, ``lift_block``/``lower_block`` to and
from the stacked-tree form the block curvature products take,
``wrap_block_op``, ``gram`` (the (s_u, s_v) matrix of ⟨u_i, v_j⟩ in one
reduction: per-leaf contractions on the tree backend, the ``dots_block``
kernel on the flat one) and ``block_combine`` (coeffs @ block).

Shared components: the negative-curvature probe (``nc_init``/``nc_probe``),
free CG-backtracking (``phi_value``/``best_init``/``best_update``), the
breakdown-guarded division (``guard_div``), and the free spectral estimates
of the s-step solvers (``ritz_from_segment``, ``leja_order``).
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

    # A tree block is the stacked tree the block curvature products take, so
    # lift_block/lower_block/wrap_block_op are identities here.
    def block_stack(self, vecs):
        return tree_map(lambda *xs: torch.stack(xs), *vecs)

    def block_col(self, block, j):
        return tree_map(lambda x: x[j], block)

    def lift_block(self, stacked):
        return stacked

    def lower_block(self, block):
        return block

    def wrap_block_op(self, A_blk: Op) -> Op:
        return A_blk

    def gram(self, U, V):
        """(s_u, s_v) matrix of ⟨u_i, v_j⟩ in f32: a sum of per-leaf
        contractions over every non-stack axis."""
        parts = [
            x.reshape(x.shape[0], -1).float() @ y.reshape(y.shape[0], -1).float().T
            for x, y in zip(tree_leaves(U), tree_leaves(V))
        ]
        return torch.sum(torch.stack(parts), dim=0)

    def block_combine(self, coeffs, U):
        """coeffs @ block: (s,) coeffs → one vector, (m, s) → an m-block."""
        return tree_map(lambda x: torch.tensordot(coeffs, x.float(), dims=1), U)


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

    # A flat block is an (s, n) f32 matrix, one row per Krylov vector.
    def block_stack(self, vecs):
        return torch.stack(vecs)

    def block_col(self, block, j):
        return block[j]

    def lift_block(self, stacked):
        """Stacked tree (leading s axis on every leaf) → (s, n) matrix."""
        leaves = tree_leaves(stacked)
        s = leaves[0].shape[0]
        return torch.cat([l.float().reshape(s, -1) for l in leaves], dim=1)

    def lower_block(self, block):
        """(s, n) matrix → stacked tree (leading s axis on every leaf)."""
        s = block.shape[0]
        parts = torch.split(block, self._sizes, dim=1)
        return tree_unflatten(
            [p.reshape((s,) + tuple(sh)) for p, sh in zip(parts, self._shapes)],
            self._spec)

    def wrap_block_op(self, A_blk: Op) -> Op:
        return lambda M: self.lift_block(A_blk(self.lower_block(M)))

    def gram(self, U, V):
        """(s_u, s_v) Gram in one pass over both blocks: the ``dots_block``
        kernel on the card, its plain version on the CPU."""
        return kops.gram_block(U, V)

    def block_combine(self, coeffs, U):
        return coeffs @ U


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


def ritz_from_segment(Gp, Tp, *, jitter: float = 1e-6):
    """Ritz values of A on the leading d = L−1 vectors of one Krylov chain,
    from the chain's (L, L) Gram ``Gp`` and its (L, d) recurrence block
    ``Tp`` (column j holds the coordinates of A·v_j in the chain):
    ⟨v_i, A v_j⟩ = (Gp @ Tp)[i, j], so the Ritz values solve K y = θ M y
    with K = sym((Gp Tp)[:d, :d]), M = Gp[:d, :d], both normalized to
    correlation scale and reduced by Cholesky.

    Returns ``(ritz, ok)``: θ ascending and a validity flag (finite inputs,
    a Cholesky that succeeded, finite eigenvalues). ``torch.linalg.cholesky``
    raises where ``jnp.linalg.cholesky`` returns NaNs, so the factor comes
    from ``cholesky_ex`` and ``info != 0`` counts as not finite.
    """
    L = Gp.shape[0]
    d = L - 1
    eye = torch.eye(d, dtype=Gp.dtype, device=Gp.device)
    ok = torch.logical_and(torch.isfinite(Gp).all(), torch.isfinite(Tp).all())
    Gp = torch.where(torch.isfinite(Gp), Gp, torch.zeros_like(Gp))
    K = (Gp @ torch.where(ok, Tp, torch.zeros_like(Tp)))[:d, :d]
    M = Gp[:d, :d]
    dg = torch.sqrt(torch.clamp_min(torch.diagonal(M), 0.0))
    dn = 1.0 / torch.clamp_min(dg, EPS)
    scale = torch.outer(dn, dn)
    Kn = 0.5 * (K + K.T) * scale
    Mn = M * scale
    C, info = torch.linalg.cholesky_ex(Mn + jitter * eye)
    ok = torch.logical_and(ok, torch.logical_and(info == 0, torch.isfinite(C).all()))
    Cs = torch.where(ok, C, eye)
    Y = torch.linalg.solve_triangular(Cs, Kn, upper=False)
    S = torch.linalg.solve_triangular(Cs, Y.T, upper=False)
    S = 0.5 * (S + S.T)
    ritz = torch.linalg.eigvalsh(torch.where(torch.isfinite(S), S, torch.zeros_like(S)))
    return ritz, torch.logical_and(ok, torch.isfinite(ritz).all())


def leja_order(vals):
    """Deterministic magnitude-damped Leja ordering of real shift values:
    θ_k maximizes |θ| · Π_{j<k} |θ − θ_j| over the remainder (so θ_0 =
    argmax |θ|); ties resolve to the first occurrence. The |θ| weight sweeps
    the early shifts down from the dominant end of the spectrum, which
    conditions f32 Newton chains better (see the reference's docstring)."""
    n = vals.shape[0]
    tiny = torch.tensor(1e-30, dtype=vals.dtype, device=vals.device)
    out = torch.zeros_like(vals)
    taken = torch.zeros((n,), dtype=torch.bool, device=vals.device)
    logp = torch.log(torch.maximum(torch.abs(vals), tiny))
    neg_inf = torch.full_like(vals, float("-inf"))
    for k in range(n):
        # gather/scatter with the index on the device: indexing with a 0-dim
        # tensor would read it on the host, twice per step
        i = torch.argmax(torch.where(taken, neg_inf, logp)).reshape(1)
        t = vals.gather(0, i)
        out[k:k + 1] = t
        taken = taken.scatter(0, i, True)
        logp = logp + torch.log(torch.maximum(torch.abs(vals - t), tiny))
    return out
