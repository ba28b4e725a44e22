"""Curvature-vector operators (twin of ``repro/core/hvp.py``): thin wrappers
over the curvature engine (``core.curvature``), plus the finite-difference
oracle ``fd_hvp`` that tests hold the exact products against.

* ``make_hvp``  — exact stochastic Hessian v ↦ ∇²f(θ) v (possibly
  indefinite; feeds Bi-CG-STAB, Hessian-CG and Hybrid-CG).
* ``make_gnvp`` — Gauss-Newton v ↦ Jᵀ (∇²_z ℓ) J v (PSD for a convex ℓ;
  feeds Martens' GN-CG and the Hybrid fallback).
* ``make_damped`` — B(v) = G(v) + λ v.

Both products default to the engine's ``"linearize"`` mode (the primal runs
once at build, each application only a tangent pass over the cached graph);
``mode="naive"`` re-runs the primal per call, ``mode="chunked"`` with
``chunk_size`` sweeps the curvature batch in microbatches. ``grad_reduce``
is applied once per product.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from torch.func import grad
from torch.utils._pytree import tree_map

from .curvature import LossFn, make_damped, make_gnvp_op, make_hvp_op

__all__ = ["make_hvp", "make_gnvp", "make_damped", "fd_hvp"]


def make_hvp(
    loss_fn: LossFn,
    params,
    batch,
    *,
    mode: str = "linearize",
    chunk_size: int = 0,
    remat: bool = True,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
) -> Callable[[Any], Any]:
    """Exact Hessian-vector product operator v ↦ ∇²f(θ) v."""
    return make_hvp_op(loss_fn, params, batch, mode=mode, chunk_size=chunk_size,
                       remat=remat, grad_reduce=grad_reduce)


def make_gnvp(
    model_out_fn: Callable[[Any, Any], Any],
    out_loss_fn: Callable[[Any, Any], Any],
    params,
    batch,
    *,
    mode: str = "linearize",
    chunk_size: int = 0,
    remat: bool = True,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
) -> Callable[[Any], Any]:
    """Gauss-Newton-vector product v ↦ Jᵀ (∇²_z ℓ(z)) J v, with
    ``model_out_fn(params, batch) -> z`` the network output and
    ``out_loss_fn(z, batch) -> scalar`` a loss convex in z."""
    return make_gnvp_op(model_out_fn, out_loss_fn, params, batch, mode=mode,
                        chunk_size=chunk_size, remat=remat, grad_reduce=grad_reduce)


def fd_hvp(loss_fn: LossFn, params, batch, v, eps: float = 1e-4):
    """Finite-difference HVP oracle (tests only): (∇f(θ+εv) − ∇f(θ−εv)) / 2ε,
    in the dtype of ``params``."""
    g = grad(loss_fn)
    gp = g(tree_map(lambda p, t: p + eps * t, params, v), batch)
    gm = g(tree_map(lambda p, t: p - eps * t, params, v), batch)
    return tree_map(lambda a, b: (a - b) / (2 * eps), gp, gm)
