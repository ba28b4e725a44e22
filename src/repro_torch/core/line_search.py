"""Armijo backtracking line search (paper Alg. 2 line 9; twin of
``repro/core/line_search.py`` with ``paired=False``).

f(θ + α δ) ≤ f(θ) + c·α·gᵀδ,  α ∈ {1, β, β², ...}. The loop test is one
host read per trial, as the reference's ``lax.while_loop`` test.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .tree_math import tree_axpy_cast


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor
    f_new: torch.Tensor
    n_evals: torch.Tensor
    success: torch.Tensor


def armijo(
    loss_fn: Callable[[Any], torch.Tensor],
    params,
    f0: torch.Tensor,
    delta,
    g_dot_delta: torch.Tensor,
    *,
    c: float = 1e-2,
    beta: float = 0.5,
    max_backtracks: int = 12,
    alpha0: float = 1.0,
) -> LineSearchResult:
    """loss_fn already closes over the batch: params ↦ scalar loss."""
    alpha = torch.full((), alpha0, dtype=torch.float32, device=f0.device)
    f_new = f0
    ok = torch.zeros((), dtype=torch.bool, device=f0.device)
    k = 0
    with torch.no_grad():
        while k < max_backtracks and not bool(ok):
            f_new = loss_fn(tree_axpy_cast(alpha, delta, params))
            ok = f_new <= f0 + c * alpha * g_dot_delta
            alpha = torch.where(ok, alpha, alpha * beta)
            k += 1
    # On failure take a zero step (alpha=0): θ unchanged, damping will increase.
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    f_new = torch.where(ok, f_new, f0)
    return LineSearchResult(alpha, f_new,
                            torch.tensor(k, dtype=torch.int32, device=f0.device), ok)
