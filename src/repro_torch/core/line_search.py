"""Armijo backtracking line search (paper Alg. 2 line 9; twin of
``repro/core/line_search.py``).

f(θ + α δ) ≤ f(θ) + c·α·gᵀδ,  α ∈ {1, β, β², ...}. The loop test is one
host read per trip, as the reference's ``lax.while_loop`` test.

``paired=True`` (the overlapped schedule, ``HFConfig.overlap``): each trip
evaluates two consecutive candidates (α, βα), which do not depend on each
other, and takes the first acceptable one: the accepted α is the unpaired
search's, for one speculative evaluation more and half the blocking trips.
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
    paired: bool = False,
) -> LineSearchResult:
    """loss_fn already closes over the batch: params ↦ scalar loss."""
    alpha = torch.full((), alpha0, dtype=torch.float32, device=f0.device)
    f_new = f0
    ok = torch.zeros((), dtype=torch.bool, device=f0.device)
    k = 0

    def trial(a):
        f = loss_fn(tree_axpy_cast(a, delta, params))
        return f, f <= f0 + c * a * g_dot_delta

    with torch.no_grad():
        while k < max_backtracks and not bool(ok):
            if paired:
                alpha2 = alpha * beta
                f1, ok1 = trial(alpha)
                f2, ok2 = trial(alpha2)
                ok = ok1 | ok2
                f_new = torch.where(ok1, f1, f2)
                alpha = torch.where(ok, torch.where(ok1, alpha, alpha2),
                                    alpha * beta * beta)
                k += 2
            else:
                f_new, ok = trial(alpha)
                alpha = torch.where(ok, alpha, alpha * beta)
                k += 1
    # On failure take a zero step (alpha=0): θ unchanged, damping will increase.
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    f_new = torch.where(ok, f_new, f0)
    return LineSearchResult(alpha, f_new,
                            torch.tensor(k, dtype=torch.int32, device=f0.device), ok)
