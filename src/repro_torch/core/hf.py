"""Hessian-free optimizer — paper Algorithm 2 as one outer step (twin of
``repro/core/hf.py``).

Variants (``HFConfig.solver``): ``"gn_cg"`` (Martens' HF: Gauss-Newton +
CG), ``"hessian_cg"`` (exact Hessian + truncated CG), ``"hybrid_cg"`` (exact
Hessian CG, switching to GN for the iteration after one that met negative
curvature) and ``"bicgstab"`` (the paper's Bi-CG-STAB on the indefinite
exact Hessian, with negative-curvature directions as escape steps).

The Krylov solve runs on the ``HFConfig.krylov_backend`` vector backend:
"tree" (parameter-shaped iterates) or "flat" (one f32 buffer whose
recurrences run through the fused CUDA kernels on the card). The curvature
operator comes from ``core.curvature`` in ``HFConfig.curvature_mode``.

``sstep_s > 1`` runs the s-step solvers of ``core.sstep`` (one Gram
reduction per cycle of s iterations, in the ``sstep_basis`` polynomial
basis, the chains paired into block products of the same cached operator);
``overlap=True`` double-buffers their cycles and pairs the line-search
trials. The reference's telemetry hooks have no counterpart yet.

For a model with flash attention, the gradient and the line search run the
flash kernels; the curvature engine routes exact-Hessian builds, and this
step the s-step GN build, through ``kernels.flash_ad.second_order_tangents``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value
from torch.utils._pytree import tree_leaves, tree_map

from . import damping as damping_mod
from .._device import check_on, resolve_device
from ..kernels.flash_ad import second_order_tangents
from .curvature import (
    MODES as CURVATURE_MODES,
    make_damped,
    make_gnvp_op,
    make_hvp_op,
    shared_primal_hvp,
)
from .blocks import block_op_from_single
from .krylov import BACKENDS, get_backend
from .line_search import armijo
from .solvers import bicgstab, cg, hutchinson_diag, pcg, sign_correct
from .sstep import sstep_bicgstab, sstep_cg
from .tree_math import (
    tree_axpy,
    tree_axpy_cast,
    tree_dot,
    tree_norm,
    tree_pseudo_noise,
    tree_scale,
    tree_where,
    tree_zeros_like,
)

SOLVERS = ("gn_cg", "hessian_cg", "hybrid_cg", "bicgstab")
SSTEP_SOLVERS = ("auto", "cg", "bicgstab")
SSTEP_BASES = ("monomial", "newton", "chebyshev")
NC_MODES = ("truncate", "escape")

# Every key hf_step's metrics carry; the same set as the reference's.
METRICS_SCHEMA = (
    "loss", "loss_new", "grad_norm", "lambda", "rho", "alpha", "ls_evals",
    "cg_iters", "cg_residual", "krylov_syncs", "blocking_syncs",
    "sstep_fallback", "sstep_basis_fallback", "sstep_basis_degraded",
    "nc_found", "nc_used", "nc_curv", "nc_lambda", "step_norm", "used_gn",
    "step_rejected",
)


@dataclasses.dataclass(frozen=True)
class HFConfig:
    """Fields, defaults and validation as ``repro.core.hf.HFConfig``; see
    that class for what each one means."""
    solver: str = "bicgstab"
    max_cg_iters: int = 16
    cg_tol: float = 5e-3
    init_damping: float = 1.0
    damping_inc: float = 1.5
    damping_dec: float = 1.5
    cg_decay: float = 0.95        # η: Krylov warm start θ_0 = η δ_{k-1}
    ls_c: float = 1e-2            # Armijo sufficient-decrease constant
    ls_beta: float = 0.5
    max_backtracks: int = 12
    krylov_jitter: float = 1e-3   # relative pseudo-noise on the warm start
    nc_min_step: float = 0.1      # floor of the NC step norm ("truncate")
    nc_mode: str = "truncate"     # "truncate" or "escape" (|λ_min|-scaled)
    precondition: bool = False    # Jacobi preconditioning (Hutchinson probe)
    precond_alpha: float = 0.75
    krylov_backend: str = "tree"  # "tree" or "flat" (fused CUDA kernels)
    curvature_mode: str = "linearize"
    curvature_chunk_size: int = 0
    curvature_remat: bool = True
    sstep_s: int = 1
    sstep_solver: str = "auto"
    sstep_basis: str = "monomial"
    overlap: bool = False
    reject_nonfinite: bool = True
    strict_descent: bool = False
    descent_guard: float = 0.0
    reject_boost: float = 0.0

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {self.solver!r}")
        if self.krylov_backend not in BACKENDS:
            raise ValueError(
                f"krylov_backend must be one of {BACKENDS}, got {self.krylov_backend!r}"
            )
        if self.curvature_mode not in CURVATURE_MODES:
            raise ValueError(
                f"curvature_mode must be one of {CURVATURE_MODES}, "
                f"got {self.curvature_mode!r}"
            )
        if self.sstep_solver not in SSTEP_SOLVERS:
            raise ValueError(
                f"sstep_solver must be one of {SSTEP_SOLVERS}, "
                f"got {self.sstep_solver!r}"
            )
        if self.sstep_basis not in SSTEP_BASES:
            raise ValueError(
                f"sstep_basis must be one of {SSTEP_BASES}, "
                f"got {self.sstep_basis!r}"
            )
        if self.nc_mode not in NC_MODES:
            raise ValueError(
                f"nc_mode must be one of {NC_MODES}, got {self.nc_mode!r}"
            )
        if self.sstep_s > 1 and self.precondition:
            raise ValueError(
                "sstep_s > 1 is incompatible with precondition=True: the "
                "s-step recurrences are unpreconditioned (use the standard "
                "solvers for Jacobi preconditioning)"
            )


class HFState(NamedTuple):
    lam: torch.Tensor       # λ damping
    prev_delta: Any         # δ_{k-1} for the Krylov warm start (f32)
    use_gn: torch.Tensor    # hybrid flag: this iteration uses the GN operator
    step: torch.Tensor


def hf_init(params, config: HFConfig, *, device="cuda") -> HFState:
    dev = resolve_device(device)
    check_on(dev, tree_leaves(params), "params")
    return HFState(
        lam=torch.tensor(config.init_damping, dtype=torch.float32, device=dev),
        prev_delta=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params),
        use_gn=torch.zeros((), dtype=torch.bool, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def hf_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params,
    state: HFState,
    batch,
    hvp_batch,
    config: HFConfig,
    model_out_fn: Optional[Callable[[Any, Any], Any]] = None,
    out_loss_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
    *,
    device="cuda",
):
    """One outer HF iteration. Returns (params, state, metrics).

    ``batch`` — the full batch (gradient and line search); ``hvp_batch`` —
    the curvature mini-batch (may be a slice of ``batch``; passing ``batch``
    itself shares one primal pass between g and the Hessian operator).
    ``model_out_fn``/``out_loss_fn`` are required by the GN solvers.
    ``grad_reduce`` is applied to g and to every curvature product. Under
    ``config.overlap`` its ``start(g)`` form, where it has one, starts the
    gradient reduce before the operator build and the step waits on the
    handle it returns (``handle.wait()`` gives the reduced g) at the Krylov
    right-hand side.
    """
    dev = resolve_device(device)
    check_on(dev, tree_leaves((params, state, batch, hvp_batch)), "hf_step input")
    needs_gn = config.solver in ("gn_cg", "hybrid_cg")
    if needs_gn and (model_out_fn is None or out_loss_fn is None):
        raise ValueError(f"solver {config.solver} requires model_out_fn/out_loss_fn")

    # ---- Alg.2 lines 3-5: gradient + stochastic curvature operator ---------
    curv_kw = dict(
        mode=config.curvature_mode, chunk_size=config.curvature_chunk_size,
        remat=config.curvature_remat, grad_reduce=grad_reduce,
    )
    # The hybrid solver reads its switch here, so only the operator it will
    # apply is built (each build in the cached modes runs a primal pass).
    use_gn = config.solver == "gn_cg" or (
        config.solver == "hybrid_cg" and bool(state.use_gn))
    shared = (
        config.curvature_mode == "linearize"
        and hvp_batch is batch
        and config.solver != "gn_cg"
    )
    hidden = not shared and grad_reduce is not None and config.overlap
    pending = None
    if shared:
        f0, g, exact = shared_primal_hvp(loss_fn, params, batch, grad_reduce=grad_reduce)
    else:
        g, f0 = grad_and_value(loss_fn)(params, batch)
        f0 = f0.detach()
        if grad_reduce is not None and not config.overlap:
            g = grad_reduce(g)
        elif hidden and hasattr(grad_reduce, "start"):
            # Overlapped schedule: the gradient reduce is in flight while the
            # operator is built, which does not depend on it (the reference's
            # hidden grad-reduce); it is waited on at the Krylov rhs.
            pending = grad_reduce.start(g)
        if not use_gn:
            exact = make_hvp_op(loss_fn, params, hvp_batch, **curv_kw)
    if use_gn:
        # The s-step solvers take batched block products of the operator,
        # which have no rule through the flash Functions: build the GN
        # operator under the chunked torch route of attention (the same
        # math; a no-op for a model without flash attention).
        gn_ctx = second_order_tangents if config.sstep_s > 1 else contextlib.nullcontext
        with gn_ctx():
            G = make_gnvp_op(model_out_fn, out_loss_fn, params, hvp_batch, **curv_kw)
    else:
        G = exact
    lam = state.lam
    A = make_damped(G, lam)
    if pending is not None:
        g = pending.wait()
    elif hidden:
        # A grad_reduce without a start form: issued after the build.
        g = grad_reduce(g)
    b = tree_map(lambda x: -x.float(), g)
    x0 = tree_scale(config.cg_decay, state.prev_delta)
    if config.krylov_jitter > 0.0:
        # Deterministic pseudo-noise seeded by g, the position and the step.
        jit_tree = tree_pseudo_noise(g, state.step)
        scale = config.krylov_jitter * torch.clamp_min(tree_norm(g), 1e-8) / (
            torch.clamp_min(tree_norm(jit_tree), 1e-20))
        x0 = tree_axpy(scale, jit_tree, x0)

    # ---- Alg.2 line 6: Krylov solve ----------------------------------------
    krylov_be = get_backend(config.krylov_backend, template=b)
    m_inv = None
    if config.precondition:
        diag = hutchinson_diag(G, b, state.step)
        m_inv = tree_map(lambda d: 1.0 / (torch.abs(d) + lam) ** config.precond_alpha, diag)
    if config.sstep_s > 1:
        # s-step solve: one Gram reduction per cycle, the chains paired into
        # block products of the SAME cached operator (no second primal).
        kind = config.sstep_solver
        if kind == "auto":
            kind = "bicgstab" if config.solver == "bicgstab" else "cg"
        sstep_fn = sstep_bicgstab if kind == "bicgstab" else sstep_cg
        res = sstep_fn(A, b, x0, lam=lam, s=config.sstep_s,
                       max_iters=config.max_cg_iters, tol=config.cg_tol,
                       backend=krylov_be, A_block=block_op_from_single(A),
                       basis=config.sstep_basis, overlap=config.overlap)
    elif config.solver == "bicgstab":
        res = bicgstab(A, b, x0, lam=lam, max_iters=config.max_cg_iters,
                       tol=config.cg_tol, M_inv=m_inv, backend=krylov_be)
    elif m_inv is not None:
        res = pcg(A, b, x0, lam=lam, M_inv=m_inv, max_iters=config.max_cg_iters,
                  tol=config.cg_tol, backend=krylov_be)
    else:
        res = cg(A, b, x0, lam=lam, max_iters=config.max_cg_iters,
                 tol=config.cg_tol, backend=krylov_be)

    # ---- Alg.2 line 7: best descent direction among {solution, NC dir} -----
    # Quadratic-model values from solver byproducts: A·x = b − r.
    gx = tree_dot(g, res.x_best)
    sign = torch.where(torch.sign(gx) == 0, torch.ones_like(gx), -torch.sign(gx))
    sol = tree_scale(sign, res.x_best)
    sol_norm = tree_norm(sol)
    xAx = tree_dot(res.x_best, tree_map(torch.sub, b, res.r_best))
    m_sol = sign * gx + 0.5 * xAx
    zero = torch.zeros_like(gx)
    nc_lam = torch.where(res.nc_found, torch.minimum(
        torch.as_tensor(res.nc_lambda, dtype=torch.float32, device=dev), res.nc_curv), zero)
    inf = torch.full_like(gx, float("inf"))
    if config.nc_mode == "escape":
        # Saddle-free escape: step along the unit NC direction at the |λ_min|
        # scale, judged by the RAW model; NaN-safe toward taking the step so
        # a poisoned λ reaches the divergence sentinel.
        nc_scale = torch.abs(nc_lam)
        nc, _ = sign_correct(g, tree_scale(nc_scale, res.nc_dir))
        g_nc = tree_dot(g, nc)
        m_nc = torch.where(res.nc_found, g_nc + 0.5 * res.nc_curv * nc_scale**2, inf)
        take_nc = torch.logical_and(res.nc_found, torch.logical_not(m_sol <= m_nc))
    else:
        # NC direction at the solution's norm scale, floored at nc_min_step.
        nc_scale = torch.clamp_min(sol_norm, config.nc_min_step)
        nc, _ = sign_correct(g, tree_scale(nc_scale, res.nc_dir))
        g_nc = tree_dot(g, nc)
        m_nc = torch.where(res.nc_found,
                           g_nc + 0.5 * (res.nc_curv + lam) * nc_scale**2, inf)
        take_nc = m_nc < m_sol
    delta = tree_where(take_nc, nc, sol)
    m_lin = torch.where(take_nc, g_nc, sign * gx)         # gᵀδ
    m_quad = torch.where(take_nc, m_nc - g_nc, 0.5 * xAx)  # ½ δᵀAδ

    # Degenerate solve (zero direction) → steepest descent.
    d_norm = tree_norm(delta)
    degenerate = d_norm < 1e-12
    delta = tree_where(degenerate, b, delta)
    gg = tree_dot(g, g)
    m_lin = torch.where(degenerate, -gg, m_lin)
    m_quad = torch.where(degenerate, zero, m_quad)

    # ---- Alg.2 line 9: Armijo line search -----------------------------------
    g_dot_delta = tree_dot(g, delta)
    ls = armijo(
        lambda p: loss_fn(p, batch), params, f0, delta, g_dot_delta,
        c=config.ls_c, beta=config.ls_beta, max_backtracks=config.max_backtracks,
        paired=config.overlap,
    )

    # ---- Alg.2 lines 8,10: LM damping + parameter update --------------------
    pred_red = ls.alpha * m_lin + ls.alpha**2 * m_quad
    pred_red = torch.clamp_max(pred_red, -1e-20)
    lam_new, rho = damping_mod.lm_update(
        lam, f0, ls.f_new, pred_red, inc=config.damping_inc, dec=config.damping_dec)
    new_params = tree_axpy_cast(ls.alpha, delta, params)
    delta_taken = tree_scale(ls.alpha, delta)

    # ---- divergence sentinel: reject poisoned / ascent steps ---------------
    rejected = torch.zeros((), dtype=torch.bool, device=dev)
    if config.reject_nonfinite or config.strict_descent:
        accept = torch.ones((), dtype=torch.bool, device=dev)
        if config.reject_nonfinite:
            finite_ok = torch.logical_and(
                torch.isfinite(ls.f_new), torch.isfinite(tree_norm(delta_taken)))
            accept = torch.logical_and(accept, finite_ok)
        if config.strict_descent:
            guard = config.descent_guard * torch.clamp_min(torch.abs(f0), 1.0)
            accept = torch.logical_and(accept, ls.f_new <= f0 + guard)
        rejected = torch.logical_not(accept)
        boost = (config.reject_boost if config.reject_boost > 0
                 else config.damping_inc ** 2)
        lam_new = torch.where(accept, lam_new, torch.clamp(lam * boost, 1e-8, 1e8))
        rho = torch.where(accept, rho, torch.zeros_like(rho))
        new_params = tree_where(accept, new_params, params)
        delta_taken = tree_where(accept, delta_taken, tree_zeros_like(state.prev_delta))

    if config.solver == "hybrid_cg":
        use_gn_next = torch.logical_and(torch.logical_not(state.use_gn), res.nc_found)
    else:
        use_gn_next = torch.zeros((), dtype=torch.bool, device=dev)

    new_state = HFState(lam=lam_new, prev_delta=delta_taken, use_gn=use_gn_next,
                        step=state.step + 1)
    is_sstep = torch.tensor(config.sstep_s > 1, device=dev)

    def sstep_flag(v):
        return torch.logical_and(is_sstep, torch.as_tensor(v, device=dev))

    metrics = {
        "loss": f0,
        "loss_new": ls.f_new,
        "grad_norm": tree_norm(g),
        "lambda": lam_new,
        "rho": rho,
        "alpha": ls.alpha,
        "ls_evals": ls.n_evals,
        "cg_iters": res.iters,
        "cg_residual": res.residual,
        # Blocking reductions of the solve: one per iteration, or one Gram
        # per s-step cycle (plus the fallback's iterations).
        "krylov_syncs": res.syncs,
        # Blocking round-trips of the step: the gradient reduce, the Krylov
        # syncs and one per line-search trip. Under overlap the gradient
        # reduce is hidden behind the operator build and the trials come in
        # pairs: syncs + ⌈E/2⌉.
        "blocking_syncs": (
            res.syncs + (ls.n_evals + 1) // 2 if config.overlap
            else 1 + res.syncs + ls.n_evals
        ),
        "sstep_fallback": sstep_flag(res.breakdown),
        # the part of sstep_fallback caused by the Gram guard
        "sstep_basis_fallback": sstep_flag(res.basis_breakdown),
        # an adaptive basis degraded to the monomial one mid-solve
        "sstep_basis_degraded": sstep_flag(res.basis_degraded),
        "nc_found": res.nc_found,
        "nc_used": take_nc,
        "nc_curv": res.nc_curv,
        "nc_lambda": nc_lam,
        "step_norm": tree_norm(delta_taken),
        "used_gn": state.use_gn,
        "step_rejected": rejected,
    }
    if set(metrics) != set(METRICS_SCHEMA):
        raise AssertionError(sorted(set(metrics) ^ set(METRICS_SCHEMA)))
    return new_params, new_state, metrics
