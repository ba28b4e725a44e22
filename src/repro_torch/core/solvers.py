"""Krylov solvers for the damped curvature system (G + λI) d = -g (twin of
``repro/core/solvers.py``).

* ``cg``/``pcg`` — (preconditioned) conjugate gradients with Martens-style
  truncation and negative-curvature capture (one body).
* ``bicgstab``   — stabilized bi-conjugate gradients (paper Algorithm 3) on
  the possibly indefinite damped Hessian, optionally right-preconditioned,
  with free NC capture and best-iterate tracking.

Each loop keeps the freeze-and-flag meaning of the reference's
``lax.while_loop``: the loop test runs before every trip, truncation,
breakdown and non-finite values freeze the iterate and end the loop, and
history slots without a new residual stay NaN. So ``iters``, ``syncs`` and
``residual_history`` equal the reference's. The ``done`` test is one host
read per iteration.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .krylov import (
    EPS as _EPS,
    best_init,
    best_update,
    get_backend,
    guard_div,
    nc_init,
    nc_probe,
    phi_value,
)
from .tree_math import tree_dot, tree_pseudo_noise, tree_scale, tree_zeros_like

Op = Callable[[Any], Any]


class KrylovResult(NamedTuple):
    x: Any                   # final iterate
    r: Any                   # its residual vector b - A x
    x_best: Any              # best-model iterate (argmin of φ over the trajectory)
    r_best: Any              # residual of x_best
    nc_dir: Any              # unit negative-curvature direction of G (zeros if none)
    nc_found: torch.Tensor   # bool scalar
    nc_curv: torch.Tensor    # dᵀGd / ‖d‖² for nc_dir (0 if none)
    iters: torch.Tensor      # Krylov iterations executed
    residual: torch.Tensor   # final ‖b - A x‖
    syncs: torch.Tensor      # blocking reductions issued (one per iteration)
    breakdown: torch.Tensor  # bool: recurrence breakdown or non-finite values
    basis_degraded: Any = False   # s-step only; False for these recurrences
    basis_breakdown: Any = False  # s-step only; False for these recurrences
    residual_history: Any = None  # (max_iters,) ‖r‖ per iteration, NaN beyond iters
    nc_lambda: Any = 0.0          # λ_min(G) estimate (the probe's best Rayleigh quotient)


def _resolve(backend):
    return get_backend("tree") if backend is None else backend


def _device(v):
    return tree_leaves(v)[0].device


def _cg_engine(A: Op, b, x0, *, lam, M_inv, max_iters: int, tol: float,
               backend) -> KrylovResult:
    """(P)CG body shared by ``cg`` and ``pcg``: M_inv=None ⇒ identity."""
    be = _resolve(backend)
    A_ = be.wrap_op(A)
    b_ = be.lift(b)
    m = None if M_inv is None else be.lift(M_inv)
    prec = (lambda r: be.mul(m, r)) if m is not None else (lambda r: r)
    dev = _device(b_)

    b_norm = be.norm(b_)
    x = be.lift(x0)
    r = be.sub(b_, A_(x))
    p = prec(r)
    rz, rr = be.dot2(p, r)   # (<z0,r0>, <r0,r0>); equal for identity M
    k = 0
    done = torch.sqrt(rr) < tol * b_norm
    nc = nc_init(be, b_)
    broke = torch.zeros((), dtype=torch.bool, device=dev)
    hist = torch.full((max_iters,), float("nan"), dtype=torch.float32, device=dev)
    while k < max_iters and not bool(done):
        Ap = A_(p)
        pAp, p_sq = be.dot2(Ap, p)
        nc = nc_probe(be, p, pAp, p_sq, lam, nc)
        # Martens truncation: stop when the damped system goes indefinite.
        trunc = pAp <= _EPS
        alpha = rz / torch.clamp_min(pAp, _EPS)
        x_new = be.axpy(alpha, p, x)
        r_new, _, rr_new = be.update_residual(r, Ap, alpha)  # r − α·Ap, ‖r‖²
        z_new = prec(r_new)
        rz_new = rr_new if m is None else be.dot(r_new, z_new)
        beta = rz_new / torch.clamp_min(rz, _EPS)
        p_new = be.axpy(beta, p, z_new)
        # Non-finite products evade every comparison: detect, freeze, flag.
        bad = torch.logical_not(torch.logical_and(torch.isfinite(pAp),
                                                  torch.isfinite(rr_new)))
        freeze = torch.logical_or(trunc, bad)
        x = be.where(freeze, x, x_new)
        r = be.where(freeze, r, r_new)
        p = be.where(freeze, p, p_new)
        rz = torch.where(freeze, rz, rz_new)
        rr = torch.where(freeze, rr, rr_new)
        hist[k] = torch.where(bad, torch.full_like(rr, float("nan")), torch.sqrt(rr))
        done = torch.logical_or(freeze, torch.sqrt(rr_new) < tol * b_norm)
        broke = torch.logical_or(broke, bad)
        k += 1
    iters = torch.tensor(k, dtype=torch.int32, device=dev)
    # (P)CG on the damped system is φ-monotone: best == last.
    x, r, nc_dir = be.lower(x), be.lower(r), be.lower(nc.dir)
    return KrylovResult(x, r, x, r, nc_dir, nc.found, nc.curv, iters, torch.sqrt(rr),
                        syncs=iters, breakdown=broke,
                        residual_history=hist, nc_lambda=nc.curv)


def cg(A: Op, b, x0, *, lam, max_iters: int, tol: float = 5e-3,
       backend=None) -> KrylovResult:
    """Conjugate gradients with negative-curvature capture. ``A`` is the
    damped operator v ↦ G v + λ v; ``lam`` is λ."""
    return _cg_engine(A, b, x0, lam=lam, M_inv=None, max_iters=max_iters,
                      tol=tol, backend=backend)


def pcg(A: Op, b, x0, *, lam, M_inv, max_iters: int, tol: float = 5e-3,
        backend=None) -> KrylovResult:
    """Jacobi-preconditioned CG; ``M_inv`` is a tree of elementwise
    inverse-preconditioner values."""
    return _cg_engine(A, b, x0, lam=lam, M_inv=M_inv, max_iters=max_iters,
                      tol=tol, backend=backend)


def bicgstab(A: Op, b, x0, *, lam, max_iters: int, tol: float = 5e-3,
             M_inv=None, backend=None) -> KrylovResult:
    """Bi-CG-STAB (paper Algorithm 3) with free negative-curvature capture;
    r0* = r0. Breakdown freezes the iterate and ends the loop. ``M_inv``
    enables the right-preconditioned (van der Vorst) form."""
    be = _resolve(backend)
    A_ = be.wrap_op(A)
    b_ = be.lift(b)
    m = None if M_inv is None else be.lift(M_inv)
    prec = (lambda r: be.mul(m, r)) if m is not None else (lambda r: r)
    dev = _device(b_)

    b_norm = be.norm(b_)
    x = be.lift(x0)
    r = be.sub(b_, A_(x))
    r0_star = r
    p = r
    rho = be.dot(r, r0_star)
    k = 0
    done = be.norm(r) < tol * b_norm
    nc = nc_init(be, b_)
    best = best_init(be, b_, x, r)
    broke = torch.zeros((), dtype=torch.bool, device=dev)
    hist = torch.full((max_iters,), float("nan"), dtype=torch.float32, device=dev)
    while k < max_iters and not bool(done):
        phat = prec(p)
        v = A_(phat)                                     # A p̂_j
        v_phat, phat_sq = be.dot2(v, phat)
        nc = nc_probe(be, phat, v_phat, phat_sq, lam, nc)
        denom_a = be.dot(v, r0_star)
        alpha, breakdown_a = guard_div(rho, denom_a)
        s = be.axpy(-alpha, v, r)                        # s_j = r_j − α A p̂_j
        shat = prec(s)
        t = A_(shat)                                     # A ŝ_j
        t_shat, shat_sq = be.dot2(t, shat)
        nc = nc_probe(be, shat, t_shat, shat_sq, lam, nc)
        st_dot, tt = be.dot2(s, t)                       # (<s,t>, <t,t>)
        breakdown_g = tt < _EPS
        gamma = st_dot / torch.where(breakdown_g, torch.ones_like(tt), tt)
        x_new = be.fused_update(x, phat, shat, alpha, gamma)   # x + αp̂ + γŝ
        # r_{j+1} = s − γ t, fused with ⟨r,r0*⟩ and ⟨r,r⟩
        r_new, rho_new, rr_new = be.update_residual(s, t, gamma, r0s=r0_star)
        one = torch.ones_like(rho)
        beta = (rho_new / torch.where(torch.abs(rho) < _EPS, one, rho)) * (
            alpha / torch.where(torch.abs(gamma) < _EPS, one, gamma))
        p_new = be.fused_update(r_new, p, v, beta, -beta * gamma)
        # Non-finite scalars evade the ρ/ω guards: fold them into breakdown.
        bad = torch.logical_not(torch.logical_and(torch.isfinite(rho_new),
                                                  torch.isfinite(rr_new)))
        breakdown = torch.logical_or(torch.logical_or(breakdown_a, breakdown_g), bad)
        x = be.where(breakdown, x, x_new)
        r = be.where(breakdown, r, r_new)
        p = be.where(breakdown, p, p_new)
        rho = torch.where(breakdown, rho, rho_new)
        phi = phi_value(be, b_, x, r)
        best = best_update(be, x, r, phi, torch.logical_not(breakdown), best)
        hist[k] = torch.where(breakdown, torch.full_like(rr_new, float("nan")),
                              torch.sqrt(torch.clamp_min(rr_new, 0.0)))
        done = torch.logical_or(breakdown, torch.sqrt(rr_new) < tol * b_norm)
        broke = torch.logical_or(broke, breakdown)
        k += 1
    iters = torch.tensor(k, dtype=torch.int32, device=dev)
    return KrylovResult(
        be.lower(x), be.lower(r), be.lower(best.x), be.lower(best.r),
        be.lower(nc.dir), nc.found, nc.curv, iters, be.norm(r),
        syncs=iters, breakdown=broke, residual_history=hist, nc_lambda=nc.curv,
    )


def hutchinson_diag(op: Op, like, step, *, samples: int = 1):
    """Hutchinson diagonal estimate diag(A) ≈ E[v ⊙ Av] with Rademacher v
    built from the deterministic pseudo-noise; ``op`` is applied as-is."""
    acc = tree_zeros_like(like)
    for s in range(samples):
        v = tree_map(lambda n: torch.sign(n) + (n == 0).float(),
                     tree_pseudo_noise(like, step * samples + s))
        Av = op(v)
        acc = tree_map(lambda a, vv, av: a + vv * av.float(), acc, v, Av)
    return tree_map(lambda a: a / samples, acc)


def sign_correct(g, d):
    """d̃ = −sign(gᵀd)·d — force a (non-ascent) direction (paper §4.2)."""
    gd = tree_dot(g, d)
    s = -torch.sign(gd)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return tree_scale(s, d), torch.abs(gd)
