"""Communication-avoiding (s-step) Krylov solvers over the block backend
(twin of ``repro/core/sstep.py``).

The standard recurrences wait for one reduction per Krylov iteration (α and
β gate everything downstream). An s-step **cycle** instead grows the Krylov
space s steps ahead with a polynomial basis (operator products only, no
scalars in between), computes every dot product the next s iterations need
as ONE Gram matrix of the basis (``be.gram``: one reduction, the
``dots_block`` kernel on the flat backend), and runs the s iterations as
O(s²) scalar recurrences in basis coordinates. One blocking reduction per
s iterations instead of s (``KrylovResult.syncs`` counts Gram reductions).

**Bases** (``BasisSpec``). The chains follow the three-term recurrence
v_{j+1} = (A v_j − α_j v_j − β_j v_{j−1}) / γ_j, and the coordinate
recurrences see A only through the change-of-basis matrix T and the Gram:

* ``"monomial"``  — α = β = 0, γ = 1, the power chain (the axpys are
  skipped). In f32 it degenerates past ~4 applications (CG s ≤ 4,
  Bi-CG-STAB s ≤ 2).
* ``"newton"``    — shifts α_j in magnitude-damped Leja order from the Ritz
  estimates plus ``_LEJA_GRID`` Chebyshev points of their interval, γ the
  interval's capacity (hi − lo)/4.
* ``"chebyshev"`` — scaled and shifted Chebyshev polynomials on the Ritz
  interval widened by ``_CHEB_WIDEN``.

The adaptive bases open with monomial **bootstrap cycles** at the f32-safe
depth (``BOOT_APPLICATIONS``) until k ≥ s iterations have run, take their
first Ritz estimates from the last bootstrap Gram (``ritz_from_segment``:
no extra products or reductions), and refresh them from every healthy
cycle's Gram.

**Guard and fallback chain.** Monomial cycles factorize each chain
segment's normalized Gram and break down when a Cholesky pivot collapses.
Adaptive (and overlapped) cycles run a depth-resolved prefix guard and
execute exactly the iterations whose chain prefix is well conditioned; a
basis that cannot start an iteration degrades the solve to the monomial
basis (sticky, ``basis_degraded``); a monomial failure is a breakdown, and
with ``fallback=True`` the standard solver finishes from the current
iterate (``basis_breakdown`` tells Gram-guard breakdowns from
Bi-CG-STAB's own ρ/ω collapse).

**Overlap** (``overlap=True``): two consecutive cycles share one Gram. Each
super-cycle grows the chains 2s deep before any Gram-gated scalar exists,
issues one Gram and runs up to 2s iterations from it, always under the
prefix guard, so the speculative deep half runs only as far as its chain
stays conditioned.

**Control flow and host reads.** The reference's ``lax.while_loop``s are
Python loops whose test runs before every trip, with the same carries: one
host read per cycle. The guards freeze and flag as the reference's do, so
``iters``, ``syncs`` and the residual history equal the reference's. The
fallback's ``lax.cond`` is one host read per solve. The small matrices
(Gram blocks of at most 4s+1 rows, Cholesky, triangular solves,
``eigvalsh``) stay on the device of the Krylov vectors. Cholesky uses ``torch.linalg.cholesky_ex``:
``info != 0`` counts as the non-finite factor that ``jnp.linalg.cholesky``
returns on a matrix that is not positive definite.

Not ported: the reference's per-cycle ``telemetry.ritz_event`` calls, which
wait for the telemetry port.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Union

import torch
from torch.utils._pytree import tree_leaves

from .blocks import pair_apply
from .krylov import (
    EPS as _EPS,
    BestState,
    NCState,
    best_init,
    guard_div,
    leja_order,
    nc_init,
    ritz_from_segment,
)
from .solvers import KrylovResult, _resolve, bicgstab, cg
from .tree_math import tree_where

Op = Callable[[Any], Any]

# Breakdown threshold on the normalized Gram's Cholesky pivots.
GUARD_PIVOT = 1e-4

# f32 monomial depth budget: the deepest power chain that reliably passes
# the Gram guard (CG s ≤ 4; Bi-CG-STAB applies A twice per iteration, so s ≤
# 2). The adaptive bases bootstrap at this depth.
BOOT_APPLICATIONS = 4

BASES = ("monomial", "newton", "chebyshev")

# Newton shift pool: the Ritz estimates plus this many Chebyshev points of
# their interval, consumed in Leja order.
_LEJA_GRID = 32

# Chebyshev interval widening, as a fraction of the Ritz interval's width on
# each end (a short chain underestimates the spectral edges).
_CHEB_WIDEN = 0.1

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class BasisSpec:
    """Polynomial basis for the s-step chains (see module docstring)."""

    kind: str = "monomial"

    def __post_init__(self):
        if self.kind not in BASES:
            raise ValueError(
                f"sstep basis must be one of {BASES}, got {self.kind!r}"
            )

    @property
    def adaptive(self) -> bool:
        return self.kind != "monomial"

    def coeffs(self, ritz, ok, depth: int):
        """Recurrence coefficients (α, β, γ), each of length ``depth``, from
        ascending Ritz estimates ``ritz``; the monomial values (0, 0, 1)
        where ``ok`` is False."""
        dev = ritz.device
        zeros = torch.zeros((depth,), dtype=_F32, device=dev)
        ones = torch.ones((depth,), dtype=_F32, device=dev)
        if self.kind == "monomial":
            return zeros, zeros.clone(), ones
        lo, hi = torch.min(ritz), torch.max(ritz)
        # Scale floor: a degenerate spectrum (hi ≈ lo) leaves the Gram guard,
        # not a division, to rule on the basis.
        floor = 1e-6 * (1.0 + torch.abs(lo) + torch.abs(hi))
        if self.kind == "newton":
            kk = torch.arange(_LEJA_GRID, dtype=_F32, device=dev)
            grid = 0.5 * (lo + hi) + 0.5 * (hi - lo) * torch.cos(
                (2.0 * kk + 1.0) * (math.pi / (2 * _LEJA_GRID)))
            th = leja_order(torch.cat([ritz.float(), grid]))
            alpha = th[:depth]
            beta = zeros
            gamma = ones * torch.maximum((hi - lo) / 4.0, floor)
        else:  # chebyshev
            c = 0.5 * (lo + hi)
            h = torch.maximum((0.5 + _CHEB_WIDEN) * (hi - lo), floor)
            alpha = ones * c
            half = ones[:depth - 1] * (0.5 * h)
            beta = torch.cat([zeros[:1], half])
            gamma = torch.cat([h.reshape(1), half])
        alpha = torch.where(ok, alpha, 0.0).to(_F32)
        beta = torch.where(ok, beta, 0.0).to(_F32)
        gamma = torch.where(ok, gamma, 1.0).to(_F32)
        return alpha, beta, gamma


def resolve_basis(basis: Union[str, BasisSpec, None]) -> BasisSpec:
    """Accept a kind string, a BasisSpec, or None (⇒ monomial)."""
    if basis is None:
        return BasisSpec("monomial")
    if isinstance(basis, BasisSpec):
        return basis
    return BasisSpec(str(basis))


# The static matrices below are built once per shape and device, on the host,
# and only read afterwards.
@functools.lru_cache(maxsize=None)
def _shift(segments, device) -> torch.Tensor:
    """Change-of-basis matrix T for concatenated *monomial* chains:
    A·(V c) = V·(T c); within a segment e_j ↦ e_{j+1}, last column zero."""
    m = sum(segments)
    T = torch.zeros((m, m), dtype=_F32)
    start = 0
    for seg in segments:
        for j in range(seg - 1):
            T[start + j + 1, start + j] = 1.0
        start += seg
    return T.to(device)


@functools.lru_cache(maxsize=None)
def _segment_shift(L: int, device) -> torch.Tensor:
    """(L, L−1) monomial recurrence block: A v_j = v_{j+1}."""
    return _shift((L,), device)[:, :L - 1]


def _segment_T(coeffs, L: int) -> torch.Tensor:
    """(L, L−1) recurrence block for one chain: column j holds the
    coordinates of A v_j = β_j v_{j−1} + α_j v_j + γ_j v_{j+1}."""
    alpha, beta, gamma = coeffs
    d = L - 1
    T = torch.zeros((L, d), dtype=_F32, device=alpha.device)
    idx = torch.arange(d, device=alpha.device)
    T[idx, idx] = alpha[:d]
    T[idx + 1, idx] = gamma[:d]
    T[idx[1:] - 1, idx[1:]] = beta[1:d]
    return T


def _basis_T(coeffs, segments) -> torch.Tensor:
    """Change-of-basis matrix for concatenated chains sharing one three-term
    recurrence: block-diagonal ``_segment_T`` blocks (contract of ``_shift``)."""
    m = sum(segments)
    T = torch.zeros((m, m), dtype=_F32, device=coeffs[0].device)
    start = 0
    for seg in segments:
        T[start:start + seg, start:start + seg - 1] = _segment_T(coeffs, seg)
        start += seg
    return T


def _grow_chains(be, pair, A_, p, r, n_apps: int, coeffs):
    """Grow the paired p/r chains: ``n_apps`` applications for the p-chain
    (n_apps+1 vectors), n_apps−1 for the r-chain (n_apps vectors), in
    lock-step width-2 block products; the p-chain's last level is a single
    product. ``coeffs`` None ⇒ monomial (the combine axpys are skipped)."""
    if coeffs is None:
        def adv(w, v, vp, j):
            return w
    else:
        alpha, beta, gamma = coeffs
        inv_g = 1.0 / gamma

        def adv(w, v, vp, j):
            t = be.axpy(-alpha[j], v, w)
            t = be.axpy(-beta[j], vp, t)
            return be.scale(inv_g[j], t)

    pch, rch = [p], [r]
    for j in range(n_apps - 1):
        w, u = pair(pch[-1], rch[-1])
        pnew = adv(w, pch[-1], pch[-2] if j else pch[-1], j)
        rnew = adv(u, rch[-1], rch[-2] if j else rch[-1], j)
        pch.append(pnew)
        rch.append(rnew)
    j = n_apps - 1
    w = A_(pch[-1])
    pch.append(adv(w, pch[-1], pch[-2] if j else pch[-1], j))
    return pch, rch


@functools.lru_cache(maxsize=None)
def _onehot(m: int, j: int, device) -> torch.Tensor:
    e = torch.zeros((m,), dtype=_F32)
    e[j] = 1.0
    return e.to(device)


def _normalize(G):
    """G scaled to a correlation matrix (unit diagonal where it is > 0)."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(G), 0.0))
    dn = 1.0 / torch.clamp_min(d, _EPS)
    return G * torch.outer(dn, dn)


def _gram_ok(G, segments, guard_pivot: float) -> torch.Tensor:
    """Binary basis-conditioning guard (the monomial chains'): the
    normalized Gram of each chain segment must factorize with every pivot
    above ``guard_pivot``. Across-segment rank deficiency is legitimate
    (p ≡ r in the first cycle)."""
    Gn = _normalize(G)
    ok = torch.isfinite(G).all()
    start = 0
    for seg in segments:
        L, info = torch.linalg.cholesky_ex(Gn[start:start + seg, start:start + seg])
        piv = torch.diagonal(L)
        ok = ok & (info == 0) & torch.isfinite(L).all() & (torch.min(piv) > guard_pivot)
        start += seg
    return ok


def _chol_prefix_ok(Gn, guard_pivot: float) -> torch.Tensor:
    """Per-column prefix-conditioning flags of a normalized segment Gram:
    ``ok[i]`` says the leading (i+1) columns factorize with every pivot
    above ``guard_pivot``. An unrolled guarded Cholesky keeps the valid
    leading pivots and makes the flags sticky-false after the first bad
    one."""
    L = Gn.shape[0]
    thresh = guard_pivot * guard_pivot
    M = Gn
    idx = torch.arange(L, device=Gn.device)
    good = torch.ones((), dtype=torch.bool, device=Gn.device)
    ok = []
    for j in range(L):
        pivsq = M[j, j]
        good = good & torch.isfinite(pivsq) & (pivsq > thresh)
        ok.append(good)
        piv = torch.sqrt(torch.clamp_min(pivsq, _EPS))
        c = torch.where(idx > j, M[:, j], 0.0) / piv
        M = M - torch.outer(c, c)
    return torch.stack(ok)


def _prefix_guard(G, segments, guard_pivot: float):
    """Depth-resolving guard of the adaptive and overlapped cycles:
    ``(finite, [per-segment prefix-ok arrays])``."""
    Gn = _normalize(G)
    finite = torch.isfinite(G).all()
    oks = []
    start = 0
    for seg in segments:
        oks.append(_chol_prefix_ok(Gn[start:start + seg, start:start + seg], guard_pivot))
        start += seg
    return finite, oks


def _lam_floor(nc_lam, ritz, rok, lam):
    """Fold a cycle's least Ritz value of the damped operator, shifted by −λ
    back to G, into the running λ_min estimate (``nc_lambda``)."""
    return torch.minimum(nc_lam, torch.where(rok, torch.min(ritz) - lam, 0.0))


def _merge_fallback(res: KrylovResult, run_standard) -> KrylovResult:
    """On breakdown, hand the iterate to the standard solver and merge: the
    most negative NC direction wins, iterations and syncs add up, the
    residual curve is the s-step prefix followed by the standard solve's,
    and ``breakdown=True`` records that the fallback ran. One host read."""
    if not bool(res.breakdown):
        return res
    std = run_standard(res.x)
    std_better = std.nc_curv < res.nc_curv
    hist = res.residual_history
    idx = torch.arange(hist.shape[0], device=hist.device)
    hist = torch.where(idx < res.iters, hist,
                       torch.roll(std.residual_history, int(res.iters)))
    return KrylovResult(
        std.x, std.r, std.x_best, std.r_best,
        tree_where(std_better, std.nc_dir, res.nc_dir),
        torch.logical_or(std.nc_found, res.nc_found),
        torch.minimum(std.nc_curv, res.nc_curv),
        res.iters + std.iters, std.residual,
        syncs=res.syncs + std.syncs,
        breakdown=torch.ones_like(res.breakdown),
        basis_degraded=res.basis_degraded,
        basis_breakdown=res.basis_breakdown,
        residual_history=hist,
        nc_lambda=torch.minimum(torch.as_tensor(std.nc_lambda), res.nc_lambda),
    )


def _record(hist, pos, k_it, active, rr_c):
    """Write ‖r‖ = sqrt(⟨r,r⟩) at absolute iteration ``k_it`` when active."""
    val = torch.sqrt(torch.clamp_min(rr_c, 0.0))
    return torch.where(torch.logical_and(active, pos == k_it), val, hist)


def _mono_coeffs(depth: int, device):
    """Monomial coefficient arrays (not None): the cycle then runs under the
    depth-resolved prefix guard."""
    return (torch.zeros((depth,), dtype=_F32, device=device),
            torch.zeros((depth,), dtype=_F32, device=device),
            torch.ones((depth,), dtype=_F32, device=device))


def _where3(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def sstep_cg(A: Op, b, x0, *, lam, s: int, max_iters: int, tol: float = 5e-3,
             backend=None, A_block: Optional[Op] = None,
             fallback: bool = True,
             guard_pivot: float = GUARD_PIVOT,
             basis: Union[str, BasisSpec] = "monomial",
             overlap: bool = False) -> KrylovResult:
    """s-step CG with Martens truncation and free negative-curvature capture
    (iteration for iteration ``solvers.cg`` in exact arithmetic). Each cycle
    builds [p-chain | r-chain] for the ``basis`` spec, reduces its Gram once
    and runs s CG steps in coordinates. ``A_block`` applies the operator to
    a stacked pair per chain level. ``fallback`` re-enters ``solvers.cg``
    from the current iterate after a monomial Gram-guard breakdown;
    ``overlap`` runs double-buffered super-cycles (module docstring)."""
    spec = resolve_basis(basis)
    s_run = 2 * s if overlap else s
    be = _resolve(backend)
    A_ = be.wrap_op(A)
    Ab_ = None if A_block is None else be.wrap_block_op(A_block)
    pair = pair_apply(be, A_, Ab_)
    b_ = be.lift(b)
    x0_ = be.lift(x0)
    dev = tree_leaves(b_)[0].device
    b_norm = be.norm(b_)
    r0 = be.sub(b_, A_(x0_))
    rr0 = be.dot(r0, r0)
    pos = torch.arange(max_iters, device=dev)

    def cycle(x, r, p, k, nc, s_cyc, coeffs, stop0, hist):
        """One cycle of up to ``s_cyc`` CG iterations; returns the advanced
        carries and the cycle's Gram."""
        m = 2 * s_cyc + 1
        segs = (s_cyc + 1, s_cyc)
        T = _shift(segs, dev) if coeffs is None else _basis_T(coeffs, segs)
        e_p, e_r = _onehot(m, 0, dev), _onehot(m, s_cyc + 1, dev)
        # Grow the space s steps ahead: products only, no scalar gates.
        pch, rch = _grow_chains(be, pair, A_, p, r, s_cyc, coeffs)
        V = be.block_stack(pch + rch)
        # The cycle's ONE reduction: every dot for s iterations.
        G = be.gram(V, V)
        G = 0.5 * (G + G.T)
        if coeffs is None:
            brk = torch.logical_not(_gram_ok(G, segs, guard_pivot))
            ok_iter = [torch.ones((), dtype=torch.bool, device=dev)] * s_cyc
        else:
            # Iteration j touches p-chain columns ≤ j+1, r-chain columns ≤ j.
            finite, (okp, okr) = _prefix_guard(G, segs, guard_pivot)
            ok_iter = [finite & okp[j + 1] & okr[j] for j in range(s_cyc)]
            brk = torch.logical_not(ok_iter[0])

        # s CG iterations as O(s²) coordinate recurrences.
        p_c, r_c = e_p, e_r
        x_c = torch.zeros((m,), dtype=_F32, device=dev)
        rr_c = G[s_cyc + 1, s_cyc + 1]
        stop = torch.logical_or(brk, stop0)
        term = torch.zeros((), dtype=torch.bool, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        cyc_found = torch.zeros((), dtype=torch.bool, device=dev)
        cyc_curv = nc.curv
        cyc_imp = torch.zeros((), dtype=torch.bool, device=dev)
        nc_c = torch.zeros((m,), dtype=_F32, device=dev)
        for j in range(s_cyc):
            active = torch.logical_not(stop) & (k + j < max_iters) & ok_iter[j]
            Tp = T @ p_c
            pAp = p_c @ (G @ Tp)
            p_sq = p_c @ (G @ p_c)
            # NC probe: (dᵀAd, dᵀd) are two Gram quadratic forms.
            raw = (pAp - lam * p_sq) / torch.clamp_min(p_sq, _EPS)
            is_nc = active & (raw < 0.0)
            better = is_nc & (raw < cyc_curv)
            nc_c = torch.where(better, p_c / torch.sqrt(torch.clamp_min(p_sq, _EPS)), nc_c)
            cyc_curv = torch.where(better, raw, cyc_curv)
            cyc_imp = cyc_imp | better
            cyc_found = cyc_found | is_nc
            # Martens truncation, frozen as in solvers.cg.
            trunc = pAp <= _EPS
            step_ok = active & torch.logical_not(trunc)
            alpha = rr_c / torch.clamp_min(pAp, _EPS)
            x_new = x_c + alpha * p_c
            r_new = r_c - alpha * Tp
            rr_new = r_new @ (G @ r_new)
            # f32 coordinate-drift guard: a non-positive ⟨r,r⟩ form discards
            # the step and ends the cycle; never reported as convergence.
            rr_bad = rr_new <= 0.0
            good = step_ok & torch.logical_not(rr_bad)
            beta = rr_new / torch.clamp_min(rr_c, _EPS)
            p_new = r_new + beta * p_c
            x_c = torch.where(good, x_new, x_c)
            r_c = torch.where(good, r_new, r_c)
            p_c = torch.where(good, p_new, p_c)
            rr_c = torch.where(good, rr_new, rr_c)
            hist = _record(hist, pos, k + it, active, rr_c)
            it = it + active.to(torch.int32)
            conv = (rr_c > 0.0) & (torch.sqrt(torch.clamp_min(rr_c, 0.0)) < tol * b_norm)
            ev = (active & trunc) | (good & conv)
            if j == 0:
                # Stagnation: a first-step drift failure leaves the carries
                # unchanged, so the next cycle would repeat it. End the solve.
                ev = ev | (step_ok & rr_bad)
            term = term | ev
            stop = stop | ev | (step_ok & rr_bad)

        # Materialize the cycle in one pass over the basis; on breakdown keep
        # the carried vectors (the overflowed basis may hold inf).
        out = be.block_combine(torch.stack([x_c, r_c, p_c, nc_c]), V)
        x2 = be.where(brk, x, be.axpy(1.0, be.block_col(out, 0), x))
        r2 = be.where(brk, r, be.block_col(out, 1))
        p2 = be.where(brk, p, be.block_col(out, 2))
        nc2 = NCState(
            nc.found | cyc_found,
            be.where(cyc_imp, be.block_col(out, 3), nc.dir),
            torch.where(cyc_imp, cyc_curv, nc.curv),
        )
        return x2, r2, p2, rr_c, it, term, brk, nc2, hist, G

    done0 = torch.sqrt(rr0) < tol * b_norm
    hist0 = torch.full((max_iters,), float("nan"), dtype=_F32, device=dev)
    nc0 = nc_init(be, b_)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    zero_f = torch.zeros((), dtype=_F32, device=dev)

    if not spec.adaptive:
        # Overlapped monomial super-cycles pass explicit monomial arrays so
        # the speculative half runs under the prefix guard.
        cf_mono = _mono_coeffs(s_run, dev) if overlap else None
        x, r, p, rr, k = x0_, r0, r0, rr0, zero_i
        done, brk, nc, syncs, hist, nc_lam = done0, no, nc0, zero_i, hist0, zero_f
        while bool(torch.logical_and(k < max_iters, torch.logical_not(done))):
            x, r, p, rr, it, term, brk_c, nc, hist, G = cycle(
                x, r, p, k, nc, s_run, cf_mono, no, hist)
            # Free λ_min estimate: the power chain's recurrence block is the
            # static shift matrix.
            ritz, rok = ritz_from_segment(
                G[:s_run + 1, :s_run + 1], _segment_shift(s_run + 1, dev))
            nc_lam = _lam_floor(nc_lam, ritz, rok, lam)
            k = k + it
            done = term | brk_c
            brk = brk | brk_c
            syncs = syncs + 1
        degraded = no
    else:
        # Bootstrap: monomial cycles at the f32-safe depth until k ≥ s (a
        # full-depth cycle launched from k < s has a rank-deficient basis by
        # construction). Prefix-guarded, so a nearly converged warm start
        # runs partial cycles. The last bootstrap Gram gives the first Ritz
        # estimates.
        s_boot = max(1, min(s_run, BOOT_APPLICATIONS))
        n_boot = -(-s_run // s_boot)
        cf0 = _mono_coeffs(s_boot, dev)
        xb, rb, pb = x0_, r0, r0
        rrb, kb, ncb = rr0, zero_i, nc0
        termb, brkb, Gb = done0, no, None
        histb = hist0
        for _ in range(n_boot):
            # A cycle speaks for the solve only while it is live: cycles run
            # after termination see a stale residual's degenerate Gram.
            live = torch.logical_not(termb | brkb)
            xb, rb, pb, rrb, it_, term_, brk_, ncb, histb, Gb = cycle(
                xb, rb, pb, kb, ncb, s_boot, cf0, torch.logical_not(live), histb)
            kb = kb + it_
            termb = termb | term_
            brkb = brkb | (brk_ & live)
        ritz, rok = ritz_from_segment(
            Gb[:s_boot + 1, :s_boot + 1], _segment_shift(s_boot + 1, dev))
        coeffs = spec.coeffs(ritz, rok, s_run)
        nc_lam = _lam_floor(zero_f, ritz, rok, lam)

        x, r, p, rr, k = xb, rb, pb, rrb, kb
        done, brk, nc = termb | brkb, brkb, ncb
        syncs = torch.full((), n_boot, dtype=torch.int32, device=dev)
        adaptive, degraded, hist = rok & torch.logical_not(brkb), no, histb
        while bool(torch.logical_and(k < max_iters, torch.logical_not(done))):
            x, r, p, rr, it, term, brk_c, nc, hist, G = cycle(
                x, r, p, k, nc, s_run, coeffs, no, hist)
            # Fallback chain: an adaptive guard failure degrades to the
            # monomial basis (sticky, cycle discarded); a monomial failure
            # is the hard breakdown the standard solver handles.
            degrade = brk_c & adaptive
            hard = brk_c & torch.logical_not(adaptive)
            # Free per-cycle refresh from the Gram just reduced.
            ritz, rok = ritz_from_segment(
                G[:s_run + 1, :s_run + 1], _segment_T(coeffs, s_run + 1))
            nc_lam = _lam_floor(nc_lam, ritz, rok, lam)
            fresh = spec.coeffs(ritz, rok, s_run)
            refresh = adaptive & rok & torch.logical_not(brk_c)
            coeffs = _where3(degrade, _mono_coeffs(s_run, dev),
                             _where3(refresh, fresh, coeffs))
            k = k + it
            done = term | hard
            brk = brk | hard
            syncs = syncs + 1
            adaptive = adaptive & torch.logical_not(degrade)
            degraded = degraded | degrade

    x, r, nc_dir = be.lower(x), be.lower(r), be.lower(nc.dir)
    # Every CG-side breakdown is a Gram-guard (basis) event.
    res = KrylovResult(x, r, x, r, nc_dir, nc.found, nc.curv, k,
                       torch.sqrt(torch.clamp_min(rr, 0.0)),
                       syncs=syncs, breakdown=brk, basis_degraded=degraded,
                       basis_breakdown=brk, residual_history=hist,
                       nc_lambda=torch.minimum(nc_lam, nc.curv))
    if not fallback:
        return res
    return _merge_fallback(
        res,
        lambda xs: cg(A, b, xs, lam=lam, max_iters=max_iters, tol=tol, backend=backend),
    )


def sstep_bicgstab(A: Op, b, x0, *, lam, s: int, max_iters: int,
                   tol: float = 5e-3, backend=None,
                   A_block: Optional[Op] = None,
                   fallback: bool = True,
                   guard_pivot: float = GUARD_PIVOT,
                   basis: Union[str, BasisSpec] = "monomial",
                   overlap: bool = False) -> KrylovResult:
    """s-step Bi-CG-STAB (CA-BICGSTAB) with NC capture and φ-best. Each cycle
    builds [p-chain, r-chain] 2s deep (an iteration applies A twice),
    appends the probe columns [r0*, b, x] to the Gram's right operand and
    reduces everything in ONE ``be.gram``. Breakdown covers the Gram guard
    (adaptive → monomial → standard) and the ρ/ω collapse of
    ``solvers.bicgstab``; with ``fallback`` either hard kind re-enters the
    standard solver from the current iterate, with a fresh shadow residual."""
    spec = resolve_basis(basis)
    s_run = 2 * s if overlap else s
    be = _resolve(backend)
    A_ = be.wrap_op(A)
    Ab_ = None if A_block is None else be.wrap_block_op(A_block)
    pair = pair_apply(be, A_, Ab_)
    b_ = be.lift(b)
    x0_ = be.lift(x0)
    dev = tree_leaves(b_)[0].device
    b_norm = be.norm(b_)
    r0 = be.sub(b_, A_(x0_))
    r0_star = r0
    rn0 = be.norm(r0)
    bx0 = be.dot(b_, x0_)
    pos = torch.arange(max_iters, device=dev)

    def cycle(x, r, p, bx, k, nc, best, s_cyc, coeffs, stop0, hist):
        """One cycle of up to ``s_cyc`` Bi-CG-STAB iterations in basis
        coordinates; returns the advanced carries and the cycle's Gram."""
        m = 4 * s_cyc + 1
        segs = (2 * s_cyc + 1, 2 * s_cyc)
        T = _shift(segs, dev) if coeffs is None else _basis_T(coeffs, segs)
        e_p, e_r = _onehot(m, 0, dev), _onehot(m, 2 * s_cyc + 1, dev)
        pch, rch = _grow_chains(be, pair, A_, p, r, 2 * s_cyc, coeffs)
        cols = pch + rch
        V = be.block_stack(cols)
        W = be.block_stack(cols + [r0_star, b_, x])
        # ONE reduction: the basis Gram and the r0*/b/x probe columns.
        Ge = be.gram(V, W)
        G = 0.5 * (Ge[:, :m] + Ge[:, :m].T)
        g_r0, g_b, g_x0 = Ge[:, m], Ge[:, m + 1], Ge[:, m + 2]
        if coeffs is None:
            brk_basis = torch.logical_not(_gram_ok(G, segs, guard_pivot))
            ok_iter = [torch.ones((), dtype=torch.bool, device=dev)] * s_cyc
        else:
            # An iteration applies T twice: p-chain columns ≤ 2j+2, r-chain
            # columns ≤ 2j+1.
            finite, (okp, okr) = _prefix_guard(G, segs, guard_pivot)
            ok_iter = [finite & okp[2 * j + 2] & okr[2 * j + 1] for j in range(s_cyc)]
            brk_basis = torch.logical_not(ok_iter[0])

        p_c, r_c = e_p, e_r
        x_c = torch.zeros((m,), dtype=_F32, device=dev)
        rho = g_r0[2 * s_cyc + 1]
        rr_c = G[2 * s_cyc + 1, 2 * s_cyc + 1]
        stop = torch.logical_or(brk_basis, stop0)
        term = torch.zeros((), dtype=torch.bool, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        brk_rec = torch.zeros((), dtype=torch.bool, device=dev)
        nc_state = (torch.zeros((m,), dtype=_F32, device=dev), nc.curv,
                    torch.zeros((), dtype=torch.bool, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
        best_xc = torch.zeros((m,), dtype=_F32, device=dev)
        best_rc = torch.zeros((m,), dtype=_F32, device=dev)
        best_phi = best.phi
        best_imp = torch.zeros((), dtype=torch.bool, device=dev)

        def probe(active, cand_c, quad, sq, state):
            nc_c, cyc_curv, cyc_imp, cyc_found = state
            raw = (quad - lam * sq) / torch.clamp_min(sq, _EPS)
            is_nc = active & (raw < 0.0)
            better = is_nc & (raw < cyc_curv)
            nc_c = torch.where(better, cand_c / torch.sqrt(torch.clamp_min(sq, _EPS)), nc_c)
            return (nc_c, torch.where(better, raw, cyc_curv), cyc_imp | better,
                    cyc_found | is_nc)

        for j in range(s_cyc):
            active = torch.logical_not(stop) & (k + j < max_iters) & ok_iter[j]
            v_c = T @ p_c                                    # A p̂_j
            Gv = G @ v_c
            pAp = p_c @ Gv
            p_sq = p_c @ (G @ p_c)
            nc_state = probe(active, p_c, pAp, p_sq, nc_state)
            alpha, bka = guard_div(rho, v_c @ g_r0)
            s_c = r_c - alpha * v_c                          # ŝ_j
            t_c = T @ s_c                                    # A ŝ_j
            Gt = G @ t_c
            ts = s_c @ Gt
            ss = s_c @ (G @ s_c)
            nc_state = probe(active, s_c, ts, ss, nc_state)
            tt = t_c @ Gt
            bkg = tt < _EPS
            gamma = ts / torch.where(bkg, torch.ones_like(tt), tt)
            x_new = x_c + alpha * p_c + gamma * s_c
            r_new = s_c - gamma * t_c
            rho_new = r_new @ g_r0
            rr_new = r_new @ (G @ r_new)
            one = torch.ones_like(rho)
            beta = (rho_new / torch.where(torch.abs(rho) < _EPS, one, rho)) * (
                alpha / torch.where(torch.abs(gamma) < _EPS, one, gamma))
            p_new = r_new + beta * (p_c - gamma * v_c)
            bk = bka | bkg
            step_ok = active & torch.logical_not(bk)
            # f32 coordinate-drift guard, as in sstep_cg.
            rr_bad = rr_new <= 0.0
            good = step_ok & torch.logical_not(rr_bad)
            x_c = torch.where(good, x_new, x_c)
            r_c = torch.where(good, r_new, r_c)
            p_c = torch.where(good, p_new, p_c)
            rho = torch.where(good, rho_new, rho)
            rr_c = torch.where(good, rr_new, rr_c)
            hist = _record(hist, pos, k + it, active, rr_c)
            # φ-best: ⟨b,x⟩ and ⟨x,r⟩ from the probe columns, no extra dots.
            phi = -0.5 * (bx + g_b @ x_c) - 0.5 * (g_x0 @ r_c + x_c @ (G @ r_c))
            improved = good & (phi < best_phi)
            best_xc = torch.where(improved, x_c, best_xc)
            best_rc = torch.where(improved, r_c, best_rc)
            best_phi = torch.where(improved, phi, best_phi)
            best_imp = best_imp | improved
            it = it + active.to(torch.int32)
            brk_rec = brk_rec | (active & bk)
            conv = (rr_c > 0.0) & (torch.sqrt(torch.clamp_min(rr_c, 0.0)) < tol * b_norm)
            ev = good & conv
            if j == 0:
                ev = ev | (step_ok & rr_bad)
            term = term | ev
            stop = stop | (active & bk) | ev | (step_ok & rr_bad)

        nc_c, cyc_curv, cyc_imp, cyc_found = nc_state
        # Materialize; on breakdown keep the carried vectors and scalars.
        out = be.block_combine(torch.stack([x_c, r_c, p_c, nc_c, best_xc, best_rc]), V)
        x2 = be.where(brk_basis, x, be.axpy(1.0, be.block_col(out, 0), x))
        xb_v = be.axpy(1.0, be.block_col(out, 4), x)  # x_start + V·best_xc
        best2 = BestState(
            be.where(best_imp, xb_v, best.x),
            be.where(best_imp, be.block_col(out, 5), best.r),
            best_phi,
        )
        nc2 = NCState(
            nc.found | cyc_found,
            be.where(cyc_imp, be.block_col(out, 3), nc.dir),
            torch.where(cyc_imp, cyc_curv, nc.curv),
        )
        r2 = be.where(brk_basis, r, be.block_col(out, 1))
        p2 = be.where(brk_basis, p, be.block_col(out, 2))
        bx2 = torch.where(brk_basis, bx, bx + g_b @ x_c)
        return (x2, r2, p2, bx2, rr_c, it, term, brk_basis, brk_rec, nc2, best2, hist, G)

    done0 = rn0 < tol * b_norm
    hist0 = torch.full((max_iters,), float("nan"), dtype=_F32, device=dev)
    nc0 = nc_init(be, b_)
    best0 = best_init(be, b_, x0_, r0)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    zero_f = torch.zeros((), dtype=_F32, device=dev)

    if not spec.adaptive:
        cf_mono = _mono_coeffs(2 * s_run, dev) if overlap else None
        x, r, p, bx, rr, k = x0_, r0, r0, bx0, rn0 * rn0, zero_i
        done, brk, nc, best, syncs = done0, no, nc0, best0, zero_i
        basis_brk, hist, nc_lam = no, hist0, zero_f
        while bool(torch.logical_and(k < max_iters, torch.logical_not(done))):
            (x, r, p, bx, rr, it, term, brk_basis, brk_rec,
             nc, best, hist, G) = cycle(x, r, p, bx, k, nc, best, s_run, cf_mono, no, hist)
            # ρ/ω collapse is a breakdown too (parity with solvers.bicgstab);
            # the fallback restarts with a fresh r0*.
            brk_c = brk_basis | brk_rec
            L = 2 * s_run + 1
            ritz, rok = ritz_from_segment(G[:L, :L], _segment_shift(L, dev))
            nc_lam = _lam_floor(nc_lam, ritz, rok, lam)
            k = k + it
            done = term | brk_c
            brk = brk | brk_c
            syncs = syncs + 1
            basis_brk = basis_brk | brk_basis
        degraded = no
    else:
        # Bootstrap at the f32-safe chain depth (s_boot = 2: 4 applications),
        # one cycle more than CG so the first full-depth cycle launches from
        # k > s.
        s_boot = max(1, min(s_run, BOOT_APPLICATIONS // 2))
        n_boot = -(-s_run // s_boot) + 1
        cf0 = _mono_coeffs(2 * s_boot, dev)
        xb, rb, pb, bxb = x0_, r0, r0, bx0
        rrb, kb, ncb, bestb = rn0 * rn0, zero_i, nc0, best0
        termb, brkb, brkb_basis, Gb = done0, no, no, None
        histb = hist0
        for _ in range(n_boot):
            live = torch.logical_not(termb | brkb)
            (xb, rb, pb, bxb, rrb, it_, term_, brk_basis_, brk_rec_,
             ncb, bestb, histb, Gb) = cycle(
                xb, rb, pb, bxb, kb, ncb, bestb, s_boot, cf0,
                torch.logical_not(live), histb)
            kb = kb + it_
            termb = termb | term_
            brkb_basis = brkb_basis | (brk_basis_ & live)
            brkb = brkb | ((brk_basis_ | brk_rec_) & live)
        Lb = 2 * s_boot + 1
        ritz, rok = ritz_from_segment(Gb[:Lb, :Lb], _segment_shift(Lb, dev))
        coeffs = spec.coeffs(ritz, rok, 2 * s_run)
        nc_lam = _lam_floor(zero_f, ritz, rok, lam)

        x, r, p, bx, rr, k = xb, rb, pb, bxb, rrb, kb
        done, brk, nc, best = termb | brkb, brkb, ncb, bestb
        syncs = torch.full((), n_boot, dtype=torch.int32, device=dev)
        adaptive, degraded = rok & torch.logical_not(brkb), no
        basis_brk, hist = brkb_basis, histb
        while bool(torch.logical_and(k < max_iters, torch.logical_not(done))):
            (x, r, p, bx, rr, it, term, brk_basis, brk_rec,
             nc, best, hist, G) = cycle(x, r, p, bx, k, nc, best, s_run, coeffs, no, hist)
            degrade = brk_basis & adaptive
            hard_basis = brk_basis & torch.logical_not(adaptive)
            hard = hard_basis | brk_rec
            L = 2 * s_run + 1
            ritz, rok = ritz_from_segment(G[:L, :L], _segment_T(coeffs, L))
            nc_lam = _lam_floor(nc_lam, ritz, rok, lam)
            fresh = spec.coeffs(ritz, rok, 2 * s_run)
            refresh = adaptive & rok & torch.logical_not(brk_basis)
            coeffs = _where3(degrade, _mono_coeffs(2 * s_run, dev),
                             _where3(refresh, fresh, coeffs))
            k = k + it
            done = term | hard
            brk = brk | hard
            syncs = syncs + 1
            adaptive = adaptive & torch.logical_not(degrade)
            degraded = degraded | degrade
            basis_brk = basis_brk | hard_basis

    res = KrylovResult(
        be.lower(x), be.lower(r), be.lower(best.x), be.lower(best.r),
        be.lower(nc.dir), nc.found, nc.curv, k, be.norm(r),
        syncs=syncs, breakdown=brk, basis_degraded=degraded,
        basis_breakdown=basis_brk, residual_history=hist,
        nc_lambda=torch.minimum(nc_lam, nc.curv),
    )
    if not fallback:
        return res
    return _merge_fallback(
        res,
        lambda xs: bicgstab(A, b, xs, lam=lam, max_iters=max_iters, tol=tol,
                            backend=backend),
    )
