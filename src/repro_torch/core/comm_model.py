"""Sync formulas of distributed HF (a copy of the ones in
``benchmarks/comm_model.py``, which the port does not import).

Per outer iteration, K Krylov iterations and E line-search evaluations:
1 gradient reduce + K per-iteration reduces + E loss reduces in the standard
schedule; the s-step solve collapses the K per-iteration round-trips into one
Gram reduction per cycle of s iterations (plus the bootstrap cycles of the
adaptive bases); the overlapped schedule (``HFConfig.overlap``) counts only
the syncs that still block. ``metrics["blocking_syncs"]`` of ``hf_step``
equals ``hf_sstep_syncs_per_iteration`` at the executed K and E.
"""
from __future__ import annotations

import math


def hf_syncs_per_iteration(cg_iters: int, ls_evals: int) -> int:
    return 1 + cg_iters + ls_evals


def sstep_basis_len(s: int, solver: str = "cg") -> int:
    """Basis length per s-step cycle: [p-chain (d+1) | r-chain (d)], chain
    depth d = s (CG) or 2s (Bi-CG-STAB: two products an iteration)."""
    d = 2 * s if solver == "bicgstab" else s
    return 2 * d + 1


# The f32-safe monomial power applications of the adaptive bases' bootstrap
# cycles (``core/sstep.py``).
SSTEP_BOOT_APPLICATIONS = 4


def sstep_bootstrap(s: int, solver: str = "cg", basis: str = "monomial"):
    """(bootstrap cycles, iterations they cover) of an s-step solve: none for
    the monomial basis; the adaptive bases open with monomial cycles at the
    f32-safe depth until k ≥ s iterations have run, plus one margin cycle
    for Bi-CG-STAB."""
    if basis == "monomial":
        return 0, 0
    if solver == "bicgstab":
        s_boot = max(1, min(s, SSTEP_BOOT_APPLICATIONS // 2))
        n_boot = -(-s // s_boot) + 1
    else:
        s_boot = max(1, min(s, SSTEP_BOOT_APPLICATIONS))
        n_boot = -(-s // s_boot)
    return n_boot, n_boot * s_boot


def hf_sstep_syncs_per_iteration(cg_iters: int, ls_evals: int, s: int,
                                 solver: str = "cg",
                                 basis: str = "monomial",
                                 overlap: bool = False) -> int:
    """Blocking synchronizations per outer iteration: 1 + n_boot +
    ⌈(K − covered)/s⌉ + E, or under ``overlap`` n_boot(2s) + ⌈(K −
    covered)/2s⌉ + ⌈E/2⌉ (the gradient reduce hidden, cycles
    double-buffered, line-search trials paired). At s = 1 the standard
    solver runs, so overlap keeps the K per-iteration round-trips."""
    s_eff = 2 * s if (overlap and s > 1) else s
    n_boot, covered = sstep_bootstrap(s_eff, solver, basis)
    cycles = math.ceil(max(cg_iters - covered, 0) / max(s_eff, 1))
    if overlap:
        krylov = (n_boot + cycles) if s > 1 else cg_iters
        return krylov + math.ceil(ls_evals / 2)
    return 1 + n_boot + cycles + ls_evals
