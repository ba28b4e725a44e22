"""Levenberg–Marquardt damping adaptation (Martens 2010, paper Alg. 2 line 8;
twin of ``repro/core/damping.py``).

ρ = actual reduction / predicted reduction of m(δ) = gᵀδ + ½ δᵀ(G+λI)δ.
ρ < 1/4 → λ ← λ·inc;  ρ > 3/4 → λ ← λ/dec.
"""
from __future__ import annotations

import torch

LM_LOW = 0.25
LM_HIGH = 0.75


def lm_update(lam, f_old, f_new, pred_red, *, inc=1.5, dec=1.5, lam_min=1e-8,
              lam_max=1e8):
    """Return (new λ, ρ). pred_red = m(δ) − m(0) (should be ≤ 0)."""
    actual = f_new - f_old
    rho = actual / torch.clamp_max(pred_red, -1e-20)  # both negative if progress
    lam_new = torch.where(rho < LM_LOW, lam * inc,
                          torch.where(rho > LM_HIGH, lam / dec, lam))
    # If the step was not even a descent step, damp hard.
    lam_new = torch.where(actual > 0.0, lam * inc * inc, lam_new)
    return torch.clamp(lam_new, lam_min, lam_max), rho
