"""Dispatch for the flat Krylov backend's fused recurrences (twin of
``repro/kernels/ops.py`` ``bicgstab_x_update``, ``bicgstab_residual_dots`` and
``dot2``).

A CUDA tensor goes to the hand-written kernel (``kernels.cg_fused``); a CPU
tensor goes to the plain version (``kernels.ref``); anything else raises.
There is no fallback from a failed build or launch to the plain version.

``LAUNCHES`` counts, per kernel, the calls that launched it; ``chip_smoke.py``
zeroes it before the main path and reads it after, to show that the path
really ran through the kernels.
"""
from __future__ import annotations

import torch

from . import cg_fused, ref

LAUNCHES = {"dot2": 0, "x_update": 0, "residual_dots": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for tensors on {t.device}")


def _scalar(a, like):
    return torch.as_tensor(a, dtype=torch.float32, device=like.device).reshape(1)


def bicgstab_x_update(x, p, s, alpha, gamma):
    """x + alpha*p + gamma*s  (flat f32 vectors)."""
    if _route(x) == "cpu":
        return ref.x_update_ref(x, p, s, alpha, gamma)
    out = cg_fused.x_update(x, p, s, _scalar(alpha, x), _scalar(gamma, x))
    LAUNCHES["x_update"] += 1
    return out


def bicgstab_residual_dots(s, As, r0s, gamma):
    """r = s - gamma*As; returns (r, <r,r0s>, <r,r>)."""
    if _route(s) == "cpu":
        return ref.residual_dots_ref(s, As, r0s, gamma)
    out = cg_fused.residual_dots(s, As, r0s, _scalar(gamma, s))
    LAUNCHES["residual_dots"] += 1
    return out


def dot2(u, v):
    """(<u,v>, <v,v>)."""
    if _route(u) == "cpu":
        return ref.dot2_ref(u, v)
    out = cg_fused.dot2(u, v)
    LAUNCHES["dot2"] += 1
    return out
