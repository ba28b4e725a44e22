"""Dispatch for the port's kernels (twin of ``repro/kernels/ops.py``): the
flat Krylov backend's fused recurrences (``bicgstab_x_update``,
``bicgstab_residual_dots``, ``dot2``, ``gram_block``) and the raw
flash-attention passes (``flash_attention_fwd``, ``flash_attention_dq``,
``flash_attention_dkv``, ``flash_attention_jvp``; the differentiable entry
point is ``kernels.flash_ad.flash_mha``) and the split-K decode
(``flash_decode``, ``flash_decode_paged``, with the mask functions
``decode_bias`` and ``paged_bias``) and the SSD intra-chunk step
(``ssd_intra``; the chunked scan around it is ``ssd_chunked_pallas``).

A CUDA tensor goes to the hand-written kernel (``kernels.cg_fused``,
``kernels.flash_attention``, ``kernels.flash_decode``, ``kernels.ssd_scan``);
a CPU tensor goes to the plain version
(``kernels.ref``); anything else raises.
There is no fallback from a failed build or launch to the plain version.

``LAUNCHES`` counts, per kernel, the calls that launched it; ``chip_smoke.py``
zeroes it before the main path and reads it after, to show that the path
really ran through the kernels.
"""
from __future__ import annotations

import torch

from . import cg_fused, ref
from . import flash_attention as fa
from . import flash_decode as fd
from . import ssd_scan as ssd
from .flash_decode import decode_bias, paged_bias  # noqa: F401  (the one decode mask)
from .ssd_scan import ssd_chunked_pallas  # noqa: F401  (the scan around ssd_intra)

LAUNCHES = {"dot2": 0, "x_update": 0, "residual_dots": 0, "dots_block": 0,
            "flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "flash_attention_jvp": 0,
            "flash_decode": 0, "flash_decode_paged": 0, "ssd_intra": 0}


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


def gram_block(U, V):
    """Gram matrix U @ V.T of two stacked flat f32 blocks, (s_u, n) and
    (s_v, n) → (s_u, s_v): the s-step solvers' one reduction per cycle."""
    if _route(U) == "cpu":
        return ref.gram_block_ref(U, V)
    return gram_tiles(U, V, _dots_block)


def _dots_block(U, V):
    out = cg_fused.dots_block(U, V)
    LAUNCHES["dots_block"] += 1
    return out


def gram_tiles(U, V, kernel, rows: int = cg_fused.GRAM_MAX_ROWS):
    """U @ V.T from ``kernel`` calls on row blocks of at most ``rows`` rows
    each: one call when both blocks fit (every shape of the s-step path up
    to s = 8; overlapped Bi-CG-STAB at s = 4 stacks 33 rows)."""
    if U.shape[0] <= rows and V.shape[0] <= rows:
        return kernel(U, V)
    return torch.cat([
        torch.cat([kernel(U[i:i + rows], V[j:j + rows])
                   for j in range(0, V.shape[0], rows)], dim=1)
        for i in range(0, U.shape[0], rows)], dim=0)


# ------------------------------------------------------ flash attention --
# Each takes causal, window, valid_len, scale and the optional (B|1, Sq, Sk)
# f32 bias as keywords, as ``repro.kernels.flash_attention`` does.

def flash_attention_fwd(q, k, v, **kw):
    """(o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32)."""
    if _route(q) == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, **kw)
    out = fa.flash_attention_fwd(q, k, v, **kw)
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def flash_attention_dq(q, k, v, do, lse, delta, **kw):
    """dq (B, Sq, H, hd) in q's dtype; Δ = rowsum(dO∘O) as (B, H, Sq)."""
    if _route(q) == "cpu":
        return ref.flash_attention_dq_ref(q, k, v, do, lse, delta, **kw)
    out = fa.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    LAUNCHES["flash_attention_dq"] += 1
    return out


def flash_attention_dkv(q, k, v, do, lse, delta, **kw):
    """Per-q-head (dk_h, dv_h), each (B, Sk, H, hd) f32."""
    if _route(q) == "cpu":
        return ref.flash_attention_dkv_ref(q, k, v, do, lse, delta, **kw)
    out = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    LAUNCHES["flash_attention_dkv"] += 1
    return out


def flash_attention_jvp(q, k, v, qt, kt, vt, lse, **kw):
    """(g (B, Sq, H, hd) f32, t (B, H, Sq) f32) of the tangent pass."""
    if _route(q) == "cpu":
        return ref.flash_attention_jvp_ref(q, k, v, qt, kt, vt, lse, **kw)
    out = fa.flash_attention_jvp(q, k, v, qt, kt, vt, lse, **kw)
    LAUNCHES["flash_attention_jvp"] += 1
    return out


# --------------------------------------------------------- flash decode --
def flash_decode(q, k, v, bias, *, scale=None, blk_k=128, n_splits=8, return_stats=False):
    """Dense split-K decode: q (B, H, hd), k/v (B, W, KV, hd), bias (B|1, W)
    → o (B, H, hd), or (o, m, l) under ``return_stats``. The plain version
    takes no split layout (``blk_k``, ``n_splits``)."""
    if _route(q) == "cpu":
        return ref.flash_decode_ref(q, k, v, bias, scale=scale, return_stats=return_stats)
    out = fd.flash_decode(q, k, v, bias, scale=scale, blk_k=blk_k, n_splits=n_splits,
                          return_stats=return_stats)
    LAUNCHES["flash_decode"] += 1
    return out


def flash_decode_paged(q, k_pool, v_pool, page_table, bias, *, scale=None,
                       return_stats=False):
    """Paged decode over the (P, page_size, KV, hd) pools, one page per
    split; returns as ``flash_decode``."""
    if _route(q) == "cpu":
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, page_table, bias, scale=scale,
                                          return_stats=return_stats)
    out = fd.flash_decode_paged(q, k_pool, v_pool, page_table, bias, scale=scale,
                                return_stats=return_stats)
    LAUNCHES["flash_decode_paged"] += 1
    return out


# ------------------------------------------------------------ SSD scan --
def ssd_intra(u, log_a, Bv, Cv):
    """The SSD intra-chunk step: u (B, nc, H, Q, P), log_a (B, nc, H, Q), Bv/Cv
    (B, nc, Q, N) shared across heads → (y, S, g, l), f32."""
    if _route(u) == "cpu":
        return ref.ssd_intra_ref(u, log_a, Bv, Cv)
    out = ssd.ssd_intra(u, log_a, Bv, Cv)
    LAUNCHES["ssd_intra"] += 1
    return out
