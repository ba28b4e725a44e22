"""GQA attention, training path (twin of ``repro/models/attention.py``:
``attn_init``, ``_split_heads``, the ``_sdpa`` oracle, ``causal_mask`` and
``attend_full``). The KV cache and the decode functions are serving's
(ROADMAP item 20).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .layers import apply_rope, dense, dense_init

NEG_INF = -1e30


def attn_init(gen, cfg, dtype, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {
        "wk": dense_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias, lead=lead),
        "wo": dense_init(gen, H * hd, d, dtype, lead=lead),
        "wq": dense_init(gen, d, H * hd, dtype, bias=cfg.qkv_bias, lead=lead),
        "wv": dense_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias, lead=lead),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _sdpa(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,KV,hd), mask (B|1,1,S,T) bool → (B,S,H,hd).
    Plain attention, the oracle of the flash route: the products accumulate
    in f32 from the inputs' values, the weights are rounded to v's dtype
    before the product with V, as in the reference."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    logits = logits + torch.where(mask[:, :, None], 0.0, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def causal_mask(S, T=None, *, window: Optional[int] = None, offset: int = 0, device="cpu"):
    """(1, 1, S, T) bool; query i attends keys j ≤ i+offset and, with a
    window, j > i+offset-window."""
    T = T if T is not None else S
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None, None]


def attend_full(p, x, positions, cfg, *, mask=None, cross_kv=None):
    """Training attention. x (B,S,d) → (B,S,d).

    ``cross_kv=(k_src, v_src)`` makes it cross-attention (no RoPE on the
    source side). Under ``cfg.use_flash_attention`` the default causal
    (sliding-window) self-attention, cross-attention and head-broadcast
    explicit masks (as an additive f32 bias) run the flash kernels through
    ``kernels.flash_ad.flash_mha``; only per-kv-head masks keep ``_sdpa``,
    which is otherwise the oracle.
    """
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    B, S, _ = x.shape
    q = _split_heads(dense(p["wq"], x), H, hd)
    if cross_kv is None:
        k = _split_heads(dense(p["wk"], x), KV, hd)
        v = _split_heads(dense(p["wv"], x), KV, hd)
        q = apply_rope(q, positions, rope_fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rope_fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        if cfg.use_flash_attention and mask is None:
            from ..kernels.flash_ad import flash_mha

            out = flash_mha(q, k, v, causal=True, window=cfg.sliding_window)
            return dense(p["wo"], out.reshape(B, S, H * hd))
        if mask is None:
            mask = causal_mask(S, window=cfg.sliding_window, device=x.device)
    else:
        k, v = cross_kv
        if cfg.use_flash_attention and mask is None:
            from ..kernels.flash_ad import flash_mha

            out = flash_mha(q, k, v, causal=False, window=None)
            return dense(p["wo"], out.reshape(B, S, H * hd))
        if mask is None:
            mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool, device=x.device)
    if cfg.use_flash_attention and mask.shape[1] == 1:
        from ..kernels.flash_ad import flash_mha

        bias = torch.where(mask[:, 0], 0.0, NEG_INF).float()
        out = flash_mha(q, k, v, causal=False, window=None, bias=bias)
        return dense(p["wo"], out.reshape(B, S, H * hd))
    out = _sdpa(q, k, v, mask)
    return dense(p["wo"], out.reshape(B, S, H * hd))
