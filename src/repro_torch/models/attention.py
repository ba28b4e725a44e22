"""GQA attention (twin of ``repro/models/attention.py``): the training path
(``attn_init``, ``_split_heads``, the ``_sdpa`` oracle, ``causal_mask``,
``attend_full``) and serving's prefill and single-token decode against a
rolling KV cache (``KVCache``, ``init_kv_cache``, ``attend_full_with_cache``,
``decode_attend``, ``decode_attend_ragged``). ``decode_cross_attend``
belongs to whisper (ROADMAP item 18) and is not ported.

The decode functions write the new token's K/V into the cache **in place**
and return the same ``KVCache``: the reference's serving loop donates the
cache buffers so that XLA updates them in place, and here the caller's cache
is the one updated. A caller that needs the old cache keeps a copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .._device import resolve_device
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


def causal_mask(S, T=None, *, window: Optional[int] = None, offset: int = 0, device="cuda"):
    """(1, 1, S, T) bool on ``device`` (the card unless the caller asks for
    the CPU); query i attends keys j ≤ i+offset and, with a window,
    j > i+offset-window."""
    device = resolve_device(device)
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


# ------------------------------------------------------------- KV cache ----
class KVCache(NamedTuple):
    k: torch.Tensor     # (B, W, KV, hd) rolling window buffer
    v: torch.Tensor     # (B, W, KV, hd)
    pos: torch.Tensor   # (W,) or (B, W) int32 absolute position per slot (-1 empty)

    @property
    def window(self):
        return self.k.shape[1]


def _window(cfg, max_len):
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_kv_cache(cfg, batch, max_len, dtype, *, ragged=False, device="cuda") -> KVCache:
    """Dense rolling cache of W = min(max_len, window) slots on ``device``
    (the card unless the caller asks for the CPU). ``ragged=True`` gives
    per-sequence slot positions pos (B, W), the continuous-batching layout
    where every batch slot sits at its own decode position."""
    device = resolve_device(device)
    W = _window(cfg, max_len)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((batch, W, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, W, KV, hd), dtype=dtype, device=device),
        pos=torch.full((batch, W) if ragged else (W,), -1, dtype=torch.int32, device=device),
    )


def _qkv_rope(p, x, positions, cfg):
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = _split_heads(dense(p["wq"], x), H, hd)
    k = _split_heads(dense(p["wk"], x), KV, hd)
    v = _split_heads(dense(p["wv"], x), KV, hd)
    q = apply_rope(q, positions, rope_fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    k = apply_rope(k, positions, rope_fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    return q, k, v


def attend_full_with_cache(p, x, positions, cfg, max_len):
    """Prefill: full-sequence causal attention that also returns the rolling
    KV cache (absolute position p in slot p % W). Under
    ``cfg.use_flash_attention`` it runs the flash forward kernel."""
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    B, S, _ = x.shape
    q, k, v = _qkv_rope(p, x, positions, cfg)
    if cfg.use_flash_attention:
        from ..kernels.flash_ad import flash_mha

        out = flash_mha(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = _sdpa(q, k, v, causal_mask(S, window=cfg.sliding_window, device=x.device))
    y = dense(p["wo"], out.reshape(B, S, H * hd))

    W = _window(cfg, max_len)
    keep = min(S, W)
    pos_kept = positions[S - keep:]
    slots = torch.remainder(pos_kept, W).long()
    cache = init_kv_cache(cfg, B, max_len, k.dtype, device=x.device)
    cache.k[:, slots] = k[:, S - keep:]
    cache.v[:, slots] = v[:, S - keep:]
    cache.pos[slots] = pos_kept.to(torch.int32)
    return y, cache


def decode_attend(p, x, t, cache: KVCache, cfg):
    """One-token decode. x (B, 1, d); t: the absolute position of this token
    (an int), the same for every sequence; cache.pos (W,).

    Writes (k, v) for position t into slot t % W (in place) and attends every
    valid slot (absolute position in (t - window, t]). Under
    ``cfg.use_flash_attention`` the attend runs the split-K flash-decode
    kernel with the mask as a (1, W) bias row (``decode_bias``)."""
    from ..kernels import ops

    hd, H = cfg.resolved_head_dim, cfg.n_heads
    B = x.shape[0]
    t = int(t)
    pos_t = torch.full((1,), t, dtype=torch.int32, device=x.device)
    q, k, v = _qkv_rope(p, x, pos_t, cfg)
    slot = t % cache.window
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[slot:slot + 1].fill_(t)   # ``pos[slot] = t`` would copy t from the host and wait
    if cfg.use_flash_attention:
        bias = ops.decode_bias(cache.pos, t, window=cfg.sliding_window)
        out = ops.flash_decode(q[:, 0].contiguous(), cache.k, cache.v, bias)[:, None]
    else:
        valid = (cache.pos >= 0) & (cache.pos <= t)
        if cfg.sliding_window:
            valid = valid & (cache.pos > t - cfg.sliding_window)
        out = _sdpa(q, cache.k, cache.v, valid[None, None, None, :])
    return dense(p["wo"], out.reshape(B, 1, H * hd)), cache


def decode_attend_ragged(p, x, t, cache: KVCache, cfg, *, active=None):
    """Per-slot decode (continuous batching). x (B, 1, d); t (B,) absolute
    position of each slot's token; cache.pos (B, W) (``ragged=True``).

    Slot b writes its (k, v) at t[b] % W (in place) and attends its own
    validity row. ``active`` (B,) bool marks live slots: inactive slots keep
    their cache rows and give a fully masked (zero) attend."""
    from ..kernels import ops

    hd, H = cfg.resolved_head_dim, cfg.n_heads
    B = x.shape[0]
    q, k, v = _qkv_rope(p, x, t[:, None].to(torch.int32), cfg)
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=x.device)
    slot = torch.remainder(t, cache.window).long()
    ar = torch.arange(B, device=x.device)
    keep = active[:, None, None]
    cache.k[ar, slot] = torch.where(keep, k[:, 0], cache.k[ar, slot])
    cache.v[ar, slot] = torch.where(keep, v[:, 0], cache.v[ar, slot])
    cache.pos[ar, slot] = torch.where(active, t.to(torch.int32), cache.pos[ar, slot])
    bias = ops.decode_bias(cache.pos, t, window=cfg.sliding_window)   # (B, W)
    bias = torch.where(active[:, None], bias, NEG_INF)
    if cfg.use_flash_attention:
        out = ops.flash_decode(q[:, 0].contiguous(), cache.k, cache.v, bias)[:, None]
    else:
        out = _sdpa(q, cache.k, cache.v, (bias == 0.0)[:, None, None, :])
    return dense(p["wo"], out.reshape(B, 1, H * hd)), cache
