"""Plain PyTorch versions of the port's kernels (twins of
``repro/kernels/ref.py``): the fused Krylov recurrences
(``bicgstab_x_update_ref``, ``bicgstab_residual_dots_ref``, ``dot2_ref`` and,
for ``ops.gram_block``, ``gram_block_ref``), the four flash-attention
passes, each with its kernel's own outputs, the dense and paged decode
(``flash_decode_ref``, ``flash_decode_paged_ref``, and each split and
merged as its kernel splits it, ``flash_decode_split_ref`` and
``flash_decode_paged_split_ref``) and
the SSD intra-chunk step (``ssd_intra_ref``).

``kernels.ops`` runs these for tensors on the CPU; ``chip_smoke.py`` holds
each CUDA kernel against them on the card. Sums are ``torch.sum`` of the
products, not ``torch.dot``: on the CPU ``torch.dot`` accumulates in f32 in
one sequence (4e-5 relative error at n = 200k), ``torch.sum`` pairwise.

The attention versions keep the reference's layout at every function: q
(B, Sq, H, hd), k/v (B, Sk, KV, hd), lse and Δ (B, H, Sq), the optional
additive bias (B|1, Sq, Sk) f32. They compute in f32 from the inputs as
given (in float64 from float64 inputs, for an exact yardstick) and return
the kernels' output types. Like the reference's kernels, they round the
softmax weights to the input type before the second product (P in the
forward, dS in dQ, P and dS in dK/dV, R = P∘Ṡ and P in the JVP; a no-op
for f32 and float64) and sum l and t from the unrounded values. Their mask
is their own copy (``_ref_mask``), independent of
``flash_ad.position_mask``.
"""
from __future__ import annotations

import torch

from .flash_decode import combine_splits, split_layout

# Column block of the reference's Gram kernel (``repro/kernels/cg_fused.py``
# ``BLOCK_GRAM``): the plain Gram sums per-block partials in block order.
BLOCK_GRAM = 16 * 1024


def x_update_ref(x, p, s, alpha, gamma):
    """x + alpha*p + gamma*s in f32."""
    return x.float() + alpha * p.float() + gamma * s.float()


def residual_dots_ref(s, As, r0s, gamma):
    """r = s - gamma*As; returns (r, <r,r0s>, <r,r>)."""
    r = s.float() - gamma * As.float()
    return r, torch.sum(r * r0s.float()), torch.sum(r * r)


def dot2_ref(u, v):
    """(<u,v>, <v,v>) in f32."""
    uf, vf = u.float(), v.float()
    return torch.sum(uf * vf), torch.sum(vf * vf)


def gram_block_ref(U, V):
    """U @ V.T of (s_u, n) and (s_v, n) blocks in f32: per-column-block
    partials over ``BLOCK_GRAM`` columns, added in block order (the
    reference's order of summation)."""
    Uf, Vf = U.float(), V.float()
    out = torch.zeros((Uf.shape[0], Vf.shape[0]), dtype=torch.float32, device=Uf.device)
    for c in range(0, Uf.shape[1], BLOCK_GRAM):
        out = out + Uf[:, c:c + BLOCK_GRAM] @ Vf[:, c:c + BLOCK_GRAM].T
    return out


# ----------------------------------------------------------- attention --
NEG_INF = -1e30


def _ref_mask(S, T, *, causal, window, valid_len, device):
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask = kj <= qi
    if window is not None:
        mask = mask & (kj > qi - window)
    if valid_len is not None:
        mask = mask & (kj < valid_len)
    return mask


def _up(t):
    """f32 for the working types, float64 kept as it is."""
    return t if t.dtype == torch.float64 else t.float()


def _as(w, like):
    """``w`` rounded to ``like``'s type and widened back, as the reference's
    ``.astype`` before a product; f32 and float64 are left as they are."""
    if like.dtype in (torch.float32, torch.float64):
        return w
    return w.to(like.dtype).to(w.dtype)


def _scale(scale, hd):
    return float(scale if scale is not None else 1.0 / hd ** 0.5)


def _ref_logits(q, k, scale, *, causal, window, valid_len, bias):
    """Masked (B, KV, G, Sq, Sk) f32 logits and the (Sq, Sk) mask."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = _up(q).reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, _up(k)) * scale
    if bias is not None:
        logits = logits + _up(bias)[:, None, None]
    mask = _ref_mask(S, T, causal=causal, window=window, valid_len=valid_len,
                     device=q.device)
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF)), mask


def _ref_p(q, k, lse, scale, *, causal, window, valid_len, bias):
    """(B, KV, G, Sq, Sk) attention weights recomputed from the stored lse."""
    B, S, H, _ = q.shape
    KV = k.shape[2]
    logits, mask = _ref_logits(q, k, scale, causal=causal, window=window,
                               valid_len=valid_len, bias=bias)
    lseg = _up(lse).reshape(B, KV, H // KV, S)
    return torch.where(mask, torch.exp(logits - lseg[..., None]),
                       torch.zeros_like(logits))


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=None, valid_len=None,
                            scale=None, bias=None):
    """(o (B, Sq, H, hd) in q's type, lse (B, H, Sq) f32). Fully masked rows
    give o = 0 and lse = 0, as the kernel's guard does."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    logits, mask = _ref_logits(q, k, _scale(scale, hd), causal=causal, window=window,
                               valid_len=valid_len, bias=bias)
    m = logits.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(logits - m_safe[..., None]), torch.zeros_like(logits))
    l = p.sum(dim=-1)
    norm = torch.where(l <= 0.0, torch.ones_like(l), l)
    lse = m_safe + torch.log(norm)
    acc = torch.einsum("bkgst,btkh->bkgsh", _as(p, v), _up(v)) / norm[..., None]
    out = acc.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, H, hd).to(q.dtype), lse.reshape(B, H, S)


def _delta_bsh(delta, B, S, KV, G):
    """Δ (B, H, Sq) → (B, KV, G, Sq, 1)."""
    return _up(delta).reshape(B, KV, G, S)[..., None]


def _grad_terms(q, k, v, do, lse, delta, scale, kw):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    p = _ref_p(q, k, lse, scale, **kw)
    dog = _up(do).reshape(B, S, KV, G, hd)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, _up(v))
    ds = p * (dp - _delta_bsh(delta, B, S, KV, G))
    return p, ds, dog


def flash_attention_dq_ref(q, k, v, do, lse, delta, *, causal=True, window=None,
                           valid_len=None, scale=None, bias=None):
    """dQ = scale·Σ_k P∘(dP − Δ)·K with P from lse → (B, Sq, H, hd) in q's type."""
    B, S, H, hd = q.shape
    sc = _scale(scale, hd)
    kw = dict(causal=causal, window=window, valid_len=valid_len, bias=bias)
    _, ds, _ = _grad_terms(q, k, v, do, lse, delta, sc, kw)
    dq = sc * torch.einsum("bkgst,btkh->bskgh", _as(ds, k), _up(k))
    return dq.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, *, causal=True, window=None,
                            valid_len=None, scale=None, bias=None):
    """Per-q-head (dk_h, dv_h), each (B, Sk, H, hd) f32: dK = scale·dSᵀQ,
    dV = PᵀdO before the GQA group-sum."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    sc = _scale(scale, hd)
    kw = dict(causal=causal, window=window, valid_len=valid_len, bias=bias)
    p, ds, dog = _grad_terms(q, k, v, do, lse, delta, sc, kw)
    qg = _up(q).reshape(B, S, KV, H // KV, hd)
    dk = sc * torch.einsum("bkgst,bskgh->btkgh", _as(ds, q), qg)
    dv = torch.einsum("bkgst,bskgh->btkgh", _as(p, do), dog)
    return dk.reshape(B, T, H, hd), dv.reshape(B, T, H, hd)


def flash_attention_jvp_ref(q, k, v, qt, kt, vt, lse, *, causal=True, window=None,
                            valid_len=None, scale=None, bias=None):
    """The tangent pass: (g (B, Sq, H, hd) f32, t (B, H, Sq) f32) with
    Ṡ = scale·(Q̇Kᵀ + QK̇ᵀ), g = Σ_k P(Ṡ v + v̇), t = Σ_k P∘Ṡ; the caller
    forms ȯ = g − t∘o."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    sc = _scale(scale, hd)
    p = _ref_p(q, k, lse, sc, causal=causal, window=window, valid_len=valid_len,
               bias=bias)
    qg = _up(q).reshape(B, S, KV, G, hd)
    qtg = _up(qt).reshape(B, S, KV, G, hd)
    st = sc * (torch.einsum("bskgh,btkh->bkgst", qtg, _up(k))
               + torch.einsum("bskgh,btkh->bkgst", qg, _up(kt)))
    r = p * st
    g = (torch.einsum("bkgst,btkh->bskgh", _as(r, v), _up(v))
         + torch.einsum("bkgst,btkh->bskgh", _as(p, vt), _up(vt)))
    t = r.sum(dim=-1)
    return g.reshape(B, S, H, hd), t.reshape(B, H, S)


# -------------------------------------------------------------- decode --
def flash_decode_ref(q, k, v, bias, *, scale=None, return_stats=False):
    """Dense decode: q (B, H, hd), k/v (B, W, KV, hd), bias (B|1, W) additive
    row (0 attendable, NEG_INF masked) → o (B, H, hd) in q's type; with
    ``return_stats``, (o, m, l) with the row max m and the softmax mass l,
    (B, H). One dense softmax, the weights rounded to v's type before the
    product with V, as the reference's oracle; a row with no live key gives
    o = 0, m = NEG_INF, l = 0, as the kernels' guard does (the reference's
    oracle averages V there)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qg = _up(q).reshape(B, KV, H // KV, hd)
    logits = (torch.einsum("bkgh,btkh->bkgt", qg, _up(k)) * _scale(scale, hd)
              + _up(bias)[:, None, None, :])
    m = logits.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe[..., None])
    l = p.sum(dim=-1)
    w = p / torch.where(l <= 0.0, torch.ones_like(l), l)[..., None]
    out = torch.einsum("bkgt,btkh->bkgh", _up(w.to(v.dtype)), _up(v))
    out = out.reshape(B, H, hd).to(q.dtype)
    if not return_stats:
        return out
    m = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), m)
    return out, m.reshape(B, H), l.reshape(B, H)


def flash_decode_split_ref(q, k, v, bias, *, scale=None, blk_k=128, n_splits=8,
                           return_stats=False):
    """Dense decode split as the kernel and the reference split it
    (``flash_decode.split_layout``): each split's partial (o, m, l) from
    ``flash_decode_ref`` on that split's keys, o rounded to q's type, then
    the partials merged in split order with ``combine_splits`` (in f32, in
    float64 from float64 inputs) and o cast to q's type. Returns as
    ``flash_decode_ref``. The tests and ``chip_smoke.py`` hold the one-launch
    dense kernel against it."""
    B = q.shape[0]
    W = k.shape[1]
    ns, span = split_layout(W, blk_k, n_splits)
    bias = bias.expand(B, W)
    parts = [flash_decode_ref(q, k[:, s:s + span], v[:, s:s + span], bias[:, s:s + span],
                              scale=scale, return_stats=True)
             for s in range(0, ns * span, span)]
    return _merge_in_order(parts, q, k.shape[2], return_stats)


def flash_decode_paged_split_ref(q, k_pool, v_pool, page_table, bias, *, scale=None,
                                 return_stats=False):
    """Paged decode split as the reference splits it, one page per split:
    each page's partial (o, m, l) from ``flash_decode_ref`` on that page's
    keys (-1 reads page 0, masked by the bias), o rounded to q's type, then
    the partials merged in page order with ``combine_splits`` (in f32, in
    float64 from float64 inputs) and o cast to q's type. Returns as
    ``flash_decode_ref``. The tests and ``chip_smoke.py`` hold the one-launch
    paged kernel against it."""
    ps = k_pool.shape[1]
    pages = page_table.clamp_min(0).long()
    parts = [flash_decode_ref(q, k_pool[pages[:, j]], v_pool[pages[:, j]],
                              bias[:, j * ps:(j + 1) * ps], scale=scale, return_stats=True)
             for j in range(page_table.shape[1])]
    return _merge_in_order(parts, q, k_pool.shape[2], return_stats)


def _merge_in_order(parts, q, KV, return_stats):
    """Per-split (o, m, l) partials of ``flash_decode_ref``, in split order,
    merged with ``combine_splits``; o cast to q's type."""
    B, H = q.shape[:2]
    o, m, l = (torch.stack([_up(p[i]).reshape(B, KV, H // KV, *p[i].shape[2:]) for p in parts],
                           dim=2) for i in range(3))
    og, mg, lg = combine_splits(o, m, l)
    og = og.to(q.dtype)
    return (og, mg, lg) if return_stats else og


def flash_decode_paged_ref(q, k_pool, v_pool, page_table, bias, *, scale=None,
                           return_stats=False):
    """Paged decode: gather each sequence's pages into a dense copy (-1
    reads page 0, masked by the bias), then ``flash_decode_ref``."""
    B = q.shape[0]
    pages = page_table.clamp_min(0).long()
    k = k_pool[pages].reshape(B, -1, *k_pool.shape[2:])
    v = v_pool[pages].reshape(B, -1, *v_pool.shape[2:])
    return flash_decode_ref(q, k, v, bias, scale=scale, return_stats=return_stats)


# ----------------------------------------------------------------- SSD --
def ssd_intra_ref(u, log_a, Bv, Cv):
    """The SSD (Mamba2) intra-chunk step of each (batch, chunk, head), B and C
    shared across heads: u (B, nc, H, Q, P), log_a (B, nc, H, Q), Bv and Cv
    (B, nc, Q, N) → (y (B, nc, H, Q, P), S (B, nc, H, N, P), g (B, nc, H),
    l (B, nc, H, Q)) with l = cumsum(log_a), y = ((C·Bᵀ) ∘ exp(lᵢ − lⱼ) ∘
    causal)·u, S = Bᵀ(u ∘ exp(l_Q − l)) and g = exp(l_Q). Computed in f32
    from the inputs as given (B and C widened), in float64 from float64 u.
    The cumsum is summed in float64 and rounded once, as the kernel sums
    it, so both give l the same bits (a sum in f32 differs by ~1e-5 at
    l ≈ −100 and so does g)."""
    wide = torch.float64 if u.dtype == torch.float64 else torch.float32
    u, Bf, Cf = u.to(wide), Bv.to(wide), Cv.to(wide)
    l = torch.cumsum(log_a.double(), dim=-1).to(wide)
    Q = u.shape[3]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    decay = torch.where(causal, torch.exp(l[..., :, None] - l[..., None, :]), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    y = torch.einsum("bchij,bchjp->bchip", scores[:, :, None] * decay, u)
    s_dec = torch.exp(l[..., -1:] - l)
    S = torch.einsum("bcjn,bchjp->bchnp", Bf, u * s_dec[..., None])
    return y, S, torch.exp(l[..., -1]), l
