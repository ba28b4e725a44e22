"""Sequence-sharded decode attention (twin of
``repro/models/decode_sharded.py``).

The KV cache's W slots are split over the processes of a mesh: each rank
holds W/N of them and runs the split-K decode kernel
(``kernels.ops.flash_decode(..., return_stats=True)``) over its own slots,
and the per-rank partials (o, m, l) merge with the logsumexp combine the
kernel uses between its own splits: one all-reduce MAX of the (B, H) maxima
and two all-reduce SUMs, of the (B, H) softmax masses and of the (B, H, hd)
weighted outputs, instead of moving the cache. A rank whose slots are all
masked gives (0, NEG_INF, 0) and adds nothing.
"""
from __future__ import annotations

import torch

from ..core.collectives import preduce
from ..kernels import ops
from .attention import NEG_INF, KVCache, _qkv_rope
from .layers import dense


def combine_shard_stats(o, m, l, mesh):
    """Merge per-rank decode partials over ``mesh``: o (B, H, hd) the rank's
    normalized output, m/l (B, H) its running max and softmax mass. Returns
    the merged (B, H, hd) f32 output."""
    m_glob = preduce(m, mesh, "decode_max", op="max")
    m_safe = torch.where(m_glob <= NEG_INF / 2, 0.0, m_glob)
    w = l * torch.exp(m - m_safe)                     # 0 where the rank is masked
    l_glob = preduce(w, mesh, "decode_sum", op="sum")
    o_glob = preduce(o.float() * w[..., None], mesh, "decode_sum", op="sum")
    return o_glob / torch.clamp_min(l_glob, 1e-20)[..., None]


def sharded_decode_attend(p, x, t, cache: KVCache, cfg, mesh):
    """One-token decode with the cache's W slots sharded over the N ranks of
    ``mesh`` (``make_data_mesh("model")``). x (B, 1, d); t: the absolute
    position of this token (an int); ``cache``: this rank's shard, k/v (B,
    W/N, KV, hd) and pos (W/N,), the slots [rank·W/N, (rank+1)·W/N) of the
    rolling cache of W slots.

    The rank that holds slot t % W writes the new (k, v) into it (in place,
    as ``attention.decode_attend``); every rank attends its own slots
    through the decode kernel, and the partials merge across the mesh.
    Returns (y (B, 1, d), the rank's cache)."""
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    B = x.shape[0]
    t = int(t)
    Wl = cache.k.shape[1]
    W = Wl * mesh.size
    pos_t = torch.full((1,), t, dtype=torch.int32, device=x.device)
    q, k, v = _qkv_rope(p, x, pos_t, cfg)
    slot = t % W - mesh.rank * Wl
    if 0 <= slot < Wl:
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        cache.pos[slot:slot + 1].fill_(t)
    bias = ops.decode_bias(cache.pos, t, window=cfg.sliding_window)
    o, m, l = ops.flash_decode(q[:, 0].contiguous(), cache.k, cache.v, bias,
                               return_stats=True)
    out = combine_shard_stats(o, m, l, mesh)
    return dense(p["wo"], out.reshape(B, 1, H * hd).to(q.dtype)), cache
