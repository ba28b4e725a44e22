"""Split-K flash decode, the serving hot path (twin of
``repro/kernels/flash_decode.py``).

Decoding attends one query row per sequence against a long KV window, so
the work is split along the keys: each split runs an online softmax over its
keys and emits a partial (o, m, l), o normalised within the split, m its row
max, l its softmax mass, and ``combine_splits`` merges the partials with
logsumexp algebra. The merge is associative, so the same (o, m, l) contract
(``return_stats``) merges across shards too.

The mask is an additive f32 bias row per sequence, built by ``decode_bias``
(rolling-cache slot positions, per-sequence t, sliding window) or
``paged_bias`` (sequence lengths, unmapped pages): the one definition of the
decode mask, shared by the kernels, their plain versions in
``kernels.ref`` and the ``_sdpa`` route of ``models.attention``.

``flash_decode`` and ``flash_decode_paged`` launch the CUDA kernels of
``csrc/flash_decode.cu`` (built into the port's one extension,
``cg_fused.extension``), each one launch that returns the merged (o, m, l):
the kernel merges its partials with ``combine_splits``' algebra in one
thread-block cluster per sequence and kv head. The dense wrapper keeps the
reference's split layout (key blocks of ``min(blk_k, max(W, 8))``, the
largest divisor of the block count that is at most ``n_splits``; at most
``MAX_SPLITS`` splits). The paged one takes one page per split, as the
reference does; the cluster's blocks take runs of pages and fold them in
page order. Each partial o is rounded to q's dtype before the merge, as the
reference stores it. ``combine_splits`` itself is kept for the plain
versions (``ref.flash_decode_split_ref``, ``ref.flash_decode_paged_split_ref``)
and the cross-shard merge. Every wrapper checks device, dtype, shape, head
dim, group size, page size, split count and contiguity and raises on
anything else; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from .cg_fused import extension
from .flash_attention import check_head_dim

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 32        # most query heads per kv head (csrc: 4 warps x 8 rows)
MAX_PAGE_SIZE = 128   # page sizes: multiples of 8 up to this
MAX_SPLITS = 8        # splits the dense kernel merges (csrc: the portable cluster size)


# ------------------------------------------------------------ mask -> bias --
def decode_bias(pos, t, *, window=None):
    """Additive f32 bias row(s) for rolling-slot decode attention.

    ``pos``: (W,) or (B, W) absolute position held in each cache slot (-1
    empty); ``t``: scalar or (B,) current decode position. A slot is
    attendable iff 0 <= pos <= t and, with a window, pos > t - window.
    Returns (B, W), or (1, W) for a shared position row and scalar t, with
    0.0 where attendable and NEG_INF elsewhere."""
    pos = torch.as_tensor(pos)
    if pos.ndim == 1:
        pos = pos[None]
    # a scalar t stays a Python number: a tensor made from it on the card
    # would cost a host-to-device copy (and a wait) per call
    if isinstance(t, torch.Tensor):
        tb = t[:, None] if t.ndim == 1 else t.reshape(1, 1)
    else:
        tb = int(t)
    valid = (pos >= 0) & (pos <= tb)
    if window is not None:
        valid = valid & (pos > tb - window)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def paged_bias(page_table, seq_len, page_size, *, window=None):
    """Additive f32 bias for paged decode attention, (B, max_pages *
    page_size). Logical token i of sequence b lives at slot i % page_size of
    logical page i // page_size; the query attends positions < seq_len[b]
    (and, with a window, > seq_len[b] - 1 - window) on mapped pages."""
    B, maxp = page_table.shape
    pos = torch.arange(maxp * page_size, dtype=torch.int32, device=page_table.device)[None]
    sl = seq_len[:, None]
    valid = pos < sl
    if window is not None:
        valid = valid & (pos > sl - 1 - window)
    mapped = (page_table >= 0)[:, :, None].expand(B, maxp, page_size).reshape(B, -1)
    return torch.where(valid & mapped, 0.0, NEG_INF).to(torch.float32)


# ------------------------------------------------------------ split combine --
def combine_splits(o, m, l):
    """Merge per-split partials: o (B, KV, S, G, hd) f32 normalised within
    each split, m and l (B, KV, S, G). Returns (o (B, H, hd), m (B, H),
    l (B, H)) with H = KV * G (head h = kv * G + g), global stats that merge
    again with the same algebra. Fully masked splits carry (m, l) =
    (NEG_INF, 0) and add nothing."""
    B, KV, S, G, hd = o.shape
    m_glob = m.amax(dim=2)
    m_safe = torch.where(m_glob <= NEG_INF / 2, 0.0, m_glob)
    w = l * torch.exp(m - m_safe[:, :, None])
    l_glob = w.sum(dim=2)
    o_glob = (o * w[..., None]).sum(dim=2) / l_glob.clamp_min(1e-20)[..., None]
    return (o_glob.reshape(B, KV * G, hd),
            torch.where(m_glob <= NEG_INF / 2, NEG_INF, m_glob).reshape(B, KV * G),
            l_glob.reshape(B, KV * G))


def _pick_splits(n_blocks, n_splits):
    """Largest divisor of n_blocks that is <= n_splits."""
    s = max(1, min(n_splits, n_blocks))
    while n_blocks % s:
        s -= 1
    return s


def split_layout(W, blk_k=128, n_splits=8):
    """(splits, keys per split) of the dense decode over W keys: the
    reference's key blocks of min(blk_k, max(W, 8)), grouped into the
    largest divisor of their count that is <= n_splits."""
    if blk_k < 1 or n_splits < 1:
        raise ValueError(f"blk_k {blk_k} and n_splits {n_splits} must be positive")
    blk_k = min(blk_k, max(W, 8))
    n_blocks = -(-W // blk_k)
    ns = _pick_splits(n_blocks, n_splits)
    return ns, (n_blocks // ns) * blk_k


# ----------------------------------------------------------------- checks --
def _check_aligned(t, name):
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_q_kv(q, k, v):
    for t, name, nd in ((q, "q", 3), (k, "k", 4), (v, "v", 4)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.ndim != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    B, H, hd = q.shape
    check_head_dim(hd)
    if k.shape != v.shape or k.shape[3] != hd or min(B, H, k.shape[1], k.shape[2]) == 0:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    KV = k.shape[2]
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{H} heads over {KV} kv heads: need a group of at most "
                         f"{MAX_GROUP} query heads per kv head")
    for t, name in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must have q's dtype and device")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_aligned(t, name)


def _check_bias(bias, rows, W, q):
    if (not isinstance(bias, torch.Tensor) or bias.ndim != 2 or bias.shape[0] not in rows
            or bias.shape[1] != W):
        raise ValueError(f"bias must be ({'|'.join(map(str, rows))}, {W}), got "
                         f"{tuple(getattr(bias, 'shape', ()))}")
    if bias.dtype != torch.float32 or bias.device != q.device:
        raise TypeError("bias must be float32 on q's device")
    _check_aligned(bias, "bias")


def _scale(scale, hd):
    return float(scale if scale is not None else 1.0 / hd ** 0.5)


# ----------------------------------------------------------------- wrappers --
def flash_decode(q, k, v, bias, *, scale=None, blk_k=128, n_splits=8, return_stats=False):
    """Dense split-K decode, one launch. q (B, H, hd), k/v (B, W, KV, hd)
    rolling cache, bias (B|1, W) f32 (``decode_bias``). Returns o (B, H, hd)
    in q's dtype, or (o, m, l) with (B, H) f32 global stats under
    ``return_stats``."""
    _check_q_kv(q, k, v)
    B, _, hd = q.shape
    W = k.shape[1]
    if k.shape[0] != B:
        raise ValueError(f"k/v batch {k.shape[0]} is not q's {B}")
    _check_bias(bias, (1, B), W, q)
    ns, span = split_layout(W, blk_k, n_splits)
    if ns > MAX_SPLITS:
        raise ValueError(f"{ns} splits: the dense kernel merges at most {MAX_SPLITS}")
    o, m, l = extension().flash_decode(q, k, v, bias, ns, span, _scale(scale, hd))
    return (o, m, l) if return_stats else o


def flash_decode_paged(q, k_pool, v_pool, page_table, bias, *, scale=None,
                       return_stats=False):
    """Paged split-K decode, one page per split, one launch. q (B, H, hd),
    k_pool/v_pool (P, page_size, KV, hd) the shared pool, page_table
    (B, max_pages) int32 physical page per logical page (-1 unmapped, read
    as page 0 and masked by the bias alone), bias (B, max_pages *
    page_size) f32 (``paged_bias``). Returns as ``flash_decode``."""
    _check_q_kv(q, k_pool, v_pool)
    B, _, hd = q.shape
    ps = k_pool.shape[1]
    if ps % 8 or ps > MAX_PAGE_SIZE:
        raise ValueError(f"page size {ps} must be a multiple of 8 up to {MAX_PAGE_SIZE}")
    if (not isinstance(page_table, torch.Tensor) or page_table.ndim != 2
            or page_table.shape[0] != B or page_table.shape[1] == 0):
        raise ValueError(f"page_table must be ({B}, max_pages)")
    if page_table.dtype != torch.int32 or page_table.device != q.device:
        raise TypeError("page_table must be int32 on q's device")
    _check_aligned(page_table, "page_table")
    _check_bias(bias, (B,), page_table.shape[1] * ps, q)
    o, m, l = extension().flash_decode_paged(q, k_pool, v_pool, page_table, bias,
                                             _scale(scale, hd))
    return (o, m, l) if return_stats else o
