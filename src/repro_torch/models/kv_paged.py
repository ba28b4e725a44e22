"""Paged KV cache: a shared page pool and per-slot page tables (twin of
``repro/models/kv_paged.py``).

* ``k_pool`` / ``v_pool``: (L, P, page_size, KV, hd), P physical pages per
  layer. Page 0 is the reserved null page: writes of inactive or unmapped
  positions land there and every read of it is masked by the bias.
* ``page_table``: (B, max_pages) int32; logical page j of slot b lives in
  physical page ``page_table[b, j]`` (-1 unmapped). Logical token i sits at
  slot i % page_size of logical page i // page_size. Every layer shares it.
* ``seq_len``: (B,) int32 tokens written per slot.
* ``free_pages`` / ``n_free``: a stack of free page ids (``free_pages[:n_free]``).

The bookkeeping (``alloc_prefill``, ``alloc_decode_page``,
``advance_and_free``, ``release_slots``) returns new tables and stacks and
hands out the same physical pages in the same order as the reference's
scans: the k-th page popped is ``stack[n - k]`` and the k-th page pushed
lands at ``n + k - 1``, written here as a ``cumsum`` over the mask, so no
step reads a value back to the host. The pool writes (``_write_positions``,
``write_prefill_kv``, ``paged_decode_attend``) update the pools **in place**
and return them, as the reference's donated buffers let XLA do.

Allocation invariant: every physical page > 0 is either on the free stack
or mapped by exactly one (slot, logical page); ``check_invariants`` asserts
it on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import resolve_device
from .attention import NEG_INF, _qkv_rope
from .layers import dense

__all__ = [
    "PagedKVCache", "init_paged_cache", "alloc_prefill", "alloc_decode_page",
    "advance_and_free", "release_slots", "write_prefill_kv",
    "paged_decode_attend", "pages_needed", "check_invariants",
]


class PagedKVCache(NamedTuple):
    k_pool: torch.Tensor      # (L, P, ps, KV, hd)
    v_pool: torch.Tensor      # (L, P, ps, KV, hd)
    page_table: torch.Tensor  # (B, max_pages) int32, -1 = unmapped
    seq_len: torch.Tensor     # (B,) int32 tokens written per slot
    free_pages: torch.Tensor  # (P,) int32 stack, [:n_free] free
    n_free: torch.Tensor      # () int32

    @property
    def page_size(self):
        return self.k_pool.shape[2]

    @property
    def max_pages(self):
        return self.page_table.shape[1]


def init_paged_cache(cfg, n_layers, batch, max_len, n_pages, dtype, page_size: int = 128,
                     *, device="cuda") -> PagedKVCache:
    """Pool of ``n_pages`` pages (page 0 the null page), empty tables for
    ``batch`` slots of ``max_len`` logical tokens, on ``device``."""
    dev = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    maxp = -(-max_len // page_size)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKVCache(
        k_pool=torch.zeros((n_layers, n_pages, page_size, KV, hd), dtype=dtype, device=dev),
        v_pool=torch.zeros((n_layers, n_pages, page_size, KV, hd), dtype=dtype, device=dev),
        page_table=torch.full((batch, maxp), -1, **i32),
        seq_len=torch.zeros((batch,), **i32),
        # ids 1..P-1 (0 is the null page); capacity P so a push never
        # overwrites a live id
        free_pages=torch.cat([torch.arange(1, n_pages, **i32), torch.zeros((1,), **i32)]),
        n_free=torch.tensor(n_pages - 1, **i32),
    )


def pages_needed(length: int, page_size: int, window: Optional[int]) -> int:
    """Pages a prefill of ``length`` maps (only those overlapping the live
    range [length - window, length) under a sliding window)."""
    hi = -(-length // page_size)
    lo = max(0, length - window) // page_size if window else 0
    return hi - lo


def _pop(stack, n, take):
    """One page per True of the flat mask ``take``, in order: the k-th is
    stack[max(n - k, 0)]. Returns (n, page ids; -1 where take is False)."""
    c = torch.cumsum(take.to(torch.int32), 0)
    pids = torch.where(take, stack[(n - c).clamp_min(0).long()], -1)
    return n - c[-1], pids


def _push(stack, n, do, pids):
    """Push ``pids`` where ``do``, in order: the k-th lands at n + k - 1.
    The other entries rewrite the top slot P - 1 with its own value (no push
    reaches it while the invariant holds), as the reference's scan does."""
    top = stack.shape[0] - 1
    c = torch.cumsum(do.to(torch.int32), 0)
    idx = torch.where(do, n + c - 1, top).long()
    stack = stack.clone()
    stack[idx] = torch.where(do, pids, stack[top])
    return stack, n + c[-1]


def alloc_prefill(cache: PagedKVCache, lengths, admit,
                  window: Optional[int] = None) -> PagedKVCache:
    """Map pages for a prefill of ``lengths`` tokens in the admitted slots
    (``admit`` (B,) bool), popping them from the free stack; other rows are
    untouched. Under a window only pages overlapping [lengths - window,
    lengths) are mapped. Admitted rows must be released first; the caller
    checks capacity (``n_free`` against ``pages_needed``)."""
    B, maxp = cache.page_table.shape
    ps = cache.page_size
    dev = cache.page_table.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    admit = torch.as_tensor(admit, dtype=torch.bool, device=dev)
    j = torch.arange(maxp, dtype=torch.int32, device=dev)[None]
    need = (j * ps < lengths[:, None]) & admit[:, None]
    if window is not None:
        need = need & ((j + 1) * ps > (lengths - window).clamp_min(0)[:, None])
    n, pids = _pop(cache.free_pages, cache.n_free, need.reshape(-1))
    return cache._replace(page_table=torch.where(need, pids.reshape(B, maxp), cache.page_table),
                          seq_len=torch.where(admit, lengths, cache.seq_len), n_free=n)


def alloc_decode_page(cache: PagedKVCache, active) -> PagedKVCache:
    """Map the page that holds position ``seq_len`` for every active slot
    that crossed a page boundary (at most one pop per slot)."""
    B, maxp = cache.page_table.shape
    ps = cache.page_size
    ar = torch.arange(B, device=active.device)
    jnew = torch.div(cache.seq_len, ps, rounding_mode="floor")
    jc = jnew.clamp_max(maxp - 1).long()
    cur = cache.page_table[ar, jc]
    need = active & (torch.remainder(cache.seq_len, ps) == 0) & (jnew < maxp) & (cur < 0)
    n, pids = _pop(cache.free_pages, cache.n_free, need)
    tbl = cache.page_table.clone()
    tbl[ar, jc] = torch.where(need, pids, cur)
    return cache._replace(page_table=tbl, n_free=n)


def advance_and_free(cache: PagedKVCache, active, window: Optional[int]) -> PagedKVCache:
    """seq_len += active; under a window, free the (at most one) page per
    slot that just rolled wholly out of [seq_len - window, seq_len)."""
    sl = cache.seq_len + active.to(torch.int32)
    cache = cache._replace(seq_len=sl)
    if window is None:
        return cache
    B, maxp = cache.page_table.shape
    ps = cache.page_size
    ar = torch.arange(B, device=active.device)
    fl = sl - window                                           # first live position
    can = active & (fl > 0) & (torch.remainder(fl, ps) == 0)
    jdead = (torch.div(fl, ps, rounding_mode="floor") - 1).clamp(0, maxp - 1).long()
    pid = cache.page_table[ar, jdead]
    do = can & (pid >= 0)
    stack, n = _push(cache.free_pages, cache.n_free, do, pid)
    tbl = cache.page_table.clone()
    tbl[ar, jdead] = torch.where(do, -1, pid)
    return cache._replace(page_table=tbl, free_pages=stack, n_free=n)


def release_slots(cache: PagedKVCache, mask) -> PagedKVCache:
    """Return every page of the masked slots to the free stack and clear
    their rows (retire finished sequences, make room for admission)."""
    rel = mask[:, None] & (cache.page_table >= 0)
    stack, n = _push(cache.free_pages, cache.n_free, rel.reshape(-1),
                     cache.page_table.reshape(-1))
    return cache._replace(page_table=torch.where(mask[:, None], -1, cache.page_table),
                          seq_len=torch.where(mask, 0, cache.seq_len),
                          free_pages=stack, n_free=n)


# ------------------------------------------------------------- pool writes --
def _write_positions(k_pool_l, v_pool_l, page_table, pos, k, v, valid):
    """Scatter rows k/v (B, T, KV, hd) at logical positions pos (B, T) into
    one layer's pools, in place. Invalid writes, and writes to unmapped
    pages, land on the null page 0 (always masked when read)."""
    B, T = pos.shape
    ps = k_pool_l.shape[1]
    jp = torch.div(pos, ps, rounding_mode="floor").clamp(0, page_table.shape[1] - 1).long()
    page = page_table[torch.arange(B, device=pos.device)[:, None], jp]
    page = torch.where(valid, page, 0).clamp_min(0).reshape(-1).long()
    slot = torch.remainder(pos, ps).reshape(-1).long()
    k_pool_l[page, slot] = k.reshape(B * T, *k.shape[2:])
    v_pool_l[page, slot] = v.reshape(B * T, *v.shape[2:])
    return k_pool_l, v_pool_l


def write_prefill_kv(k_pool_l, v_pool_l, page_table, k, v, lengths):
    """Prefill one layer: write k/v (B, S, KV, hd) for logical positions
    [0, lengths[b]) into the pages, in place (positions past a length, or
    below a freed window page, fall through to the null page)."""
    B, S = k.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=k.device)[None].expand(B, S)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=k.device)
    return _write_positions(k_pool_l, v_pool_l, page_table, pos, k, v, pos < lengths[:, None])


# ----------------------------------------------------------------- attend ---
def paged_decode_attend(p, x, cache_kv, page_table, seq_len, cfg, *, active=None):
    """One-token decode of one layer against the paged pool.

    x (B, 1, d); ``cache_kv`` this layer's (k_pool_l, v_pool_l), each
    (P, ps, KV, hd); ``seq_len`` (B,) the position being written (its page
    must be mapped: ``alloc_decode_page``). Returns (y, (k_pool_l,
    v_pool_l)), the pools written in place. Under
    ``cfg.use_flash_attention`` the attend runs the paged flash-decode
    kernel; otherwise the plain gather-and-softmax version."""
    from ..kernels import ops, ref

    k_pool_l, v_pool_l = cache_kv
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    B = x.shape[0]
    ps = k_pool_l.shape[1]
    pos_bt = seq_len[:, None].to(torch.int32)
    q, k, v = _qkv_rope(p, x, pos_bt, cfg)
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=x.device)
    _write_positions(k_pool_l, v_pool_l, page_table, pos_bt, k, v, active[:, None])
    sl_now = seq_len + active.to(torch.int32)                  # incl. this token
    bias = ops.paged_bias(page_table, sl_now, ps, window=cfg.sliding_window)
    bias = torch.where(active[:, None], bias, NEG_INF)
    attend = ops.flash_decode_paged if cfg.use_flash_attention else ref.flash_decode_paged_ref
    out = attend(q[:, 0].contiguous(), k_pool_l, v_pool_l, page_table, bias)
    return dense(p["wo"], out.reshape(B, 1, H * hd)), (k_pool_l, v_pool_l)


# ------------------------------------------------------------- diagnostics --
def check_invariants(cache: PagedKVCache):
    """On the host: every page > 0 is free xor mapped exactly once."""
    tbl = cache.page_table.cpu().numpy()
    free = cache.free_pages[: int(cache.n_free)].cpu().numpy()
    P = cache.k_pool.shape[1]
    mapped = set(tbl[tbl >= 0].tolist())
    free_s = set(free.tolist())
    assert 0 not in mapped, "null page mapped"
    assert len(mapped) == int((tbl >= 0).sum()), "page double-mapped"
    assert len(free_s) == len(free), "free stack duplicate"
    assert not mapped & free_s, "page both mapped and free"
    leaked = set(range(1, P)) - mapped - free_s
    assert not leaked, f"leaked pages {leaked}"
