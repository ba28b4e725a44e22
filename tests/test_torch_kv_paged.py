"""The port's paged KV cache against ``repro.models.kv_paged``.

* A scripted run of ``alloc_prefill`` / ``alloc_decode_page`` /
  ``advance_and_free`` / ``release_slots`` (with and without a window, slot
  reuse, staggered activity) gives **identical** page tables, ``seq_len``,
  ``free_pages[:n_free]`` and ``n_free`` to the reference's after every
  operation: the pops and pushes hand out the same physical pages in the
  same order.
* ``check_invariants`` holds throughout and catches a double-mapped, a
  leaked and a mapped null page; pool exhaustion is accounted as the
  reference accounts it.
* ``paged_decode_attend`` (flash route and plain) equals the reference's
  within 1e-5 and the dense rolling-cache decode of each sequence within
  2e-5 (the twin of ``tests/test_kv_paged.py``), and its pool writes equal
  the reference's on every page but the null page (whose contents are
  garbage by design).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import kv_paged as jkvp  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.interop import (paged_cache_from_numpy, paged_cache_to_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import kv_paged as kvp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _cfgs(**kw):
    base = dict(arch_id="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64, use_flash_attention=True)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _same_books(c, jc):
    """Tables, lengths and the live part of the free stack, exactly."""
    np.testing.assert_array_equal(c.page_table.numpy(), np.asarray(jc.page_table))
    np.testing.assert_array_equal(c.seq_len.numpy(), np.asarray(jc.seq_len))
    n = int(jc.n_free)
    assert int(c.n_free) == n
    assert c.page_table.dtype == c.seq_len.dtype == c.free_pages.dtype == torch.int32
    np.testing.assert_array_equal(c.free_pages[:max(n, 0)].numpy(),
                                  np.asarray(jc.free_pages[:max(n, 0)]))


def _both(c, jc, fn, jfn, *args):
    """Apply one operation to both caches; its mask/length arguments are
    numpy arrays handed to each side."""
    c = fn(c, *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    jc = jfn(jc, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    _same_books(c, jc)
    kvp.check_invariants(c)
    return c, jc


@pytest.mark.parametrize("window", [None, 12])
def test_scripted_bookkeeping_matches_reference(window):
    jcfg, cfg = _cfgs(sliding_window=window)
    B, ps, P, max_len = 3, 8, 24, 64
    c = kvp.init_paged_cache(cfg, 1, B, max_len, P, torch.float32, page_size=ps, device="cpu")
    jc = jkvp.init_paged_cache(jcfg, 1, B, max_len, P, jnp.float32, page_size=ps)
    _same_books(c, jc)
    ones = np.ones((B,), bool)
    c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill,
                  np.array([20, 5, 1], np.int32), ones, window)
    rng = np.random.default_rng(0)
    for step in range(30):
        active = rng.random(B) < 0.8
        c, jc = _both(c, jc, kvp.alloc_decode_page, jkvp.alloc_decode_page, active)
        c, jc = _both(c, jc, kvp.advance_and_free, jkvp.advance_and_free, active, window)
        if step in (9, 21):
            # retire one slot and admit a new prompt into it
            b = step % B
            mask = np.arange(B) == b
            c, jc = _both(c, jc, kvp.release_slots, jkvp.release_slots, mask)
            c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill,
                          np.where(mask, 13 + step, 0).astype(np.int32), mask, window)
    c, jc = _both(c, jc, kvp.release_slots, jkvp.release_slots, ones)
    assert int(c.n_free) == P - 1


def test_interop_carries_the_reference_cache():
    jcfg, _ = _cfgs()
    jc = jkvp.init_paged_cache(jcfg, 2, 3, 64, 16, jnp.float32, page_size=8)
    jc = jkvp.alloc_prefill(jc, jnp.array([17, 9, 30]), jnp.ones((3,), bool))
    c = paged_cache_from_numpy([np.asarray(x) for x in jc], "cpu")
    assert isinstance(c, kvp.PagedKVCache) and c.page_table.dtype == torch.int32
    _same_books(c, jc)
    back = paged_cache_to_numpy(c)
    for got, want in zip(back, jc):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_check_invariants_catches_corruption():
    _, cfg = _cfgs()
    c = kvp.init_paged_cache(cfg, 1, 2, 32, 8, torch.float32, page_size=8, device="cpu")
    c = kvp.alloc_prefill(c, torch.tensor([16, 8]), torch.ones(2, dtype=torch.bool))
    kvp.check_invariants(c)
    tbl = c.page_table.clone()
    tbl[1, 1] = tbl[0, 0]
    with pytest.raises(AssertionError, match="double-mapped|both mapped and free"):
        kvp.check_invariants(c._replace(page_table=tbl))
    tbl = c.page_table.clone()
    tbl[0, 1] = -1
    with pytest.raises(AssertionError, match="leaked"):
        kvp.check_invariants(c._replace(page_table=tbl))
    tbl = c.page_table.clone()
    tbl[1, 2] = 0
    with pytest.raises(AssertionError, match="null page"):
        kvp.check_invariants(c._replace(page_table=tbl))


def test_pool_exhaustion_accounting():
    """Popping exactly the free count leaves n_free == 0 and every page
    mapped once; popping past it is accounted as the reference does."""
    jcfg, cfg = _cfgs()
    P, ps = 9, 8                                      # 8 allocatable pages
    c = kvp.init_paged_cache(cfg, 1, 2, 64, P, torch.float32, page_size=ps, device="cpu")
    jc = jkvp.init_paged_cache(jcfg, 1, 2, 64, P, jnp.float32, page_size=ps)
    c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill,
                  np.array([32, 32], np.int32), np.ones((2,), bool))
    assert int(c.n_free) == 0
    assert (c.page_table[:, :4] >= 0).all() and (c.page_table[:, 4:] == -1).all()
    # a fifth page each with the pool empty: no guard (the caller's
    # backpressure prevents it); the pops run n_free below zero and hand out
    # the bottom of the stack, the same in both
    c2 = kvp.alloc_decode_page(c, torch.ones(2, dtype=torch.bool))
    jc2 = jkvp.alloc_decode_page(jc, jnp.ones((2,), bool))
    np.testing.assert_array_equal(c2.page_table.numpy(), np.asarray(jc2.page_table))
    assert int(c2.n_free) == int(jc2.n_free) == -2


def test_windowed_prefill_maps_only_live_pages():
    jcfg, cfg = _cfgs(sliding_window=12)
    c = kvp.init_paged_cache(cfg, 1, 2, 64, 32, torch.float32, page_size=8, device="cpu")
    jc = jkvp.init_paged_cache(jcfg, 1, 2, 64, 32, jnp.float32, page_size=8)
    c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill,
                  np.array([40, 6], np.int32), np.ones((2,), bool), 12)
    tbl = c.page_table
    assert (tbl[0, :3] == -1).all() and (tbl[0, 3:5] >= 0).all()
    assert kvp.pages_needed(40, 8, 12) == jkvp.pages_needed(40, 8, 12) == 2
    assert tbl[1, 0] >= 0 and (tbl[1, 1:] == -1).all()


def _attn_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = jcfg.d_model, jcfg.resolved_head_dim
    shapes = {"wk": (d, jcfg.n_kv_heads * hd), "wo": (jcfg.n_heads * hd, d),
              "wq": (d, jcfg.n_heads * hd), "wv": (d, jcfg.n_kv_heads * hd)}
    p = {k: {"w": (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)}
         for k, s in shapes.items()}
    return {k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}, params_from_numpy(p, "cpu")


def _proj_kv(p, cfg, x, positions):
    k = att._split_heads(att.dense(p["wk"], x), cfg.n_kv_heads, cfg.resolved_head_dim)
    v = att._split_heads(att.dense(p["wv"], x), cfg.n_kv_heads, cfg.resolved_head_dim)
    k = att.apply_rope(k, positions, rope_fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    return k, v


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [None, 12])
def test_paged_decode_matches_reference_and_dense(window, flash):
    """Ragged prefill and 20 decode steps: each slot's paged attend equals
    the reference's paged attend and the port's dense scalar-t decode of the
    same sequence; the bookkeeping stays identical and the pools agree on
    every page but the null page."""
    jcfg, cfg = _cfgs(sliding_window=window, use_flash_attention=flash)
    jp, p = _attn_params(jcfg, 0)
    B, ps, P, max_len = 3, 8, 32, 64
    lens = np.array([20, 5, 1], np.int32)
    c = kvp.init_paged_cache(cfg, 1, B, max_len, P, torch.float32, page_size=ps, device="cpu")
    jc = jkvp.init_paged_cache(jcfg, 1, B, max_len, P, jnp.float32, page_size=ps)
    ones = np.ones((B,), bool)
    c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill, lens, ones, window)
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32))
    kpre, vpre = _proj_kv(p, cfg, xs, torch.arange(20))
    kvp.write_prefill_kv(c.k_pool[0], c.v_pool[0], c.page_table, kpre, vpre,
                         torch.from_numpy(lens))
    # the reference's pools start from the port's prefill writes
    jc = jc._replace(k_pool=jnp.asarray(c.k_pool.numpy()), v_pool=jnp.asarray(c.v_pool.numpy()))
    dense = []
    for b in range(B):
        d = att.init_kv_cache(cfg, 1, max_len, torch.float32, device="cpu")
        keep = min(int(lens[b]), d.window)
        pos = torch.arange(int(lens[b]) - keep, int(lens[b]))
        d.k[:, pos % d.window] = kpre[b:b + 1, pos]
        d.v[:, pos % d.window] = vpre[b:b + 1, pos]
        d.pos[pos % d.window] = pos.to(torch.int32)
        dense.append(d)
    active = torch.ones(B, dtype=torch.bool)
    for step in range(20):
        c, jc = _both(c, jc, kvp.alloc_decode_page, jkvp.alloc_decode_page, ones)
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y, _ = kvp.paged_decode_attend(p, torch.from_numpy(x), (c.k_pool[0], c.v_pool[0]),
                                       c.page_table, c.seq_len, cfg, active=active)
        jy, (jkp, jvp) = jkvp.paged_decode_attend(
            jp, jnp.asarray(x), (jc.k_pool[0], jc.v_pool[0]), jc.page_table, jc.seq_len, jcfg,
            active=jnp.asarray(ones), interpret=True)
        jc = jc._replace(k_pool=jc.k_pool.at[0].set(jkp), v_pool=jc.v_pool.at[0].set(jvp))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for b in range(B):
            yd, dense[b] = att.decode_attend(p, torch.from_numpy(x[b:b + 1]),
                                             int(lens[b]) + step, dense[b], cfg)
            np.testing.assert_allclose(y[b].numpy(), yd[0].numpy(), rtol=2e-5, atol=2e-5)
        c, jc = _both(c, jc, kvp.advance_and_free, jkvp.advance_and_free, ones, window)
    np.testing.assert_allclose(c.k_pool[0, 1:].numpy(), np.asarray(jc.k_pool[0, 1:]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c.v_pool[0, 1:].numpy(), np.asarray(jc.v_pool[0, 1:]),
                               rtol=1e-6, atol=1e-6)
    if window is not None:
        # steady state: about window tokens per slot, not max_len
        assert P - 1 - int(c.n_free) <= B * (window // ps + 2)


def test_release_and_reuse_slot():
    jcfg, cfg = _cfgs()
    B, P = 3, 16
    c = kvp.init_paged_cache(cfg, 1, B, 64, P, torch.float32, page_size=8, device="cpu")
    jc = jkvp.init_paged_cache(jcfg, 1, B, 64, P, jnp.float32, page_size=8)
    c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill,
                  np.array([17, 9, 30], np.int32), np.ones((B,), bool))
    n0 = int(c.n_free)
    c, jc = _both(c, jc, kvp.release_slots, jkvp.release_slots, np.array([False, True, False]))
    assert int(c.n_free) == n0 + 2 and int(c.seq_len[1]) == 0
    assert (c.page_table[1] == -1).all()
    c, jc = _both(c, jc, kvp.alloc_prefill, jkvp.alloc_prefill, np.array([0, 23, 0], np.int32),
                  np.array([False, True, False]))
    assert int(c.seq_len[1]) == 23 and (c.page_table[1, :3] >= 0).all()
    assert int(c.seq_len[0]) == 17 and int(c.seq_len[2]) == 30
