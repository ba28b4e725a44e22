"""The port's serving path against the reference's.

On the ``_tiny`` qwen2 config of ``tests/test_serve_continuous.py`` (2
layers, d 64, 4 heads over 2 kv heads), f32, flash route (the kernels'
plain versions on the CPU) and plain route, without and with a sliding
window of 6:

* ``prefill``, ``decode_step``, ``decode_step_ragged`` (an idle slot
  included), ``prefill_paged`` and ``decode_step_paged`` give logits within
  1e-5 of the reference's from the same JAX weights and prompts (on the
  plain paged route, for the active slots: an idle slot's row is garbage by
  design, and the reference's plain oracle averages V there where the port's
  gives 0, as both kernels do); the dense caches agree within 1e-5 with
  equal positions, the paged bookkeeping is identical and the pools agree
  within 1e-5 on every page but the null page.
* ``serve`` and ``serve_continuous`` give the reference's tokens, exactly.
* The twins of ``test_continuous_matches_batch_at_once``,
  ``test_paged_decode_token_parity`` and ``test_ragged_decode_matches_scalar_t``
  hold on the port alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import kv_paged as jkvp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import (kv_cache_from_numpy, kv_cache_to_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.launch.serve import serve, serve_continuous  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.kv_paged import check_invariants, release_slots  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

TOL = 1e-5
quiet = dict(log_fn=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _tiny(mod, **kw):
    return mod.get_smoke_config("qwen2-1.5b").replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(window, flash):
    """The reference's model (its serving functions jitted, as its serving
    loop runs them) and weights, and the port's model and copy of them."""
    kw = dict(sliding_window=window, use_flash_attention=flash)
    jm = j_build_model(_tiny(jconfigs, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    jm = jm._replace(prefill=jax.jit(jm.prefill, static_argnums=2),
                     **{f: jax.jit(getattr(jm, f)) for f in (
                         "decode_step", "decode_step_ragged", "prefill_paged",
                         "decode_step_paged")})
    return jm, jp, build_model(_tiny(configs, **kw), device="cpu"), params_from_numpy(_np(jp), "cpu")


def _prompt(B, S, seed=1):
    toks = np.array(j_lm_batch(jax.random.PRNGKey(seed), _tiny(jconfigs), B, S + 1)["tokens"])
    return toks[:, :S]


def _logits_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _dense_close(c, jc):
    c = kv_cache_to_numpy(c["b0_attn"])
    jc = jc["b0_attn"]
    np.testing.assert_allclose(c.k, np.asarray(jc.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.v, np.asarray(jc.v), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(c.pos, np.asarray(jc.pos))


CASES = [(None, False), (None, True), (6, False), (6, True)]
IDS = ["plain", "flash", "plain-window6", "flash-window6"]


@pytest.mark.parametrize("window,flash", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(window, flash):
    jm, jp, m, p = _models(window, flash)
    B, S, gen = 3, 10, 5
    toks = _prompt(B, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S + gen)
    with torch.no_grad():
        lg, c = m.prefill(p, {"tokens": torch.from_numpy(toks).long()}, S + gen)
    _logits_close(lg, jl)
    _dense_close(c, jc)
    # the reference's cache carried across decodes like the port's own
    carried = {"b0_attn": kv_cache_from_numpy(_np(jc["b0_attn"]), "cpu")}
    tok = np.array(jnp.argmax(jl[:, -1:], axis=-1))
    for i in range(gen - 1):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32), jc)
        with torch.no_grad():
            lg, c = m.decode_step(p, torch.from_numpy(tok).long(), S + i, c)
            lgc, carried = m.decode_step(p, torch.from_numpy(tok).long(), S + i, carried)
        _logits_close(lg, jl)
        _logits_close(lgc, jl)
        tok = np.array(jnp.argmax(jl, axis=-1))
    _dense_close(c, jc)


@pytest.mark.parametrize("window,flash", CASES, ids=IDS)
def test_ragged_decode_matches_reference(window, flash):
    """Per-slot positions staggered by slot, slot 1 idle on one step."""
    jm, jp, m, p = _models(window, flash)
    B, S, steps = 3, 10, 4
    toks = _prompt(B, S)
    _, jd = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S + steps + 2)
    kv = jd["b0_attn"]
    L, W = kv.pos.shape
    jc = {"b0_attn": kv._replace(pos=jnp.broadcast_to(kv.pos[:, None], (L, B, W)))}
    c = {"b0_attn": kv_cache_from_numpy(_np(jc["b0_attn"]), "cpu")}
    rng = np.random.default_rng(0)
    for i in range(steps):
        tok = rng.integers(0, 256, (B, 1)).astype(np.int32)
        t = (S + i + np.array([0, 1, 2])).astype(np.int32)
        active = np.array([True, i != 1, True])
        jl, jc = jm.decode_step_ragged(jp, jnp.asarray(tok), jnp.asarray(t), jc,
                                       jnp.asarray(active))
        with torch.no_grad():
            lg, c = m.decode_step_ragged(p, torch.from_numpy(tok).long(), torch.from_numpy(t),
                                         c, torch.from_numpy(active))
        _logits_close(lg, jl)
    _dense_close(c, jc)


@pytest.mark.parametrize("window,flash", CASES, ids=IDS)
def test_paged_matches_reference(window, flash):
    """Admission of three prompts slot by slot, then decode steps with a
    slot idle and one retired and re-admitted."""
    jm, jp, m, p = _models(window, flash)
    B, S, gen, ps = 3, 10, 6, 4
    max_len = S + gen
    toks = _prompt(B, S)
    n_pages = 1 + B * (-(-max_len // ps) + 1)
    jc = jm.init_cache_paged(B, max_len, n_pages, ps)
    c = m.init_cache_paged(B, max_len, n_pages, ps)

    def same():
        for name in ("page_table", "seq_len", "n_free"):
            np.testing.assert_array_equal(getattr(c, name).numpy(), np.asarray(getattr(jc, name)))
        n = int(c.n_free)
        np.testing.assert_array_equal(c.free_pages[:n].numpy(), np.asarray(jc.free_pages[:n]))
        for pool, jpool in ((c.k_pool, jc.k_pool), (c.v_pool, jc.v_pool)):
            np.testing.assert_allclose(pool[:, 1:].numpy(), np.asarray(jpool[:, 1:]),
                                       rtol=TOL, atol=TOL)
        check_invariants(c)

    def admit(b, row):
        nonlocal jc, c
        jl, jc = jm.prefill_paged(jp, {"tokens": jnp.asarray(row)}, jc, jnp.asarray(b))
        with torch.no_grad():
            lg, c = m.prefill_paged(p, {"tokens": torch.from_numpy(row).long()}, c, b)
        _logits_close(lg, jl)
        same()

    for b in range(B):
        admit(b, toks[b:b + 1])
    rng = np.random.default_rng(1)
    for i in range(gen - 1):
        tok = rng.integers(0, 256, (B, 1)).astype(np.int32)
        active = np.array([True, i != 2, True])
        jl, jc = jm.decode_step_paged(jp, jnp.asarray(tok), jc, jnp.asarray(active))
        with torch.no_grad():
            lg, c = m.decode_step_paged(p, torch.from_numpy(tok).long(), c,
                                        torch.from_numpy(active))
        # an idle slot's logits are garbage by design: the reference's plain
        # oracle averages V over its fully masked row, the port's plain
        # version (like both packages' kernels) gives o = 0 there
        rows = slice(None) if flash else active
        _logits_close(lg[rows], np.asarray(jl)[rows])
        same()
        if i == 1:      # retire slot 0 and admit the last prompt again
            mask = np.arange(B) == 0
            jc = jkvp.release_slots(jc, jnp.asarray(mask))
            c = release_slots(c, torch.from_numpy(mask))
            same()
            admit(0, toks[2:3])


@pytest.mark.parametrize("flash", [False, True])
def test_serve_matches_reference(flash):
    """Batch-at-once greedy tokens equal the reference's ``serve`` (its
    smoke config, its weights and prompts carried across)."""
    B, S, gen = 3, 8, 5
    want, _ = jserve.serve("qwen2-1.5b", smoke=True, batch_size=B, prompt_len=S,
                           gen_len=gen, **quiet)
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    toks = np.asarray(j_lm_batch(jax.random.PRNGKey(1), jcfg, B, S + 1)["tokens"])[:, :S]
    got, stats = serve("qwen2-1.5b", smoke=True, batch_size=B, prompt_len=S, gen_len=gen,
                       use_flash_attention=flash, device="cpu",
                       params=params_from_numpy(_np(jp), "cpu"),
                       prompts=[toks[r:r + 1] for r in range(B)], **quiet)
    np.testing.assert_array_equal(got, want)
    assert stats["n_tok"] == B * gen and stats["prefill_s"] > 0


def test_serve_continuous_matches_reference():
    """3 requests on 2 slots with staggered arrivals and ragged lengths:
    the tokens equal the reference's ``serve_continuous``."""
    S, gen, n_req = 8, 5, 3
    kw = dict(smoke=True, batch_size=2, n_requests=n_req, prompt_len=S, gen_len=gen,
              arrival_steps=[0, 0, 2], gen_lens=[5, 3, 4], **quiet)
    want, jstats = jserve.serve_continuous("qwen2-1.5b", **kw)
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    toks = np.asarray(j_lm_batch(jax.random.PRNGKey(1), jcfg, n_req, S + 1)["tokens"])[:, :S]
    got, stats = serve_continuous("qwen2-1.5b", use_flash_attention=True, device="cpu",
                                  params=params_from_numpy(_np(jp), "cpu"),
                                  prompts=[toks[r:r + 1] for r in range(n_req)], **kw)
    np.testing.assert_array_equal(got, want)
    assert stats["steps"] == jstats["steps"] and stats["n_pages"] == jstats["n_pages"]
    assert stats["pages_free"] == stats["n_pages"] - 1   # every page back on the stack


# ------------------------------------------- twins of the reference's --
def _batch_at_once(m, p, toks, S, gen, max_len):
    with torch.no_grad():
        logits, cache = m.prefill(p, {"tokens": toks}, max_len)
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        for i in range(gen - 1):
            logits, cache = m.decode_step(p, tok, S + i, cache)
            tok = logits.argmax(-1)
            out.append(tok)
    return torch.cat(out, 1).numpy()


def test_continuous_matches_batch_at_once():
    S, gen, n_req = 8, 5, 3
    ref, _ = serve("qwen2-1.5b", smoke=True, batch_size=n_req, prompt_len=S, gen_len=gen,
                   use_flash_attention=True, device="cpu", **quiet)
    got, stats = serve_continuous("qwen2-1.5b", smoke=True, batch_size=2, n_requests=n_req,
                                  prompt_len=S, gen_len=gen, arrival_steps=[0, 0, 2],
                                  use_flash_attention=True, device="cpu", **quiet)
    np.testing.assert_array_equal(got, ref)
    assert stats["steps"] >= gen


@pytest.mark.parametrize("window", [None, 6])
def test_paged_decode_token_parity(window):
    _, _, m, p = _models(window, True)
    B, S, gen, ps = 3, 10, 6, 4
    max_len = S + gen
    toks = torch.from_numpy(_prompt(B, S)).long()
    ref = _batch_at_once(m, p, toks, S, gen, max_len)
    cache = m.init_cache_paged(B, max_len, 1 + B * (-(-max_len // ps) + 1), ps)
    tok = torch.zeros((B, 1), dtype=torch.long)
    with torch.no_grad():
        for b in range(B):
            lg, cache = m.prefill_paged(p, {"tokens": toks[b:b + 1]}, cache, b)
            tok[b, 0] = lg[0, -1].argmax()
        out = [tok]
        for _ in range(gen - 1):
            lg, cache = m.decode_step_paged(p, tok, cache)
            tok = lg.argmax(-1)
            out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), ref)


def test_ragged_decode_matches_scalar_t():
    _, _, m, p = _models(None, True)
    B, S, gen = 3, 10, 5
    max_len = S + gen
    toks = torch.from_numpy(_prompt(B, S)).long()
    ref = _batch_at_once(m, p, toks, S, gen, max_len)
    with torch.no_grad():
        _, dcache = m.prefill(p, {"tokens": toks}, max_len)
        kv = dcache["b0_attn"]
        L, W = kv.pos.shape
        rcache = {"b0_attn": KVCache(kv.k, kv.v, kv.pos[:, None].expand(L, B, W).clone())}
        tok = torch.from_numpy(ref[:, :1])
        out = [tok]
        for i in range(gen - 1):
            t = torch.full((B,), S + i, dtype=torch.int32)
            lg, rcache = m.decode_step_ragged(p, tok, t, rcache, torch.ones(B, dtype=torch.bool))
            tok = lg.argmax(-1)
            out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), ref)
