"""The port's dense decoder transformers against ``repro.models``.

Parameters and batches are the JAX package's own (``init`` and ``lm_batch``
from PRNG keys), carried over through ``interop``. On the ``_tiny`` config
of ``tests/test_flash_path.py`` (qwen2-1.5b's smoke config cut to 2 layers,
d 64, kv 2): logits and loss within 1e-5, flash and plain attention; the
GN and Hessian products of the port's curvature engine in every mode within
the tolerance of ``tests/test_flash_path.py`` (rtol 1e-3, atol 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.curvature import make_gnvp_op as j_gnvp, make_hvp_op as j_hvp  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.curvature import MODES, make_gnvp_op, make_hvp_op  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.interop import (batch_from_numpy, params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import attention, layers, ssm  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "qwen2-1.5b", "granite-3-8b", "chatglm3-6b")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")  # no TF32 in a parity run
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _tiny(mod, arch="qwen2-1.5b", **kw):
    return mod.get_smoke_config(arch).replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The reference's _tiny model, params, batch and tangent, and the port's
    copies of them."""
    jcfg = _tiny(jconfigs)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = j_lm_batch(jax.random.PRNGKey(1), jcfg, 2, 32)
    jt = jax.tree_util.tree_map(
        lambda p: jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape), jp)
    return dict(jcfg=jcfg, jm=jm, jp=jp, jb=jb, jt=jt, cfg=_tiny(configs),
                tp=params_from_numpy(_np(jp), "cpu"),
                tb=batch_from_numpy({k: np.asarray(v) for k, v in jb.items()}, "cpu"),
                tt=params_from_numpy(_np(jt), "cpu"))


def _close(got, want, rtol, atol):
    got = [np.asarray(x.detach().float()) for x in tree_leaves(got)]
    want = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------------------ configs --
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        mine = dataclasses.asdict(getattr(configs, getter)(arch))
        theirs = dataclasses.asdict(getattr(jconfigs, getter)(arch))
        assert mine == theirs
        assert (getattr(configs, getter)(arch).param_count()
                == getattr(jconfigs, getter)(arch).param_count())


def test_qwen_full_parameter_count():
    cfg = configs.get_config("qwen1.5-0.5b")
    assert cfg.param_count() == 464_118_784
    assert (cfg.padded_vocab, cfg.resolved_head_dim) == (152_064, 64)


def test_other_families_raise_naming_their_item():
    for arch in configs.UNPORTED_ARCH_IDS:
        with pytest.raises(NotImplementedError, match="item 18"):
            configs.get_config(arch)
    with pytest.raises(NotImplementedError, match="item 18"):
        build_model(configs.get_smoke_config("qwen2-1.5b").replace(family="moe",
                                                                   block_pattern=("moe",)),
                    device="cpu")


def test_hf_opt_config_equals_the_reference():
    assert dataclasses.asdict(configs.HFOptConfig()) == dataclasses.asdict(
        jconfigs.HFOptConfig())


# --------------------------------------------------------------- model --
def test_parameter_tree_and_leaf_order_equal_the_reference(tiny):
    port = build_model(tiny["cfg"], device="cpu").init(torch.Generator().manual_seed(0))
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tiny["jp"])[0]]
    ppaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tiny["tp"])[0]]
    assert jpaths == ppaths
    assert [tuple(t.shape) for t in tree_leaves(port)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(tiny["jp"])]
    assert [t.dtype for t in tree_leaves(port)] == [torch.float32] * len(jpaths)


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_logits_and_loss_match_the_reference(tiny, flash):
    jm_flash = j_build_model(tiny["jcfg"].replace(use_flash_attention=True))
    for jm in (tiny["jm"], jm_flash):
        want_logits = jm.logits_fn(tiny["jp"], tiny["jb"])
        want_loss = float(jm.loss_fn(tiny["jp"], tiny["jb"]))
        m = build_model(tiny["cfg"].replace(use_flash_attention=flash), device="cpu")
        logits = m.logits_fn(tiny["tp"], tiny["tb"])
        assert logits.dtype == torch.float32
        scale = float(np.abs(np.asarray(want_logits)).max())
        assert float((logits - torch.tensor(np.asarray(want_logits))).abs().max()) <= 1e-5 * scale
        assert abs(float(m.loss_fn(tiny["tp"], tiny["tb"])) - want_loss) <= 1e-5


@pytest.fixture(scope="module")
def reference_products(tiny):
    """The reference's products at linearize (its modes agree with each
    other, tests/test_flash_path.py), through _sdpa and through flash."""
    out = {}
    for flash in (False, True):
        jm = j_build_model(tiny["jcfg"].replace(use_flash_attention=flash))
        out[flash] = dict(
            hvp=j_hvp(jm.loss_fn, tiny["jp"], tiny["jb"])(tiny["jt"]),
            gnvp=j_gnvp(jm.logits_fn, jm.out_loss_fn, tiny["jp"], tiny["jb"])(tiny["jt"]))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("product", ["hvp", "gnvp"])
def test_curvature_products_match_the_reference(tiny, reference_products, product, flash,
                                                mode):
    m = build_model(tiny["cfg"].replace(use_flash_attention=flash), device="cpu")
    kw = dict(mode=mode, chunk_size=1 if mode == "chunked" else 0)
    if product == "hvp":
        op = make_hvp_op(m.loss_fn, tiny["tp"], tiny["tb"], **kw)
    else:
        op = make_gnvp_op(m.logits_fn, m.out_loss_fn, tiny["tp"], tiny["tb"], **kw)
    _close(op(tiny["tt"]), reference_products[flash][product], rtol=1e-3, atol=1e-4)


def test_rope_partial_fraction_and_layernorm_match_the_reference():
    from repro.models import layers as jl

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.arange(6)
    for frac in (1.0, 0.5):
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), rope_fraction=frac, theta=1e4)
        got = layers.apply_rope(torch.tensor(x), torch.tensor(pos), rope_fraction=frac,
                                theta=1e4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    p = {"bias": rng.standard_normal(16).astype(np.float32),
         "scale": rng.standard_normal(16).astype(np.float32)}
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = layers.apply_norm({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    w = {"wi": {"w": rng.standard_normal((16, 8)).astype(np.float32)},
         "wo": {"w": rng.standard_normal((8, 16)).astype(np.float32)}}
    want = jl.apply_mlp(jax.tree_util.tree_map(jnp.asarray, w), jnp.asarray(x))
    got = layers.apply_mlp(tree_map(torch.tensor, w), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_explicit_mask_and_cross_attention_route_to_the_kernels(tiny):
    cfg = tiny["cfg"]
    p = params_from_numpy(_np(tiny["jp"]["blocks"]["b0_attn"]["attn"]), "cpu")
    p = tree_map(lambda t: t[0], p)
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 20, 64)),
                     dtype=torch.float32)
    pos = torch.arange(20)
    # random holes in the causal mask; the diagonal stays, so no row is empty
    # (there _sdpa averages V and the kernels give 0, in the reference too)
    mask = attention.causal_mask(20, device="cpu") & (torch.tensor(
        np.random.default_rng(2).random((2, 1, 20, 20)) > 0.3) | torch.eye(20, dtype=torch.bool))
    want = attention.attend_full(p, x, pos, cfg, mask=mask)
    got = attention.attend_full(p, x, pos, cfg.replace(use_flash_attention=True), mask=mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # cross-attention (no mask): the non-causal kernels on q and kv lengths
    # that differ (20 against 33, both padded to 128)
    kv = [torch.tensor(np.random.default_rng(s).standard_normal((2, 33, 2, 16)),
                       dtype=torch.float32) for s in (3, 4)]
    want = attention.attend_full(p, x, pos, cfg, cross_kv=kv)
    got = attention.attend_full(p, x, pos, cfg.replace(use_flash_attention=True), cross_kv=kv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_lm_batch_follows_the_reference_process():
    cfg = configs.get_smoke_config("qwen2-1.5b")
    b = lm_batch(torch.Generator().manual_seed(3), cfg, 4, 33, device="cpu")
    jb = j_lm_batch(jax.random.PRNGKey(3), jconfigs.get_smoke_config("qwen2-1.5b"), 4, 33)
    assert list(b) == sorted(jb)
    for k in b:
        assert tuple(b[k].shape) == tuple(jb[k].shape)
    toks, tgts = b["tokens"], b["targets"]
    assert toks.dtype == tgts.dtype == torch.int64
    assert torch.equal(toks[:, 1:-1], tgts[:, :-2])           # next-token targets
    assert torch.equal(toks[:, -1], toks[:, -2]) and torch.equal(tgts[:, -1], tgts[:, -2])
    step = torch.remainder(tgts[:, :-1] - toks[:, :-1] + 3, cfg.vocab_size)
    assert bool((step <= 6).all()) and bool((toks < cfg.vocab_size).all())
    assert torch.equal(b["loss_mask"], torch.ones(4, 33))
    again = lm_batch(torch.Generator().manual_seed(3), cfg, 4, 33, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)


def _hold_bf16_logits(logits, loss, ref_bf16, ref_f32):
    """The gate of the bf16 routes (the rule of the full-width bf16 checks in
    ``chip_smoke.py``), set before the run:
    the port's bf16 logits lie no farther from the reference's f32 logits
    (the same bf16 weights widened to f32) than 1.5x the reference's own
    bf16 logits do, in max|·| over max|f32 logit|; the loss is finite; and
    the argmax equals the reference's bf16 argmax at every position where
    the reference's top-two margin exceeds twice the largest absolute
    difference between the two sides' bf16 logits (at least one such
    position)."""
    got = logits.detach().double().numpy()
    ref_bf16, ref_f32 = (np.asarray(a, np.float64) for a in (ref_bf16, ref_f32))
    scale = np.abs(ref_f32).max()
    own = np.abs(ref_bf16 - ref_f32).max() / scale
    assert own > 0  # the reference's bf16 route rounds
    assert np.abs(got - ref_f32).max() / scale <= 1.5 * own
    assert np.isfinite(float(loss))
    top2 = np.sort(ref_bf16, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * np.abs(got - ref_bf16).max()
    assert sure.any()
    assert np.array_equal(got.argmax(-1)[sure], ref_bf16.argmax(-1)[sure])


@pytest.fixture(scope="module")
def tiny_bf16():
    """The reference's _tiny model in bf16 (its own init), its bf16 logits
    on a (2, 32) batch and, on the same weights widened to f32, its f32
    logits; the port's copies of weights and batch."""
    jcfg = _tiny(jconfigs, dtype="bfloat16")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = j_lm_batch(jax.random.PRNGKey(1), jcfg, 2, 32)
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
    return dict(jp=jp, cfg=_tiny(configs, dtype="bfloat16"),
                tp=params_from_numpy(_np(jp), "cpu"),
                tb=batch_from_numpy({k: np.asarray(v) for k, v in jb.items()}, "cpu"),
                ref_bf16=np.asarray(jm.logits_fn(jp, jb), np.float32),
                ref_f32=np.asarray(j_build_model(_tiny(jconfigs)).logits_fn(jp32, jb)))


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_bf16_logits_hold_the_reference_within_its_own_bf16_distance(tiny_bf16, flash):
    """The tiny Qwen2 config in bf16 on both sides: the weights cross
    ``interop`` bit for bit, and the port's logits through plain attention
    and through the flash kernels' plain versions hold ``_hold_bf16_logits``."""
    leaves = lambda tree: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    for got, want in zip(leaves(params_to_numpy(tiny_bf16["tp"])), leaves(tiny_bf16["jp"])):
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    m = build_model(tiny_bf16["cfg"].replace(use_flash_attention=flash), device="cpu")
    with torch.no_grad():
        logits = m.logits_fn(tiny_bf16["tp"], tiny_bf16["tb"])
        loss = m.loss_fn(tiny_bf16["tp"], tiny_bf16["tb"])
    _hold_bf16_logits(logits, loss, tiny_bf16["ref_bf16"], tiny_bf16["ref_f32"])


@pytest.mark.parametrize("ctor", ["causal_mask", "init_kv_cache", "init_mamba_cache",
                                  "norm_init", "rope_freqs"])
def test_public_constructors_default_to_the_card(ctor, monkeypatch):
    """Without a device the five public constructors ask for the card and
    raise where there is none (no fall back to the CPU); with
    ``device="cpu"`` every tensor they make lies on the CPU."""
    cfg = configs.get_smoke_config("zamba2-7b")
    call = {
        "causal_mask": lambda **kw: attention.causal_mask(8, window=4, **kw),
        "init_kv_cache": lambda **kw: attention.init_kv_cache(cfg, 2, 16, torch.float32, **kw),
        "init_mamba_cache": lambda **kw: ssm.init_mamba_cache(cfg, 2, torch.float32, **kw),
        "norm_init": lambda **kw: layers.norm_init(8, torch.float32, "layernorm", **kw),
        "rope_freqs": lambda **kw: layers.rope_freqs(32, 0.5, 1e4, **kw),
    }[ctor]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    made = [t for t in tree_leaves(call(device="cpu")) if isinstance(t, torch.Tensor)]
    assert made and all(t.device.type == "cpu" for t in made)


def test_serving_entry_points_raise_naming_their_slice(tiny):
    """Serving (ROADMAP item 20) is ported: every serving entry point is set
    and the dense cache has the reference's stacked layout (parity in
    tests/test_torch_serve.py); chunked cross-entropy still raises naming
    its item."""
    m = build_model(tiny["cfg"], device="cpu")
    for name in ("prefill", "decode_step", "init_cache", "decode_step_ragged",
                 "init_cache_ragged", "decode_step_paged", "init_cache_paged", "prefill_paged"):
        assert callable(getattr(m, name)), name
    cfg = tiny["cfg"]
    kv = m.init_cache(3, 16)["b0_attn"]
    assert kv.k.shape == (cfg.n_layers, 3, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert kv.pos.shape == (cfg.n_layers, 16) and kv.pos.dtype == torch.int32
    assert bool((kv.pos == -1).all())
    with pytest.raises(NotImplementedError, match="ce_chunk"):
        build_model(tiny["cfg"].replace(ce_chunk=64), device="cpu").loss_fn(tiny["tp"],
                                                                           tiny["tb"])
