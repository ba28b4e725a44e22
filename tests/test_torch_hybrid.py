"""The port's zamba2 hybrid (Mamba2 backbone with one weight-shared
attention block) against ``repro.models``.

On zamba2-7b's smoke config (5 Mamba layers in 2 groups of 2 and a tail of
1, d 128, 4 heads of 32, chunk 16, f32), with the reference's weights and
batches carried over through ``interop``:

* logits and loss within 1e-5, flash and plain attention;
* GN and Hessian products (linearize mode) within 1e-4 of the largest
  magnitude;
* one gn_cg ``hf_step`` at λ 100, ``cg_tol`` 0, ``krylov_jitter`` 0 within
  1e-4 (loss, and parameters with rtol 1e-3 and atol 1e-4 as
  ``tests/test_torch_train.py`` holds the dense step);
* prefill (logits within 1e-5) and 8 greedy tokens, equal to the
  reference's, with ``use_flash_attention`` off and on (on: the Mamba
  prefill through ``ssd_chunked_pallas``); the caches cross through
  ``interop.hybrid_cache_{from,to}_numpy`` and agree within 1e-5;
* ``serve`` gives the reference's tokens; ``serve_continuous`` raises for
  the hybrid, as the reference's does; ``train`` runs an HF step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import HFConfig as JHFConfig, hf_init as j_hf_init, hf_step as j_hf_step  # noqa: E402
from repro.core.curvature import make_gnvp_op as j_gnvp, make_hvp_op as j_hvp  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.transformer import hybrid_layout as j_hybrid_layout  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.curvature import make_gnvp_op, make_hvp_op  # noqa: E402
from repro_torch.core.hf import HFConfig, hf_init, hf_step  # noqa: E402
from repro_torch.interop import (batch_from_numpy, hybrid_cache_from_numpy,  # noqa: E402
                                 hybrid_cache_to_numpy, params_from_numpy, params_to_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import serve, serve_continuous  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.transformer import build_model, hybrid_layout  # noqa: E402

ARCH = "zamba2-7b"
TOL = 1e-5
quiet = dict(log_fn=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")  # no TF32 in a parity run
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def zamba():
    """The reference's smoke model, weights, a (2, 32) batch and a tangent,
    and the port's copies."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = j_lm_batch(jax.random.PRNGKey(1), jcfg, 2, 32)
    jt = jax.tree_util.tree_map(
        lambda p: jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape), jp)
    return dict(jcfg=jcfg, jm=jm, jp=jp, jb=jb, jt=jt, cfg=configs.get_smoke_config(ARCH),
                tp=params_from_numpy(_np(jp), "cpu"),
                tb=batch_from_numpy({k: np.asarray(v) for k, v in jb.items()}, "cpu"),
                tt=params_from_numpy(_np(jt), "cpu"))


# ------------------------------------------------------------ configs --
def test_config_and_layout_equal_the_reference():
    for getter in ("get_config", "get_smoke_config"):
        mine, theirs = getattr(configs, getter)(ARCH), getattr(jconfigs, getter)(ARCH)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert hybrid_layout(mine) == j_hybrid_layout(theirs)
    full = configs.get_config(ARCH)
    # the analytic count leaves out each Mamba block's conv of B and C, its
    # conv bias and its gate norm (14,976 parameters a layer); the tree
    # holds them, in both packages
    assert full.param_count() == 6_749_917_776
    shapes = jax.eval_shape(j_build_model(jconfigs.get_config(ARCH)).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == (
        6_749_917_776 + 81 * 14_976)
    assert hybrid_layout(full) == (13, 6, 3)
    assert (full.d_inner, full.ssm_n_heads, full.resolved_head_dim) == (7168, 112, 112)
    assert ARCH in configs.ARCH_IDS and ARCH not in configs.UNPORTED_ARCH_IDS


def test_other_families_still_raise():
    cfg = configs.get_smoke_config(ARCH).replace(block_pattern=("mlstm",))
    with pytest.raises(NotImplementedError, match="item 18"):
        build_model(cfg, device="cpu")


def test_parameter_tree_and_leaf_order_equal_the_reference(zamba):
    port = build_model(zamba["cfg"], device="cpu").init(torch.Generator().manual_seed(0))
    path = lambda tree: [jax.tree_util.keystr(p) for p, _ in
                         jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert path(port) == path(zamba["jp"]) == path(zamba["tp"])
    assert [tuple(t.shape) for t in tree_leaves(port)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(zamba["jp"])]
    # a bf16 model keeps A_log, D and dt_bias in f32, as the reference does
    bf = build_model(zamba["cfg"].replace(dtype="bfloat16"), device="cpu").init(
        torch.Generator().manual_seed(0))
    jbf = j_build_model(zamba["jcfg"].replace(dtype="bfloat16")).init(jax.random.PRNGKey(0))
    assert [str(t.dtype).split(".")[-1] for t in tree_leaves(bf)] == [
        str(x.dtype) for x in jax.tree_util.tree_leaves(jbf)]
    assert bf["groups"]["b0_mamba"]["mamba"]["A_log"].dtype == torch.float32


# --------------------------------------------------------------- model --
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_logits_and_loss_match_the_reference(zamba, flash):
    jm = j_build_model(zamba["jcfg"].replace(use_flash_attention=flash))
    want_logits = jm.logits_fn(zamba["jp"], zamba["jb"])
    want_loss = float(jm.loss_fn(zamba["jp"], zamba["jb"]))
    m = build_model(zamba["cfg"].replace(use_flash_attention=flash), device="cpu")
    logits = m.logits_fn(zamba["tp"], zamba["tb"])
    assert logits.dtype == torch.float32
    assert _rel(logits.detach(), want_logits) <= TOL
    assert abs(float(m.loss_fn(zamba["tp"], zamba["tb"])) - want_loss) <= TOL


@pytest.fixture(scope="module")
def zamba_bf16():
    """The reference's smoke model in bf16 (its own init; A_log, D and
    dt_bias stay f32), its bf16 logits on a (2, 32) batch and, on the same
    weights widened to f32, its f32 logits; the port's copies of weights and
    batch."""
    jcfg = jconfigs.get_smoke_config(ARCH).replace(dtype="bfloat16")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = j_lm_batch(jax.random.PRNGKey(1), jcfg, 2, 32)
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
    return dict(jp=jp, cfg=configs.get_smoke_config(ARCH).replace(dtype="bfloat16"),
                tp=params_from_numpy(_np(jp), "cpu"),
                tb=batch_from_numpy({k: np.asarray(v) for k, v in jb.items()}, "cpu"),
                ref_bf16=np.asarray(jm.logits_fn(jp, jb), np.float32),
                ref_f32=np.asarray(j_build_model(jconfigs.get_smoke_config(ARCH)).logits_fn(
                    jp32, jb)))


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_bf16_logits_hold_the_reference_within_its_own_bf16_distance(zamba_bf16, flash):
    """zamba2's smoke config in bf16 on both sides, under the gate of the
    bf16 routes (the rule of the full-width bf16 checks in ``chip_smoke.py``),
    set before the run: the weights cross
    ``interop`` bit for bit; the port's bf16 logits, through plain attention
    and through the flash kernels' plain versions, lie no farther from the
    reference's f32 logits than 1.5x the reference's own bf16 logits do (max
    |·| over max|f32 logit|); the loss is finite; and the argmax equals the
    reference's bf16 argmax at every position where the reference's top-two
    margin exceeds twice the largest absolute difference between the two
    sides' bf16 logits (at least one such position)."""
    leaves = lambda tree: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    for got, want in zip(leaves(params_to_numpy(zamba_bf16["tp"])), leaves(zamba_bf16["jp"])):
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    m = build_model(zamba_bf16["cfg"].replace(use_flash_attention=flash), device="cpu")
    with torch.no_grad():
        got = m.logits_fn(zamba_bf16["tp"], zamba_bf16["tb"]).double().numpy()
        loss = float(m.loss_fn(zamba_bf16["tp"], zamba_bf16["tb"]))
    ref_bf16, ref_f32 = (np.asarray(zamba_bf16[k], np.float64) for k in ("ref_bf16", "ref_f32"))
    scale = np.abs(ref_f32).max()
    own = np.abs(ref_bf16 - ref_f32).max() / scale
    assert own > 0  # the reference's bf16 route rounds
    assert np.abs(got - ref_f32).max() / scale <= 1.5 * own
    assert np.isfinite(loss)
    top2 = np.sort(ref_bf16, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * np.abs(got - ref_bf16).max()
    assert sure.any()
    assert np.array_equal(got.argmax(-1)[sure], ref_bf16.argmax(-1)[sure])


@pytest.fixture(scope="module")
def reference_products(zamba):
    """The reference's products through its plain attention (its flash
    route agrees with it, tests/test_flash_path.py), each jitted once."""
    jm, jp, jb = zamba["jm"], zamba["jp"], zamba["jb"]
    return dict(
        hvp=jax.jit(lambda t: j_hvp(jm.loss_fn, jp, jb)(t))(zamba["jt"]),
        gnvp=jax.jit(lambda t: j_gnvp(jm.logits_fn, jm.out_loss_fn, jp, jb)(t))(zamba["jt"]))


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("product", ["hvp", "gnvp"])
def test_curvature_products_match_the_reference(zamba, reference_products, product, flash):
    m = build_model(zamba["cfg"].replace(use_flash_attention=flash), device="cpu")
    if product == "hvp":
        op = make_hvp_op(m.loss_fn, zamba["tp"], zamba["tb"], mode="linearize")
    else:
        op = make_gnvp_op(m.logits_fn, m.out_loss_fn, zamba["tp"], zamba["tb"],
                          mode="linearize")
    got = [g.detach() for g in tree_leaves(op(zamba["tt"]))]
    want = jax.tree_util.tree_leaves(reference_products[product])
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert float(np.abs(g.double().numpy() - np.asarray(w, np.float64)).max()) <= 1e-4 * scale


HF_KW = dict(solver="gn_cg", max_cg_iters=4, init_damping=100.0, krylov_backend="flat",
             cg_tol=0.0, krylov_jitter=0.0)


@pytest.fixture(scope="module")
def reference_step(zamba):
    jm, jcfg = zamba["jm"], JHFConfig(**HF_KW)
    return jax.jit(lambda p, s, b: j_hf_step(
        jm.loss_fn, p, s, b, b, jcfg, model_out_fn=jm.logits_fn,
        out_loss_fn=jm.out_loss_fn))(zamba["jp"], j_hf_init(zamba["jp"], jcfg), zamba["jb"])


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_hf_step_matches_the_reference(zamba, reference_step, flash):
    jp, _, jmet = reference_step
    cfg = HFConfig(**HF_KW)
    m = build_model(zamba["cfg"].replace(use_flash_attention=flash), device="cpu")
    tp, _, met = hf_step(m.loss_fn, zamba["tp"], hf_init(zamba["tp"], cfg, device="cpu"),
                         zamba["tb"], zamba["tb"], cfg, model_out_fn=m.logits_fn,
                         out_loss_fn=m.out_loss_fn, device="cpu")
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4
    assert abs(float(met["loss_new"]) - float(jmet["loss_new"])) <= 1e-4
    assert int(met["cg_iters"]) == int(jmet["cg_iters"])
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------- serving --
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "kernels"])
def test_prefill_greedy_tokens_and_caches_match_the_reference(zamba, flash):
    """A 20-token prompt (chunk 16 falls back to 10), then 8 greedy tokens."""
    jm = j_build_model(zamba["jcfg"].replace(use_flash_attention=flash))
    m = build_model(zamba["cfg"].replace(use_flash_attention=flash), device="cpu")
    toks = np.asarray(zamba["jb"]["tokens"])[:, :20]
    jl, jc = jm.prefill(zamba["jp"], {"tokens": jnp.asarray(toks)}, 28)
    with torch.no_grad():
        tl, tc = m.prefill(zamba["tp"], {"tokens": torch.tensor(toks)}, 28)
    assert _rel(tl, jl) <= TOL
    assert sorted(tc) == ["groups_attn", "groups_mamba", "tail"]
    for got, want in zip(jax.tree_util.tree_leaves(hybrid_cache_to_numpy(tc)),
                         jax.tree_util.tree_leaves(jc)):
        assert _rel(got, want) <= TOL
    # the reference's cache carried over decodes as the port's own
    carried = hybrid_cache_from_numpy(_np(jc), "cpu")
    jt, tt = jnp.argmax(jl[:, -1:], -1), tl[:, -1:].argmax(-1)
    jtoks, ttoks = [], []
    with torch.no_grad():
        first, _ = m.decode_step(zamba["tp"], tt, 20, carried)
    for i in range(8):
        jl, jc = jm.decode_step(zamba["jp"], jt, 20 + i, jc)
        with torch.no_grad():
            tl, tc = m.decode_step(zamba["tp"], tt, 20 + i, tc)
        if i == 0:
            assert _rel(tl, jl) <= TOL and _rel(first, jl) <= TOL
        jt, tt = jnp.argmax(jl, -1), tl.argmax(-1)
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(ttoks, 1), np.concatenate(jtoks, 1))
    for got, want in zip(jax.tree_util.tree_leaves(hybrid_cache_to_numpy(tc)),
                         jax.tree_util.tree_leaves(jc)):
        assert _rel(got, want) <= TOL
    assert ops.LAUNCHES["ssd_intra"] == 0  # the CPU runs no kernel


def test_serve_matches_the_reference_and_continuous_raises(zamba):
    B, S, gen = 2, 16, 5
    want, _ = jserve.serve(ARCH, smoke=True, batch_size=B, prompt_len=S, gen_len=gen, **quiet)
    toks = np.asarray(j_lm_batch(jax.random.PRNGKey(1), zamba["jcfg"], B, S + 1)["tokens"])
    got, stats = serve(ARCH, smoke=True, batch_size=B, prompt_len=S, gen_len=gen,
                       use_flash_attention=True, device="cpu", params=zamba["tp"],
                       prompts=[toks[r:r + 1, :S] for r in range(B)], **quiet)
    np.testing.assert_array_equal(got, want)
    assert stats["n_tok"] == B * gen
    with pytest.raises(ValueError, match="continuous batching needs a plain decoder"):
        jserve.serve_continuous(ARCH, smoke=True, **quiet)
    with pytest.raises(ValueError, match="continuous batching needs a plain decoder"):
        serve_continuous(ARCH, smoke=True, device="cpu", **quiet)
    m = build_model(zamba["cfg"], device="cpu")
    assert m.decode_step_paged is None and m.prefill_paged is None
    assert m.decode_step_ragged is None


def test_train_runs_an_hf_step_on_the_hybrid():
    """The twin of ``tests/test_arch_smoke.py::test_one_hf_train_step``."""
    params, _, hist = train(ARCH, smoke=True, solver="bicgstab", steps=1, batch_size=4,
                            seq_len=32, max_cg_iters=3, use_flash_attention=True,
                            device="cpu", **quiet)
    (m,) = hist
    assert np.isfinite(m["loss"]) and np.isfinite(m["loss_new"])
    assert m["loss_new"] <= m["loss"] + 1e-5
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
