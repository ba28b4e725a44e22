"""The port's split-K flash decode against the reference's.

* The plain versions (``repro_torch.kernels.ref``, what ``ops`` runs for CPU
  tensors) against the Pallas decode kernels in interpret mode and against
  the reference's oracles, on every case of ``tests/test_flash_decode.py``
  (``FD_CASES``, ``PAGED_CASES``, head dim 16 included), each in f32 and
  bf16: within 1e-5 (f32) and 1e-2 (bf16) of the largest magnitude of the
  reference (bf16 rounding of the per-split partials alone is ~4e-3).
* The plain split-and-merge of the dense kernel
  (``ref.flash_decode_split_ref``) against the Pallas kernel on one, two and
  eight splits, a ragged W, wholly masked splits and an idle row; that of
  the paged kernel (``ref.flash_decode_paged_split_ref``, one page per
  split) on the reference's paged cases, unmapped holes with an idle row, a
  table of 20 pages and pages of 8 and 16.
* The (o, m, l) contract of ``return_stats``, fully masked rows, the mask
  functions ``decode_bias``/``paged_bias``, ``combine_splits`` and
  ``_pick_splits`` against the reference's (masks and split counts exactly).
* The decode attends of ``models.attention`` against the reference's,
  flash and plain, through a rolling window, per slot, and with inactive
  slots (within 1e-5, caches equal within 1e-6).
* The CUDA wrappers refuse tensors that are not on the card, before any build.

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.interop import kv_cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import cg_fused, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


# The cases of tests/test_flash_decode.py (dtype given separately here).
FD_CASES = [
    # (B, W, H, KV, hd, blk_k, n_splits, window, ragged)
    (1, 128, 2, 2, 32, 64, 2, None, False),
    (2, 256, 4, 2, 32, 64, 4, None, False),   # GQA
    (2, 300, 4, 1, 32, 64, 4, 90, False),     # window + unaligned W
    (3, 200, 4, 2, 32, 64, 8, None, True),    # ragged per-seq t
    (2, 192, 8, 2, 64, 64, 3, 64, True),      # everything
    (1, 40, 2, 2, 16, 128, 4, None, False),   # W < blk_k
]
PAGED_CASES = [
    # (B, P, ps, maxp, H, KV, hd, window, seq_lens)
    (2, 8, 64, 3, 4, 2, 32, None, (130, 57)),       # non-page-aligned lengths
    (3, 12, 64, 5, 2, 1, 32, 100, (320, 17, 64)),   # window frees early pages
    (2, 6, 128, 2, 4, 4, 16, None, (256, 1)),       # MHA, full + single token
]
DTYPES = ("float32", "bfloat16")


def _pair(a, dtype):
    """One numpy f32 array as (jax array, torch tensor) in ``dtype``, the
    same bits on both sides."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(a, jnp.float32).astype(dtype), t


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def _dense_inputs(case, dtype, seed):
    B, W, H, KV, hd, _, _, window, ragged = case
    rng = np.random.default_rng(seed)
    (jq, q), (jk, k), (jv, v) = (_pair(rng.standard_normal(s), dtype)
                                 for s in ((B, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    pos = np.arange(W, dtype=np.int32)
    t = (np.array([(7 * b + 11) % W for b in range(B)], np.int32) if ragged
         else np.int32(W - 1))
    jbias = jfd.decode_bias(jnp.asarray(pos), jnp.asarray(t), window=window)
    bias = fd.decode_bias(torch.from_numpy(pos), torch.from_numpy(np.asarray(t)), window=window)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    return (jq, jk, jv, jbias), (q, k, v, bias)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FD_CASES, ids=[f"fd{i}" for i in range(len(FD_CASES))])
def test_flash_decode_plain_matches_reference(case, dtype):
    (jq, jk, jv, jbias), (q, k, v, bias) = _dense_inputs(case, dtype, FD_CASES.index(case))
    blk_k, n_splits = case[5], case[6]
    got = ops.flash_decode(q, k, v, bias, blk_k=blk_k, n_splits=n_splits)
    assert got.dtype == q.dtype and ops.LAUNCHES["flash_decode"] == 0
    kernel = jops.flash_decode(jq, jk, jv, jbias, blk_k=blk_k, n_splits=n_splits,
                               interpret=True)
    _close(got, np.asarray(kernel, np.float32), TOL[dtype])
    _close(got, np.asarray(jref.flash_decode_ref(jq, jk, jv, jbias), np.float32), TOL[dtype])


def _paged_inputs(case, dtype, seed, holes=False):
    B, P, ps, maxp, H, KV, hd, window, seq_lens = case
    rng = np.random.default_rng(100 + seed)
    (jq, q), (jk, kp), (jv, vp) = (_pair(rng.standard_normal(s), dtype)
                                   for s in ((B, H, hd), (P, ps, KV, hd), (P, ps, KV, hd)))
    # the reference test's layout: pages interleaved across the pool, -1
    # unmapped, and pages a window has rolled past freed; with ``holes``
    # every third logical page is left unmapped between mapped ones
    tbl = np.full((B, maxp), -1, np.int32)
    nxt = 0
    for b in range(B):
        for j in range(-(-seq_lens[b] // ps)):
            if holes and j % 3 == 1:
                continue
            tbl[b, j] = nxt % P
            nxt += 1
    if window is not None:
        for b in range(B):
            first_live = max(0, seq_lens[b] - window)
            tbl[b, [j for j in range(maxp) if (j + 1) * ps <= first_live]] = -1
    sl = np.asarray(seq_lens, np.int32)
    jbias = jfd.paged_bias(jnp.asarray(tbl), jnp.asarray(sl), ps, window=window)
    bias = fd.paged_bias(torch.from_numpy(tbl), torch.from_numpy(sl), ps, window=window)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    return (jq, jk, jv, jnp.asarray(tbl), jbias), (q, kp, vp, torch.from_numpy(tbl), bias)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"paged{i}" for i in range(len(PAGED_CASES))])
def test_flash_decode_paged_plain_matches_reference(case, dtype):
    jargs, args = _paged_inputs(case, dtype, PAGED_CASES.index(case))
    got = ops.flash_decode_paged(*args)
    assert got.dtype == args[0].dtype and ops.LAUNCHES["flash_decode_paged"] == 0
    _close(got, np.asarray(jops.flash_decode_paged(*jargs, interpret=True), np.float32),
           TOL[dtype])
    _close(got, np.asarray(jref.flash_decode_paged_ref(*jargs), np.float32), TOL[dtype])


def test_return_stats_match_reference_and_merge():
    """(o, m, l) of the plain version equal the Pallas kernel's global stats,
    and two halves of the window merge with ``combine_splits`` to the whole
    (the sequence-sharded decode's merge)."""
    B, W, H, KV, hd = 2, 256, 4, 2, 32
    case = (B, W, H, KV, hd, 64, 8, None, True)
    (jq, jk, jv, jbias), (q, k, v, bias) = _dense_inputs(case, "float32", 7)
    o, m, l = ops.flash_decode(q, k, v, bias, return_stats=True)
    jo, jm, jl = jops.flash_decode(jq, jk, jv, jbias, blk_k=64, interpret=True,
                                   return_stats=True)
    for got, want in ((o, jo), (m, jm), (l, jl)):
        _close(got, np.asarray(want), TOL["float32"])
    half = W // 2
    parts = [ops.flash_decode(q, k[:, s], v[:, s], bias[:, s], return_stats=True)
             for s in (slice(0, half), slice(half, W))]
    G = H // KV
    merged, mm, ml = fd.combine_splits(
        torch.stack([p[0].reshape(B, KV, G, hd) for p in parts], dim=2),
        torch.stack([p[1].reshape(B, KV, G) for p in parts], dim=2),
        torch.stack([p[2].reshape(B, KV, G) for p in parts], dim=2))
    _close(merged, o.numpy(), TOL["float32"])
    _close(mm, m.numpy(), TOL["float32"])
    _close(ml, l.numpy(), TOL["float32"])


# The dense kernel's split layouts: (B, W, H, KV, hd, blk_k, n_splits, window,
# idle row). One split, two, eight; a ragged W (the last split holds 12 of
# its 64 keys); a window that masks six of eight splits wholly; an idle row.
SPLIT_CASES = {
    "ns1": (2, 96, 4, 2, 32, 128, 8, None, False),
    "ns2": (2, 128, 4, 2, 32, 64, 2, None, False),
    "ns8": (2, 512, 6, 1, 32, 64, 8, None, False),
    "ns8-ragged": (2, 460, 6, 2, 32, 64, 8, None, False),
    "ns8-masked-splits": (2, 512, 4, 2, 32, 64, 8, 100, False),
    "ns4-idle-row": (3, 256, 8, 2, 64, 64, 8, None, True),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_flash_decode_split_ref_matches_pallas_kernel(name, dtype):
    """``ref.flash_decode_split_ref`` (the plain split-and-merge the dense
    kernel is held to on the card) against the Pallas kernel in interpret
    mode, (o, m, l), on the reference's split layouts: o within 1e-5 (f32)
    and 1e-2 (bf16; both round each split's o to bf16, the Pallas kernel
    its unnormalised weights, the plain version the normalised ones) of
    max|o|, m on live rows and l within 1e-5; an idle row is exactly
    (0, NEG_INF, 0) on both sides."""
    B, W, H, KV, hd, blk_k, n_splits, window, idle = case = SPLIT_CASES[name]
    assert fd.split_layout(W, blk_k, n_splits)[0] == int(name[2])
    (jq, jk, jv, jbias), (q, k, v, bias) = _dense_inputs(case[:8] + (False,), dtype,
                                                         list(SPLIT_CASES).index(name))
    bias = bias.expand(B, W).clone()
    if idle:
        bias[-1] = fd.NEG_INF
    got = ref.flash_decode_split_ref(q, k, v, bias, blk_k=blk_k, n_splits=n_splits,
                                     return_stats=True)
    want = jfd.flash_decode(jq, jk, jv, jnp.asarray(bias.numpy()), blk_k=blk_k,
                            n_splits=n_splits, interpret=True, return_stats=True)
    assert got[0].dtype == q.dtype and got[0].shape == (B, H, hd)
    _close(got[0], np.asarray(want[0], np.float32), TOL[dtype])
    live = np.asarray(want[1]) > fd.NEG_INF / 2
    assert np.array_equal(got[1].numpy() > fd.NEG_INF / 2, live)
    _close(got[1][torch.from_numpy(live)], np.asarray(want[1])[live], TOL["float32"])
    _close(got[2], np.asarray(want[2]), TOL["float32"])
    if idle:
        assert torch.all(got[0][-1] == 0) and torch.all(got[1][-1] <= fd.NEG_INF / 2)
        assert torch.all(got[2][-1] == 0)


# The paged kernel's layouts: (B, P, ps, max_pages, H, KV, hd, window,
# seq_lens, holes, idle row). The reference's PAGED_CASES; unmapped pages
# between mapped ones and an idle row; a table wider than 8 pages (20 pages
# of 8: one cluster block holds three, four to a 32-key tile); pages of 16
# (two to a tile) behind a window.
PAGED_SPLIT_CASES = {
    "paged0": PAGED_CASES[0] + (False, False),
    "paged1-window": PAGED_CASES[1] + (False, False),
    "paged2-mha": PAGED_CASES[2] + (False, False),
    "holes-idle": (3, 40, 16, 12, 4, 2, 32, None, (190, 77, 30), True, True),
    "wide-ps8": (2, 48, 8, 20, 4, 2, 32, None, (157, 90), False, False),
    "ps16-window": (2, 24, 16, 9, 6, 2, 32, 50, (140, 33), False, False),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(PAGED_SPLIT_CASES))
def test_flash_decode_paged_split_ref_matches_pallas_kernel(name, dtype):
    """``ref.flash_decode_paged_split_ref`` (the plain per-page split and
    merge the one-launch paged kernel is held to on the card) against the
    Pallas kernel in interpret mode, (o, m, l): o within 1e-5 (f32) and 1e-2
    (bf16; both round each page's o to bf16) of max|o|, m on live rows and l
    within 1e-5; an idle row is exactly (0, NEG_INF, 0) on both sides."""
    *case, holes, idle = PAGED_SPLIT_CASES[name]
    jargs, args = _paged_inputs(tuple(case), dtype, list(PAGED_SPLIT_CASES).index(name),
                                holes=holes)
    B, H, hd = args[0].shape
    if idle:
        args = args[:4] + (args[4].clone(),)
        args[4][-1] = fd.NEG_INF
        jargs = jargs[:4] + (jnp.asarray(args[4].numpy()),)
    got = ref.flash_decode_paged_split_ref(*args, return_stats=True)
    want = jfd.flash_decode_paged(*jargs, interpret=True, return_stats=True)
    assert got[0].dtype == args[0].dtype and got[0].shape == (B, H, hd)
    _close(got[0], np.asarray(want[0], np.float32), TOL[dtype])
    live = np.asarray(want[1]) > fd.NEG_INF / 2
    assert np.array_equal(got[1].numpy() > fd.NEG_INF / 2, live)
    _close(got[1][torch.from_numpy(live)], np.asarray(want[1])[live], TOL["float32"])
    _close(got[2], np.asarray(want[2]), TOL["float32"])
    if idle:
        assert torch.all(got[0][-1] == 0) and torch.all(got[1][-1] <= fd.NEG_INF / 2)
        assert torch.all(got[2][-1] == 0)
        assert np.all(np.asarray(want[0][-1], np.float32) == 0) and not live[-1].any()


@pytest.mark.parametrize("paged", [False, True])
def test_fully_masked_rows(paged):
    """A row whose bias is NEG_INF everywhere gives (o, m, l) = (0, NEG_INF,
    0), as the kernels' guard (and the reference's kernels) give; the
    others are untouched."""
    if paged:
        jargs, args = _paged_inputs(PAGED_CASES[0], "float32", 3)
        args = args[:4] + (args[4].clone(),)
        args[4][1] = fd.NEG_INF
        jargs = jargs[:4] + (jnp.asarray(args[4].numpy()),)
        got = ops.flash_decode_paged(*args, return_stats=True)
        want = jops.flash_decode_paged(*jargs, interpret=True, return_stats=True)
    else:
        (jq, jk, jv, _), (q, k, v, _) = _dense_inputs(FD_CASES[1], "float32", 2)
        bias = torch.full((2, 256), fd.NEG_INF)
        bias[0] = 0.0
        got = ops.flash_decode(q, k, v, bias, return_stats=True)
        want = jops.flash_decode(jq, jk, jv, jnp.asarray(bias.numpy()), blk_k=64,
                                 interpret=True, return_stats=True)
    o, m, l = got
    assert torch.all(o[1] == 0.0) and torch.all(m[1] <= fd.NEG_INF / 2)
    assert torch.all(l[1] == 0.0)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), TOL["float32"])


@pytest.mark.parametrize("window", [None, 1, 5, 300])
def test_decode_bias_matches_reference(window):
    rng = np.random.default_rng(11)
    for pos, t in (
        (np.arange(64, dtype=np.int32), np.int32(40)),                     # shared row
        (np.where(rng.random(64) < 0.2, -1, np.arange(64)).astype(np.int32), np.int32(63)),
        (rng.integers(-1, 80, (3, 64)).astype(np.int32),                    # per slot
         np.array([0, 31, 79], np.int32)),
    ):
        want = jfd.decode_bias(jnp.asarray(pos), jnp.asarray(t), window=window)
        got = fd.decode_bias(torch.from_numpy(pos), torch.from_numpy(np.asarray(t)),
                             window=window)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ops.decode_bias(torch.arange(8, dtype=torch.int32), 5, window=window)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfd.decode_bias(jnp.arange(8, dtype=jnp.int32), 5,
                                                window=window)))


@pytest.mark.parametrize("window", [None, 3, 20])
def test_paged_bias_matches_reference(window):
    rng = np.random.default_rng(12)
    tbl = np.where(rng.random((4, 6)) < 0.3, -1, rng.integers(0, 30, (4, 6))).astype(np.int32)
    sl = np.array([0, 1, 17, 48], np.int32)
    want = jfd.paged_bias(jnp.asarray(tbl), jnp.asarray(sl), 8, window=window)
    got = ops.paged_bias(torch.from_numpy(tbl), torch.from_numpy(sl), 8, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_combine_splits_matches_reference():
    rng = np.random.default_rng(13)
    B, KV, S, G, hd = 3, 2, 5, 3, 16
    o = rng.standard_normal((B, KV, S, G, hd)).astype(np.float32)
    m = (3 * rng.standard_normal((B, KV, S, G))).astype(np.float32)
    l = rng.random((B, KV, S, G)).astype(np.float32) + 0.1
    # fully masked splits, and one row masked in every split
    m[0, 1, 2] = jfd.NEG_INF
    l[0, 1, 2] = 0.0
    m[1, 0] = jfd.NEG_INF
    l[1, 0] = 0.0
    o[1, 0] = 0.0
    want = jfd.combine_splits(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))
    got = fd.combine_splits(*(torch.from_numpy(a) for a in (o, m, l)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_pick_splits_matches_reference():
    for n_blocks in range(1, 25):
        for n_splits in range(1, 12):
            assert fd._pick_splits(n_blocks, n_splits) == jfd._pick_splits(n_blocks, n_splits)


# --------------------------------------------------- model-path parity --
def _cfgs(**kw):
    base = dict(arch_id="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64, **kw)
    return JModelConfig(**base), ModelConfig(**base)


def _attn_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = jcfg.d_model, jcfg.resolved_head_dim
    shapes = {"wk": (d, jcfg.n_kv_heads * hd), "wo": (jcfg.n_heads * hd, d),
              "wq": (d, jcfg.n_heads * hd), "wv": (d, jcfg.n_kv_heads * hd)}
    p = {k: {"w": (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)}
         for k, s in shapes.items()}
    return {k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}, params_from_numpy(p, "cpu")


def _cache_close(c, jc):
    c = kv_cache_to_numpy(c)
    np.testing.assert_allclose(c.k, np.asarray(jc.k), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c.v, np.asarray(jc.v), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(c.pos, np.asarray(jc.pos))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [None, 12])
def test_decode_attend_matches_reference(window, flash):
    """Token by token through a rolling window of 32 slots (14 steps, so the
    windowed run rolls past its window of 12)."""
    jcfg, cfg = _cfgs(sliding_window=window, use_flash_attention=flash)
    jp, p = _attn_params(jcfg, 0)
    B = 2
    jc = jatt.init_kv_cache(jcfg, B, 32, jnp.float32)
    c = att.init_kv_cache(cfg, B, 32, torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    for t in range(14):
        x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jatt.decode_attend(jp, jnp.asarray(x), t, jc, jcfg)
        y, c = att.decode_attend(p, torch.from_numpy(x), t, c, cfg)
        _close(y, np.asarray(jy), TOL["float32"])
    _cache_close(c, jc)


@pytest.mark.parametrize("flash", [False, True])
def test_decode_attend_ragged_matches_reference(flash):
    """Per-slot decode at staggered positions with a window, one slot idle
    every third step: outputs and caches equal the reference's."""
    jcfg, cfg = _cfgs(sliding_window=10, use_flash_attention=flash)
    jp, p = _attn_params(jcfg, 2)
    B = 3
    offsets = np.array([0, 2, 5], np.int32)
    jc = jatt.init_kv_cache(jcfg, B, 32, jnp.float32, ragged=True)
    c = att.init_kv_cache(cfg, B, 32, torch.float32, ragged=True, device="cpu")
    rng = np.random.default_rng(3)
    for step in range(8):
        x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        t = offsets + step
        active = np.array([True, step % 3 != 1, True])
        jy, jc = jatt.decode_attend_ragged(jp, jnp.asarray(x), jnp.asarray(t), jc, jcfg,
                                           active=jnp.asarray(active))
        y, c = att.decode_attend_ragged(p, torch.from_numpy(x), torch.from_numpy(t), c, cfg,
                                        active=torch.from_numpy(active))
        _close(y, np.asarray(jy), TOL["float32"])
        if flash and not active[1]:
            assert torch.all(y[1] == 0.0)   # fully masked attend: o = 0, no wo bias
    _cache_close(c, jc)


def test_cuda_wrappers_refuse_cpu_tensors_before_any_build():
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 64, 2, 32)
    bias = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(q, k, k, bias)
    pools = torch.zeros(4, 16, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_paged(q, pools, pools, torch.zeros(2, 4, dtype=torch.int32),
                              torch.zeros(2, 64))
    assert cg_fused._ext is None
