"""The port's flash attention against the reference's.

* The plain versions (``repro_torch.kernels.ref``, what ``ops`` runs for
  CPU tensors) against the Pallas kernels in interpret mode, as
  ``tests/test_kernels.py`` runs them: forward (o, lse), dQ, dK/dV per
  q-head and JVP (g, t), f32, within 1e-5 of the largest magnitude; and
  with bf16 inputs, where both round P and dS (the JVP's R and P) to bf16
  before the second product: f32 outputs within 1e-4, bf16 outputs within
  4e-3 (half a bf16 ulp at the largest magnitude); forward, dQ and JVP
  also on the case with fully masked rows and on the non-causal case, and
  dK/dV on those two within 5e-4, a gate that the unrounded version
  misses.
* The two autograd Functions of ``kernels.flash_ad``: gradient, forward-mode
  JVP, the backward of the backward in dO (the GN product's J·v), and the
  second-order route under ``second_order_tangents()``.
* The CUDA wrappers refuse what the kernels do not take, before any build.
"""
import functools

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, jvp  # noqa: E402

from repro.kernels.ops import fa as jfa  # noqa: E402  (the Pallas module)
from repro_torch.kernels import cg_fused, flash_ad, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.attention import _sdpa, causal_mask  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")  # no TF32 in a parity run
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


# (B, S, H, KV, hd, causal, window, valid_len, bias). "ragged" is S = 130
# as flash_mha hands it to the kernels: zero-padded to 256, valid_len 130.
CASES = {
    "gqa": (1, 256, 4, 2, 32, True, None, None, False),
    "window": (1, 256, 2, 2, 32, True, 64, None, False),
    "ragged": (1, 256, 2, 1, 32, True, None, 130, False),
    "bias": (1, 128, 2, 1, 32, False, None, None, True),
    "noncausal": (1, 128, 4, 4, 32, False, None, None, False),
    # head dims between the kernels' register widths: zamba2-7b's 112 and
    # phi-3-vision's 96
    "hd112": (1, 128, 2, 2, 112, True, None, None, False),
    "hd96": (1, 128, 4, 2, 96, True, None, None, False),
}
KERNELS = ("fwd", "dq", "dkv", "jvp")
# bf16 cases, and the tolerance of each output type. In "bias" and
# "noncausal" (not here) the two sides' f32 scores differ in summation order
# by enough to round a few P entries to neighbouring bf16 values, each moving
# an element of dv_h by up to p·2⁻⁸·|dO|: dk_h and dv_h agree there within
# 2.3e-4 (1.7e-3 to 2.1e-3 without the rounding).
BF16_CASES = ("gqa", "hd112", "hd96", "ragged", "window")
BF16_TOL = {torch.bfloat16: 4e-3, torch.float32: 1e-4}
# The kernels that hold "bias" (fully masked rows, a masked patch) in bf16 at
# BF16_TOL: dK/dV does not (dk_h 2.25e-4 apart, the rounding flips above),
# so "bias" stays out of BF16_CASES.
BF16_BIAS_KERNELS = ("fwd", "dq", "jvp")


@functools.lru_cache(maxsize=None)
def _case(name, dtype="float32"):
    """Inputs from a seed (rounded to bf16 for ``dtype`` "bfloat16"), and
    every output of the Pallas kernels on them."""
    B, S, H, KV, hd, causal, window, valid_len, with_bias = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    a = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(q=a(B, S, H, hd), k=a(B, S, KV, hd), v=a(B, S, KV, hd), do=a(B, S, H, hd),
             qt=a(B, S, H, hd), kt=a(B, S, KV, hd), vt=a(B, S, KV, hd))
    if valid_len is not None:
        for n in x:
            x[n][:, valid_len:] = 0.0
    if dtype == "bfloat16":
        x = {n: t.astype(ml_dtypes.bfloat16) for n, t in x.items()}
    kw = dict(causal=causal, window=window, valid_len=valid_len, bias=None)
    if with_bias:
        bias = np.zeros((1, S, S), np.float32)
        bias[0, 5] = -1e30                  # a fully masked row
        bias[0, 9, 3:40] = -1e30
        kw["bias"] = bias
    jkw = dict(kw, blk_q=128, blk_k=128, interpret=True,
               bias=None if kw["bias"] is None else jnp.asarray(kw["bias"]))
    o, lse = jfa.flash_attention_fwd(x["q"], x["k"], x["v"], **jkw)
    delta = np.einsum("bshd,bshd->bhs", np.asarray(o, np.float32),
                      x["do"].astype(np.float32)).astype(np.float32)
    out = {
        "fwd": (o, lse),
        "dq": (jfa.flash_attention_dq(x["q"], x["k"], x["v"], x["do"], lse, delta, **jkw),),
        "dkv": jfa.flash_attention_dkv(x["q"], x["k"], x["v"], x["do"], lse, delta, **jkw),
        "jvp": jfa.flash_attention_jvp(x["q"], x["k"], x["v"], x["qt"], x["kt"], x["vt"],
                                       lse, **jkw),
    }
    out = {k: [np.asarray(t) for t in v] for k, v in out.items()}
    return x, kw, np.asarray(lse), delta, out


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.tensor(a.astype(np.float32)).bfloat16()  # exact
    return torch.tensor(a)


def _assert_close(got, want, tol=TOL):
    for g, w in zip(got, want):
        g, w = g.detach().double().numpy(), np.asarray(w, np.float64)
        assert g.shape == w.shape
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, err


def _plain_and_pallas(case, kernel, dtype="float32"):
    """(the plain version's outputs through ``ops``, the Pallas kernel's)."""
    x, kw, lse, delta, want = _case(case, dtype)
    t = {n: _t(v) for n, v in x.items()}
    tkw = dict(kw, bias=None if kw["bias"] is None else _t(kw["bias"]))
    L, D = _t(lse), _t(delta)
    got = {
        "fwd": lambda: ops.flash_attention_fwd(t["q"], t["k"], t["v"], **tkw),
        "dq": lambda: (ops.flash_attention_dq(t["q"], t["k"], t["v"], t["do"], L, D, **tkw),),
        "dkv": lambda: ops.flash_attention_dkv(t["q"], t["k"], t["v"], t["do"], L, D, **tkw),
        "jvp": lambda: ops.flash_attention_jvp(t["q"], t["k"], t["v"], t["qt"], t["kt"],
                                               t["vt"], L, **tkw),
    }[kernel]()
    assert ops.LAUNCHES[f"flash_attention_{kernel}"] == 0  # the CPU runs no kernel
    return got, want[kernel]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_kernel(case, kernel):
    _assert_close(*_plain_and_pallas(case, kernel))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("case", BF16_CASES)
def test_plain_version_matches_pallas_kernel_in_bf16(case, kernel):
    """bf16 inputs: the plain versions round the weights where the
    reference's kernels round them (1.1e-3 to 2.3e-3 apart in dk_h, dv_h
    and g without that), and return the kernels' output types."""
    got, want = _plain_and_pallas(case, kernel, "bfloat16")
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if w.dtype == ml_dtypes.bfloat16 else torch.float32)
        _assert_close([g], [w], BF16_TOL[g.dtype])


@pytest.mark.parametrize("kernel", BF16_BIAS_KERNELS)
def test_plain_version_matches_pallas_kernel_in_bf16_with_masked_rows(kernel):
    """bf16 inputs on the "bias" case: fully masked rows, where the kernels'
    guard gives o = 0 and lse = 0, and the JVP's R and P are zero."""
    got, want = _plain_and_pallas("bias", kernel, "bfloat16")
    for g, w in zip(got, want):
        _assert_close([g], [w], BF16_TOL[g.dtype])


@pytest.mark.parametrize("kernel", ("fwd", "dq", "jvp"))
def test_plain_version_matches_pallas_kernel_in_bf16_noncausal(kernel):
    """bf16 inputs on the "noncausal" case (no mask at all) at BF16_TOL."""
    got, want = _plain_and_pallas("noncausal", kernel, "bfloat16")
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if w.dtype == ml_dtypes.bfloat16 else torch.float32)
        _assert_close([g], [w], BF16_TOL[g.dtype])


# The gate of bf16 dK/dV on "bias" and "noncausal", set before the run: 5e-4
# of max|·| for dk_h and dv_h (both f32). Above the 2.3e-4 that the rounding
# flips of P leave (see BF16_CASES), below the 1.7e-3 of a plain version that
# rounds neither P nor dS, so that it still tells the two apart.
BF16_DKV_TOL = 5e-4


@pytest.mark.parametrize("case", ["bias", "noncausal"])
def test_bf16_dkv_holds_a_gate_that_the_unrounded_version_misses(case):
    """bf16 dK/dV on the two cases BF16_CASES leaves out, within
    BF16_DKV_TOL of the Pallas kernel's; the plain version on the same bf16
    values widened to f32 (where it rounds neither P nor dS) misses that
    gate in both outputs."""
    got, want = _plain_and_pallas(case, "dkv", "bfloat16")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _assert_close([g], [w], BF16_DKV_TOL)
    x, kw, lse, delta, _ = _case(case, "bfloat16")
    t = {n: _t(v).float() for n, v in x.items()}
    tkw = dict(kw, bias=None if kw["bias"] is None else _t(kw["bias"]))
    unrounded = ops.flash_attention_dkv(t["q"], t["k"], t["v"], t["do"], _t(lse), _t(delta),
                                        **tkw)
    for u, w in zip(unrounded, want):
        w = np.asarray(w, np.float64)
        assert np.abs(u.double().numpy() - w).max() / np.abs(w).max() > BF16_DKV_TOL


# ------------------------------------------------------- the Functions --
B, S, H, KV, HD = 2, 40, 4, 2, 32


def _qkv(seed=0, S=S):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, S, H, HD), (B, S, KV, HD), (B, S, KV, HD))]


def _plain(q, k, v):
    return _sdpa(q, k, v, causal_mask(q.shape[1], device="cpu"))


def _flash(q, k, v):
    return flash_ad.flash_mha(q, k, v, causal=True)


def _loss(attn):
    w = torch.tensor(np.random.default_rng(9).standard_normal((B, S, H, HD)),
                     dtype=torch.float32)
    return lambda q, k, v: (attn(q, k, v) * w).sum() + (attn(q, k, v) ** 2).sum()


@pytest.mark.parametrize("seq", [40, 130], ids=["S40", "S130-padded"])
def test_gradient_through_flash_function_matches_sdpa(seq):
    q, k, v = _qkv(1, seq)
    for t in (q, k, v):
        t.requires_grad_(True)
    f = lambda attn: (attn(q, k, v) ** 2).sum()
    g_flash = torch.autograd.grad(f(_flash), (q, k, v))
    g_plain = torch.autograd.grad(f(_plain), (q, k, v))
    _assert_close(g_flash, [g.numpy() for g in g_plain])


def test_forward_mode_jvp_matches_the_plain_jvp():
    q, k, v = _qkv(2)
    tangents = _qkv(3)
    o, ot = jvp(_flash, (q, k, v), tuple(tangents))
    _, lse = ref.flash_attention_fwd_ref(q, k, v, causal=True)
    g, t = ref.flash_attention_jvp_ref(q, k, v, *tangents, lse, causal=True)
    _assert_close([ot], [(g - t.transpose(1, 2)[..., None] * o).numpy()])
    _, ot_plain = jvp(_plain, (q, k, v), tuple(tangents))
    _assert_close([ot], [ot_plain.numpy()])


def test_backward_of_backward_in_do_is_the_jvp():
    """J·v of the GN product: the backward, with respect to the cotangent u,
    of the graph of Jᵀu."""
    q, k, v = (t.requires_grad_(True) for t in _qkv(4))
    tangents = _qkv(5)
    o = _flash(q, k, v)
    u = torch.zeros_like(o, requires_grad=True)
    jt = torch.autograd.grad(o, (q, k, v), grad_outputs=u, create_graph=True)
    jv = torch.autograd.grad(jt, u, grad_outputs=tangents)[0]
    _, ot = jvp(_plain, tuple(t.detach() for t in (q, k, v)), tuple(tangents))
    _assert_close([jv], [ot.numpy()])


@pytest.mark.parametrize("order", ["reverse-over-reverse", "forward-over-reverse"])
def test_hessian_product_under_second_order_tangents_matches_sdpa(order):
    q, k, v = _qkv(6)
    tangents = tuple(_qkv(7))

    def hvp(attn):
        f = _loss(attn)
        if order == "forward-over-reverse":
            return jvp(grad(f, argnums=(0, 1, 2)), (q, k, v), tangents)[1]
        prim = [t.clone().requires_grad_(True) for t in (q, k, v)]
        g = torch.autograd.grad(f(*prim), prim, create_graph=True)
        return torch.autograd.grad(g, prim, grad_outputs=tangents)

    with flash_ad.second_order_tangents():
        assert flash_ad.second_order_active()
        got = hvp(_flash)
    assert not flash_ad.second_order_active()
    _assert_close(got, [h.numpy() for h in hvp(_plain)])


def test_forward_over_reverse_outside_the_context_raises():
    q, k, v = _qkv(8)
    with pytest.raises(NotImplementedError, match="second_order_tangents"):
        jvp(grad(_loss(_flash), argnums=(0, 1, 2)), (q, k, v), tuple(_qkv(9)))


def test_chunked_route_matches_sdpa_with_bias_and_window():
    q, k, v = _qkv(10)
    mask = causal_mask(S, window=16, device="cpu")
    mask = mask & torch.tensor(np.random.default_rng(0).random((1, 1, S, S)) > 0.2)
    bias = torch.where(mask[:, 0], 0.0, flash_ad.NEG_INF)
    with flash_ad.second_order_tangents():
        got = flash_ad.flash_mha(q, k, v, causal=False, bias=bias, blk=16)
    _assert_close([got], [_sdpa(q, k, v, mask).numpy()])


def test_position_mask_is_the_plain_versions_mask():
    qp = torch.arange(40)[:, None]
    kp = torch.arange(50)[None, :]
    for kw in (dict(causal=True, window=None, valid_len=None),
               dict(causal=True, window=7, valid_len=None),
               dict(causal=False, window=None, valid_len=33)):
        assert torch.equal(flash_ad.position_mask(qp, kp, **kw),
                           ref._ref_mask(40, 50, device="cpu", **kw))


# ---------------------------------------------------------- wrappers --
def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    q, k, v = _qkv(0)
    lse = torch.zeros(B, H, S)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_dq(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_dkv(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_jvp(q, k, v, q, k, v, lse)
    assert cg_fused._ext is None  # nothing was compiled


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 8, 2, 44), torch.float32, "head dim"),
    ((1, 8, 2, 136), torch.float32, "head dim"),
    ((1, 8, 2, 32), torch.float16, "float32 or bfloat16"),
    ((8, 2, 32), torch.float32, "4-D"),
], ids=["head-dim", "head-dim-above-128", "dtype", "ndim"])
def test_flash_wrapper_rejects_what_the_kernels_do_not_take(shape, dtype, match, monkeypatch):
    """Checked as if the tensors were on the card: the shape and dtype
    checks come after the device check and before any build."""
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    t = torch.zeros(shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.flash_attention_fwd(t, t, t)
    assert cg_fused._ext is None


def test_ops_refuses_other_devices():
    t = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention_fwd(t, t, t)
