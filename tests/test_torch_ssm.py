"""The port's SSD scan and Mamba2 block against ``repro``.

* ``ssd_intra`` on the CPU (the kernel's plain version,
  ``kernels.ref.ssd_intra_ref``) against the reference's Pallas kernel in
  interpret mode, on the four cases of ``tests/test_ssd_kernel.py``: y, S
  and l within 1e-5 of their largest magnitude, g within 1e-5 relative with
  an absolute floor of 1e-30 (XLA on the CPU flushes the denormal g of a
  128-step chunk, about e^-100, to zero).
* ``ssd_chunked`` and ``ssd_chunked_pallas`` (its CPU route) against the
  reference's ``ssd_chunked`` and ``ssd_chunked_pallas(interpret=True)``,
  with and without h0, within 2e-4, the reference test's tolerance; the
  twin of ``test_models_property.py::test_ssd_chunked_equals_recurrence``.
* ``apply_mamba`` (from zero state and from a carried ``(h0, conv0)``,
  both SSD routes) and ``mamba_decode_step`` on zamba2's smoke widths
  against the reference, within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunked_pallas as j_ssd_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra as j_ssd_intra  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import mamba_cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import cg_fused, ops, ssd_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-5
# (B, L, H, N, P, chunk): the cases of tests/test_ssd_kernel.py
CASES = [
    (1, 64, 1, 16, 16, 16),
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 64, 128),
    (2, 64, 3, 16, 32, 64),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _t(a):
    return torch.tensor(np.asarray(a))


def _inputs(B, L, H, N, P):
    """The reference test's draws: u, log_a = -softplus(N(0,1)), B, C, h0."""
    ks = jax.random.split(jax.random.PRNGKey(L + H), 5)
    return dict(u=jax.random.normal(ks[0], (B, L, H, P)),
                log_a=-jax.nn.softplus(jax.random.normal(ks[1], (B, L, H))),
                Bv=jax.random.normal(ks[2], (B, L, N)) * 0.5,
                Cv=jax.random.normal(ks[3], (B, L, N)) * 0.5,
                h0=jax.random.normal(ks[4], (B, H, N, P)) * 0.3)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------- ssd_intra --
@pytest.mark.parametrize("case", CASES, ids=[f"chunk{c[-1]}" for c in CASES])
def test_plain_ssd_intra_matches_the_pallas_kernel(case):
    B, L, H, N, P, chunk = case
    x = _inputs(B, L, H, N, P)
    nc, Q = L // chunk, chunk
    u = jnp.asarray(x["u"]).reshape(B, nc, Q, H, P).transpose(0, 1, 3, 2, 4)
    la = jnp.asarray(x["log_a"]).reshape(B, nc, Q, H).transpose(0, 1, 3, 2)
    Bv, Cv = (x[k].reshape(B, nc, Q, N) for k in ("Bv", "Cv"))
    want = j_ssd_intra(u, la, Bv, Cv, interpret=True)
    got = ops.ssd_intra(*(_t(a) for a in (u, la, Bv, Cv)))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(g.dtype == torch.float32 for g in got)
    for name, g, w in zip("ySl", (got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert _rel(g, w) <= TOL, name
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=TOL, atol=1e-30)
    assert ops.LAUNCHES["ssd_intra"] == 0  # the CPU runs no kernel


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on the 13
    dropped bits of the significand, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_split(a, b):
    """a @ b as the kernel forms an f32 product on the tensor cores: each
    operand split as hi = tf32(x), lo = tf32(x - hi), lo·hi + hi·lo summed
    first, then hi·hi, every sum in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    """a @ b as one TF32 product (operands rounded to TF32, f32 sums)."""
    return _tf32(a) @ _tf32(b)


def _ssd_intra_emulated(u, log_a, Bv, Cv, mm):
    """(y, S) of the SSD intra-chunk step with every product formed by
    ``mm``: C·Bᵀ, the decayed causal triangle D in f32 (the mask selects),
    y = D·u and S = Bᵀ(u ∘ w), as ``csrc/ssd_scan.cu`` forms them."""
    l = torch.cumsum(log_a.double(), -1).float()
    Q = u.shape[3]
    cb = mm(Cv, Bv.transpose(-1, -2))[:, :, None]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    D = torch.where(causal, cb * torch.exp(l[..., :, None] - l[..., None, :]), 0.0)
    w = torch.exp(l[..., -1:] - l)
    return mm(D, u), mm(Bv.transpose(-1, -2)[:, :, None], u * w[..., None])


def _ssd_case(case, regime):
    """The reference test's inputs of one case, in the kernel's layout; the
    "model" regime draws log_a = -softplus(x - 2) from the same x."""
    B, L, H, N, P, chunk = case
    x = _inputs(B, L, H, N, P)
    if regime == "model":
        ks = jax.random.split(jax.random.PRNGKey(L + H), 5)
        x["log_a"] = -jax.nn.softplus(jax.random.normal(ks[1], (B, L, H)) - 2.0)
    nc, Q = L // chunk, chunk
    u = jnp.asarray(x["u"]).reshape(B, nc, Q, H, P).transpose(0, 1, 3, 2, 4)
    la = jnp.asarray(x["log_a"]).reshape(B, nc, Q, H).transpose(0, 1, 3, 2)
    Bv, Cv = (x[k].reshape(B, nc, Q, N) for k in ("Bv", "Cv"))
    return u, la, Bv, Cv


@pytest.mark.parametrize("regime", ["reference", "model"])
@pytest.mark.parametrize("case", CASES, ids=[f"chunk{c[-1]}" for c in CASES])
def test_split_tf32_ssd_intra_matches_the_pallas_kernel(case, regime):
    """The kernel's numeric scheme (split TF32 products, decay applied to
    C·Bᵀ in f32), emulated in torch, against the reference's Pallas kernel
    in interpret mode: y and S within 1e-5 of their largest magnitude, in
    both log_a regimes."""
    u, la, Bv, Cv = _ssd_case(case, regime)
    want = j_ssd_intra(u, la, Bv, Cv, interpret=True)
    y, S = _ssd_intra_emulated(*(_t(a) for a in (u, la, Bv, Cv)), _mm_split)
    assert _rel(y, want[0]) <= TOL
    assert _rel(S, want[1]) <= TOL


def test_plain_tf32_ssd_intra_misses_the_gate():
    """One TF32 product (no split) is not enough: y is off by far more than
    1e-5 of max|y| on the reference's chunk-128 case, which the split
    scheme holds."""
    u, la, Bv, Cv = _ssd_case(CASES[2], "reference")
    want = j_ssd_intra(u, la, Bv, Cv, interpret=True)
    args = [_t(a) for a in (u, la, Bv, Cv)]
    y1, S1 = _ssd_intra_emulated(*args, _mm_tf32)
    y3, S3 = _ssd_intra_emulated(*args, _mm_split)
    assert _rel(y1, want[0]) > 10 * TOL and _rel(S1, want[1]) > 10 * TOL
    assert _rel(y3, want[0]) <= TOL and _rel(S3, want[1]) <= TOL


def test_plain_ssd_intra_rounds_the_cumsum_once_and_runs_in_float64():
    """l is the float64 cumsum rounded to f32 (the kernel's sum), and a
    float64 call computes every output in float64."""
    rng = np.random.default_rng(0)
    u = torch.tensor(rng.standard_normal((1, 2, 3, 128, 8)), dtype=torch.float32)
    la = -torch.nn.functional.softplus(torch.tensor(rng.standard_normal((1, 2, 3, 128)),
                                                    dtype=torch.float32))
    Bv, Cv = (torch.tensor(rng.standard_normal((1, 2, 128, 4)), dtype=torch.float32)
              for _ in range(2))
    y, S, g, l = ops.ssd_intra(u, la, Bv, Cv)
    assert torch.equal(l, torch.cumsum(la.double(), -1).float())
    y64, S64, g64, l64 = ops.ssd_intra(u.double(), la, Bv.double(), Cv.double())
    assert {t.dtype for t in (y64, S64, g64, l64)} == {torch.float64}
    assert _rel(y, y64) <= TOL and _rel(S, S64) <= TOL and _rel(l, l64) <= 1e-7
    # bf16 B and C are widened: the same as f32 inputs holding the bf16 values
    yb = ops.ssd_intra(u, la, Bv.bfloat16(), Cv.bfloat16())[0]
    yf = ops.ssd_intra(u, la, Bv.bfloat16().float(), Cv.bfloat16().float())[0]
    assert torch.equal(yb, yf)


# ----------------------------------------------------------- chunked SSD --
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("route", ["ssd_chunked", "ssd_chunked_pallas"])
@pytest.mark.parametrize("case", CASES, ids=[f"chunk{c[-1]}" for c in CASES])
def test_chunked_ssd_matches_the_reference(case, route, with_h0):
    B, L, H, N, P, chunk = case
    x = _inputs(B, L, H, N, P)
    h0 = x["h0"] if with_h0 else None
    args = (x["u"], x["log_a"], x["Bv"], x["Cv"], chunk)
    if route == "ssd_chunked":
        want = jssm.ssd_chunked(*args, h0=h0)
        got = ssm.ssd_chunked(*(_t(a) for a in args[:4]), chunk,
                              h0=None if h0 is None else _t(h0))
    else:
        want = j_ssd_pallas(*args, h0=h0, interpret=True)
        got = ops.ssd_chunked_pallas(*(_t(a) for a in args[:4]), chunk,
                                     h0=None if h0 is None else _t(h0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L,chunk,H,N,P,seed", [
    (8, 4, 1, 4, 4, 0),
    (8, 8, 2, 16, 8, 1),
    (32, 8, 3, 4, 8, 2),
    (32, 16, 1, 16, 4, 3),
    (64, 16, 4, 16, 8, 4),
    (64, 4, 2, 4, 4, 5),
])
def test_ssd_chunked_equals_recurrence(L, chunk, H, N, P, seed):
    """The twin of the reference's property test: the chunked form equals
    the one-token recurrence ``ssd_step``, on the reference's draws."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    B = 2
    u = _t(jax.random.normal(ks[0], (B, L, H, P)))
    log_a = _t(-jax.nn.softplus(jax.random.normal(ks[1], (B, L, H))))
    Bv = _t(jax.random.normal(ks[2], (B, L, N)))
    Cv = _t(jax.random.normal(ks[3], (B, L, N)))
    y_chunk, h_chunk = ssm.ssd_chunked(u, log_a, Bv, Cv, chunk)
    state = torch.zeros((B, H, N, P))
    ys = []
    for t in range(L):
        y_t, state = ssm.ssd_step(u[:, t], log_a[:, t], Bv[:, t], Cv[:, t], state)
        ys.append(y_t)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h_chunk.numpy(), state.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_chunked_gradient_is_finite_where_the_upper_decay_overflows():
    """The exponent is masked before exp: with steps of log decay -60 the
    upper triangle's exp(l_i - l_j) would overflow f32, and a mask applied
    to exp's result would give 0·inf = NaN in the gradient. Where nothing
    overflows, the gradient equals the reference's."""
    rng = np.random.default_rng(3)
    u = rng.standard_normal((1, 16, 2, 4)).astype(np.float32)
    Bv, Cv = (rng.standard_normal((1, 16, 4)).astype(np.float32) for _ in range(2))

    def port_grads(log_a):
        xs = [torch.tensor(a, requires_grad=True) for a in (u, log_a, Bv, Cv)]
        y, h = ssm.ssd_chunked(*xs, 16)
        (y.square().sum() + h.sum()).backward()
        return [x.grad for x in xs]

    steep = np.full((1, 16, 2), -60.0, np.float32)
    assert all(bool(torch.isfinite(g).all()) for g in port_grads(steep))
    mild = (-np.log1p(np.exp(rng.standard_normal((1, 16, 2))))).astype(np.float32)

    def loss(u_, la_, b_, c_):
        y, h = jssm.ssd_chunked(u_, la_, b_, c_, 16)
        return jnp.sum(y ** 2) + jnp.sum(h)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(u, mild, Bv, Cv)
    for g, w in zip(port_grads(mild), want):
        assert _rel(g, w) <= 1e-5


def test_ssd_chunked_pallas_is_forward_only():
    u = torch.zeros((1, 16, 1, 4), requires_grad=True)
    la, Bv = torch.zeros((1, 16, 1)), torch.zeros((1, 16, 4))
    with pytest.raises(RuntimeError, match="forward only"):
        ops.ssd_chunked_pallas(u, la, Bv, Bv, 16)
    with torch.no_grad():
        y, h = ops.ssd_chunked_pallas(u, la, Bv, Bv, 16)
    assert y.shape == (1, 16, 1, 4) and h.shape == (1, 1, 4, 4)


@pytest.mark.parametrize("shape,bdtype,match", [
    ((1, 1, 2, 129, 16), torch.float32, "from 1 to 128"),
    ((1, 1, 2, 128, 256), torch.float32, "shared memory"),
    ((1, 1, 2, 16, 16), torch.float16, "float32 or both bfloat16"),
], ids=["chunk", "smem", "dtype"])
def test_ssd_intra_wrapper_rejects_what_the_kernel_does_not_take(shape, bdtype, match,
                                                                 monkeypatch):
    """Checked as if the tensors were on the card: after the device check
    and before any build."""
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    B, nc, H, Q, P = shape
    N = 256 if match == "shared memory" else 16
    u, la = torch.zeros(shape), torch.zeros((B, nc, H, Q))
    Bv = torch.zeros((B, nc, Q, N), dtype=bdtype)
    with pytest.raises((ValueError, TypeError), match=match):
        ssd_scan.ssd_intra(u, la, Bv, Bv)
    assert cg_fused._ext is None


def test_ssd_intra_wrapper_refuses_cpu_tensors_without_a_build():
    t = torch.zeros((1, 1, 1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_intra(t, torch.zeros((1, 1, 1, 4)), torch.zeros((1, 1, 4, 4)),
                           torch.zeros((1, 1, 4, 4)))
    assert cg_fused._ext is None
    assert ssd_scan.smem_bytes(128, 64, 64) == 112_640  # the slice's shape: two blocks an SM


# ---------------------------------------------------------- Mamba2 block --
@pytest.fixture(scope="module")
def block():
    """zamba2's smoke widths (d 128, d_inner 256: 16 heads of 16, N 16,
    chunk 16): the reference's block weights and inputs, and the port's
    copies."""
    jcfg = jconfigs.get_smoke_config("zamba2-7b")
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 40, jcfg.d_model)))
    return dict(jcfg=jcfg, jp=jp, x=x, cfg=configs.get_smoke_config("zamba2-7b"),
                tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"))


def test_mamba_init_tree_equals_the_reference(block):
    gen = torch.Generator().manual_seed(0)
    mine = ssm.mamba_init(gen, block["cfg"], torch.bfloat16, lead=(3,))
    want = jssm.mamba_init(jax.random.PRNGKey(0), block["jcfg"], jnp.bfloat16)
    assert list(mine) == sorted(want)
    for k in mine:
        for a, b in zip(jax.tree_util.tree_leaves(mine[k]), jax.tree_util.tree_leaves(want[k])):
            assert tuple(a.shape) == (3,) + tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)


@pytest.mark.parametrize("ssd_kernel", [False, True], ids=["ssd_chunked", "kernel_route"])
def test_apply_mamba_matches_the_reference(block, ssd_kernel):
    """16 tokens, then 24 more from their (h0, conv0) (chunk 16 falls back
    to 12), and all 40 at once (chunk 10), against the reference."""
    jcfg, jp, tp, x = block["jcfg"], block["jp"], block["tp"], block["x"]
    jy, jc = jssm.apply_mamba(jp, jnp.asarray(x[:, :16]), jcfg)
    jy2, jc2 = jssm.apply_mamba(jp, jnp.asarray(x[:, 16:]), jcfg, h0=jc.state, conv0=jc.conv)
    with torch.no_grad():
        y, c = ssm.apply_mamba(tp, _t(x[:, :16]), block["cfg"], ssd_kernel=ssd_kernel)
        y2, c2 = ssm.apply_mamba(tp, _t(x[:, 16:]), block["cfg"], h0=c.state, conv0=c.conv,
                                 ssd_kernel=ssd_kernel)
        yf, cf = ssm.apply_mamba(tp, _t(x), block["cfg"], ssd_kernel=ssd_kernel)
        jyf, jcf = jssm.apply_mamba(jp, jnp.asarray(x), jcfg)
    for got, want in ((y, jy), (y2, jy2), (yf, jyf), *zip(c, jc), *zip(c2, jc2), *zip(cf, jcf)):
        assert _rel(got, want) <= TOL


def test_mamba_decode_step_matches_the_reference_and_writes_in_place(block):
    jcfg, jp, tp, x = block["jcfg"], block["jp"], block["tp"], block["x"]
    _, jc = jssm.apply_mamba(jp, jnp.asarray(x[:, :8]), jcfg)
    cache = mamba_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    conv_buf, state_buf = cache.conv, cache.state
    for t in range(8, 12):
        jy, jc = jssm.mamba_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        with torch.no_grad():
            y, cache = ssm.mamba_decode_step(tp, _t(x[:, t:t + 1]), cache, block["cfg"])
        assert _rel(y, jy) <= TOL
        assert _rel(cache.conv, jc.conv) <= TOL and _rel(cache.state, jc.state) <= TOL
    assert cache.conv is conv_buf and cache.state is state_buf
    assert cache.state.dtype == torch.float32
