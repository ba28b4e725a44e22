"""The port's block layer against the reference: the block ops of both Krylov
backends (``repro_torch.core.krylov`` against ``repro.core.krylov``, the
JAX flat backend in Pallas interpret mode), the block curvature products
(``core/blocks.py``: a block of s tangents equals s single products, in
every curvature mode), and the free spectral estimates
(``ritz_from_segment``, ``leja_order``).

Block ops and block products agree to 1e-5 relative to the largest entry;
Leja order exactly; Ritz values to 1e-5 relative to the largest one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import blocks as jblocks, curvature as jcurv  # noqa: E402
from repro.core import krylov as jkrylov, sstep as jsstep  # noqa: E402
from repro.data import classification_dataset as jax_dataset  # noqa: E402
from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch.core import blocks, curvature as curv, krylov, sstep  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402

N = 14  # a tree {"a": (5,), "b": (3, 3)}
DIMS = (8, 12, 4)
B = 24


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jvec(x):
    x = jnp.asarray(x, jnp.float32)
    return {"a": x[:5], "b": x[5:].reshape(3, 3)}


def _tvec(x):
    x = torch.tensor(np.asarray(x, np.float32))
    return {"a": x[:5], "b": x[5:].reshape(3, 3)}


def _rows(n, seed):
    return np.random.default_rng(seed).standard_normal((n, N)).astype(np.float32)


def _backends(kind):
    """(reference backend, port backend) of one kind for N-vectors."""
    jt, tt = _jvec(np.zeros(N)), _tvec(np.zeros(N))
    return (jkrylov.get_backend(kind, template=jt, interpret=True),
            krylov.get_backend(kind, template=tt))


def _close(t, j, tol=1e-5):
    t = np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.max(np.abs(j))), 1e-30)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


def _np(ttree):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), ttree)


def _close_trees(ttree, jtree, tol=1e-5):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    scale = max(float(np.max(np.abs(np.asarray(l)))) for l in jl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0,
                                   atol=tol * scale)


def _blocks(kind, X):
    """The rows of X as a block of each package's backend."""
    jbe, tbe = _backends(kind)
    jb = jbe.block_stack([jbe.lift(_jvec(r)) for r in X])
    tb = tbe.block_stack([tbe.lift(_tvec(r)) for r in X])
    return jbe, tbe, jb, tb


# ---------------------------------------------------------------- block ops --
@pytest.mark.parametrize("kind", ["tree", "flat"])
@pytest.mark.parametrize("su,sv", [(3, 3), (2, 3), (5, 8)])
def test_gram_matches_reference_and_float64(kind, su, sv):
    X = _rows(su + sv, su * 10 + sv)
    jbe, tbe, _, _ = _blocks(kind, X[:1])
    U = [X[i] for i in range(su)]
    V = [X[su + i] for i in range(sv)]
    jG = jbe.gram(jbe.block_stack([jbe.lift(_jvec(r)) for r in U]),
                  jbe.block_stack([jbe.lift(_jvec(r)) for r in V]))
    tG = tbe.gram(tbe.block_stack([tbe.lift(_tvec(r)) for r in U]),
                  tbe.block_stack([tbe.lift(_tvec(r)) for r in V]))
    _close(tG, jG)
    _close(tG, np.stack(U).astype(np.float64) @ np.stack(V).astype(np.float64).T)


@pytest.mark.parametrize("kind", ["tree", "flat"])
def test_block_combine_and_col_match_reference(kind):
    X = _rows(4, 1)
    C = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    jbe, tbe, jb, tb = _blocks(kind, X)
    jo = jbe.block_combine(jnp.asarray(C), jb)
    to = tbe.block_combine(torch.from_numpy(C), tb)
    for i in range(3):
        _close_trees(tbe.lower(tbe.block_col(to, i)) if kind == "flat"
                     else tbe.block_col(to, i),
                     jbe.lower(jbe.block_col(jo, i)) if kind == "flat"
                     else jbe.block_col(jo, i))


def test_flat_block_layout_matches_reference_leaf_order():
    """lift_block/lower_block keep JAX's sorted-key leaf order, so a flat
    block is the reference's matrix entry for entry and lowers back to the
    tree backend's stacked tree exactly."""
    X = _rows(4, 3)
    jbe, tbe = _backends("flat")
    jstack = jblocks.stack_tangents([_jvec(r) for r in X])
    tstack = blocks.stack_tangents([_tvec(r) for r in X])
    M = tbe.lift_block(tstack)
    np.testing.assert_array_equal(M.numpy(), np.asarray(jbe.lift_block(jstack)))
    back = tbe.lower_block(M)
    for a, b in zip(tree_leaves(back), tree_leaves(tstack)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(blocks.unstack_tangents(tstack)[2]), tree_leaves(_tvec(X[2]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["tree", "flat"])
def test_wrap_block_op_and_pair_apply_match_reference(kind):
    Q = np.random.default_rng(4).standard_normal((N, N)).astype(np.float32)
    Mj, Mt = jnp.asarray(Q), torch.from_numpy(Q)

    def jop(v):
        return _jvec(Mj @ jnp.concatenate([v["a"], v["b"].reshape(-1)]))

    def top(v):
        y = Mt @ torch.cat([v["a"], v["b"].reshape(-1)])
        return {"a": y[:5], "b": y[5:].reshape(3, 3)}

    X = _rows(2, 5)
    jbe, tbe, jb, tb = _blocks(kind, X)
    jo = jbe.wrap_block_op(jblocks.block_op_from_single(jop))(jb)
    to = tbe.wrap_block_op(blocks.block_op_from_single(top))(tb)
    _close(tbe.gram(to, to), jbe.gram(jo, jo))
    jpair = jblocks.pair_apply(jbe, jbe.wrap_op(jop), jbe.wrap_block_op(jax.vmap(jop)))
    tpair = blocks.pair_apply(tbe, tbe.wrap_op(top), tbe.wrap_block_op(
        blocks.block_op_from_single(top)))
    for jv, tv in zip(jpair(jbe.block_col(jb, 0), jbe.block_col(jb, 1)),
                      tpair(tbe.block_col(tb, 0), tbe.block_col(tb, 1))):
        _close(tbe.dot(tv, tv), jbe.dot(jv, jv))


# ----------------------------------------------------------- block curvature --
@pytest.fixture(scope="module")
def mlp():
    jm = jax_build_mlp(DIMS)
    jp = jm.init(jax.random.PRNGKey(1))
    jb = jax_dataset(jax.random.PRNGKey(0), B, DIMS[0], DIMS[-1])
    rng = np.random.default_rng(7)
    tangents = [[{"b": rng.standard_normal(o).astype(np.float32),
                  "w": rng.standard_normal((i, o)).astype(np.float32)}
                 for i, o in zip(DIMS[:-1], DIMS[1:])] for _ in range(3)]
    return dict(
        jm=jm, tm=build_mlp(DIMS, device="cpu"), jp=jp, jb=jb,
        tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        tb=batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu"),
        jv=[jax.tree_util.tree_map(jnp.asarray, t) for t in tangents],
        tv=[params_from_numpy(t, "cpu") for t in tangents],
    )


BLOCK_MODES = [("naive", 0), ("linearize", 0), ("chunked", 10)]


@pytest.mark.parametrize("kind", ["hvp", "gnvp"])
@pytest.mark.parametrize("mode,chunk", BLOCK_MODES)
def test_block_product_matches_singles_and_reference(mlp, kind, mode, chunk):
    s = mlp
    kw = dict(mode=mode, chunk_size=chunk)
    if kind == "hvp":
        single = curv.make_hvp_op(s["tm"].loss_fn, s["tp"], s["tb"], **kw)
        blk = blocks.make_block_hvp_op(s["tm"].loss_fn, s["tp"], s["tb"], **kw)
        jblk = jblocks.make_block_hvp_op(s["jm"].loss_fn, s["jp"], s["jb"], **kw)
    else:
        args_t = (s["tm"].logits_fn, s["tm"].out_loss_fn, s["tp"], s["tb"])
        args_j = (s["jm"].logits_fn, s["jm"].out_loss_fn, s["jp"], s["jb"])
        single = curv.make_gnvp_op(*args_t, **kw)
        blk = blocks.make_block_gnvp_op(*args_t, **kw)
        jblk = jblocks.make_block_gnvp_op(*args_j, **kw)
    out = blk(blocks.stack_tangents(s["tv"]))
    for got, v in zip(blocks.unstack_tangents(out), s["tv"]):
        _close_trees(got, _np(single(v)))
    _close_trees(out, jblk(jblocks.stack_tangents(s["jv"])))


def test_damped_block_shares_the_cached_graph(mlp):
    """block_op_from_single(make_damped(G, λ)) is G's block plus λ·V from the
    graph built once: applying it runs no primal pass."""
    s = mlp
    calls = {"n": 0}

    def counting_loss(p, b):
        calls["n"] += 1
        return s["tm"].loss_fn(p, b)

    lam = 3.0
    G = curv.make_hvp_op(counting_loss, s["tp"], s["tb"], mode="linearize")
    built = calls["n"]
    A_blk = blocks.block_op_from_single(curv.make_damped(G, lam))
    V = blocks.stack_tangents(s["tv"])
    out = A_blk(V)
    assert calls["n"] == built
    jG = jcurv.make_hvp_op(s["jm"].loss_fn, s["jp"], s["jb"], mode="linearize")
    want = jblocks.block_op_from_single(jcurv.make_damped(jG, lam))(
        jblocks.stack_tangents(s["jv"]))
    _close_trees(out, want)


# ------------------------------------------------------- spectral estimates --
def _chain(ev, basis, seed=7):
    """A chain of a symmetric operator with spectrum ``ev`` and its (Gram,
    the reference's recurrence block, the port's): one application short of
    full dimension in a Chebyshev basis on [min ev, max ev], three in the
    monomial basis. A full-dimension chain ends in a vector of round-off, and
    deeper monomial chains leave the interior Ritz values to f32 round-off:
    there no two implementations agree to 1e-5 (the reference's own tests
    hold those at 0.02, or only the extremes)."""
    d = len(ev)
    n = 3 if basis == "monomial" else d - 1
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.randn(d, d))
    A = (U * np.asarray(ev)) @ U.T
    if basis == "monomial":
        alpha, beta, gamma = np.zeros(n), np.zeros(n), np.ones(n)
    else:
        lo, hi = min(ev), max(ev)
        c, h = 0.5 * (lo + hi), 0.6 * (hi - lo)
        alpha = np.full(n, c)
        beta = np.r_[0.0, np.full(n - 1, h / 2)]
        gamma = np.r_[h, np.full(n - 1, h / 2)]
    alpha, beta, gamma = (a.astype(np.float32) for a in (alpha, beta, gamma))
    ch = [rng.randn(d)]
    for j in range(n):
        vp = ch[-2] if j > 0 else ch[-1]
        ch.append((A @ ch[-1] - alpha[j] * ch[-1] - beta[j] * vp) / gamma[j])
    V = np.stack(ch).astype(np.float32)
    G = (V @ V.T).astype(np.float32)
    jT = jsstep._segment_T(tuple(jnp.asarray(a) for a in (alpha, beta, gamma)), n + 1)
    tT = sstep._segment_T(tuple(torch.from_numpy(a) for a in (alpha, beta, gamma)), n + 1)
    np.testing.assert_array_equal(tT.numpy(), np.asarray(jT))
    return G, jT, tT


@pytest.mark.parametrize("basis", ["monomial", "chebyshev"])
@pytest.mark.parametrize("ev", [[1.0, 2.0, 3.0, 4.0, 5.0], [-2.0, -0.5, 1.0, 3.0, 6.0]],
                         ids=["spd", "indefinite"])
def test_ritz_from_segment_matches_reference(ev, basis):
    G, jT, tT = _chain(ev, basis)
    jr, jok = jkrylov.ritz_from_segment(jnp.asarray(G), jT)
    tr, tok = krylov.ritz_from_segment(torch.from_numpy(G), tT)
    assert bool(tok) == bool(jok)
    _close(tr, jr)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_ritz_from_segment_flags_nonfinite_gram_like_reference(bad):
    G = np.full((4, 4), bad, np.float32)
    _, jok = jkrylov.ritz_from_segment(jnp.asarray(G), jsstep._segment_shift(4))
    tr, tok = krylov.ritz_from_segment(torch.from_numpy(G),
                                       sstep._segment_shift(4, torch.device("cpu")))
    assert not bool(jok) and not bool(tok)
    assert torch.isfinite(tr).all()


def test_ritz_flags_a_gram_that_is_not_positive_definite():
    """Where ``jnp.linalg.cholesky`` returns NaNs, ``cholesky_ex`` reports
    info != 0: both packages say "no estimate"."""
    G = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    _, jok = jkrylov.ritz_from_segment(jnp.asarray(G), jsstep._segment_shift(4))
    _, tok = krylov.ritz_from_segment(torch.from_numpy(G),
                                      sstep._segment_shift(4, torch.device("cpu")))
    assert not bool(jok) and not bool(tok)


@pytest.mark.parametrize("vals", [
    [1.0, 10.0, 5.0],
    [3.0, -7.0, 1.5, 0.2],
    [2.0, 2.0, -2.0, 0.0],
    list(np.random.RandomState(0).randn(12)),
    list(np.linspace(0.5, 40.0, 37)),
], ids=["known", "mixed", "ties", "random12", "grid37"])
def test_leja_order_matches_reference_exactly(vals):
    v = np.asarray(vals, np.float32)
    want = np.asarray(jkrylov.leja_order(jnp.asarray(v)))
    got = krylov.leja_order(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
