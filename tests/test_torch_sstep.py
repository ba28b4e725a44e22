"""The port's s-step Krylov solvers (``repro_torch.core.sstep``) against
``repro.core.sstep`` on small dense operators, both vector backends.

Counts and flags (``iters``, ``syncs``, ``breakdown``, ``basis_degraded``,
``basis_breakdown``, ``nc_found``) must be equal. The iterate agrees to
1e-5 × max|x|, or, where the reference's own tree and flat backends part by
more than a tenth of that, to ten times their distance: an s-step CG cycle
whose chains are four or more applications deep reproduces exact CG only to
~1e-4 in f32 on this operator, and the reference's two backends differ by
7e-5 to 8.5e-4 there (Bi-CG-STAB's by under 1e-6).

The reference runs under ``jax.disable_jit()``: the same functions op by op,
which skips compiling every solve's while-loops (seconds per solve on a
CPU). The operator has its spectrum in [0.2, 2] so that the power chains
stay O(1), and the solves stop after 8 iterations (< 30, the dimension),
while the residual is far above round-off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import blocks as jblocks, krylov as jkrylov  # noqa: E402
from repro.core import line_search as jls, sstep as jsstep  # noqa: E402
from repro_torch.core import blocks, krylov, line_search, solvers, sstep  # noqa: E402

N = 30  # a tree {"a": (5,), "b": (5, 5)}
LAM = 0.5
COUNTS = ("iters", "syncs", "breakdown", "basis_degraded", "basis_breakdown", "nc_found")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jvec(x):
    x = jnp.asarray(x, jnp.float32)
    return {"a": x[:5], "b": x[5:].reshape(5, 5)}


def _tvec(x):
    x = torch.tensor(np.asarray(x, np.float32))
    return {"a": x[:5], "b": x[5:].reshape(5, 5)}


def _flat(tree):
    """A tree of either package as one numpy vector, in leaf order."""
    return np.concatenate([np.asarray(l).ravel() for l in jax.tree_util.tree_leaves(tree)])


def _spectrum_op(ev, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    return ((q * np.asarray(ev, np.float64)) @ q.T).astype(np.float32)


def _ops(M, poison=False):
    Mj, Mt = jnp.asarray(M), torch.from_numpy(M)

    def jop(v):
        y = Mj @ jnp.concatenate([v["a"], v["b"].reshape(-1)])
        return _jvec(y * jnp.nan if poison else y)

    def top(v):
        y = Mt @ torch.cat([v["a"], v["b"].reshape(-1)])
        y = y * float("nan") if poison else y
        return {"a": y[:5], "b": y[5:].reshape(5, 5)}

    return jop, top


def _rhs(seed):
    return np.random.default_rng(seed).standard_normal(N).astype(np.float32)


def _solve(name, M, b, x0, backend, poison=False, block=True, **kw):
    """(reference result, port result) of one s-step solve."""
    jop, top = _ops(M, poison)
    jb, tb = _jvec(b), _tvec(b)
    jbe = jkrylov.get_backend(backend, template=jb, interpret=True)
    tbe = krylov.get_backend(backend, template=tb)
    with jax.disable_jit():
        jres = getattr(jsstep, name)(
            jop, jb, _jvec(x0), backend=jbe,
            A_block=jblocks.block_op_from_single(jop) if block else None, **kw)
    tres = getattr(sstep, name)(
        top, tb, _tvec(x0), backend=tbe,
        A_block=blocks.block_op_from_single(top) if block else None, **kw)
    return jres, tres


def _assert_same(jres, tres, tol=1e-5):
    for field in COUNTS:
        assert int(getattr(tres, field)) == int(getattr(jres, field)), field
    jx, tx = _flat(jres.x), _flat(tres.x)
    scale = float(np.max(np.abs(jx)))
    assert np.max(np.abs(tx - jx)) <= tol * scale
    jh = np.asarray(jres.residual_history)
    th = tres.residual_history.numpy()
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    assert np.isfinite(tx).all() == np.isfinite(jx).all()


SPD = np.linspace(0.2, 2.0, N)


def _solve_both(name, M, b, x0, **kw):
    """{backend: (reference, port)} on both backends, and the tolerance the
    iterate is held to: 1e-5, or ten times the reference's own tree-vs-flat
    distance (relative to max|x|) where that is larger."""
    out = {be: _solve(name, M, b, x0, be, **kw) for be in ("tree", "flat")}
    jt, jf = _flat(out["tree"][0].x), _flat(out["flat"][0].x)
    own = float(np.max(np.abs(jt - jf)) / max(float(np.max(np.abs(jf))), 1e-30))
    return out, max(1e-5, 10 * own)


# Monomial chains deeper than the reference's f32 budget (BOOT_APPLICATIONS
# = 4 applications a cycle): overlapped CG at s = 4 (8 deep) and overlapped
# Bi-CG-STAB (8 and 16 deep). The reference calls them not f32-viable; past
# the first iterations their guard and drift verdicts follow round-off, and
# its own tree and flat backends then part in counts and flags.
DEEP_MONOMIAL = {("sstep_cg", 4), ("sstep_bicgstab", 2), ("sstep_bicgstab", 4)}
GRID = [(name, basis, s, overlap)
        for name in ("sstep_cg", "sstep_bicgstab")
        for basis in ("monomial", "newton", "chebyshev")
        for s in (2, 4) for overlap in (False, True)]


def _grid(solver):
    return [pytest.param(*g, id=f"{g[1]}-s{g[2]}-{'overlap' if g[3] else 'plain'}")
            for g in GRID if g[0] == solver
            and not (g[1] == "monomial" and g[3] and (g[0], g[2]) in DEEP_MONOMIAL)]


def check_grid_case(name, basis, s, overlap):
    M = _spectrum_op(SPD, 0)
    b, x0 = _rhs(1), np.zeros(N, np.float32)
    out, tol = _solve_both(name, M, b, x0, lam=LAM, s=s, max_iters=8, tol=0.0,
                           basis=basis, overlap=overlap)
    for jres, tres in out.values():
        _assert_same(jres, tres, tol=tol)


@pytest.mark.parametrize("name,basis,s,overlap", _grid("sstep_cg"))
def test_sstep_cg_matches_reference(name, basis, s, overlap):
    check_grid_case(name, basis, s, overlap)


@pytest.mark.parametrize("name,s", sorted(DEEP_MONOMIAL))
def test_deep_monomial_overlap_runs_like_reference(name, s):
    """The configurations past the monomial budget (DEEP_MONOMIAL): the first
    iteration's residual agrees to 1e-5, the counts stay in range, and the
    iterate is finite on both backends."""
    M = _spectrum_op(SPD, 0)
    out, _ = _solve_both(name, M, _rhs(1), np.zeros(N, np.float32), lam=LAM, s=s,
                         max_iters=8, tol=0.0, basis="monomial", overlap=True)
    for jres, tres in out.values():
        jh, th = np.asarray(jres.residual_history), tres.residual_history.numpy()
        assert abs(th[0] - jh[0]) <= 1e-5 * jh[0]
        assert 1 <= int(tres.syncs) <= int(tres.iters) <= 8
        assert np.isfinite(_flat(tres.x)).all()


@pytest.mark.parametrize("name", ["sstep_cg", "sstep_bicgstab"])
def test_stops_at_tolerance_like_reference(name):
    M = _spectrum_op(SPD, 0)
    out, tol = _solve_both(name, M, _rhs(1), np.zeros(N, np.float32), lam=LAM, s=2,
                           max_iters=24, tol=1e-2)
    for jres, tres in out.values():
        assert int(tres.iters) < 24
        _assert_same(jres, tres, tol=tol)


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("name", ["sstep_cg", "sstep_bicgstab"])
def test_indefinite_operator_like_reference(name, s):
    """Indefinite: CG truncates at negative curvature, Bi-CG-STAB solves on.
    Held for 2 iterations (f32 reduction-order noise grows fast on an
    indefinite Bi-CG-STAB)."""
    ev = np.concatenate([[-1.5, -0.7], np.linspace(0.4, 2.0, N - 2)])
    M = _spectrum_op(ev, 3)
    jres, tres = _solve(name, M, _rhs(4), np.zeros(N, np.float32), "flat",
                        lam=LAM, s=s, max_iters=2, tol=0.0, fallback=False)
    assert bool(tres.nc_found)
    _assert_same(jres, tres)
    np.testing.assert_allclose(float(tres.nc_curv), float(jres.nc_curv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_flat(tres.nc_dir), _flat(jres.nc_dir), rtol=0, atol=1e-5)


# ------------------------------------------------------- guard and fallback --
def _ill(top):
    """A diagonal operator with spectrum logspace(0, top): the monomial s=8
    chains degenerate in the first cycle (the reference's
    TestGramBreakdownFallback uses top = 8)."""
    return np.diag(np.logspace(0, top, N).astype(np.float32)), _rhs(2)


@pytest.mark.parametrize("name", ["sstep_cg", "sstep_bicgstab"])
def test_gram_guard_freezes_like_reference(name):
    """Without fallback the guard flags the first cycle and freezes x0."""
    M, b = _ill(8)
    jres, tres = _solve(name, M, b, np.zeros(N, np.float32), "tree", lam=0.0, s=8,
                        max_iters=60, tol=1e-8, fallback=False, block=False)
    assert bool(tres.breakdown) and bool(tres.basis_breakdown)
    assert int(tres.iters) == 0 and not np.any(_flat(tres.x))
    _assert_same(jres, tres)


@pytest.mark.parametrize("name", ["sstep_cg", "sstep_bicgstab"])
def test_fallback_runs_the_standard_solver_like_reference(name):
    """With fallback the standard solver finishes from the frozen iterate:
    the port's result is its own standard solve, and the reference's. The
    spectrum spans 1e3 and the budget is 4 iterations: on the reference's
    1e8 spectrum, or over 12 iterations at 1e3, standard f32 CG and
    Bi-CG-STAB already part from themselves by 1e-3 under a change of
    summation order."""
    M, b = _ill(3)
    x0 = np.zeros(N, np.float32)
    jres, tres = _solve(name, M, b, x0, "tree", lam=0.0, s=8, max_iters=4,
                        tol=1e-8, fallback=True, block=False)
    assert bool(tres.breakdown) and int(tres.syncs) == 1 + 4
    _assert_same(jres, tres)
    std = getattr(solvers, name[len("sstep_"):])
    plain = std(_ops(M)[1], _tvec(b), _tvec(x0), lam=0.0, max_iters=4, tol=1e-8)
    np.testing.assert_array_equal(_flat(tres.x), _flat(plain.x))


@pytest.mark.parametrize("basis", ["monomial", "newton", "chebyshev"])
@pytest.mark.parametrize("name", ["sstep_cg", "sstep_bicgstab"])
def test_nan_operator_breaks_down_like_reference(name, basis):
    """A NaN curvature product is a breakdown (or a degraded basis), never
    convergence, and the iterate stays finite."""
    M = _spectrum_op(SPD, 0)
    for fallback in (False, True):
        jres, tres = _solve(name, M, _rhs(1), np.zeros(N, np.float32), "tree",
                            poison=True, lam=LAM, s=2, max_iters=20, tol=1e-8,
                            basis=basis, fallback=fallback)
        assert bool(tres.breakdown) or bool(tres.basis_degraded)
        assert np.isfinite(_flat(tres.x)).all()
        assert not bool(tres.residual < 1e-8)
        _assert_same(jres, tres)


# ------------------------------------------------------------ paired Armijo --
@pytest.mark.parametrize("scale", [1.0, 3.0, 40.0, -1.0])
def test_paired_armijo_matches_reference_and_unpaired(scale):
    """Two candidates per trip: the same accepted α and loss as the unpaired
    search, and the reference's evaluation count."""
    rng = np.random.default_rng(5)
    H = _spectrum_op(np.linspace(0.5, 3.0, N), 6)
    g = rng.standard_normal(N).astype(np.float32)
    p0 = rng.standard_normal(N).astype(np.float32)
    d = (-scale * np.linalg.solve(H, g)).astype(np.float32)
    Hj, Ht, gj, gt = jnp.asarray(H), torch.from_numpy(H), jnp.asarray(g), torch.from_numpy(g)
    jloss = lambda p: 0.5 * p @ Hj @ p + gj @ p
    tloss = lambda p: 0.5 * p @ Ht @ p + gt @ p
    jp, tp, jd, td = jnp.asarray(p0), torch.from_numpy(p0), jnp.asarray(d), torch.from_numpy(d)
    jgd = (Hj @ jp + gj) @ jd
    tgd = (Ht @ tp + gt) @ td
    jf0, tf0 = jloss(jp), tloss(tp)
    for paired in (False, True):
        jr = jls.armijo(jloss, jp, jf0, jd, jgd, paired=paired)
        tr = line_search.armijo(tloss, tp, tf0, td, tgd, paired=paired)
        assert int(tr.n_evals) == int(jr.n_evals)
        assert bool(tr.success) == bool(jr.success)
        assert float(tr.alpha) == float(jr.alpha)
        np.testing.assert_allclose(float(tr.f_new), float(jr.f_new), rtol=1e-5, atol=1e-6)
    unpaired = line_search.armijo(tloss, tp, tf0, td, tgd)
    paired = line_search.armijo(tloss, tp, tf0, td, tgd, paired=True)
    assert float(paired.alpha) == float(unpaired.alpha)
    assert int(paired.n_evals) >= int(unpaired.n_evals)
