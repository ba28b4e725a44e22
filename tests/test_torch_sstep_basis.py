"""The port's s-step basis layer (``repro_torch.core.sstep``) against
``repro.core.sstep``: the Bi-CG-STAB half of the solver grid (the CG half
and the tolerances are in ``test_torch_sstep.py``), the basis coefficients
and recurrence blocks, the Gram guards, the adaptive bases at doubled depth
on the reference's clustered spectrum, and the fallback chain.

Four reference tests fail under the installed jax 0.9.0 (ROADMAP Queue 3):
``test_sstep_basis.py::TestAdaptiveDoublesDepth::test_bicgstab_s4_guard_quiet
[newton]`` and ``::test_cg_s8_flat_backend_matches_tree``,
``TestFallbackChain::test_few_point_spectrum_converges_in_bootstraps`` and
``test_sstep.py::TestHFStepSStep::test_backend_parity[bicgstab-2]`` (its twin
is in ``test_torch_hf.py``). Their twins here (``test_twin_*``) hold the port
to the JAX function's output on the same inputs, not to the property those
tests assert.

On the reference's clustered spectrum (κ = 100, ‖A‖ = 100) and on its
three-point spectrum the deep chains run into f32 round-off within the
first cycles, and the reference's own tree and flat backends then part:
iterations 24 against 14 for newton CG at s = 8, 3 against 5 on the
three-point spectrum, breakdown against none for newton Bi-CG-STAB at s = 4
(measured). There the port is held where the reference agrees with itself
(``_assert_where_reference_agrees``): every count both reference backends
report alike, and the residual history up to the first iteration where
they part by more than 1e-3 (5e-3 for Bi-CG-STAB), to four times that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sstep as jsstep  # noqa: E402
from repro_torch.core import sstep  # noqa: E402
from test_torch_sstep import (  # noqa: E402
    COUNTS, N, _assert_same, _flat, _grid, _jvec, _ops, _rhs, _solve, _solve_both, _tvec,
    check_grid_case,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name,basis,s,overlap", _grid("sstep_bicgstab"))
def test_sstep_bicgstab_matches_reference(name, basis, s, overlap):
    check_grid_case(name, basis, s, overlap)


# --------------------------------------------------- coefficients and blocks --
RITZ = [np.array([0.7, 1.3, 2.0, 9.5], np.float32),
        np.array([-1.2, 0.4, 3.0], np.float32),
        np.array([2.0, 2.0], np.float32)]


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("depth", [4, 8])
@pytest.mark.parametrize("kind", ["monomial", "newton", "chebyshev"])
def test_basis_coefficients_match_reference(kind, depth, ok):
    for ritz in RITZ:
        want = jsstep.BasisSpec(kind).coeffs(jnp.asarray(ritz), jnp.asarray(ok), depth)
        got = sstep.BasisSpec(kind).coeffs(torch.from_numpy(ritz), torch.tensor(ok), depth)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_basis_spec_validation_matches_reference():
    assert sstep.BASES == jsstep.BASES
    with pytest.raises(ValueError) as jerr:
        jsstep.resolve_basis("legendre")
    with pytest.raises(ValueError) as terr:
        sstep.resolve_basis("legendre")
    assert str(terr.value) == str(jerr.value)
    assert sstep.resolve_basis(None).kind == "monomial"
    assert sstep.resolve_basis(sstep.BasisSpec("newton")).kind == "newton"
    assert not sstep.BasisSpec("monomial").adaptive and sstep.BasisSpec("chebyshev").adaptive


@pytest.mark.parametrize("segs", [(3, 2), (5, 4), (9, 8), (2, 1)])
def test_recurrence_blocks_match_reference_exactly(segs):
    rng = np.random.default_rng(sum(segs))
    coeffs = [rng.standard_normal(segs[0]).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(sstep._shift(segs, CPU).numpy(),
                                  np.asarray(jsstep._shift(segs)))
    np.testing.assert_array_equal(sstep._segment_shift(segs[0], CPU).numpy(),
                                  np.asarray(jsstep._segment_shift(segs[0])))
    np.testing.assert_array_equal(
        sstep._basis_T(tuple(torch.from_numpy(c) for c in coeffs), segs).numpy(),
        np.asarray(jsstep._basis_T(tuple(jnp.asarray(c) for c in coeffs), segs)))


def _gram(kind, m, seed):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, 12))
    if kind == "dependent":
        V[m - 1] = V[m - 2] + 1e-7 * V[0]
    elif kind == "power":
        # normalized power chain: its columns collapse onto the dominant
        # eigenvector, the degeneration the guards exist for
        A = np.diag(np.logspace(0, 3, 12))
        for j in range(1, m):
            V[j] = A @ V[j - 1]
            V[j] /= np.linalg.norm(V[j])
    elif kind == "nonfinite":
        V[2, 3] = np.inf
    return (V @ V.T).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "dependent", "power", "nonfinite"])
def test_gram_guards_match_reference(kind):
    segs = (5, 4)
    G = _gram(kind, sum(segs), 3)
    want = bool(jsstep._gram_ok(jnp.asarray(G), segs, jsstep.GUARD_PIVOT))
    assert bool(sstep._gram_ok(torch.from_numpy(G), segs, sstep.GUARD_PIVOT)) == want
    jf, joks = jsstep._prefix_guard(jnp.asarray(G), segs, jsstep.GUARD_PIVOT)
    tf, toks = sstep._prefix_guard(torch.from_numpy(G), segs, sstep.GUARD_PIVOT)
    assert bool(tf) == bool(jf)
    for a, b in zip(joks, toks):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ------------------------------------------- the reference's clustered SPD --
def _clustered_spd(n=30, seed=2):
    """The reference's test operator: a cluster near 1 plus a spread tail
    (κ = 100), and its right-hand side."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.randn(n, n))
    d = np.concatenate([1.0 + 0.1 * np.arange(20), np.linspace(5, 100, n - 20)])
    M = ((U * d.astype(np.float32)) @ U.T).astype(np.float32)
    return M, rng.randn(n).astype(np.float32)


def _rel_res(M, x, b):
    return np.linalg.norm(M @ _flat(x) - b) / np.linalg.norm(b)


def _assert_where_reference_agrees(out, rtol=1e-3):
    """Hold both port backends to every count on which the reference's tree
    and flat backends agree, and, within 4 × ``rtol``, to the residual
    history before the first iteration where those part by more than
    ``rtol`` (the margin: where the reference's two summation orders still
    agree, a third one, the port's, lands up to a few times as far)."""
    (jt, tt), (jf, tf) = out["tree"], out["flat"]
    for field in COUNTS:
        if int(getattr(jt, field)) == int(getattr(jf, field)):
            for t in (tt, tf):
                assert int(getattr(t, field)) == int(getattr(jt, field)), field
    ht, hf = np.asarray(jt.residual_history), np.asarray(jf.residual_history)
    with np.errstate(invalid="ignore"):
        agree = np.abs(ht - hf) <= rtol * np.abs(ht)
    n = len(agree) if agree.all() else int(np.argmin(agree))
    assert n >= 2
    for j, t in out.values():
        np.testing.assert_allclose(t.residual_history.numpy()[:n],
                                   np.asarray(j.residual_history)[:n], rtol=4 * rtol)
        assert np.isfinite(_flat(t.x)).all()


@pytest.mark.parametrize("basis", ["newton", "chebyshev"])
def test_cg_s8_adaptive_basis_matches_reference(basis):
    """Monomial CG cannot start at s = 8; the adaptive bases run guard-quiet."""
    M, b = _clustered_spd()
    x0 = np.zeros(N, np.float32)
    kw = dict(lam=0.0, s=8, max_iters=24, tol=1e-5, fallback=False, block=False)
    jres, tres = _solve("sstep_cg", M, b, x0, "tree", basis="monomial", **kw)
    assert bool(tres.breakdown) and int(tres.iters) == 0
    _assert_same(jres, tres)
    out, _ = _solve_both("sstep_cg", M, b, x0, basis=basis, **kw)
    _assert_where_reference_agrees(out)
    for _, tres in out.values():
        assert not bool(tres.breakdown) and not bool(tres.basis_degraded)
        assert _rel_res(M, tres.x, b) < 0.1


@pytest.mark.parametrize("basis", ["newton", "chebyshev"])
def test_twin_bicgstab_s4_adaptive_basis(basis):
    """Twin of ``test_bicgstab_s4_guard_quiet``: the monomial guard kills
    s = 4; the adaptive bases are held to the reference's output."""
    M, b = _clustered_spd()
    x0 = np.zeros(N, np.float32)
    kw = dict(lam=0.0, s=4, max_iters=24, tol=1e-5, fallback=False, block=False)
    jres, tres = _solve("sstep_bicgstab", M, b, x0, "tree", basis="monomial", **kw)
    assert bool(tres.basis_breakdown)
    _assert_same(jres, tres)
    out, _ = _solve_both("sstep_bicgstab", M, b, x0, basis=basis, **kw)
    # Its bootstrap chains are already 4 applications deep: the reference's
    # own backends part by 1.2e-3 at the second iteration (measured), and by
    # under 5e-3 for several more.
    _assert_where_reference_agrees(out, rtol=5e-3)


def test_twin_cg_s8_flat_backend_matches_tree():
    """Twin of ``test_cg_s8_flat_backend_matches_tree``: newton s = 8 on each
    backend, held to the reference's output on that backend."""
    M, b = _clustered_spd()
    out, _ = _solve_both("sstep_cg", M, b, np.zeros(N, np.float32), lam=0.0, s=8,
                         max_iters=24, tol=1e-5, basis="newton", fallback=False,
                         block=False)
    _assert_where_reference_agrees(out)


# --------------------------------------------------------- fallback chain --
class _GarbageBasis(sstep.BasisSpec):
    def coeffs(self, ritz, ok, depth):
        return (torch.full((depth,), 1e30), torch.zeros((depth,)),
                torch.full((depth,), 1e-30))


class _JaxGarbageBasis(jsstep.BasisSpec):
    def coeffs(self, ritz, ok, depth):
        return (jnp.full((depth,), 1e30, jnp.float32), jnp.zeros((depth,), jnp.float32),
                jnp.full((depth,), 1e-30, jnp.float32))


def test_unusable_adaptive_basis_degrades_like_reference():
    """Garbage coefficients overflow the chain, the guard fires and the solve
    degrades (sticky) to prefix-guarded monomial cycles: the same counts and
    flags as the reference, and a solved system (the iterates themselves
    follow f32 round-off on this spectrum, see the module docstring)."""
    M, b = _clustered_spd()
    jop, top = _ops(M)
    kw = dict(lam=0.0, s=8, max_iters=24, tol=1e-5, fallback=True)
    with jax.disable_jit():
        jres = jsstep.sstep_cg(jop, _jvec(b), _jvec(np.zeros(N)),
                               basis=_JaxGarbageBasis("chebyshev"), **kw)
    tres = sstep.sstep_cg(top, _tvec(b), _tvec(np.zeros(N)),
                          basis=_GarbageBasis("chebyshev"), **kw)
    assert bool(tres.basis_degraded)
    assert _rel_res(M, tres.x, b) < 0.1
    for field in COUNTS:
        assert int(getattr(tres, field)) == int(getattr(jres, field)), field


def test_fully_degenerate_spectrum_reaches_standard_like_reference():
    """On A = 3·I every chain is rank 1: the bootstrap cannot start and the
    standard solver finishes exactly."""
    M = (3.0 * np.eye(N)).astype(np.float32)
    b = _rhs(4)
    jres, tres = _solve("sstep_cg", M, b, np.zeros(N, np.float32), "tree", lam=0.0,
                        s=8, max_iters=24, tol=1e-8, basis="chebyshev", fallback=True,
                        block=False)
    assert bool(tres.breakdown) and bool(tres.basis_breakdown)
    np.testing.assert_allclose(_flat(tres.x), b / 3.0, rtol=1e-5, atol=1e-6)
    _assert_same(jres, tres)


def test_twin_few_point_spectrum_converges_in_bootstraps():
    """Twin of ``test_few_point_spectrum_converges_in_bootstraps``: a
    3-eigenvalue spectrum, chebyshev s = 8, held to the reference's output."""
    rng = np.random.RandomState(2)
    U, _ = np.linalg.qr(rng.randn(N, N))
    d = np.array([1.0] * 10 + [2.0] * 10 + [5.0] * 10, np.float32)
    M = ((U * d) @ U.T).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    out, _ = _solve_both("sstep_cg", M, b, np.zeros(N, np.float32), lam=0.0, s=8,
                         max_iters=24, tol=1e-6, basis="chebyshev", fallback=True,
                         block=False)
    _assert_where_reference_agrees(out)


@pytest.mark.parametrize("name,s", [("sstep_cg", 8), ("sstep_bicgstab", 4)])
def test_converged_warm_start_is_not_a_breakdown_like_reference(name, s):
    """An x0 that already solves the system ends cleanly: verdicts of the
    bootstrap cycles run after termination are masked."""
    M, b = _clustered_spd()
    xt = np.linalg.solve(M.astype(np.float64), b).astype(np.float32)
    jres, tres = _solve(name, M, b, xt, "tree", lam=0.0, s=s, max_iters=24, tol=1e-4,
                        basis="newton", fallback=False, block=False)
    assert not bool(tres.breakdown) and int(tres.iters) == 0
    _assert_same(jres, tres)


def test_monomial_path_reports_no_degrade_like_reference():
    M, b = _clustered_spd()
    jres, tres = _solve("sstep_cg", M, b, np.zeros(N, np.float32), "flat", lam=0.0,
                        s=2, max_iters=16, tol=1e-5, basis="monomial")
    assert not bool(tres.basis_degraded)
    for field in ("iters", "syncs", "breakdown", "basis_degraded", "basis_breakdown"):
        assert int(getattr(tres, field)) == int(getattr(jres, field)), field
