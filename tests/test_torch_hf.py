"""The port's outer HF step against ``repro.core.hf``.

One ``hf_step`` per solver × Krylov backend × jitter from identical inputs,
well damped (λ = 100, cg_tol = 0, so K is pinned): the loss, the new
parameters and every ``METRICS_SCHEMA`` key agree to 1e-4. Plus a short
training run of the port alone and the config validation.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import hf as jhf  # noqa: E402
from repro.data import classification_dataset as jax_dataset  # noqa: E402
from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch.core import hf  # noqa: E402
from repro_torch.data.synthetic import classification_dataset  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402

DIMS = (16, 32, 4)
LAM = 100.0
# Counts and flags must be equal; floats agree to 1e-4.
EXACT = {"ls_evals", "cg_iters", "krylov_syncs", "blocking_syncs", "sstep_fallback",
         "sstep_basis_fallback", "sstep_basis_degraded", "nc_found", "nc_used",
         "used_gn", "step_rejected"}
# The raw curvature (dᵀAd − λ‖d‖²)/‖d‖² subtracts two f32 numbers of size λ,
# so its rounding error scales with λ.
LAMBDA_SCALED = {"nc_curv", "nc_lambda"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jm = jax_build_mlp(DIMS)
    jp = jm.init(jax.random.PRNGKey(1))
    jb = jax_dataset(jax.random.PRNGKey(0), 64, DIMS[0], DIMS[-1])
    return dict(
        jm=jm, jp=jp, jb=jb, tm=build_mlp(DIMS, device="cpu"),
        tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        tb=batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu"),
    )


def _both_steps(s, hvp_rows=None, **kw):
    cfg = {**dict(init_damping=LAM, cg_tol=0.0, max_cg_iters=4), **kw}
    jcfg, tcfg = jhf.HFConfig(**cfg), hf.HFConfig(**cfg)
    jm, tm = s["jm"], s["tm"]
    jhvp = s["jb"] if hvp_rows is None else {k: x[:hvp_rows] for k, x in s["jb"].items()}
    thvp = s["tb"] if hvp_rows is None else {k: x[:hvp_rows] for k, x in s["tb"].items()}
    # Un-jitted: after the first call XLA's per-primitive caches are warm, so
    # this costs the CPU about a third of a whole-step jit compile.
    jp, jst, jmet = jhf.hf_step(
        jm.loss_fn, s["jp"], jhf.hf_init(s["jp"], jcfg), s["jb"], jhvp, jcfg,
        model_out_fn=jm.logits_fn, out_loss_fn=jm.out_loss_fn)
    tp, tst, tmet = hf.hf_step(
        tm.loss_fn, s["tp"], hf.hf_init(s["tp"], tcfg, device="cpu"), s["tb"], thvp,
        tcfg, model_out_fn=tm.logits_fn, out_loss_fn=tm.out_loss_fn, device="cpu")
    return (jp, jst, jmet), (tp, tst, tmet)


def _assert_step_matches(j, t, unheld=()):
    (jp, jst, jmet), (tp, tst, tmet) = j, t
    assert set(tmet) == set(hf.METRICS_SCHEMA) == set(jmet)
    for k in hf.METRICS_SCHEMA:
        if k in unheld:
            continue
        a, b = float(jmet[k]), float(tmet[k])
        if k in EXACT:
            assert a == b, k
        elif k in LAMBDA_SCALED:
            assert abs(a - b) <= 1e-5 * LAM, (k, a, b)
        else:
            assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (k, a, b)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jst.prev_delta), tree_leaves(tst.prev_delta)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    assert float(tst.lam) == pytest.approx(float(jst.lam), rel=1e-5)
    assert int(tst.step) == int(jst.step) and bool(tst.use_gn) == bool(jst.use_gn)


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
@pytest.mark.parametrize("backend", ["tree", "flat"])
@pytest.mark.parametrize("solver", hf.SOLVERS)
def test_hf_step_matches_reference(setup, solver, backend, jitter):
    _assert_step_matches(*_both_steps(setup, solver=solver, krylov_backend=backend,
                                      krylov_jitter=jitter))


@pytest.mark.parametrize("kw", [
    dict(solver="bicgstab", nc_mode="escape", krylov_backend="flat"),
    dict(solver="bicgstab", precondition=True, krylov_backend="flat"),
    dict(solver="hessian_cg", precondition=True),
    dict(solver="bicgstab", curvature_mode="naive", hvp_rows=40),
    dict(solver="gn_cg", curvature_mode="chunked", curvature_chunk_size=24, hvp_rows=40),
], ids=["escape", "bicgstab-precond", "pcg", "naive-slice", "gn-chunked-slice"])
def test_hf_step_options_match_reference(setup, kw):
    kw = dict(kw)
    _assert_step_matches(*_both_steps(setup, hvp_rows=kw.pop("hvp_rows", None), **kw))


def test_bicgstab_flat_trains_below_a_third_of_the_initial_loss():
    model = build_mlp(DIMS, device="cpu")
    data = classification_dataset(torch.Generator().manual_seed(0), 256, DIMS[0],
                                  DIMS[-1], device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    cfg = hf.HFConfig(solver="bicgstab", max_cg_iters=10, krylov_backend="flat")
    state = hf.hf_init(params, cfg, device="cpu")
    prev = first = float(model.loss_fn(params, data))
    for _ in range(10):
        params, state, m = hf.hf_step(model.loss_fn, params, state, data, data, cfg,
                                      device="cpu")
        cur = float(model.loss_fn(params, data))
        assert cur <= prev + 1e-5  # Armijo: never an accepted ascent
        prev = cur
    assert prev < 0.3 * first
    assert float(model.accuracy(params, data)) > 0.9


def test_nonfinite_batch_step_is_rejected():
    model = build_mlp(DIMS, device="cpu")
    data = classification_dataset(torch.Generator().manual_seed(0), 32, DIMS[0],
                                  DIMS[-1], device="cpu")
    data["x"][0, 0] = float("nan")
    params = model.init(torch.Generator().manual_seed(1))
    cfg = hf.HFConfig(max_cg_iters=3)
    state = hf.hf_init(params, cfg, device="cpu")
    new, new_state, m = hf.hf_step(model.loss_fn, params, state, data, data, cfg,
                                   device="cpu")
    assert bool(m["step_rejected"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))
    assert float(new_state.lam) == pytest.approx(cfg.init_damping * cfg.damping_inc**2)


BAD_CONFIGS = [
    dict(solver="newton"), dict(krylov_backend="blocked"), dict(curvature_mode="exact"),
    dict(sstep_solver="gmres"), dict(sstep_basis="legendre"), dict(nc_mode="flip"),
    dict(sstep_s=2, precondition=True),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(kw))
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as jerr:
        jhf.HFConfig(**kw)
    with pytest.raises(ValueError) as terr:
        hf.HFConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_config_fields_and_defaults_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jhf.HFConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(hf.HFConfig)}
    assert tf == jf
    assert hf.METRICS_SCHEMA == jhf.METRICS_SCHEMA


@pytest.mark.parametrize("kw", [dict(sstep_s=2), dict(overlap=True)])
def test_unported_schedules_raise(setup, kw):
    """The two schedules that raised NotImplementedError before the s-step
    port now run, and match the reference step for step (at λ = 5 and
    cg_tol = 1e-3: see ``test_sstep_hf_step_matches_reference``)."""
    _assert_step_matches(*_both_steps(setup, krylov_jitter=0.0, init_damping=5.0,
                                      cg_tol=1e-3, max_cg_iters=8, **kw))


# ------------------------------------------------------------ s-step steps --
# (solver, sstep_s, basis, overlap, backend): the s-step solve of every
# solver family and basis on both backends, the overlapped schedule at s > 1,
# and overlap at s = 1 (the standard solver with the paired line search).
SSTEP_STEPS = [
    ("gn_cg", 2, "monomial", False, "flat"),
    ("gn_cg", 2, "monomial", False, "tree"),
    ("gn_cg", 4, "newton", False, "flat"),
    ("hessian_cg", 2, "chebyshev", False, "tree"),
    ("bicgstab", 2, "newton", False, "flat"),
    ("bicgstab", 2, "monomial", False, "tree"),
    ("gn_cg", 2, "monomial", True, "flat"),
    ("bicgstab", 1, "monomial", True, "flat"),
]


@pytest.mark.parametrize("solver,s,basis,overlap,backend", SSTEP_STEPS,
                         ids=["-".join(map(str, c)) for c in SSTEP_STEPS])
def test_sstep_hf_step_matches_reference(setup, solver, s, basis, overlap, backend):
    """Parameters to 1e-4, every metric, and ``krylov_syncs`` equal to the
    sync model's Krylov term (the comm model's blocking syncs less the
    gradient and line-search terms) where no fallback fired. No jitter;
    λ = 5 (the damped Hessian is then positive definite) and cg_tol = 1e-3,
    so the solve ends on its tolerance while the residual is well above
    round-off. At λ = 100 the damped operator is within 4% of 100·I: the
    first two iterations cut the residual by 1e-6, and with cg_tol = 0 the
    later s-step cycles run on round-off (their Gram guards and drift
    verdicts then differ between any two implementations)."""
    from benchmarks.comm_model import hf_sstep_syncs_per_iteration

    j, t = _both_steps(setup, solver=solver, sstep_s=s, sstep_basis=basis,
                       overlap=overlap, krylov_backend=backend, krylov_jitter=0.0,
                       max_cg_iters=8, init_damping=5.0, cg_tol=1e-3)
    m = t[2]
    # A CG cycle whose chains are 4 or more applications deep reports its
    # final residual and its NC probe as Gram quadratic forms that f32
    # round-off moves by ~10%: the reference's own tree and flat backends
    # give cg_residual 5.5e-3 and 6.0e-3 on the gn_cg s=4 newton step, and a
    # negative raw curvature on the positive semi-definite GN operator
    # (measured). The residual is held to a hundredfold cut of the first
    # one (x0 = 0, so ‖r0‖ = ‖g‖).
    deep_cg = solver != "bicgstab" and s * (2 if overlap else 1) >= 4
    unheld = {"cg_residual", "nc_curv", "nc_lambda"} if deep_cg else ()
    _assert_step_matches(j, t, unheld=unheld)
    if deep_cg:
        assert 0 < float(m["cg_residual"]) < 1e-2 * float(m["grad_norm"])
    K, E = int(m["cg_iters"]), int(m["ls_evals"])
    kind = "bicgstab" if solver == "bicgstab" else "cg"
    total = hf_sstep_syncs_per_iteration(K, E, s, solver=kind, basis=basis, overlap=overlap)
    krylov = total - ((E + 1) // 2 if overlap else 1 + E)
    if not bool(m["sstep_fallback"]):
        assert int(m["krylov_syncs"]) == krylov
    assert int(m["blocking_syncs"]) == total


def test_twin_backend_parity_bicgstab_s2():
    """Twin of ``test_sstep.py::TestHFStepSStep::test_backend_parity[bicgstab-2]``
    (fails under jax 0.9.0): its MLP (8, 16, 4), data and config on both
    backends. The reference's own tree and flat steps part there (that is
    the failure), so the port is held to every count both reference
    backends report alike, and its parameters on each backend to the
    reference's on that backend within 1e-4 or ten times the reference's
    own tree-vs-flat distance."""
    dims = (8, 16, 4)
    jm = jax_build_mlp(dims)
    jp = jm.init(jax.random.PRNGKey(1))
    jb = jax_dataset(jax.random.PRNGKey(0), 64, 8, 4)
    s = dict(jm=jm, jp=jp, jb=jb, tm=build_mlp(dims, device="cpu"),
             tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
             tb=batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu"))
    out = {be: _both_steps(s, solver="bicgstab", max_cg_iters=8, init_damping=5.0,
                           krylov_backend=be, sstep_s=2) for be in ("tree", "flat")}
    jt, jf = out["tree"][0], out["flat"][0]
    for k in ("cg_iters", "krylov_syncs", "blocking_syncs", "sstep_fallback"):
        if float(jt[2][k]) == float(jf[2][k]):
            for be in ("tree", "flat"):
                assert float(out[be][1][2][k]) == float(jt[2][k]), k
    own = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
              for a, b in zip(jax.tree_util.tree_leaves(jt[0]),
                              jax.tree_util.tree_leaves(jf[0])))
    for (jp2, _, _), (tp2, _, _) in out.values():
        for a, b in zip(jax.tree_util.tree_leaves(jp2), tree_leaves(tp2)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=max(1e-4, 10 * own))


def test_gn_cg_s8_at_lambda_1_follows_roundoff_in_the_reference_too():
    """ROADMAP Queue 3: on a 36-64x3-197 MLP at λ = 1, a gn_cg s=8 newton
    step of 16 iterations (cg_tol 0) diverged in the port where the
    reference's converged. The reference alone does the same: weights
    perturbed by 1e-7 (f32 round-off) move its final Krylov residual over
    many orders of magnitude on both of its backends, so which
    implementation diverges on given inputs is round-off, not a fault of
    the port. The port's step on the unperturbed inputs stays finite and
    does not raise the loss."""
    dims = (36, 64, 64, 64, 197)
    jm = jax_build_mlp(dims)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = jax_dataset(jax.random.PRNGKey(100), 512, dims[0], dims[-1])
    jhvp = {k: x[:128] for k, x in jb.items()}
    kw = dict(solver="gn_cg", sstep_s=8, sstep_basis="newton", max_cg_iters=16, cg_tol=0.0,
              init_damping=1.0)
    residuals = []
    for backend in ("tree", "flat"):
        jcfg = jhf.HFConfig(krylov_backend=backend, **kw)
        step = jax.jit(lambda p, st: jhf.hf_step(
            jm.loss_fn, p, st, jb, jhvp, jcfg, model_out_fn=jm.logits_fn,
            out_loss_fn=jm.out_loss_fn)[2]["cg_residual"])
        for t in range(3):
            rng = np.random.default_rng(t)
            p = jp if t == 0 else jax.tree_util.tree_map(
                lambda a: (np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape))
                           ).astype(np.float32), jp)
            residuals.append(float(step(p, jhf.hf_init(p, jcfg))))
    print("reference residuals (tree, then flat; unperturbed first):", residuals)
    assert max(residuals) / min(residuals) > 1e3, residuals

    tm = build_mlp(dims, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tb = batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu")
    cfg = hf.HFConfig(krylov_backend="flat", **kw)
    _, _, m = hf.hf_step(tm.loss_fn, tp, hf.hf_init(tp, cfg, device="cpu"), tb,
                         {k: x[:128] for k, x in tb.items()}, cfg, model_out_fn=tm.logits_fn,
                         out_loss_fn=tm.out_loss_fn, device="cpu")
    print("port flat residual:", float(m["cg_residual"]))
    assert np.isfinite(float(m["loss_new"])) and float(m["loss_new"]) <= float(m["loss"])
