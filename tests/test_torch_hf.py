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
    cfg = dict(init_damping=LAM, cg_tol=0.0, max_cg_iters=4, **kw)
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


def _assert_step_matches(j, t):
    (jp, jst, jmet), (tp, tst, tmet) = j, t
    assert set(tmet) == set(hf.METRICS_SCHEMA) == set(jmet)
    for k in hf.METRICS_SCHEMA:
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
    s = setup
    cfg = hf.HFConfig(**kw)
    with pytest.raises(NotImplementedError):
        hf.hf_step(s["tm"].loss_fn, s["tp"], hf.hf_init(s["tp"], cfg, device="cpu"),
                   s["tb"], s["tb"], cfg, device="cpu")
