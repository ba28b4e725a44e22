"""Slice-1 acceptance twins of the reference's system tests, run through the
port on the CPU (``device="cpu"``):

* the paper's Fig. 2 saddle A/B (``tests/test_saddle.py::
  test_escape_exits_saddle_in_fewer_steps``): Bi-CG-STAB HF with
  ``nc_mode="escape"`` leaves the saddle in strictly fewer outer steps than
  with ``"truncate"``, from the same start and ``HFConfig``, and reaches the
  minimum's loss −0.25 ± 1e-2. The Krylov jitter is the port's own
  deterministic pseudo-noise, so the outcome is held, not the trajectory;
* Armijo monotonicity (``tests/test_system.py::TestMLPTraining::
  test_monotone_under_line_search``): 10 Bi-CG-STAB steps on a (16, 32, 3)
  MLP never raise the loss by more than 1e-5;
* ``examples/quickstart.py`` in miniature: each of the four solvers takes a
  (32, 64, 4) MLP's loss to at most half its start in 10 outer steps.

Data and initial parameters are the reference's (``jax.random``), carried
over through numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.data import classification_dataset as jax_dataset  # noqa: E402
from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch.core.hf import HFConfig, hf_init, hf_step  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402

QUICKSTART_FACTOR = 0.5  # loss after 10 steps ≤ this × the starting loss


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _mlp_case(dims, n, data_seed, param_seed):
    """The port's MLP with the reference's parameters and data."""
    jp = jax_build_mlp(dims).init(jax.random.PRNGKey(param_seed))
    jb = jax_dataset(jax.random.PRNGKey(data_seed), n, dims[0], dims[-1])
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    batch = batch_from_numpy({k: np.asarray(v) for k, v in jb.items()}, "cpu")
    return build_mlp(dims, device="cpu"), params, batch


# ------------------------------------------------------ Fig. 2 saddle --
def saddle_loss(params, batch):
    """f(x, y) = 0.5x² + 0.25y⁴ − 0.5y²: saddle at (0, 0), minima (0, ±1)."""
    x, y = params["x"], params["y"]
    return 0.5 * x ** 2 + 0.25 * y ** 4 - 0.5 * y ** 2 + 0.0 * torch.sum(batch)


def _steps_to_exit(nc_mode, thresh=0.5, steps=40):
    """Outer steps until |y| > thresh, over the whole trajectory; returns
    (exit step, final parameters). The reference's configuration."""
    cfg = HFConfig(solver="bicgstab", max_cg_iters=10, init_damping=1e-3,
                   krylov_jitter=1e-3, nc_mode=nc_mode)
    batch = torch.zeros(1)
    params = {"x": torch.tensor(0.9), "y": torch.tensor(0.0)}
    state = hf_init(params, cfg, device="cpu")
    exit_step = steps + 1
    for i in range(steps):
        params, state, _ = hf_step(saddle_loss, params, state, batch, batch, cfg, device="cpu")
        if exit_step > steps and abs(float(params["y"])) > thresh:
            exit_step = i + 1
    return exit_step, params


def test_escape_exits_saddle_in_fewer_steps():
    n_esc, p_esc = _steps_to_exit("escape")
    n_trunc, _ = _steps_to_exit("truncate")
    assert n_esc < n_trunc
    assert float(saddle_loss(p_esc, torch.zeros(1))) == pytest.approx(-0.25, abs=1e-2)


# ------------------------------------------------------- MLP training --
def test_monotone_under_line_search():
    """Armijo guarantees f never increases across accepted steps."""
    model, params, data = _mlp_case((16, 32, 3), 256, data_seed=2, param_seed=3)
    cfg = HFConfig(solver="bicgstab", max_cg_iters=8)
    state = hf_init(params, cfg, device="cpu")
    prev = float(model.loss_fn(params, data))
    for _ in range(10):
        params, state, _ = hf_step(model.loss_fn, params, state, data, data, cfg, device="cpu")
        cur = float(model.loss_fn(params, data))
        assert cur <= prev + 1e-5
        prev = cur


@pytest.mark.parametrize("solver", ["gn_cg", "hessian_cg", "hybrid_cg", "bicgstab"])
def test_quickstart_solvers_lower_the_loss(solver):
    """``examples/quickstart.py``'s four HF variants (``max_cg_iters`` 10,
    λ₀ 1) on a small MLP: each takes the loss to at most QUICKSTART_FACTOR
    of its start in 10 outer steps, every loss finite."""
    model, params, data = _mlp_case((32, 64, 4), 512, data_seed=0, param_seed=1)
    cfg = HFConfig(solver=solver, max_cg_iters=10, init_damping=1.0)
    state = hf_init(params, cfg, device="cpu")
    start = float(model.loss_fn(params, data))
    for _ in range(10):
        params, state, m = hf_step(model.loss_fn, params, state, data, data, cfg,
                                   model_out_fn=model.logits_fn,
                                   out_loss_fn=model.out_loss_fn, device="cpu")
        assert np.isfinite(float(m["loss"]))
    end = float(model.loss_fn(params, data))
    assert end <= QUICKSTART_FACTOR * start, (start, end)
