"""The port's training path against ``repro``: ``hf_step`` on the tiny
transformer with flash and plain attention, the s-step solvers on a flash
model, the optimizer API and first-order baselines, and the training CLI.

``hf_step`` parity is held where the step is well damped (λ = 100,
``cg_tol`` 0, so K is pinned), as ``tests/test_flash_path.py`` holds the
reference's flash step against its jnp step: loss within 1e-5, parameters
within rtol 1e-3, atol 1e-4.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import HFConfig as JHFConfig, hf_init as j_hf_init, hf_step as j_hf_step  # noqa: E402
from repro.data import classification_dataset as j_dataset, lm_batch as j_lm_batch  # noqa: E402
from repro.models import build_mlp as j_build_mlp, build_model as j_build_model  # noqa: E402
from repro.optim import first_order as j_first_order  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.collectives import DataMesh  # noqa: E402
from repro_torch.core.hf import HFConfig, hf_init, hf_step  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.optim import api, first_order  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")  # no TF32 in a parity run
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


def _tiny(mod, **kw):
    return mod.get_smoke_config("qwen2-1.5b").replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny(jconfigs)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = j_lm_batch(jax.random.PRNGKey(1), jcfg, 2, 32)
    return dict(jm=jm, jp=jp, jb=jb, cfg=_tiny(configs),
                tp=params_from_numpy(_np(jp), "cpu"),
                tb=batch_from_numpy({k: np.asarray(v) for k, v in jb.items()}, "cpu"))


@pytest.mark.parametrize("solver", ["gn_cg", "bicgstab"])
def test_hf_step_matches_the_reference(tiny, solver):
    kw = dict(solver=solver, max_cg_iters=4, init_damping=100.0, krylov_backend="flat",
              cg_tol=0.0)
    jm, jcfg = tiny["jm"], JHFConfig(**kw)
    jp, _, jmet = jax.jit(lambda p, s, b: j_hf_step(
        jm.loss_fn, p, s, b, b, jcfg, model_out_fn=jm.logits_fn,
        out_loss_fn=jm.out_loss_fn))(tiny["jp"], j_hf_init(tiny["jp"], jcfg), tiny["jb"])
    cfg = HFConfig(**kw)
    for flash in (False, True):
        m = build_model(tiny["cfg"].replace(use_flash_attention=flash), device="cpu")
        tp, _, met = hf_step(m.loss_fn, tiny["tp"], hf_init(tiny["tp"], cfg, device="cpu"),
                             tiny["tb"], tiny["tb"], cfg, model_out_fn=m.logits_fn,
                             out_loss_fn=m.out_loss_fn, device="cpu")
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5
        assert int(met["cg_iters"]) == int(jmet["cg_iters"])
        for got, want in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("solver,mode", [
    ("gn_cg", "linearize"), ("gn_cg", "naive"), ("gn_cg", "chunked"),
    ("hybrid_cg", "linearize"), ("bicgstab", "linearize"),
])
def test_hf_step_flash_sstep_runs(solver, mode):
    """The twin of the reference's test of the same name: the s-step block
    products have no rule through the flash Functions, so hf_step builds the
    GN operator under second_order_tangents() (and make_gnvp_op re-enters it
    in its in-call modes)."""
    cfg = _tiny(configs).replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                                 vocab_size=128, use_flash_attention=True)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    batch = lm_batch(torch.Generator().manual_seed(1), cfg, 2, 16, device="cpu")
    hcfg = HFConfig(solver=solver, max_cg_iters=4, sstep_s=2, curvature_mode=mode,
                    curvature_chunk_size=1 if mode == "chunked" else 0)
    _, _, metrics = hf_step(m.loss_fn, params, hf_init(params, hcfg, device="cpu"), batch,
                            batch, hcfg, model_out_fn=m.logits_fn, out_loss_fn=m.out_loss_fn,
                            device="cpu")
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["loss_new"]))


# ------------------------------------------------------------ optimizers --
MLP_DIMS = (16, 32, 4)


@pytest.fixture(scope="module")
def mlp():
    jm = j_build_mlp(MLP_DIMS)
    jp = jm.init(jax.random.PRNGKey(1))
    jb = j_dataset(jax.random.PRNGKey(0), 64, MLP_DIMS[0], MLP_DIMS[-1])
    return dict(jm=jm, jp=jp, jb=jb, tm=build_mlp(MLP_DIMS, device="cpu"),
                tp=params_from_numpy(_np(jp), "cpu"),
                tb=batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu"))


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_first_order_steps_match_the_reference(mlp, name):
    make = {"sgd": lambda m: m.sgd(0.1), "momentum": lambda m: m.momentum_sgd(0.1, 0.9),
            "adam": lambda m: m.adam(0.01)}[name]
    jopt, topt = make(j_first_order), make(first_order)
    jp, tp = mlp["jp"], mlp["tp"]
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js, jmet = jopt.step(mlp["jm"].loss_fn, jp, js, mlp["jb"])
        tp, ts, tmet = topt.step(mlp["tm"].loss_fn, tp, ts, mlp["tb"])
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-4
    for got, want in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_make_optimizer_slices_the_curvature_batch(mlp, monkeypatch):
    seen = {}

    def fake_hf_step(loss_fn, params, state, batch, hvp_batch, cfg, **kw):
        seen.update(rows=hvp_batch["x"].shape[0], batch_rows=batch["x"].shape[0],
                    solver=cfg.solver, backend=cfg.krylov_backend, device=kw["device"])
        return params, state, {}

    monkeypatch.setattr(api, "hf_step", fake_hf_step)
    opt = api.make_optimizer(configs.HFOptConfig(name="gn_cg", hvp_batch_frac=0.25,
                                                 krylov_backend="flat"),
                             mlp["tm"].loss_fn, mlp["tm"].logits_fn, mlp["tm"].out_loss_fn,
                             device="cpu")
    opt.step(mlp["tp"], opt.init(mlp["tp"]), mlp["tb"])
    assert seen == dict(rows=16, batch_rows=64, solver="gn_cg", backend="flat", device="cpu")
    assert api._slice_batch(mlp["tb"], 0.001)["x"].shape[0] == 1
    assert api._slice_batch(mlp["tb"], 1.0) is mlp["tb"]
    # a mesh: first-order optimizers refuse it, HF builds the data-parallel
    # step, whose curvature batch is the leading quarter of the shard
    one = DataMesh(None, size=1, rank=0)
    with pytest.raises(ValueError, match="first-order"):
        api.make_optimizer(configs.HFOptConfig(name="sgd"), mlp["tm"].loss_fn, mesh=one)
    seen.clear()
    monkeypatch.setattr(distributed, "hf_step", fake_hf_step)
    opt = api.make_optimizer(configs.HFOptConfig(name="gn_cg", hvp_batch_frac=0.25),
                             mlp["tm"].loss_fn, mlp["tm"].logits_fn, mlp["tm"].out_loss_fn,
                             mesh=one, device="cpu")
    opt.step(mlp["tp"], opt.init(mlp["tp"]), mlp["tb"])
    assert seen == dict(rows=16, batch_rows=64, solver="gn_cg", backend="tree", device="cpu")


# ------------------------------------------------------------------ CLI --
def test_cli_trains_two_smoke_steps_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "history.json"
    train_mod.main(["--arch", "qwen1.5-0.5b", "--flash-attention", "--solver", "gn_cg",
                    "--krylov-backend", "flat", "--steps", "2", "--batch-size", "4",
                    "--seq-len", "32", "--max-cg-iters", "3", "--device", "cpu",
                    "--history-out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and all("λ" in ln and "cg 3" in ln for ln in lines)
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["loss_new"] <= h["loss"] for h in hist)
    assert all(set(h["launches"].values()) == {0} for h in hist)  # no kernel on the CPU
    assert "max_memory_allocated" not in hist[0]


def test_train_continues_a_run_and_first_order_runs():
    kw = dict(smoke=True, use_flash_attention=True, batch_size=2, seq_len=16,
              max_cg_iters=2, device="cpu", log_fn=lambda line: None)
    p, s, h = train_mod.train("granite-3-8b", solver="gn_cg", steps=1, **kw)
    p, s, h2 = train_mod.train("granite-3-8b", solver="bicgstab", steps=2, start=1,
                               params=p, state=s, **kw)
    assert [x["step"] for x in h + h2] == [0, 1]
    _, _, h3 = train_mod.train("chatglm3-6b", solver="adam", steps=2, lr=1e-3, **kw)
    assert len(h3) == 2 and all(np.isfinite(x["loss"]) for x in h3)


def test_cli_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--arch", "qwen2-1.5b", "--steps", "1"])


@pytest.mark.parametrize("flag,value,item", [
    ("--num-processes", "2", "item"), ("--ckpt-dir", "/nonexistent", "item 21"),
    ("--telemetry-dir", "/nonexistent", "item 22"), ("--max-restarts", "1", "item 23"),
    ("--hang-timeout", "5", "item 23"), ("--watchdog-s", "5", "item 23"),
])
def test_cli_unported_flags_raise_naming_their_item(flag, value, item):
    # --num-processes runs (the test below); across processes the naive
    # curvature mode does not yet, and the parent says so before spawning
    extra = ["--curvature-mode", "naive"] if flag == "--num-processes" else []
    with pytest.raises(NotImplementedError, match=item):
        train_mod.main(["--device", "cpu", flag, value, *extra])


def test_cli_trains_two_processes_on_the_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "history.json"
    train_mod.main(["--arch", "qwen1.5-0.5b", "--flash-attention", "--solver", "gn_cg",
                    "--krylov-backend", "flat", "--steps", "2", "--batch-size", "4",
                    "--seq-len", "32", "--max-cg-iters", "3", "--device", "cpu",
                    "--num-processes", "2", "--history-out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and all("λ" in ln and "cg 3" in ln for ln in lines)  # primary only
    ranks = [json.loads(out.read_text()), json.loads((tmp_path / "history.json.rank1").read_text())]
    for key in ("loss", "loss_new", "grad_norm", "cg_iters", "ls_evals"):
        assert [h[key] for h in ranks[0]] == [h[key] for h in ranks[1]]
    assert all(np.isfinite(h["loss"]) and h["loss_new"] <= h["loss"] for h in ranks[0])
