"""The port's telemetry (``repro_torch.obs``): the sink, the trace merge and
the overlap arithmetic, the report CLI, and the step's hooks held against
the reference's on the same inputs: the reference's ``instrumented_run``
configuration (MLP (16, 32, 4), hessian_cg, K 6, ``cg_tol`` 0, ``sstep_s``
2, one process) gives the same phase names in the same order, per-tag
collective spans equal to the executed counts, and the same solve summary;
an adaptive s-step solve gives the reference's Ritz events. The zero-cost
property is held on the port itself (not against the reference's
``test_zero_cost_when_disabled``, which fails on this jax): with no sink the
hooks never reach torch and a step's outputs are the same bits as with a
sink. A NaN batch leaves a ``step_reject`` fault event. Two CPU ranks
through ``train --num-processes 2 --telemetry-dir`` merge ``trace.json``
whose gradient reduce overlaps the curvature build on every step with
``--overlap`` and on none without it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core import HFConfig as JHFConfig, hf_init as j_hf_init  # noqa: E402
from repro.core import hf_step as j_hf_step  # noqa: E402
from repro.core.collectives import count_executed as j_count_executed  # noqa: E402
from repro.core.distributed import data_parallel_hf_step as j_dp_step  # noqa: E402
from repro.data import classification_dataset  # noqa: E402
from repro.models import build_mlp as j_build_mlp  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.collectives import DataMesh, count_executed  # noqa: E402
from repro_torch.core.distributed import data_parallel_hf_step  # noqa: E402
from repro_torch.core.hf import METRICS_SCHEMA, HFConfig, hf_init, hf_step  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402
from repro_torch.obs import report, telemetry, trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- sink --
def test_sink_roundtrip(tmp_path):
    d = str(tmp_path)
    with telemetry.Telemetry(d, process_index=3, meta={"kind": "t"}) as s:
        with s.span("outer", step=1):
            s.instant("hello", x=2)
        s.counter("depth", 4)
        s.collective_begin("g", "g")
        s.collective_begin("g", "g")   # FIFO: two in flight, same key
        s.collective_end("g", "g")
        s.collective_end("g", "g")
        s.solve_event(0, iters=3, residual=0.5)
    evs = trace.load_events(d)
    assert all(e["pid"] == 3 for e in evs)
    assert evs[0]["ev"] == "meta" and evs[0]["kind"] == "t"
    colls = [e for e in evs if e["ev"] == "coll"]
    assert len(colls) == 2 and all(c["t1"] >= c["t0"] for c in colls)
    assert colls[0]["t0"] <= colls[1]["t0"]
    span = next(e for e in evs if e["ev"] == "span")
    assert span["t1"] >= span["t0"] and span["step"] == 1


# ------------------------------------------ the reference's instrumented run --
DIMS, N = (16, 32, 4), 16
CFG = dict(solver="hessian_cg", max_cg_iters=6, cg_tol=0.0, sstep_s=2)


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree_util.tree_map(np.asarray, j_build_mlp(DIMS).init(jax.random.PRNGKey(1)))
    data = jax.tree_util.tree_map(np.asarray,
                                  classification_dataset(jax.random.PRNGKey(0), N, 16, 4))
    return params, data


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield DataMesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_run(inputs, tmp_path_factory):
    """The reference's ``instrumented_run``: one jitted s-step data-parallel
    step with its sink and executed-count instrumentation armed."""
    params, data = inputs
    model = j_build_mlp(DIMS)
    mesh = jax.make_mesh((len(jax.devices()),), ("data",))
    cfg = JHFConfig(**CFG)
    d = str(tmp_path_factory.mktemp("ref_telemetry"))
    sink = jtel.Telemetry(d)
    p = jax.tree_util.tree_map(jax.numpy.asarray, params)
    with jtel.install(sink), j_count_executed() as counts:
        step = j_dp_step(model.loss_fn, mesh, cfg)
        out = jax.jit(step)(p, j_hf_init(p, cfg), data)
        jax.block_until_ready(out[0])
    sink.close()
    return (trace.load_events(d), counts.per_device(len(jax.local_devices())),
            jax.device_get(out[2]))


@pytest.fixture(scope="module")
def port_run(inputs, gloo_mesh, tmp_path_factory):
    """The same step in the port, over a real gloo group of one."""
    params, data = inputs
    model = build_mlp(DIMS, device="cpu")
    cfg = HFConfig(**CFG)
    p = params_from_numpy(params, "cpu")
    d = str(tmp_path_factory.mktemp("port_telemetry"))
    sink = telemetry.Telemetry(d)
    with telemetry.install(sink), count_executed() as counts:
        step = data_parallel_hf_step(model.loss_fn, gloo_mesh, cfg, device="cpu")
        _, _, m = step(p, hf_init(p, cfg, device="cpu"), batch_from_numpy(data, "cpu"))
    sink.close()
    return (d, trace.load_events(d), (dict(counts.counts), dict(counts.collectives)),
            {k: float(v) for k, v in m.items()})


def test_phase_names_in_the_reference_order(reference_run, port_run):
    jevents, _, _ = reference_run
    _, events, _, _ = port_run
    names = [s["name"] for s in trace.phase_spans(events) if s["step"] == 0]
    assert names == [s["name"] for s in trace.phase_spans(jevents) if s["step"] == 0]
    # the shared-primal path: no separate grad_build phase
    assert names == ["curvature_primal", "krylov_solve", "line_search", "update_damping"]
    spans = trace.phase_spans(events)
    assert [s["t1"] for s in spans] == sorted(s["t1"] for s in spans)
    assert all(s["t1"] >= s["t0"] for s in spans)


def test_collective_spans_equal_the_executed_counts(reference_run, port_run):
    """One span per all-reduce the port issued (``collectives``); the counts
    the reference's callbacks give (a block of w stacked tangents counting
    w, though one all-reduce carries it) equal its ``counts``."""
    _, jexecuted, _ = reference_run
    _, events, (executed, calls), _ = port_run
    by_tag = {}
    for c in trace.collective_spans(events):
        by_tag[c["tag"]] = by_tag.get(c["tag"], 0) + 1
        assert c["t1"] >= c["t0"]
    assert by_tag == {t: n for t, n in calls.items() if n}
    assert executed == {t: int(n) for t, n in jexecuted.items() if n}
    # the gradient reduce carries its label on the shared path
    assert any(c["label"] == "grad_reduce" for c in trace.collective_spans(events))


def test_solve_event_matches_the_reference_and_the_metrics(reference_run, port_run):
    jevents, _, _ = reference_run
    _, events, _, m = port_run
    (want,) = [e for e in jevents if e["ev"] == "solve"]
    (sol,) = [e for e in events if e["ev"] == "solve"]
    assert sol["step"] == want["step"] == 0
    assert sol["iters"] == want["iters"] == int(m["cg_iters"])
    assert sol["syncs"] == want["syncs"] == int(m["krylov_syncs"])
    assert (sol["nc_found"], sol["breakdown"]) == (want["nc_found"], want["breakdown"])
    hist, jhist = np.asarray(sol["residual_history"]), np.asarray(want["residual_history"])
    assert len(hist) == len(jhist) == sol["iters"]
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert sol["residual"] == pytest.approx(m["cg_residual"], rel=1e-5)


def test_metrics_contract(port_run):
    _, _, _, m = port_run
    assert set(m) == set(METRICS_SCHEMA)
    assert all(np.isfinite(v) for v in m.values())


def test_report_renders_the_port_run(port_run, capsys):
    d, _, _, _ = port_run
    summary = report.render(d)
    out = capsys.readouterr().out
    assert summary["n_phases"] > 0 and summary["n_collectives"] > 0
    assert summary["n_solves"] == 1
    for section in ("phase breakdown", "collective timeline", "solve convergence"):
        assert section in out, out
    assert report.main([d, "--check"]) == 0


# ------------------------------------------------------------- Ritz events --
# s 2 at λ₀ 5, cg_tol 1e-3: there the two packages' chains agree to ~1e-5.
# At s 4 the 4-deep monomial bootstrap's smallest Ritz value follows
# round-off (λ₀ 5: 0.967 in the reference, 1.799 in the port, and the
# solves then stop at 16 and 4 iterations; λ₀ 1: the middle values 1.2%
# apart), so the s 4 Ritz values are not held against the reference.
SSTEP_CFG = dict(solver="gn_cg", max_cg_iters=16, cg_tol=1e-3, init_damping=5.0, sstep_s=2,
                 sstep_basis="newton", krylov_jitter=0.0)


def test_ritz_events_match_the_reference(inputs, tmp_path):
    """Adaptive s-step: one Ritz snapshot from the bootstrap and one per
    adaptive cycle, as the reference's, with its values (s 2, λ₀ 5, where
    the solve carries signal; see ``SSTEP_CFG``)."""
    params, data = inputs
    jm = j_build_mlp(DIMS)
    jsink = jtel.Telemetry(str(tmp_path / "j"))
    p = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jcfg = JHFConfig(**SSTEP_CFG)
    with jtel.install(jsink):
        out = jax.jit(lambda p, s: j_hf_step(jm.loss_fn, p, s, data, data, jcfg,
                                             model_out_fn=jm.logits_fn,
                                             out_loss_fn=jm.out_loss_fn))(p, j_hf_init(p, jcfg))
        jax.block_until_ready(out[0])
    jsink.close()
    model = build_mlp(DIMS, device="cpu")
    cfg = HFConfig(**SSTEP_CFG)
    tp, batch = params_from_numpy(params, "cpu"), batch_from_numpy(data, "cpu")
    sink = telemetry.Telemetry(str(tmp_path / "t"))
    with telemetry.install(sink):
        _, _, m = hf_step(model.loss_fn, tp, hf_init(tp, cfg, device="cpu"), batch, batch, cfg,
                          model_out_fn=model.logits_fn, out_loss_fn=model.out_loss_fn,
                          device="cpu")
    sink.close()
    want = [e for e in trace.load_events(str(tmp_path / "j")) if e["ev"] == "ritz"]
    got = [e for e in trace.load_events(str(tmp_path / "t")) if e["ev"] == "ritz"]
    assert len(got) == len(want) > 1
    assert len(got) == int(m["krylov_syncs"]) and not m["sstep_fallback"]
    for a, b in zip(got, want):
        assert (a["step"], a["basis"], a["ok"]) == (b["step"], b["basis"], b["ok"]) == (
            0, "newton", True)
        np.testing.assert_allclose(a["values"], b["values"], rtol=1e-4)


# ------------------------------------------------------------- zero cost --
def _mlp_step(sink, params, data, cfg):
    model = build_mlp(DIMS, device="cpu")
    ctx = telemetry.install(sink) if sink is not None else _null()
    with ctx:
        return hf_step(model.loss_fn, params, hf_init(params, cfg, device="cpu"), data, data,
                       cfg, model_out_fn=model.logits_fn, out_loss_fn=model.out_loss_fn,
                       device="cpu")


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("solver,sstep", [("gn_cg", 1), ("bicgstab", 1), ("gn_cg", 4)])
def test_zero_cost_when_off(inputs, tmp_path, monkeypatch, solver, sstep):
    """No sink: no hook records anything (the one path into torch is never
    taken); with a sink: records, and the step's outputs and launches are
    the same bits."""
    params, data = inputs
    calls = []
    real = telemetry._record
    monkeypatch.setattr(telemetry, "_record", lambda *a: (calls.append(a[0]), real(*a)))
    cfg = HFConfig(solver=solver, max_cg_iters=6, sstep_s=sstep,
                   sstep_basis="newton" if sstep > 1 else "monomial", init_damping=5.0)
    tp, batch = params_from_numpy(params, "cpu"), batch_from_numpy(data, "cpu")
    before = dict(ops.LAUNCHES)
    off = _mlp_step(None, tp, batch, cfg)
    launches_off = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    assert calls == []
    before = dict(ops.LAUNCHES)
    with telemetry.Telemetry(str(tmp_path)) as sink:
        on = _mlp_step(sink, tp, batch, cfg)
    assert {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES} == launches_off
    assert "phase" in calls and "solve" in calls and "reject" in calls
    assert ("ritz" in calls) == (sstep > 1)
    for a, b in zip(jax.tree_util.tree_leaves((off[0], tuple(off[1]))),
                    jax.tree_util.tree_leaves((on[0], tuple(on[1])))):
        assert torch.equal(a, b)
    assert set(off[2]) == set(on[2])
    for k in off[2]:
        assert torch.equal(off[2][k], on[2][k]), k
    assert telemetry._records == []


def test_hooks_return_before_torch_without_a_sink(monkeypatch):
    """Every hook with no sink installed returns before it looks at its
    arguments: handed objects that raise on any use, nothing happens."""
    class Poison:
        def __getattr__(self, name):
            raise AssertionError(f"hook touched its argument ({name})")

    x = Poison()
    assert telemetry.active() is None
    telemetry.marker("p", x, step=x)
    telemetry.solve_event(x, iters=x, residual=x, syncs=x, residual_history=x, nc_found=x,
                          breakdown=x)
    telemetry.reject_event(x, x, x, x)
    telemetry.ritz_event(x, x, basis="newton")
    telemetry.anchor(x)
    telemetry.flush()
    assert telemetry._records == []


def test_step_reject_event_from_a_nan_batch(inputs, tmp_path):
    params, data = inputs
    tp = params_from_numpy(params, "cpu")
    batch = batch_from_numpy(data, "cpu")
    batch["x"] = batch["x"] * float("nan")
    with telemetry.Telemetry(str(tmp_path)) as sink:
        _, _, m = _mlp_step(sink, tp, batch, HFConfig(solver="gn_cg", max_cg_iters=4))
    assert bool(m["step_rejected"])
    faults = trace.fault_events(trace.load_events(str(tmp_path)))
    assert [(e["kind"], e["step"]) for e in faults] == [("step_reject", 0)]


# ------------------------------------------------- trace merge and report --
def _synthetic_events():
    return [
        {"ev": "meta", "pid": 0, "process": 0, "ts": 100.0},
        {"ev": "phase", "pid": 0, "name": "step_begin", "step": 0, "ts": 100.0},
        {"ev": "phase", "pid": 0, "name": "grad_build", "step": 0, "ts": 100.1},
        {"ev": "phase", "pid": 0, "name": "curvature_primal", "step": 0, "ts": 100.4},
        {"ev": "coll", "pid": 0, "tag": "grad_hvp", "label": "grad_reduce",
         "t0": 100.15, "t1": 100.35},
        {"ev": "coll", "pid": 1, "tag": "grad_hvp", "label": "grad_reduce",
         "t0": 100.0, "t1": 100.05},
        {"ev": "phase", "pid": 1, "name": "step_begin", "step": 0, "ts": 99.9},
        {"ev": "phase", "pid": 1, "name": "grad_reduce", "step": 0, "ts": 100.05},
        {"ev": "phase", "pid": 1, "name": "curvature_primal", "step": 0, "ts": 100.3},
        {"ev": "counter", "pid": 0, "name": "loss", "value": 2.0, "ts": 100.4},
        {"ev": "span", "pid": 0, "name": "host_step", "t0": 100.0, "t1": 100.5, "step": 0},
    ]


def test_overlap_math_on_synthetic_events():
    evs = _synthetic_events()
    assert trace.overlap_seconds(dict(t0=0.0, t1=2.0), dict(t0=1.0, t1=3.0)) == 1.0
    assert trace.overlap_seconds(dict(t0=0.0, t1=1.0), dict(t0=2.0, t1=3.0)) == 0.0
    by_pid = {r["pid"]: r for r in trace.grad_reduce_overlap(evs)}
    assert by_pid[0]["overlap_s"] == pytest.approx(0.2, abs=1e-9)
    assert by_pid[1]["overlap_s"] == pytest.approx(0.0, abs=1e-9)


def test_build_trace_structure(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "events-p0.jsonl"), "w") as f:
        for e in _synthetic_events():
            if e.get("pid") == 0:
                f.write(json.dumps({k: v for k, v in e.items() if k != "pid"}) + "\n")
    out = trace.merge_dir(d)
    assert os.path.basename(out) == "trace.json"
    evs = json.load(open(out))["traceEvents"]
    phases = [e for e in evs if e.get("ph") == "X"]
    assert phases and all(e["ts"] >= 0 and e["dur"] >= 1 for e in phases)
    assert {e["ph"] for e in evs} >= {"X", "M", "C"}
    assert {"grad_build", "curvature_primal", "grad_reduce", "host_step"} <= {
        e["name"] for e in phases}


def test_report_check_fails_on_empty(tmp_path):
    d = str(tmp_path)
    with telemetry.Telemetry(d):
        pass
    assert report.main([d, "--check"]) == 1


def test_report_cli_runs_as_a_module(port_run):
    d, _, _, _ = port_run
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", d, "--check"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "solve convergence" in r.stdout


# ------------------------------------------- two ranks through the CLI --
def _two_rank_trace(overlap: bool, d: str):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
           "--smoke", "--num-processes", "2", "--steps", "2", "--batch-size", "8",
           "--seq-len", "16", "--max-cg-iters", "4", "--sstep", "2", "--device", "cpu",
           "--telemetry-dir", d] + (["--overlap"] if overlap else [])
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(os.path.join(d, "trace.json"))
    evs = trace.load_events(d)
    assert {e["pid"] for e in evs} == {0, 1}
    return trace.grad_reduce_overlap(evs)


def test_two_process_trace_shows_overlap(tmp_path):
    rows_ov = _two_rank_trace(True, str(tmp_path / "ov"))
    rows_bl = _two_rank_trace(False, str(tmp_path / "bl"))
    for pid in (0, 1):
        ov = [r for r in rows_ov if r["pid"] == pid]
        bl = [r for r in rows_bl if r["pid"] == pid]
        assert len(ov) == len(bl) == 2, (rows_ov, rows_bl)
        assert all(r["overlap_s"] > 0 for r in ov), rows_ov
        assert all(r["overlap_s"] == 0 for r in bl), rows_bl
