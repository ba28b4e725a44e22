"""The port's data-parallel HF step (``repro_torch.core.distributed``) at one
and two gloo processes on the CPU, held against a live run of the
reference's ``repro.core.distributed.data_parallel_hf_step`` on a 1-device
mesh under ``count_executed``, on the same inputs: the fig5 executed series
(``benchmarks/fig5_scaling.py``: MLP (16, 32, 4), batch 16, K = 8,
``cg_tol`` 0, data from ``PRNGKey(0)``, parameters from ``PRNGKey(1)``).

At the series' damping (λ₀ = 1) the Bi-CG-STAB solves on this indefinite
Hessian follow round-off: the reference's own plain ``hf_step`` and its
shard_map step part by ~6e-3 in the first step's loss, and the line search
then takes a different number of trials. For those runs the Krylov
schedule (the gradient/product reduces a step) is held against the
reference and the loss-reduce count against 1 + E; their losses, and the
whole count, are held where the solve carries signal, at λ₀ = 5 with
``cg_tol`` 1e-3 (the port's s-step parity setting), for both Bi-CG-STAB
combos. The CG combos are held on both steps at λ₀ = 1.

One module-scoped spawn per process count runs every run; each child imports
only ``repro_torch``.
"""
import concurrent.futures
import json
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from benchmarks import fig5_scaling as f5  # noqa: E402
from repro.core import HFConfig as JHFConfig, hf_init as j_hf_init  # noqa: E402
from repro.core.collectives import count_executed as j_count_executed  # noqa: E402
from repro.core.distributed import data_parallel_hf_step as j_dp_step  # noqa: E402
from repro.data import classification_dataset as j_dataset  # noqa: E402
from repro.launch import multiproc as j_multiproc  # noqa: E402
from repro.models import build_mlp as j_build_mlp  # noqa: E402
from repro_torch.core import comm_model, hf as hf_mod  # noqa: E402
from repro_torch.core.collectives import DataMesh  # noqa: E402
from repro_torch.core.distributed import data_parallel_hf_step  # noqa: E402
from repro_torch.core.hf import HFConfig, hf_init, hf_step  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import fig5, multiproc  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402

# (combo, backend, λ₀, cg_tol): the fig5 series, the flat backend on the
# standard solvers, and the Bi-CG-STAB combos where the solve carries signal.
RUNS = [(name, "tree", 1.0, 0.0) for name in f5.EXEC_COMBOS] + [
    ("cg_s1", "flat", 1.0, 0.0), ("bicgstab_s1", "flat", 1.0, 0.0),
    ("bicgstab_s1", "tree", 5.0, 1e-3), ("bicgstab_s1", "flat", 5.0, 1e-3),
    ("bicgstab_s2_newton", "tree", 5.0, 1e-3),
]
IDS = [f"{n}-{b}-lam{lam:g}" for n, b, lam, _ in RUNS]
REF_KEYS = sorted({(n, lam, tol) for n, _, lam, tol in RUNS})
STEPS = 2  # the series' outer steps (fig5_scaling.run_bench)

WORKER = textwrap.dedent("""
    import sys
    import torch
    from repro_torch.launch import fig5

    torch.set_num_threads(1)
    fig5.main(sys.argv[1:])
    assert "jax" not in sys.modules, "a child of the port imported jax"
""")


def _spec(run):
    return f5.EXEC_COMBOS[run[0]]


def _roundoff_bound(run):
    """A Bi-CG-STAB run at the series' damping: its losses follow round-off."""
    return _spec(run)["solver"] == "bicgstab" and run[2] == 1.0


def _ref_run(name, damping, cg_tol):
    """``benchmarks.fig5_scaling.run_combo`` with the damping and tolerance
    given, and the executed counts taken per step."""
    spec = f5.EXEC_COMBOS[name]
    model = j_build_mlp(f5.EXEC_DIMS)
    params = model.init(jax.random.PRNGKey(1))
    data = j_dataset(jax.random.PRNGKey(0), f5.EXEC_BATCH, f5.EXEC_DIMS[0], f5.EXEC_DIMS[-1])
    cfg = JHFConfig(solver=spec["solver"], max_cg_iters=f5.EXEC_K, cg_tol=cg_tol,
                    init_damping=damping, sstep_s=spec["s"], sstep_basis=spec["basis"],
                    overlap=spec["overlap"])
    mesh = jax.make_mesh((1,), ("data",))
    step = j_dp_step(model.loss_fn, mesh, cfg, model_out_fn=model.logits_fn,
                     out_loss_fn=model.out_loss_fn)
    p = j_multiproc.replicate(params, mesh)
    s = j_multiproc.replicate(j_hf_init(params, cfg), mesh)
    batch = j_multiproc.shard_batch(data, mesh)
    rows = []
    with j_count_executed() as counts:
        jitted = jax.jit(step)
        for _ in range(spec.get("n_steps", STEPS)):
            before = dict(counts.counts)
            p, s, m = jitted(p, s, batch)
            jax.block_until_ready(p)
            jax.effects_barrier()
            row = {k: float(v) for k, v in m.items()}
            row["executed"] = {k: n - before.get(k, 0) for k, n in counts.counts.items()
                               if n != before.get(k, 0)}
            rows.append(row)
    return rows


def _spawn(d, n):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(d), env.get("PYTHONPATH", "")])
    runs = ",".join(f"{n_}:{b}:{lam}:{tol}" for n_, b, lam, tol in RUNS)
    multiproc.spawn(n, "_dp_worker", ["--runs", runs, "--data", str(d / "exec.npz"),
                                      "--device", "cpu", "--out", str(d / f"n{n}")],
                    env=env, timeout_s=300)
    return [json.loads((d / f"n{n}" / f"rank{r}.json").read_text()) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{1: [rank0 records], 2: [rank0 records, rank1 records]} of the port,
    and the reference's rows per (combo, λ₀, cg_tol)."""
    d = tmp_path_factory.mktemp("distributed")
    (d / "_dp_worker.py").write_text(WORKER)
    model = j_build_mlp(f5.EXEC_DIMS)
    leaves = jax.tree_util.tree_leaves(model.init(jax.random.PRNGKey(1)))
    data = j_dataset(jax.random.PRNGKey(0), f5.EXEC_BATCH, f5.EXEC_DIMS[0], f5.EXEC_DIMS[-1])
    np.savez(d / "exec.npz", x=np.asarray(data["x"]), y=np.asarray(data["y"]),
             **{f"p{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(_spawn, d, n) for n in (1, 2)}
        ref = {key: _ref_run(*key) for key in REF_KEYS}
        port = {n: f.result() for n, f in futs.items()}
    return port, ref


def _port(runs, run, nproc, rank=0):
    i = RUNS.index(run)
    return runs[0][nproc][rank][i]


def _ref(runs, run):
    return runs[1][(run[0], run[2], run[3])]


def _close(a, b):
    return abs(a - b) <= 1e-4 * max(1.0, abs(b))


def _family(run):
    return "bicgstab" if _spec(run)["solver"] == "bicgstab" else "cg"


@pytest.mark.parametrize("nproc", [1, 2])
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_loss_matches_the_reference(runs, run, nproc):
    rec, ref = _port(runs, run, nproc), _ref(runs, run)
    assert len(rec["steps"]) == len(ref)
    assert _close(rec["steps"][0]["loss"], ref[0]["loss"])
    if _roundoff_bound(run):
        return
    for got, want in zip(rec["steps"], ref):
        assert _close(got["loss_new"], want["loss_new"]), (got["loss_new"], want["loss_new"])


@pytest.mark.parametrize("nproc", [1, 2])
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_executed_counts_match_the_reference(runs, run, nproc):
    rec, ref = _port(runs, run, nproc), _ref(runs, run)
    if not _roundoff_bound(run):
        assert rec["executed"] == {k: sum(r["executed"].get(k, 0) for r in ref)
                                   for k in ref[0]["executed"]}
        assert [r["executed"] for r in rec["steps"]] == [r["executed"] for r in ref]
        return
    # The Krylov schedule is the reference's; the line search's trials follow
    # the direction, which follows round-off here.
    for got in rec["steps"]:
        krylov = {k: v for k, v in got["executed"].items() if k != "loss"}
        assert krylov == {k: v for k, v in ref[0]["executed"].items() if k != "loss"}


@pytest.mark.parametrize("nproc", [1, 2])
@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_blocking_syncs_equal_the_sync_formula(runs, run, nproc):
    """At ``cg_tol`` 0 (the series) every cycle runs whole and the count is
    the formula's at the executed K and E, as ``fig5_scaling.check`` holds
    it; with a tolerance the adaptive cycles may run shorter, and the count
    is the reference's."""
    rec, spec = _port(runs, run, nproc), _spec(run)
    for i, st in enumerate(rec["steps"]):
        K, E = int(st["cg_iters"]), int(st["ls_evals"])
        if run[3] == 0.0:
            assert int(st["blocking_syncs"]) == comm_model.hf_sstep_syncs_per_iteration(
                K, E, spec["s"], solver=_family(run), basis=spec["basis"],
                overlap=spec["overlap"])
        else:
            assert st["blocking_syncs"] == _ref(runs, run)[i]["blocking_syncs"]
        assert st["executed"]["loss"] == 1 + E
        assert st["executed"].get("out_loss", 0) == (_family(run) == "cg")
        assert st["sstep_fallback"] == 0.0
    if spec["s"] == 1 and not spec["overlap"]:
        assert all(int(st["blocking_syncs"]) == comm_model.hf_syncs_per_iteration(
            int(st["cg_iters"]), int(st["ls_evals"])) for st in rec["steps"])


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_both_ranks_take_the_same_steps(runs, run):
    a, b = _port(runs, run, 2, 0), _port(runs, run, 2, 1)
    for sa, sb in zip(a["steps"], b["steps"]):
        for key in sa:
            if key not in ("wall_s", "preduce_s", "grad_wait_s"):
                assert sa[key] == sb[key], key
    assert a["bytes_per_reduce"]["grad_hvp"] == 676 * 4 or _spec(run)["s"] > 1


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_two_processes_match_one(runs, run):
    one, two = _port(runs, run, 1), _port(runs, run, 2)
    if _roundoff_bound(run):
        for a, b in zip(one["steps"], two["steps"]):
            assert a["executed"]["grad_hvp"] == b["executed"]["grad_hvp"]
        return
    # the reference's own multi-process gate (fig5_scaling.check)
    assert _close(two["final_loss"], one["final_loss"])
    assert one["executed"] == two["executed"]


def test_the_port_runs_the_reference_series():
    assert fig5.EXEC_COMBOS == f5.EXEC_COMBOS
    assert (fig5.EXEC_K, fig5.EXEC_STEPS) == (f5.EXEC_K, STEPS)


# ------------------------------------------------ schedule in one process --
class _Work:
    def __init__(self, log, n):
        self.log, self.n = log, n

    def wait(self):
        self.log.append(("wait", self.n))


class _RecordingMesh(DataMesh):
    """A one-process mesh standing in for a process group: every all-reduce
    is logged where it is issued and where it is waited on."""

    def __init__(self, log):
        super().__init__(None, size=1, rank=0)
        self.log = log

    def all_reduce(self, buf, op):
        self.log.append(("issue", buf.numel()))
        return _Work(self.log, buf.numel())


@pytest.fixture(scope="module")
def exec_inputs():
    model = j_build_mlp(f5.EXEC_DIMS)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1)))
    data = j_dataset(jax.random.PRNGKey(0), f5.EXEC_BATCH, f5.EXEC_DIMS[0], f5.EXEC_DIMS[-1])
    tm = build_mlp(f5.EXEC_DIMS, device="cpu")
    return tm, params_from_numpy(params, "cpu"), {
        "x": torch.from_numpy(np.array(data["x"])),
        "y": torch.from_numpy(np.array(data["y"])).long()}


@pytest.mark.parametrize("overlap", [False, True])
def test_overlap_starts_the_gradient_reduce_before_the_operator_build(
        exec_inputs, monkeypatch, overlap):
    tm, params, data = exec_inputs
    log = []
    real_build = hf_mod.make_gnvp_op

    def build(*a, **k):
        log.append(("build", 0))
        op = real_build(*a, **k)
        log.append(("built", 0))
        return op

    monkeypatch.setattr(hf_mod, "make_gnvp_op", build)
    cfg = HFConfig(solver="gn_cg", max_cg_iters=8, cg_tol=0.0, sstep_s=2, overlap=overlap)
    step = data_parallel_hf_step(tm.loss_fn, _RecordingMesh(log), cfg,
                                 model_out_fn=tm.logits_fn, out_loss_fn=tm.out_loss_fn,
                                 device="cpu")
    step(params, hf_init(params, cfg, device="cpu"), data)
    n = sum(leaf.numel() for leaf in jax.tree_util.tree_leaves(params))
    model_sized = [i for i, (what, size) in enumerate(log) if what == "issue" and size % n == 0]
    grad_issue, first_product = model_sized[0], model_sized[1]
    grad_wait = log.index(("wait", n), grad_issue)
    build, built = log.index(("build", 0)), log.index(("built", 0))
    if overlap:
        assert grad_issue < build < built < grad_wait < first_product, log[:12]
    else:
        assert grad_issue < grad_wait < build < built < first_product, log[:12]


def test_one_process_mesh_gives_the_plain_step(exec_inputs):
    tm, params, data = exec_inputs
    cfg = HFConfig(solver="bicgstab", max_cg_iters=4, cg_tol=0.0, init_damping=100.0)
    step = data_parallel_hf_step(tm.loss_fn, _RecordingMesh([]), cfg, device="cpu")
    p1, _, m1 = step(params, hf_init(params, cfg, device="cpu"), data)
    p2, _, m2 = hf_step(tm.loss_fn, params, hf_init(params, cfg, device="cpu"), data, data, cfg,
                        device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)):
        assert torch.equal(a, b)
    assert float(m1["loss_new"]) == float(m2["loss_new"])


@pytest.mark.parametrize("mode", ["naive", "chunked"])
def test_unported_curvature_modes_raise_naming_their_item(exec_inputs, mode):
    tm = exec_inputs[0]
    with pytest.raises(NotImplementedError, match="item 27"):
        data_parallel_hf_step(tm.loss_fn, _RecordingMesh([]),
                              HFConfig(curvature_mode=mode, curvature_chunk_size=4))


def test_data_axes_must_be_the_mesh_axes(exec_inputs):
    with pytest.raises(ValueError, match="data_axes"):
        data_parallel_hf_step(exec_inputs[0].loss_fn, _RecordingMesh([]), HFConfig(),
                              data_axes=("pod", "data"))
