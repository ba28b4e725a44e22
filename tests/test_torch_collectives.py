"""The port's tagged collectives (``repro_torch.core.collectives``) across two
gloo processes on the CPU, and its copy of the sync formulas
(``repro_torch.core.comm_model``) against ``benchmarks.comm_model``.

One module-scoped spawn of two children runs every collective case; each
child imports only ``repro_torch`` and writes what it saw, and the tests
below read it.
"""
import json
import os
import textwrap

import pytest

torch = pytest.importorskip("torch")

from benchmarks import comm_model as jcomm  # noqa: E402
from repro_torch.core import comm_model  # noqa: E402
from repro_torch.launch import multiproc  # noqa: E402

WORKER = textwrap.dedent("""
    import json, sys
    import torch
    from torch.func import grad_and_value
    from repro_torch.core import collectives as C
    from repro_torch.launch import multiproc
    from repro_torch.launch.mesh import make_data_mesh

    torch.set_num_threads(1)
    multiproc.initialize_from_env("cpu")
    mesh = make_data_mesh()
    r, out = mesh.rank, {}
    calls = []
    real = mesh.all_reduce
    mesh.all_reduce = lambda buf, op: (calls.append([buf.numel(), str(buf.dtype), op]),
                                       real(buf, op))[1]

    # the mean of a tree: one all-reduce, inputs left as they were
    tree = {"a": torch.full((3,), float(r + 1)), "b": torch.arange(4.0).reshape(2, 2) * (r + 1)}
    kept = {k: v.clone() for k, v in tree.items()}
    with C.count_executed() as cnt:
        red = C.preduce(tree, mesh, "t")
    out["mean"] = {k: v.tolist() for k, v in red.items()}
    out["mean_calls"] = list(calls)
    out["inputs_kept"] = all(torch.equal(tree[k], kept[k]) for k in tree)
    out["mean_counts"] = dict(cnt.counts)
    out["mean_bytes"] = dict(cnt.nbytes)

    # sum and max; a tree of two dtypes: one all-reduce each, one count
    calls.clear()
    x = torch.tensor([1.0 + r, -2.0 * r])
    out["sum"] = C.preduce(x, mesh, "s", op="sum").tolist()
    out["max"] = C.preduce(x, mesh, "m", op="max").tolist()
    with C.count_executed() as cnt:
        mixed = C.preduce({"f": torch.ones(2) * r, "d": torch.ones(3, dtype=torch.float64) * r},
                          mesh, "mixed")
    out["mixed"] = {k: v.tolist() for k, v in mixed.items()}
    out["mixed_dtypes"] = sorted(str(v.dtype) for v in mixed.values())
    out["mixed_counts"] = [dict(cnt.counts), dict(cnt.collectives)]
    out["sum_max_calls"] = list(calls)

    # counting by tag; a block of 4 stacked tangents counts 4, one all-reduce
    with C.count_executed() as cnt:
        for _ in range(3):
            C.preduce(torch.ones(5), mesh, "grad_hvp")
        C.preduce(torch.ones(1), mesh, "loss")
        C.preduce(torch.ones(4, 5), mesh, "grad_hvp", count=4)
        with C.count_executed() as inner:
            C.preduce(torch.ones(1), mesh, "loss")
        C.preduce(torch.ones(1), mesh, "loss")
    out["tags"] = [dict(cnt.counts), dict(cnt.collectives), dict(inner.counts),
                   cnt.total(), cnt.per_device(1), dict(cnt.wait_seconds)]
    out["outside"] = C._active is None

    # a reduce started ahead: the same result as preduce, the wait timed
    with C.count_executed() as cnt:
        h = C.preduce_start([torch.full((2,), 3.0 * r)], mesh, "grad_hvp")
        waited = h.wait()
    out["started"] = waited[0].tolist()
    out["started_wait"] = [cnt.wait_seconds["grad_hvp"] >= 0.0, cnt.seconds["grad_hvp"] > 0.0]

    # the loss wrapper: mean value, local gradient, local Hessian products
    w = torch.tensor([0.3, -1.2, 2.0])
    def f(w):
        return C.preduce_value(((r + 1) * w ** 3).sum(), mesh, "loss")
    with C.count_executed() as cnt:
        g, v = grad_and_value(f)(w)
        p = w.clone().requires_grad_(True)
        gp = torch.autograd.grad(f(p), p, create_graph=True)[0]
        hv = torch.autograd.grad(gp, p, grad_outputs=torch.ones(3), retain_graph=True)[0]
        V = torch.eye(3)
        hb = torch.autograd.grad(gp, p, grad_outputs=V, is_grads_batched=True)[0]
    out["value"] = float(v)
    out["grad"] = g.tolist()
    out["hvp"] = hv.tolist()
    out["hvp_block"] = hb.tolist()
    out["wrapper_counts"] = dict(cnt.counts)
    json.dump(out, open(sys.argv[1] + f"/rank{r}.json", "w"))
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "a child of the port imported jax"
""")


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    (d / "_collectives_worker.py").write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(d), env.get("PYTHONPATH", "")])
    multiproc.spawn(2, "_collectives_worker", [str(d)], env=env, timeout_s=240)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_preduce_is_one_all_reduce_of_the_mean(seen, rank):
    s = seen[rank]
    assert s["mean"] == {"a": [1.5] * 3, "b": [[0.0, 1.5], [3.0, 4.5]]}
    assert s["mean_calls"] == [[7, "torch.float32", "mean"]]  # one buffer, one call
    assert s["inputs_kept"]
    assert s["mean_counts"] == {"t": 1} and s["mean_bytes"] == {"t": 28}


@pytest.mark.parametrize("rank", [0, 1])
def test_preduce_sum_max_and_one_buffer_per_dtype(seen, rank):
    s = seen[rank]
    assert s["sum"] == [3.0, -2.0] and s["max"] == [2.0, 0.0]
    assert s["mixed"] == {"f": [0.5, 0.5], "d": [0.5, 0.5, 0.5]}
    assert s["mixed_dtypes"] == ["torch.float32", "torch.float64"]
    assert s["mixed_counts"] == [{"mixed": 1}, {"mixed": 2}]
    assert [c[2] for c in s["sum_max_calls"]] == ["sum", "max", "mean", "mean"]


@pytest.mark.parametrize("rank", [0, 1])
def test_count_executed_counts_by_tag(seen, rank):
    counts, collectives, inner, total, per_device, waits = seen[rank]["tags"]
    assert counts == {"grad_hvp": 7, "loss": 2} and collectives == {"grad_hvp": 4, "loss": 2}
    assert inner == {"loss": 1}  # a nested region counts into its own tally only
    assert total == 9 and per_device == counts
    assert waits == {}  # only reduces started ahead count their wait
    assert seen[rank]["outside"]


@pytest.mark.parametrize("rank", [0, 1])
def test_preduce_start_waits_for_the_same_mean(seen, rank):
    assert seen[rank]["started"] == [1.5, 1.5]
    assert seen[rank]["started_wait"] == [True, True]


@pytest.mark.parametrize("rank", [0, 1])
def test_loss_wrapper_reduces_the_value_and_passes_the_local_gradient(seen, rank):
    w = torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64)
    c = rank + 1
    s = seen[rank]
    assert s["value"] == pytest.approx(float(1.5 * (w ** 3).sum()), rel=1e-6)
    assert s["grad"] == pytest.approx((3 * c * w ** 2).tolist(), rel=1e-6)
    assert s["hvp"] == pytest.approx((6 * c * w).tolist(), rel=1e-6)
    torch.testing.assert_close(torch.tensor(s["hvp_block"], dtype=torch.float64),
                               torch.diag(6 * c * w), rtol=1e-6, atol=1e-12)
    # grad_and_value and the create_graph evaluation: one reduce each
    assert s["wrapper_counts"] == {"loss": 2}


# ----------------------------------------------------- sync formulas --
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("basis", ["monomial", "newton", "chebyshev"])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_comm_model_copy_equals_the_benchmarks_formulas(s, solver, basis, overlap):
    assert comm_model.sstep_basis_len(s, solver) == jcomm.sstep_basis_len(s, solver)
    assert comm_model.sstep_bootstrap(s, solver, basis) == jcomm.sstep_bootstrap(s, solver, basis)
    for K in range(0, 21):
        for E in range(0, 6):
            assert comm_model.hf_sstep_syncs_per_iteration(
                K, E, s, solver=solver, basis=basis, overlap=overlap
            ) == jcomm.hf_sstep_syncs_per_iteration(
                K, E, s, solver=solver, basis=basis, overlap=overlap), (K, E)
            assert comm_model.hf_syncs_per_iteration(K, E) == jcomm.hf_syncs_per_iteration(K, E)
    assert comm_model.SSTEP_BOOT_APPLICATIONS == jcomm.SSTEP_BOOT_APPLICATIONS
