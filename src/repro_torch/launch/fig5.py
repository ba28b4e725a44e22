"""The executed schedule of the paper's Fig. 5 scaling claim, on the current
process set (the port's twin of ``benchmarks/fig5_scaling.py``'s executed
series and its ``--worker``).

Each combo runs 2 outer HF steps of an MLP through
``core.distributed.data_parallel_hf_step`` (``cg_tol`` 0 pins the solve to
K iterations; the curvature batch is the whole shard) under
``count_executed``, and records per step: the metrics, the executed
collectives per tag, the host seconds inside ``preduce``, the host's wait
on the hidden gradient reduce, the kernel launches (``kernels.ops``) and
the wall (after ``torch.cuda.synchronize()`` on the card).

  PYTHONPATH=src python -m repro_torch.launch.fig5 --runs cg_s1:flat,bicgstab_s1:flat \\
      --dims 360,512,512,512,1973 --batch 4096 --out OUT --num-processes 2

writes ``OUT/rank<r>.json`` from each rank: a list of combo records. With
``--data FILE.npz`` the batch (``x``, ``y``) and the parameters (``p0``,
``p1``, ... in the flattened order of the port's tree) come from the file
instead of from seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.collectives import count_executed
from ..core.distributed import data_parallel_hf_step
from ..core.hf import HFConfig, hf_init
from ..data.synthetic import classification_dataset
from ..kernels import ops
from ..models.mlp import build_mlp
from . import multiproc
from .mesh import make_data_mesh

EXEC_K = 8      # cg_tol 0 pins the solve to K iterations
EXEC_STEPS = 2  # outer steps a combo (Bi-CG-STAB s=2 takes one)

# {cg, bicgstab} × {s=1, s>1 newton} + the monomial overlap pair, as the
# reference's EXEC_COMBOS. Bi-CG-STAB s=2 takes one step: its later steps
# follow the round-off of the reduction order (the reference's note).
EXEC_COMBOS = {
    "cg_s1": dict(solver="gn_cg", s=1, basis="monomial", overlap=False),
    "cg_s4_newton": dict(solver="gn_cg", s=4, basis="newton", overlap=False),
    "bicgstab_s1": dict(solver="bicgstab", s=1, basis="monomial", overlap=False),
    "bicgstab_s2_newton": dict(solver="bicgstab", s=2, basis="newton", overlap=False,
                               n_steps=1),
    "cg_s2": dict(solver="gn_cg", s=2, basis="monomial", overlap=False),
    "cg_s2_overlap": dict(solver="gn_cg", s=2, basis="monomial", overlap=True),
}


def _delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def run_combo(name, model, params, data, mesh, *, cg_tol=0.0, init_damping=1.0,
              backend="tree", device="cuda") -> dict:
    """One combo's record on this rank: ``params`` and ``data`` are the
    global ones (the same on every rank); the step runs on this rank's
    shard of ``data``."""
    spec = EXEC_COMBOS[name]
    dev = torch.device(device)
    cfg = HFConfig(solver=spec["solver"], max_cg_iters=EXEC_K, cg_tol=cg_tol,
                   init_damping=init_damping, sstep_s=spec["s"],
                   sstep_basis=spec["basis"], overlap=spec["overlap"],
                   krylov_backend=backend)
    step = data_parallel_hf_step(model.loss_fn, mesh, cfg, model_out_fn=model.logits_fn,
                                 out_loss_fn=model.out_loss_fn, device=dev)
    p, s = multiproc.replicate((params, hf_init(params, cfg, device=dev)), mesh)
    batch = multiproc.shard_batch(data, mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rows = []
    with count_executed() as counts:
        for _ in range(spec.get("n_steps", EXEC_STEPS)):
            before = (dict(counts.counts), sum(counts.seconds.values()),
                      counts.wait_seconds["grad_hvp"], dict(ops.LAUNCHES))
            sync()
            t0 = time.perf_counter()
            p, s, m = step(p, s, batch)
            sync()
            row = {k: float(v) for k, v in m.items()}
            row.update(
                wall_s=time.perf_counter() - t0,
                executed=_delta(dict(counts.counts), before[0]),
                preduce_s=sum(counts.seconds.values()) - before[1],
                grad_wait_s=counts.wait_seconds["grad_hvp"] - before[2],
                launches=_delta(dict(ops.LAUNCHES), before[3]),
            )
            rows.append(row)
    return {
        "combo": name, **spec, "backend": backend, "init_damping": init_damping,
        "cg_tol": cg_tol, "n_processes": mesh.size,
        "rank": mesh.rank, "final_loss": rows[-1]["loss_new"], "steps": rows,
        "executed": counts.per_device(), "collectives": dict(counts.collectives),
        "bytes_per_reduce": {t: counts.nbytes[t] // counts.collectives[t]
                             for t in counts.collectives},
    }


def _inputs(args, dev):
    if args.data:
        with np.load(args.data) as f:
            arrays = {k: f[k] for k in f.files}
        leaves = [arrays[f"p{i}"] for i in range(sum(k.startswith("p") for k in arrays))]
        dims = [leaves[1].shape[0]] + [w.shape[1] for w in leaves[1::2]]
        model = build_mlp(dims, device=dev)
        _, spec = tree_flatten(model.init(torch.Generator().manual_seed(0)))
        params = tree_unflatten([torch.from_numpy(a).to(dev) for a in leaves], spec)
        data = {"x": torch.from_numpy(arrays["x"]).to(dev),
                "y": torch.from_numpy(arrays["y"]).long().to(dev)}
        return model, params, data
    dims = [int(d) for d in args.dims.split(",")]
    model = build_mlp(dims, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    data = classification_dataset(torch.Generator().manual_seed(1), args.batch, dims[0],
                                  dims[-1], device=dev)
    return model, params, data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", required=True,
                    help="comma-separated combo:backend[:init_damping:cg_tol] runs, backend "
                         "tree or flat, λ₀ 1 and cg_tol 0 if not given")
    ap.add_argument("--data", default=None, help="npz of x, y and p0, p1, ...")
    ap.add_argument("--dims", default="16,32,4",
                    help="MLP widths (without --data; parameters from seed 0, data seed 1)")
    ap.add_argument("--batch", type=int, default=16, help="global batch (without --data)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", required=True, help="directory for rank<r>.json")
    ap.add_argument("--num-processes", type=int, default=1)
    args = ap.parse_args(argv)
    if not multiproc.active():
        multiproc.spawn(args.num_processes, "repro_torch.launch.fig5",
                        list(sys.argv[1:] if argv is None else argv))
        return
    dev = multiproc.initialize_from_env(args.device)
    mesh = make_data_mesh()
    model, params, data = _inputs(args, dev)
    records = []
    for run in args.runs.split(","):
        name, backend, *kw = run.split(":")
        damping, cg_tol = (float(x) for x in kw) if kw else (1.0, 0.0)
        rec = run_combo(name, model, params, data, mesh, cg_tol=cg_tol, init_damping=damping,
                        backend=backend, device=dev)
        records.append(rec)
        if multiproc.is_primary():
            print(f"[fig5] {name} {backend} nproc={mesh.size}: loss "
                  f"{[round(r['loss_new'], 6) for r in rec['steps']]} blocking "
                  f"{[int(r['blocking_syncs']) for r in rec['steps']]} executed "
                  f"{rec['executed']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(records, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
