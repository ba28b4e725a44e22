"""Training entry point (twin of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --full \\
      --flash-attention --solver gn_cg --krylov-backend flat --steps 2

Runs the HF optimizer (or a first-order baseline) on synthetic LM batches
and prints the reference's per-step line. ``--smoke`` (the default) selects
the reduced configuration, ``--full`` the published one. The run is on the
card unless ``--device cpu`` is given.

``--num-processes N`` (N > 1) re-launches this command as N processes
(``launch.multiproc.spawn``) that run the data-parallel HF step
(``core.distributed``) over a gloo group: each takes its shard of every
step's batch, and only the primary logs. With ``--history-out PATH`` rank 0
writes PATH and rank r > 0 ``PATH.rank<r>``. The flags of the parts not
ported yet (checkpoints, telemetry, supervised restarts) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .._device import resolve_device
from ..configs import ARCH_IDS, UNPORTED_ARCH_IDS, HFOptConfig, get_config, get_smoke_config
from ..core.distributed import require_linearize
from ..data.synthetic import lm_batch
from ..kernels import ops
from ..models.transformer import build_model
from ..optim import make_optimizer
from . import multiproc
from .mesh import make_data_mesh

# Flags of the reference whose parts are not ported yet: (type, default, what
# and its ROADMAP item). Each raises when it asks for anything but the default.
UNPORTED_FLAGS = {
    "ckpt_dir": (str, None, "checkpoints (ROADMAP item 21)"),
    "telemetry_dir": (str, None, "telemetry (ROADMAP item 22)"),
    "max_restarts": (int, 0, "supervised restarts (ROADMAP item 23)"),
    "hang_timeout": (float, 0.0, "supervised restarts (ROADMAP item 23)"),
    "watchdog_s": (float, 0.0, "the collective watchdog (ROADMAP item 23)"),
}


def train(
    arch: str,
    *,
    smoke: bool = True,
    solver: str = "bicgstab",
    use_flash_attention: bool = False,
    steps: int = 20,
    batch_size: int = 8,
    seq_len: int = 64,
    lr: float = 0.1,
    hvp_batch_frac: float = 0.25,
    max_cg_iters: int = 8,
    precondition: bool = False,
    krylov_backend: str = "tree",
    curvature_mode: str = "linearize",
    curvature_chunk_size: int = 0,
    sstep: int = 1,
    sstep_solver: str = "auto",
    sstep_basis: str = "monomial",
    overlap: bool = False,
    nc_mode: str = "truncate",
    strict_descent: bool = False,
    distributed: bool = False,
    device="cuda",
    params=None,
    state=None,
    start: int = 0,
    log_fn=print,
):
    """Returns (params, state, history). Parameters come from ``init`` with
    generator seed 0 and the batch of step i from seed 1000 + i, as the
    reference's PRNG keys do. ``params``/``state``/``start`` continue a run
    in this process (the optimizer's state must fit ``solver``: every HF
    solver shares one). Each history entry holds the step's metrics, its
    wall (taken after ``torch.cuda.synchronize()`` on the card), the kernel
    launches it made (``launches``; none on the CPU), and on the card the
    peak device memory (``max_memory_allocated``).

    ``distributed``: run the data-parallel step over the default process
    group (``multiproc.initialize_from_env`` first): every rank makes the
    same global batch and keeps its shard, the parameters and state are
    rank 0's on every rank, and only the primary calls ``log_fn``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if use_flash_attention:
        cfg = cfg.replace(use_flash_attention=True)
    model = build_model(cfg, device=dev)
    opt_cfg = HFOptConfig(
        name=solver, lr=lr, hvp_batch_frac=hvp_batch_frac,
        max_cg_iters=max_cg_iters, precondition=precondition,
        krylov_backend=krylov_backend,
        curvature_mode=curvature_mode,
        curvature_chunk_size=curvature_chunk_size,
        sstep_s=sstep, sstep_solver=sstep_solver, sstep_basis=sstep_basis,
        overlap=overlap, nc_mode=nc_mode, strict_descent=strict_descent,
    )
    mesh = None
    if distributed:
        mesh = make_data_mesh()
        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} not divisible by data-mesh size "
                             f"{mesh.size}")
        if not multiproc.is_primary():
            log_fn = lambda *a, **k: None  # noqa: E731  (primary-only logging)
    opt = make_optimizer(opt_cfg, model.loss_fn, model_out_fn=model.logits_fn,
                         out_loss_fn=model.out_loss_fn, mesh=mesh, device=dev)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    if state is None:
        state = opt.init(params)
    if mesh is not None:
        params, state = multiproc.replicate((params, state), mesh)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    history = []
    for i in range(start, steps):
        batch = lm_batch(torch.Generator().manual_seed(1000 + i), cfg, batch_size, seq_len,
                         device=dev)
        if mesh is not None:
            batch = multiproc.shard_batch(batch, mesh)
        before = dict(ops.LAUNCHES)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        params, state, metrics = opt.step(params, state, batch)
        sync()
        wall_s = time.perf_counter() - t0
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step"] = i
        metrics["wall_s"] = wall_s
        metrics["launches"] = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        if on_card:
            metrics["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        history.append(metrics)
        log_fn(
            f"step {i:4d} loss {metrics['loss']:.4f} |g| {metrics['grad_norm']:.3f}"
            + (f" λ {metrics['lambda']:.3g} α {metrics['alpha']:.2f} cg {metrics['cg_iters']:.0f}"
               if "lambda" in metrics else "")
        )
    return params, state, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCH_IDS + UNPORTED_ARCH_IDS), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--solver", default="bicgstab",
                    choices=["sgd", "momentum", "adam", "gn_cg", "hessian_cg",
                             "hybrid_cg", "bicgstab"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--hvp-batch-frac", type=float, default=0.25,
                    help="curvature mini-batch: the leading fraction of the batch")
    ap.add_argument("--max-cg-iters", type=int, default=8)
    ap.add_argument("--flash-attention", action="store_true",
                    help="route attention through the flash-attention kernels "
                         "(their plain versions on the CPU)")
    ap.add_argument("--precondition", action="store_true",
                    help="Jacobi preconditioning (PCG / preconditioned Bi-CG-STAB)")
    ap.add_argument("--krylov-backend", default="tree", choices=["tree", "flat"],
                    help="Krylov vectors as parameter trees, or one flat f32 buffer "
                         "whose recurrences run through the fused CUDA kernels")
    ap.add_argument("--curvature-mode", default="linearize",
                    choices=["naive", "linearize", "chunked"])
    ap.add_argument("--curvature-chunk-size", type=int, default=0)
    ap.add_argument("--sstep", type=int, default=1,
                    help="s-step Krylov solve: one Gram reduction per S iterations")
    ap.add_argument("--sstep-solver", default="auto", choices=["auto", "cg", "bicgstab"])
    ap.add_argument("--sstep-basis", default="monomial",
                    choices=["monomial", "newton", "chebyshev"])
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered s-step cycles and paired line-search trials")
    ap.add_argument("--nc-mode", default="truncate", choices=["truncate", "escape"])
    ap.add_argument("--strict-descent", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--num-processes", type=int, default=1,
                    help="data-parallel HF over N processes (gloo), N > 1")
    for flag, (kind, default, _) in UNPORTED_FLAGS.items():
        ap.add_argument("--" + flag.replace("_", "-"), type=kind, default=default)
    args = ap.parse_args(argv)
    for flag, (_, default, what) in UNPORTED_FLAGS.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported yet")
    if args.num_processes > 1 and not multiproc.active():
        require_linearize(args.curvature_mode)  # before N processes start
        multiproc.spawn(args.num_processes, "repro_torch.launch.train",
                        list(sys.argv[1:] if argv is None else argv))
        return
    distributed = multiproc.active()
    device = multiproc.initialize_from_env(args.device) if distributed else args.device

    _, _, history = train(
        args.arch, smoke=args.smoke, solver=args.solver, steps=args.steps,
        use_flash_attention=args.flash_attention,
        batch_size=args.batch_size, seq_len=args.seq_len, lr=args.lr,
        hvp_batch_frac=args.hvp_batch_frac,
        max_cg_iters=args.max_cg_iters, precondition=args.precondition,
        krylov_backend=args.krylov_backend,
        curvature_mode=args.curvature_mode,
        curvature_chunk_size=args.curvature_chunk_size,
        sstep=args.sstep, sstep_solver=args.sstep_solver,
        sstep_basis=args.sstep_basis, overlap=args.overlap,
        nc_mode=args.nc_mode, strict_descent=args.strict_descent,
        distributed=distributed, device=device,
    )
    if args.history_out:
        path = args.history_out
        if not multiproc.is_primary():
            path = f"{path}.rank{torch.distributed.get_rank()}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(history, f, indent=1)
    if distributed:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
