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
writes PATH and rank r > 0 ``PATH.rank<r>``.

Operations, as in the reference:

* ``--ckpt-dir D --ckpt-every K``: the primary saves parameters and the
  whole optimizer state every K steps (``checkpoint``), and a run started
  on D resumes bit for bit from its newest valid checkpoint (a corrupt one
  is skipped; one of another configuration or process count raises).
* ``--telemetry-dir D``: each process writes ``events-p<rank>.jsonl``
  (``obs.telemetry``: the ``compile`` span of the kernel build, a
  ``host_step`` span and a ``loss`` counter a step, the step's
  device-timed phase markers, its collectives and its solve summary), and
  the primary merges ``trace.json`` at the end; read it with
  ``python -m repro_torch.obs.report D``.
* ``--num-processes N --max-restarts R``: the N processes run under
  ``multiproc.spawn_supervised``, which restarts all of them (up to R
  times) when one dies or, with ``--hang-timeout S``, stops beating for S
  seconds; ``--watchdog-s W`` ends a worker whose all-reduce has waited W
  seconds with exit code 87, so the restart comes at once.
* ``REPRO_TORCH_FAULTS`` injects faults (``launch.faults``).

On the card the kernel extension is built before the first step (the
``compile_s`` of the first step's metrics), so no step's wall holds it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from .._device import resolve_device
from ..checkpoint import config_fingerprint, restore_latest_valid, save_checkpoint
from ..configs import ARCH_IDS, UNPORTED_ARCH_IDS, HFOptConfig, get_config, get_smoke_config
from ..core import collectives as collectives_mod
from ..core.distributed import require_linearize
from ..data.synthetic import lm_batch
from ..kernels import cg_fused, ops
from ..models.transformer import build_model
from ..obs import telemetry as telemetry_mod
from ..obs import trace as trace_mod
from ..optim import make_optimizer
from . import faults as faults_mod
from . import multiproc
from .mesh import make_data_mesh


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
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    telemetry_dir: str | None = None,
    watchdog_s: float = 0.0,
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
    rank 0's on every rank, and only the primary calls ``log_fn``.

    ``ckpt_dir``/``ckpt_every``, ``telemetry_dir`` and ``watchdog_s`` are
    the operations of the module docstring. A restore replaces ``params``,
    ``state`` and ``start``; the first step run records ``compile_s`` (the
    kernel build on the card, 0 on the CPU) and, after a restore,
    ``restore_s``; a step that saves records ``ckpt_save_s`` and
    ``ckpt_bytes``."""
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
    nproc = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    # The manifest's fingerprint covers what fixes the step and the batch
    # stream; a restore refuses a checkpoint of any other configuration.
    fingerprint = config_fingerprint(dict(
        arch=arch, smoke=smoke, opt=opt_cfg, batch_size=batch_size, seq_len=seq_len))
    restore_s = None
    if ckpt_dir:
        t_r = time.perf_counter()
        restored = restore_latest_valid(ckpt_dir, params, state, expect_fingerprint=fingerprint,
                                        expect_processes=nproc)
        if restored is not None:
            params, state, meta, _ = restored
            start = meta["step"]
            restore_s = time.perf_counter() - t_r
            log_fn(f"restored checkpoint at step {start} in {restore_s:.3f} s")
    if mesh is not None:
        params, state = multiproc.replicate((params, state), mesh)
    on_card = dev.type == "cuda"

    sink = None
    if telemetry_dir:
        sink = telemetry_mod.Telemetry(
            telemetry_dir, process_index=rank,
            meta=dict(kind="train", arch=arch, solver=solver, steps=steps,
                      batch_size=batch_size, seq_len=seq_len, sstep=sstep, overlap=overlap,
                      processes=nproc, attempt=multiproc.restart_attempt()))
        # SIGTERM (the supervisor's teardown), SIGINT and a normal exit all
        # flush the sink: a killed worker's event file stays parseable.
        telemetry_mod.register_crash_flush(sink)
    plan = faults_mod.FaultPlan.from_env(rank, telemetry=sink)
    if plan.active():
        log_fn(f"fault plan armed: {'; '.join(f.spec() for f in plan.faults)}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # The kernel build (about a minute the first time) happens here, not in
    # the first step; the heartbeat after it keeps a hang timeout that
    # covers one step from firing during the build.
    tc = time.time()
    if on_card and (use_flash_attention or krylov_backend == "flat"):
        cg_fused.extension()
    compile_s = time.time() - tc
    multiproc.heartbeat(start)
    if sink is not None:
        sink.emit({"ev": "span", "name": "compile", "t0": tc, "t1": time.time(),
                   "step": start})

    watchdog = (collectives_mod.collective_watchdog(watchdog_s) if watchdog_s > 0
                else contextlib.nullcontext())
    install = telemetry_mod.install(sink) if sink is not None else contextlib.nullcontext()
    history = []
    with watchdog, install:
        for i in range(start, steps):
            multiproc.heartbeat(i)
            plan.on_step_begin(i)
            batch = lm_batch(torch.Generator().manual_seed(1000 + i), cfg, batch_size, seq_len,
                             device=dev)
            batch = plan.poison_batch(i, batch)
            if mesh is not None:
                batch = multiproc.shard_batch(batch, mesh)
            before = dict(ops.LAUNCHES)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync()
            if sink is not None:
                telemetry_mod.anchor(dev)
            host_span = (sink.span("host_step", step=i) if sink is not None
                         else contextlib.nullcontext())
            with host_span:
                t0 = time.perf_counter()
                params, state, metrics = opt.step(params, state, batch)
                sync()
                wall_s = time.perf_counter() - t0
            if sink is not None:
                # The step's markers and device scalars, read after its sync.
                telemetry_mod.flush()
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = i
            metrics["wall_s"] = wall_s
            metrics["launches"] = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
            if on_card:
                metrics["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            if i == start:
                metrics["compile_s"] = compile_s
                if restore_s is not None:
                    metrics["restore_s"] = restore_s
            history.append(metrics)
            if sink is not None:
                sink.counter("loss", metrics["loss"])
            log_fn(
                f"step {i:4d} loss {metrics['loss']:.4f} |g| {metrics['grad_norm']:.3f}"
                + (f" λ {metrics['lambda']:.3g} α {metrics['alpha']:.2f} "
                   f"cg {metrics['cg_iters']:.0f}" if "lambda" in metrics else "")
            )
            if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0 and rank == 0:
                t_s = time.perf_counter()
                path = save_checkpoint(ckpt_dir, i + 1, params, state,
                                       fingerprint=fingerprint, processes=nproc)
                metrics["ckpt_save_s"] = time.perf_counter() - t_s
                metrics["ckpt_bytes"] = os.path.getsize(path)
                plan.corrupt_checkpoint(i + 1, ckpt_dir)
    if sink is not None:
        sink.close()
        if mesh is not None and mesh.size > 1:
            # Every process has closed its events file before the primary
            # merges them.
            torch.distributed.barrier()
        if rank == 0:
            log_fn(f"telemetry: merged trace at {trace_mod.merge_dir(telemetry_dir)}")
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
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="supervise the N processes: on a death or a hang, tear the "
                         "survivors down and start all again (resuming from the newest "
                         "valid checkpoint) up to R times; 0 = unsupervised")
    ap.add_argument("--hang-timeout", type=float, default=0.0,
                    help="supervisor liveness: restart when no worker has beaten for this "
                         "many seconds (must cover the start-up and a step); 0 = exit "
                         "codes only")
    ap.add_argument("--watchdog-s", type=float, default=0.0,
                    help="end a worker whose all-reduce has waited this long with exit "
                         f"code {multiproc.EXIT_WATCHDOG}, so the supervisor restarts at "
                         "once; 0 = off")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest valid checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint every K steps (the primary); 0 = never")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write events-p<rank>.jsonl and, on the primary at the end, the "
                         "merged trace.json; read with python -m repro_torch.obs.report DIR")
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not multiproc.active():
        require_linearize(args.curvature_mode)  # before N processes start
        argv = list(sys.argv[1:] if argv is None else argv)
        if args.max_restarts > 0:
            restarts = multiproc.spawn_supervised(
                args.num_processes, "repro_torch.launch.train", argv,
                max_restarts=args.max_restarts, hang_timeout_s=args.hang_timeout or None)
            print(f"[supervisor] run completed after {restarts} restart(s)", file=sys.stderr,
                  flush=True)
        else:
            multiproc.spawn(args.num_processes, "repro_torch.launch.train", argv)
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
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        telemetry_dir=args.telemetry_dir, watchdog_s=args.watchdog_s,
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
