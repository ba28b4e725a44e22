#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of its own; any failure exits non-zero:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
             print the build time and the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
             n = 1,722,293 (the TIMIT MLP's parameter count) and n = 65,537:
             relative error (≤ 1e-5), time with L2 cold and warm, the plain
             version's time, a library yardstick where one exists, and the
             bound (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s).
   The Gram kernel ``dots_block`` is held against its plain version at the
   s-step path's shapes: (17, 20), (17, 17), (9, 12) and (9, 9) rows at
   n = 1,722,293 and (9, 17) at n = 65,537, relative error ≤ 1e-5 of max|G|,
   with ``U @ V.T`` (TF32 off) as its library yardstick.
3. slice   — the main path: ``hf_init`` and 3 Bi-CG-STAB ``hf_step``s, then
             1 ``gn_cg`` step, on the paper's TIMIT MLP (360-512x3-1973) with
             the flat Krylov backend, a synthetic batch of 4096 and the
             curvature batch as its first 1024 rows. The kernels' launch
             counts are zeroed just before and read just after.
4. s-step  — the s-step path on the same slice: 2 outer steps from ``hf_init``
             for each of gn_cg s=8 newton, bicgstab s=4 newton, gn_cg s=2
             monomial overlapped and bicgstab s=2 monomial, with
             max_cg_iters 16, cg_tol 0 and initial damping 0.01. Each
             step's loss must fall and, where no fallback fired, its
             ``krylov_syncs`` must equal the sync model (a copy of
             ``benchmarks/comm_model.py``'s), or lie between it and one Gram
             per iteration where the prefix guard may shorten cycles.
             Launch counts are zeroed just before and read just after.
5. checks  — flat against tree backend from one state (parameters within
             1e-4), standard and s-step, and the card against the CPU's plain
             versions on a small MLP (within 1e-4), standard and s-step.
6. profile — one step under ``torch.profiler``: device-busy share of the step
             wall and the top device kernels; then the step wall per
             curvature mode; then a gn_cg s=8 newton step against a standard
             gn_cg step at 16 Krylov iterations, each with its wall, busy
             share, top kernels and host reads (synchronizing calls counted
             with ``torch.cuda.set_sync_debug_mode``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
N_MAIN = 1_722_293          # parameters of the TIMIT MLP
N_RAGGED = 65_537
TOL = 1e-5
# Gram shapes of the s-step path: Bi-CG-STAB's (4s+1) x (4s+4) at s = 4 and
# CG's (2s+1)^2 at s = 8, and the same at s = 2; plus a ragged tail.
GRAM_SHAPES = ((17, 20, N_MAIN), (17, 17, N_MAIN), (9, 12, N_MAIN), (9, 9, N_MAIN),
               (9, 17, N_RAGGED))
# The s-step configurations: (solver, sstep_s, basis, overlap).
SSTEP_CONFIGS = (("gn_cg", 8, "newton", False), ("bicgstab", 4, "newton", False),
                 ("gn_cg", 2, "monomial", True), ("bicgstab", 2, "monomial", False))
SSTEP_K = 16
# Initial damping of the s-step runs. At the default λ = 1 the damped GN
# operator of the freshly drawn network is within a few percent of λ·I: the
# Krylov residual falls by 1e-7 in five iterations, the monomial bootstrap
# chains' Cholesky pivots sit at the guard threshold, and the cycles follow
# f32 round-off (on a 36-64x3-197 rehearsal: unmatched sync counts and a
# failed line search). At λ = 0.01 the curvature shapes the solve and all
# 16 iterations carry signal.
SSTEP_LAM = 1e-2


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing --
def time_cold(torch, fn, flush, reps=20):
    """Median ms of one call with L2 flushed before it. A device-side sleep
    after the flush keeps the GPU busy while the host enqueues the call, so
    no host gap enters the window."""
    ts = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def time_warm(torch, fn, reps=100):
    """Mean ms per call over back-to-back calls (inputs stay in L2). A
    device-side sleep holds the GPU while the host enqueues all the calls,
    so the window times the device and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sstep_krylov_syncs(K, s, solver, basis, overlap):
    """(schedule, ceiling) of the Gram reductions of an s-step solve of K
    iterations. The schedule is the bootstrap cycles of the adaptive bases,
    then one Gram per full cycle of s (2s under overlap): a copy of
    ``benchmarks/comm_model.py``'s ``hf_sstep_syncs_per_iteration`` less its
    gradient and line-search terms (the port imports nothing of the
    benchmarks). The depth-resolved prefix guard of the adaptive and
    overlapped cycles may run shorter cycles, each of at least one
    iteration, so their count lies between the schedule and the ceiling of
    one Gram per iteration after the bootstraps (the invariant of the
    reference's ``benchmarks/sstep_bench.py``). Monomial cycles without
    overlap run whole or break down: their count is the schedule."""
    s_eff = 2 * s if overlap else s
    if basis == "monomial":
        n_boot, covered = 0, 0
    else:
        s_boot = max(1, min(s_eff, 2 if solver == "bicgstab" else 4))
        n_boot = -(-s_eff // s_boot) + (1 if solver == "bicgstab" else 0)
        covered = n_boot * s_boot
    schedule = n_boot + math.ceil(max(K - covered, 0) / s_eff)
    whole = basis == "monomial" and not overlap
    return schedule, schedule if whole else n_boot + max(K - covered, 0)


# ---------------------------------------------------------------- phases --
def phase_gram(torch, cg_fused, ref):
    """``dots_block`` against ``gram_block_ref`` at the s-step shapes;
    returns the record of the largest shape."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    first = None
    for su, sv, n in GRAM_SHAPES:
        U = torch.randn(su, n, device="cuda", generator=gen)
        V = torch.randn(sv, n, device="cuda", generator=gen)
        kern = lambda: cg_fused.dots_block(U, V)
        plain = lambda: ref.gram_block_ref(U, V)
        got, want = kern(), plain()
        exact = U.double() @ V.double().T
        torch.cuda.synchronize()
        scale = float(exact.abs().max())
        abs_err = float((got - want).abs().max())
        rec = {
            "shape": [su, sv, n], "rel_err": abs_err / scale, "max_abs_err": abs_err,
            "rel_err_f64": float((got.double() - exact).abs().max()) / scale,
            "ms": time_cold(torch, kern, flush),
            "ms_l2_warm": time_warm(torch, kern),
            "plain_ms": time_cold(torch, plain, flush),
            "library_ms": time_cold(torch, lambda: U @ V.T, flush),
        }
        rec["bound_ms"], rec["bound_by"] = bound_ms((su + sv) * n * 4 + su * sv * 4,
                                                    2 * su * sv * n)
        print(f"[kernel] dots_block: {json.dumps(rec)}", flush=True)
        if not rec["rel_err"] <= TOL or not rec["rel_err_f64"] <= TOL:
            fail(f"dots_block at {su}x{sv}, n={n}: relative error {rec['rel_err']} "
                 f"(float64: {rec['rel_err_f64']}) > {TOL}")
        first = first or rec
    del flush
    torch.cuda.empty_cache()
    return first


def phase_kernels(torch, cg_fused, ref):
    """Each kernel against its plain version; returns records keyed by name."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    alpha = torch.tensor([0.37], device="cuda")
    gamma = torch.tensor([-1.3], device="cuda")
    records = {}
    for n in (N_MAIN, N_RAGGED):
        x, p, s = (torch.randn(n, device="cuda", generator=gen) for _ in range(3))
        cases = {
            # name: (kernel call, plain call, Σ|terms| per output, bytes, flops, library)
            "dot2": (
                lambda: cg_fused.dot2(x, p), lambda: ref.dot2_ref(x, p),
                lambda: [(x * p).abs().sum(), (p * p).sum()],
                2 * n * 4 + 2 * 4, 4 * n,
                lambda: (torch.dot(x, p), torch.dot(p, p)),
            ),
            "x_update": (
                lambda: [cg_fused.x_update(x, p, s, alpha, gamma)],
                lambda: [ref.x_update_ref(x, p, s, alpha, gamma)],
                lambda: [x.abs() + (alpha * p).abs() + (gamma * s).abs()],
                4 * n * 4 + 2 * 4, 4 * n, None,
            ),
            "residual_dots": (
                lambda: cg_fused.residual_dots(x, p, s, gamma),
                lambda: ref.residual_dots_ref(x, p, s, gamma),
                lambda: [x.abs() + (gamma * p).abs(),
                         ((x - gamma * p) * s).abs().sum(),
                         ((x - gamma * p) ** 2).sum()],
                4 * n * 4 + 3 * 4, 6 * n, None,
            ),
        }
        for name, (kern, plain, scale, nb, nf, library) in cases.items():
            got, want, terms = kern(), plain(), scale()
            torch.cuda.synchronize()
            abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            rel_err = max(float(((g - w).abs() / (t + 1e-30)).max())
                          for g, w, t in zip(got, want, terms))
            b_ms, b_by = bound_ms(nb, nf)
            rec = {
                "n": n, "rel_err": rel_err, "max_abs_err": abs_err,
                "ms": time_cold(torch, kern, flush),
                "ms_l2_warm": time_warm(torch, kern),
                "plain_ms": time_cold(torch, plain, flush),
                "plain_ms_l2_warm": time_warm(torch, plain),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if library is None else time_cold(torch, library, flush),
            }
            print(f"[kernel] {name}: {json.dumps(rec)}", flush=True)
            if not rel_err <= TOL:
                fail(f"{name} at n={n}: relative error {rel_err} > {TOL}")
            if n == N_MAIN:
                records[name] = rec
    del flush
    torch.cuda.empty_cache()
    return records


def _finite_params(torch, tree_leaves, params):
    return all(bool(torch.isfinite(l).all()) for l in tree_leaves(params))


def phase_slice(torch, ops):
    """The main path: 3 Bi-CG-STAB steps and 1 gn_cg step on the TIMIT MLP."""
    from repro_torch.configs.paper_mlp import TIMIT_FIG5
    from repro_torch.core.hf import HFConfig, hf_init, hf_step
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models.mlp import build_mlp
    from torch.utils._pytree import tree_leaves

    model = build_mlp(TIMIT_FIG5)
    params = model.init(torch.Generator().manual_seed(0))
    n_params = sum(l.numel() for l in tree_leaves(params))
    if n_params != N_MAIN:
        fail(f"TIMIT MLP has {n_params} parameters, expected {N_MAIN}")
    batch = classification_dataset(torch.Generator().manual_seed(1), 4096,
                                   TIMIT_FIG5[0], TIMIT_FIG5[-1])
    hvp_batch = {k: v[:1024] for k, v in batch.items()}
    bicg = HFConfig(solver="bicgstab", krylov_backend="flat", max_cg_iters=10)
    gn = HFConfig(solver="gn_cg", krylov_backend="flat", max_cg_iters=10)
    print(f"[slice] TIMIT MLP {TIMIT_FIG5}: {n_params} parameters, batch 4096, "
          f"curvature batch 1024, flat backend, max_cg_iters 10", flush=True)

    ops.reset_launches()
    state = hf_init(params, bicg)
    losses = []
    for i, cfg in enumerate((bicg, bicg, bicg, gn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = hf_step(model.loss_fn, params, state, batch, hvp_batch, cfg,
                                   model_out_fn=model.logits_fn,
                                   out_loss_fn=model.out_loss_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f0, f1 = float(m["loss"]), float(m["loss_new"])
        losses.append((f0, f1))
        print(f"[slice] {cfg.solver} step {i}: wall {wall:.4f} s  cg_iters "
              f"{int(m['cg_iters'])}  loss {f0:.6f} -> {f1:.6f}  launches so far "
              f"{dict(ops.LAUNCHES)}", flush=True)
    launches = dict(ops.LAUNCHES)
    print(f"[slice] launches {launches}", flush=True)
    if not all(math.isfinite(a) and math.isfinite(b) for a, b in losses):
        fail(f"non-finite loss: {losses}")
    if not all(b < a for a, b in losses) or not losses[-1][1] < losses[0][0]:
        fail(f"loss did not fall: {losses}")
    if not _finite_params(torch, tree_leaves, params):
        fail("non-finite parameters after the slice")
    for name in ("dot2", "x_update", "residual_dots"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return model, params, state, batch, hvp_batch, launches


def _timit_start(torch, model):
    """The slice's initial parameters, drawn again from their seed."""
    return model.init(torch.Generator().manual_seed(0))


def phase_sstep(torch, ops, model, batch, hvp_batch):
    """The s-step path: 2 outer steps from hf_init per configuration."""
    from repro_torch.core.hf import HFConfig, hf_init, hf_step
    from torch.utils._pytree import tree_leaves

    print(f"[sstep] TIMIT MLP, batch 4096, curvature batch 1024, flat backend, "
          f"max_cg_iters {SSTEP_K}, cg_tol 0, initial damping {SSTEP_LAM}", flush=True)
    ops.reset_launches()
    for solver, s, basis, overlap in SSTEP_CONFIGS:
        cfg = HFConfig(solver=solver, krylov_backend="flat", max_cg_iters=SSTEP_K,
                       cg_tol=0.0, sstep_s=s, sstep_basis=basis, overlap=overlap,
                       init_damping=SSTEP_LAM)
        tag = f"{solver} s={s} {basis}{' overlap' if overlap else ''}"
        params = _timit_start(torch, model)
        state = hf_init(params, cfg)
        for step in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = hf_step(model.loss_fn, params, state, batch, hvp_batch, cfg,
                                       model_out_fn=model.logits_fn,
                                       out_loss_fn=model.out_loss_fn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            K, ks, bs = int(m["cg_iters"]), int(m["krylov_syncs"]), int(m["blocking_syncs"])
            flags = {k: bool(m[k]) for k in ("sstep_fallback", "sstep_basis_fallback",
                                             "sstep_basis_degraded")}
            f0, f1 = float(m["loss"]), float(m["loss_new"])
            lo, hi = sstep_krylov_syncs(K, s, "bicgstab" if solver == "bicgstab"
                                        else "cg", basis, overlap)
            print(f"[sstep] {tag} step {step}: wall {wall:.4f} s  cg_iters {K}  "
                  f"krylov_syncs {ks} (schedule {lo}, ceiling {hi})  blocking_syncs {bs}  "
                  f"ls_evals {int(m['ls_evals'])}  {flags}  loss {f0:.6f} -> {f1:.6f}",
                  flush=True)
            if not (math.isfinite(f0) and math.isfinite(f1)):
                fail(f"{tag} step {step}: non-finite loss {f0} -> {f1}")
            if not f1 < f0:
                fail(f"{tag} step {step}: loss did not fall ({f0} -> {f1})")
            if not flags["sstep_fallback"] and not lo <= ks <= hi:
                fail(f"{tag} step {step}: krylov_syncs {ks} outside the sync model "
                     f"[{lo}, {hi}]")
        if not _finite_params(torch, tree_leaves, params):
            fail(f"{tag}: non-finite parameters")
    launches = dict(ops.LAUNCHES)
    print(f"[sstep] launches {launches}", flush=True)
    for name in ("dots_block", "dot2"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the s-step path")
    return launches


def _worst_rel(torch, tree_leaves, a, b):
    return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_checks(torch, model, params, state, batch, hvp_batch):
    """Flat against tree at full width; card against CPU on a small MLP."""
    from repro_torch.core.hf import HFConfig, hf_init, hf_step
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.mlp import build_mlp
    from torch.utils._pytree import tree_leaves

    # Standard Bi-CG-STAB from the slice's state; then s-step gn_cg from the
    # initial parameters at SSTEP_LAM. At λ = 100 the damped operator is
    # within 1e-4 of λ·I, the residual reaches round-off in two iterations,
    # and the cycles after that follow round-off (no two summation orders
    # agree there).
    flat_tree = (
        ("bicgstab", dict(solver="bicgstab", max_cg_iters=10), state, params),
        ("s-step gn_cg s=2", dict(solver="gn_cg", max_cg_iters=SSTEP_K, sstep_s=2,
                                  init_damping=SSTEP_LAM, cg_tol=0.0, krylov_jitter=0.0),
         None, _timit_start(torch, model)),
    )
    for tag, kw, st, p0 in flat_tree:
        out = {}
        for backend in ("flat", "tree"):
            cfg = HFConfig(krylov_backend=backend, **kw)
            out[backend] = hf_step(model.loss_fn, p0, st or hf_init(p0, cfg), batch,
                                   hvp_batch, cfg, model_out_fn=model.logits_fn,
                                   out_loss_fn=model.out_loss_fn)
        worst = _worst_rel(torch, tree_leaves, out["flat"][0], out["tree"][0])
        print(f"[flat-vs-tree] {tag}: loss_new {float(out['flat'][2]['loss_new']):.7f} vs "
              f"{float(out['tree'][2]['loss_new']):.7f}  cg_iters "
              f"{int(out['flat'][2]['cg_iters'])} vs {int(out['tree'][2]['cg_iters'])}  "
              f"krylov_syncs {int(out['flat'][2]['krylov_syncs'])} vs "
              f"{int(out['tree'][2]['krylov_syncs'])}  worst param rel diff {worst:.3e}",
              flush=True)
        if not worst <= 1e-4:
            fail(f"{tag}: flat and tree backends differ by {worst} > 1e-4")

    dims = (16, 32, 4)
    small = {}
    data_cpu = classification_dataset(torch.Generator().manual_seed(2), 64, dims[0],
                                      dims[-1], device="cpu")
    p_cpu = build_mlp(dims, device="cpu").init(torch.Generator().manual_seed(3))
    # The s-step case in the configuration the CPU tests hold against the
    # reference (λ = 5, cg_tol 1e-3).
    for tag, cfg in (
        ("bicgstab", HFConfig(solver="bicgstab", krylov_backend="flat",
                              init_damping=100.0, cg_tol=0.0, max_cg_iters=4)),
        ("bicgstab s=2", HFConfig(solver="bicgstab", krylov_backend="flat", sstep_s=2,
                                  init_damping=5.0, cg_tol=1e-3, max_cg_iters=8,
                                  krylov_jitter=0.0)),
    ):
        for dev in ("cpu", "cuda"):
            m = build_mlp(dims, device=dev)
            p = params_from_numpy(params_to_numpy(p_cpu), dev)
            d = {k: v.to(dev) for k, v in data_cpu.items()}
            small[dev] = hf_step(m.loss_fn, p, hf_init(p, cfg, device=dev), d, d, cfg,
                                 device=dev)
        worst = _worst_rel(torch, tree_leaves,
                           [t.cpu() for t in tree_leaves(small["cuda"][0])],
                           tree_leaves(small["cpu"][0]))
        print(f"[card-vs-cpu] MLP {dims} {tag} flat: loss_new "
              f"{float(small['cuda'][2]['loss_new']):.7f} vs "
              f"{float(small['cpu'][2]['loss_new']):.7f}  cg_iters "
              f"{int(small['cuda'][2]['cg_iters'])} vs {int(small['cpu'][2]['cg_iters'])}  "
              f"worst param rel diff {worst:.3e}", flush=True)
        if not worst <= 1e-4:
            fail(f"{tag}: card and CPU differ by {worst} > 1e-4")


def phase_profile(torch, model, params, state, batch, hvp_batch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hf import HFConfig, hf_step

    def step(mode):
        cfg = HFConfig(solver="bicgstab", krylov_backend="flat", max_cg_iters=10,
                       curvature_mode=mode, curvature_chunk_size=256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = hf_step(model.loss_fn, params, state, batch, hvp_batch, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, int(m["cg_iters"])

    step("linearize")  # warm
    plain_wall_ms, _ = step("linearize")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, iters = step("linearize")
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"[profile] bicgstab linearize step (cg_iters {iters}): device busy "
          f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.2f}% of the profiled wall "
          f"{wall_ms:.1f} ms, {100 * busy_ms / plain_wall_ms:.2f}% of the unprofiled "
          f"wall {plain_wall_ms:.1f} ms", flush=True)
    if busy_ms <= 0:
        fail("the profiler saw no device time in the step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    for name in ("dot2_partial", "x_update", "residual_dots_partial", "sum2_final"):
        own = [e for e in kern if name in e.key]
        print(f"[profile] port kernel {name}: "
              f"{sum(e.self_device_time_total for e in own) / 1e3:.3f} ms in "
              f"{sum(e.count for e in own)} launches", flush=True)
    walls = {}
    for mode in ("naive", "linearize", "chunked"):
        step(mode)  # warm
        walls[mode] = step(mode)
    print("[profile] step wall per curvature mode: " + ", ".join(
        f"{k} {w:.1f} ms (cg_iters {i})" for k, (w, i) in walls.items()), flush=True)


def count_host_reads(torch, fn):
    """Synchronizing CUDA calls made by ``fn()``, counted with the sync debug
    mode's warnings (each host read of a device value is one)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_profile_sstep(torch, model, batch, hvp_batch):
    """A gn_cg s=8 newton step against a standard gn_cg step, both with 16
    Krylov iterations (cg_tol 0, λ = SSTEP_LAM) from the slice's initial
    parameters: step wall, device-busy share, top kernels and host reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hf import HFConfig, hf_init, hf_step

    params = _timit_start(torch, model)
    results = {}
    for tag, kw in (("standard gn_cg", {}),
                    ("gn_cg s=8 newton", dict(sstep_s=8, sstep_basis="newton"))):
        cfg = HFConfig(solver="gn_cg", krylov_backend="flat", max_cg_iters=SSTEP_K,
                       cg_tol=0.0, init_damping=SSTEP_LAM, **kw)
        state = hf_init(params, cfg)

        def step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = hf_step(model.loss_fn, params, state, batch, hvp_batch, cfg,
                              model_out_fn=model.logits_fn, out_loss_fn=model.out_loss_fn)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, m

        step()  # warm
        walls = [step()[0] for _ in range(3)]
        wall_ms, m = step()
        walls.append(wall_ms)
        reads = count_host_reads(torch, step)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ms, _ = step()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        med = statistics.median(walls)
        K, ks = int(m["cg_iters"]), int(m["krylov_syncs"])
        results[tag] = dict(wall_ms=med, busy_ms=busy, host_reads=reads, cg_iters=K,
                            krylov_syncs=ks)
        print(f"[profile-sstep] {tag}: cg_iters {K}  krylov_syncs {ks}  blocking_syncs "
              f"{int(m['blocking_syncs'])}  step wall median {med:.1f} ms of "
              f"{[round(w, 1) for w in walls]}  device busy {busy:.2f} ms = "
              f"{100 * busy / med:.2f}% of the unprofiled wall ({100 * busy / prof_ms:.2f}% "
              f"of the profiled {prof_ms:.1f} ms)  host reads {reads} "
              f"({reads / max(K, 1):.2f} per Krylov iteration)", flush=True)
        if busy <= 0:
            fail(f"{tag}: the profiler saw no device time")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile-sstep] {tag}: {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<5d} {e.key[:90]}", flush=True)
        for name in ("dots_block_partial", "gram_final", "dot2_partial"):
            own = [e for e in kern if name in e.key]
            print(f"[profile-sstep] {tag}: port kernel {name}: "
                  f"{sum(e.self_device_time_total for e in own) / 1e3:.3f} ms in "
                  f"{sum(e.count for e in own)} launches", flush=True)
    return results


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(src))
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import cg_fused, ops, ref

    card = card_line()
    cg_fused.extension()
    print(f"[build] cg_fused ({', '.join(s.name for s in cg_fused.SOURCES)}) in "
          f"{cg_fused.build_seconds:.1f} s", flush=True)
    print(f"[card] {card}", flush=True)

    records = phase_kernels(torch, cg_fused, ref)
    records["dots_block"] = phase_gram(torch, cg_fused, ref)
    model, params, state, batch, hvp_batch, launches = phase_slice(torch, ops)
    launches["dots_block"] = phase_sstep(torch, ops, model, batch, hvp_batch)["dots_block"]
    phase_checks(torch, model, params, state, batch, hvp_batch)
    phase_profile(torch, model, params, state, batch, hvp_batch)
    phase_profile_sstep(torch, model, batch, hvp_batch)

    replaces = {"dot2": 146, "x_update": 42, "residual_dots": 71, "dots_block": 114}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cg_fused.cu",
        "replaces": f"src/repro/kernels/cg_fused.py:{replaces[name]}",
        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
    } for name, rec in records.items()]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    # The script drives cuda:0 only: one card, whatever the machine holds.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}),
        flush=True)


if __name__ == "__main__":
    main()
