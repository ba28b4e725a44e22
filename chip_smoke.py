#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of its own; any failure exits non-zero:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (``cg_fused.cu``, ``flash_attention.cu``, ``flash_decode.cu`` and
             ``ssd_scan.cu``, one extension); beside it, ``nvcc -Xptxas -v``
             on each source prints the registers, spills and shared memory
             of each instance of the four tensor-core flash kernels
             (forward, dQ, dK/dV, JVP), the two one-launch decode kernels,
             ``ssd_intra_kernel``, ``dots_block_partial`` and the three
             one-wave Krylov kernels (a spill in one of ``NO_SPILL`` fails);
             print the build time and the card's name and power limit.
2. kernels — each Krylov kernel against its plain PyTorch version and
             float64 on the card at n = 1,722,293 (the TIMIT MLP's parameter
             count) and n = 65,537, and at 1,722,293 on views at element
             offsets (1, 1, 1) and (1, 2, 0) into larger tensors: relative
             error (≤ 1e-5), the same bits on repeated calls, time with L2
             cold and warm, the plain version's time, a library yardstick
             where one exists, and the bound (bytes over 3.35 TB/s or f32
             operations over 67 TFLOP/s). ``residual_dots`` also in the CG
             solver's form, r0s = s (three streams), which must give the
             bits of r0s = a copy of s. ``dot2``, ``x_update`` and both
             forms of ``residual_dots`` also at n = 464,118,784 (the
             transformer slice's flat vectors) under the same gates: ms
             with L2 cold, achieved GB/s, two ``torch.dot`` calls beside
             ``dot2`` and a copy of x beside the others.
   The Gram kernel ``dots_block`` is held against its plain version at the
   s-step path's shapes: (17, 20), (17, 17), (9, 12) and (9, 9) rows at
   n = 1,722,293 and (9, 17) at n = 65,537, relative error ≤ 1e-5 of max|G|,
   with ``U @ V.T`` (TF32 off) as its library yardstick.
   The four flash-attention kernels (forward, dQ, dK/dV, JVP) are held
   against their plain versions on every case of ``FLASH_CASES`` (head dims
   32 to 128, 40 among them) in f32 and bf16: relative error of max|plain|
   ≤ 1e-5 in f32 and ≤ 1e-2 in bf16 (against the plain version in f32 from
   the same bf16 inputs; bf16 output rounding alone is ~4e-3), the same
   against the plain version in float64 and, in bf16, against the plain
   version run on the bf16 inputs themselves (rounding P and dS where the
   reference rounds them); times with L2 cold and warm, the plain version's,
   the library yardstick (``scaled_dot_product_attention`` forward, and its
   backward for dQ and dK/dV together) where one computes the same
   function, with the backend its top kernel's name shows, and the bound
   (bytes over 3.35 TB/s, or the operations the mask lets through over 989
   TFLOP/s in bf16 and 67 TFLOP/s in f32).
3. slice   — the MLP main path: ``hf_init`` and 3 Bi-CG-STAB ``hf_step``s,
             then 1 ``gn_cg`` step, on the paper's TIMIT MLP (360-512x3-1973)
             with the flat Krylov backend, a synthetic batch of 4096 and the
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
             wall, the top device kernels, and each Krylov kernel's launches,
             which must equal its wrapper's calls in the step; then the step
             wall per curvature mode; then a gn_cg s=8 newton step against a
             standard gn_cg step at 16 Krylov iterations, each with its wall,
             busy share, top kernels and host reads (synchronizing calls
             counted with ``torch.cuda.set_sync_debug_mode``).
6b. data parallel — the data-parallel HF step (``core.distributed``) over
             gloo, its ranks sharing the one card: ``repro_torch.launch.fig5``
             runs the TIMIT MLP at full width, global batch 4096, the whole
             shard as curvature batch, flat backend, K = 8, cg_tol 0, λ₀ 1,
             combos cg_s1, bicgstab_s1 and cg_s2_overlap, 2 steps each, at 1
             and 2 ranks. Gates: per-tag executed collectives equal on both
             ranks and at 1 and 2 ranks on step 1; ``blocking_syncs`` equal to
             ``core.comm_model``'s formula at the executed K and E on every
             step; the loss reduced 1 + E times a step; step 1's loss at 2
             ranks within 1e-4·max(1, |loss|) of 1 rank; each rank's
             launches of dot2, x_update, residual_dots and dots_block
             non-zero, equal on both ranks and, on step 1, equal to 1 rank's.
             Printed: step walls, host seconds inside ``preduce`` a step, bytes
             an all-reduce, the host's wait on the hidden gradient reduce.
             Then ``launch.train --num-processes 2`` (Qwen1.5-0.5B smoke,
             flash attention, gn_cg, flat, 2 steps: two step lines from the
             primary, flash launches on each rank) and
             ``sharded_decode_attend`` on 2 ranks at Qwen2-1.5B's attention
             (12 heads over 2, hd 128, B 16, W 1024 split 512/512; a full
             cache and one whose second half is empty) in f32 and bf16
             against the unsharded ``flash_decode`` route: ≤ 1e-5 (f32) and
             ≤ 1e-2 (bf16) of max|y|. NCCL is not tried: it takes a card a
             rank.
6c. operations (after the transformer phases, which hand it their state) —
             (b) from the transformer slice's state, one full-width gn_cg step
             through ``launch.train.train`` without a telemetry sink and one
             with it: the same loss bits, parameters and launches, both walls
             printed; one TIMIT gn_cg s=4 newton step (λ₀ 0.01) with a sink: a
             Ritz event per executed cycle (Gram launch). (a) ``python -m
             repro_torch.launch.train`` on the transformer slice (full
             Qwen1.5-0.5B, gn_cg, flat, flash), 2 steps, a checkpoint a step,
             ``REPRO_TORCH_FAULTS=corrupt_ckpt@step=2`` and a telemetry
             directory: the newest checkpoint fails ``verify_checkpoint``,
             ``latest_valid_step`` is 1, a fresh process resumes from it and
             replays step 1 to run 1's loss within 1e-6; the checkpoint's
             bytes and its save, verify and restore seconds; run 1's phases
             in the reference's gn_cg order, every device-timed marker inside
             its step's ``host_step`` span (1 ms), one solve event a step
             equal to its metrics, ``trace.json`` written. (c) 2 gloo ranks
             on the card (smoke Qwen1.5-0.5B, the reference chaos check's
             arguments, gn_cg, flat, flash, 4 steps): an unsupervised
             baseline, then ``kill@step=2,proc=1`` under ``--max-restarts 2
             --hang-timeout 300``: at least one restart, steps 2-3 resumed at
             the baseline's losses within 1e-6, the kill in the telemetry at
             step 2. (d) the same with ``hang@step=2,proc=1,secs=600`` and
             ``--watchdog-s 5 --max-restarts 1``: rank 0 exits with 87, the
             restart comes well inside the hang timeout, the same losses.
7. transformer — the transformer main path through
             ``repro_torch.launch.train.train``: Qwen1.5-0.5B at full width
             and depth (464,118,784 parameters, bf16, random weights from
             seed 0), flash attention, flat backend, batch 8 x 512, curvature
             batch 2 x 512, max_cg_iters 8, linearize mode; 2 gn_cg steps,
             then 1 Bi-CG-STAB step. Per step: loss, |g|, λ, α, cg
             iterations, wall, peak device memory and the kernels' launches
             beside the flash launches derived from the code, which they
             must equal. Every loss finite, each accepted step's loss at most
             its starting loss, the last below the first. Launch counts are
             zeroed just before and read just after.
8. transformer profile — one gn_cg step of the slice under
             ``torch.profiler``: wall, device-busy share, top kernels and the
             flash kernels' share of device time (the bf16 JVP must show as
             ``fa_jvp_mma``).
9. transformer checks — granite-3-8b's smoke config (GQA, kv 2) in f32: the
             flash model against the ``_sdpa`` model on the card (loss,
             gradient, GN and Hessian products within 1e-4), and one gn_cg
             ``hf_step`` (λ 100, cg_tol 0) on the card against the CPU's
             plain versions (parameters within 1e-4).
10. decode — the split-K decode kernels, each one launch that merges its
             partials (``flash_decode``, dense rolling cache, its splits;
             ``flash_decode_paged``, page pool, its pages) against their plain
             versions on ``DECODE_CASES`` and ``PAGED_CASES`` in f32 and bf16:
             relative error of max|plain| ≤ 1e-5 (f32) and ≤ 1e-2 (bf16), the
             same against float64 and against the kernel's plain
             split-and-merge on the inputs in their own type; the
             return_stats (m, l) within 1e-5,
             idle rows exactly (0, NEG_INF, 0); times with L2 cold and warm,
             the plain version's, ``scaled_dot_product_attention`` as the
             dense kernel's yardstick, and the byte bound of the live K/V.
11. serve   — the serving main path through ``repro_torch.launch.serve``:
             Qwen2-1.5B at full width and depth (1,543,910,912 parameters,
             bf16, random weights from seed 0), flash attention. Batch-at-once
             16 x (896 + 128): prefill, decode, tok/s, peak memory, launches
             (flash forward 28, flash_decode 28 x 127). Continuous batching of
             32 requests (lengths uniform in [32, 128] from seed 0, one
             arriving every 4 steps) on 16 slots with pages of 16: steps,
             tok/s, time to first token, peak memory, pages free, the page
             pool's invariants, launches (flash forward 28 x 32,
             flash_decode_paged 28 x the decode steps). Launch counts are
             zeroed just before each run and read just after. Then, from one
             prefilled state, the first decode step's logits through the
             kernels against the plain route and paged against dense (within
             1e-2 of max|logit|), the prefill profiled, and 8 decode steps
             timed and profiled, dense and then paged (each decode kernel's
             launches a step must be 28, one a layer). Operations part (e):
             both runs again with a telemetry sink, the same tokens and
             launches, a ``request`` span per request with a finite time to
             first token, ``queue_depth`` and ``pages_free`` on every tick;
             tok/s with and without the sink.
12. serve checks — qwen2-1.5b's smoke config (hd 32) in f32 with flash on
             the card: continuous batching (3 requests on 2 slots) gives
             batch-at-once's tokens, the card gives the CPU's tokens for both,
             and the first decode step's logits agree with the CPU's (1e-4).
13. ssd     — the SSD intra-chunk kernel (``ssd_intra``, ``csrc/ssd_scan.cu``)
             against its plain version in f32 (TF32 off) and float64 on
             ``SSD_CASES`` (the reference test's four, the smoke layer, a
             fallback chunk of 7 and the slice's prefill: B 8, 7 chunks of
             128, 112 heads of 64, N 64), log_a = -softplus(x) and
             -softplus(x - 2): y, S, g and l each within 1e-5 of max|.| (g's
             denominator at least 2^-126); the slice's case with bf16 B and
             C too, timed with L2 cold and warm beside the plain version and
             the f32 operation bound. Then ``ssd_chunked_pallas`` against
             ``ssd_chunked``, with and without h0, within 2e-4.
14. heads   — the six flash kernels at head dims 112 and 96 (zamba2-7b's
             attention, 32 heads over 32, S 896; decode B 8, W 1024) in f32
             and bf16 against their plain versions and float64, under the
             gates of phases 2 and 10.
15. hybrid serve — the hybrid's main path through ``launch.serve.serve``:
             zamba2-7b at full width and depth (81 Mamba2 layers, 13 shared
             attention blocks; 6,751,130,832 parameters in the tree,
             param_count() 6,749,917,776; bf16, random weights from seed 0 on
             the card), flash attention and the SSD kernel, batch-at-once
             8 x (896 + 128): prefill, decode, tok/s, peak memory, launches
             (ssd_intra 81, flash forward 13, flash_decode 13 x 127), zeroed
             just before and read just after; then a prefill profiled and a
             decode step timed and profiled (the dense decode kernel's
             launches a step must be 13, one an attention block).
16. hybrid check — at full width from 2 prompts, in f32 and bf16, the
             kernel route against the plain route (prefill logits, final
             Mamba states, first decode logits): f32 within 1e-4, bf16 no
             farther from the f32 plain route than 1.5x the plain route is;
             then zamba2's smoke config in f32, card against CPU: prefill
             logits (1e-4), 8 greedy tokens equal, one gn_cg hf_step (1e-4).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 on the tensor cores (dense)
TF32_FLOPS_PER_S = 495e12   # H100 SXM TF32 on the tensor cores (dense)
N_MAIN = 1_722_293          # parameters of the TIMIT MLP
N_RAGGED = 65_537
TOL = 1e-5
# Gram shapes of the s-step path: Bi-CG-STAB's (4s+1) x (4s+4) at s = 4 and
# CG's (2s+1)^2 at s = 8, and the same at s = 2; plus a ragged tail, and the
# widest block the kernel takes (its general 8 x 8 cut).
GRAM_SHAPES = ((17, 20, N_MAIN), (17, 17, N_MAIN), (9, 12, N_MAIN), (9, 9, N_MAIN),
               (9, 17, N_RAGGED), (32, 32, N_RAGGED))
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


# ----------------------------------------------------------------- build --
PTXAS_SOURCES = ("flash_attention.cu", "flash_decode.cu", "ssd_scan.cu", "cg_fused.cu")
PTXAS_KERNELS = ("fa_forward_mma", "fa_dq_mma", "fa_dkv_mma", "fa_jvp_mma", "fd_dense_kernel",
                 "fd_paged_kernel", "ssd_intra_kernel", "dots_block_partial", "dot2_single",
                 "x_update", "residual_dots_single")
# A spill in an instance of these fails the run.
NO_SPILL = ("fa_dq_mma", "fa_jvp_mma", "ssd_intra_kernel", "dots_block_partial", "dot2_single",
            "x_update", "residual_dots_single")
# The labels of the instances of the kernels templated on bools, one pair a bool.
BOOL_INSTANCES = {"ssd_intra_kernel": (("f32 B, C", "bf16 B, C"),),
                  "dot2_single": (("4-byte body", "16-byte body"),),
                  "x_update": (("4-byte body", "16-byte body"),),
                  "residual_dots_single": (("4-byte body", "16-byte body"),
                                           ("r0s read", "r0s is s"))}


def start_ptxas():
    """``nvcc -Xptxas -v`` on each of ``PTXAS_SOURCES`` (plain C, no PyTorch
    headers: seconds each), started together beside the extension's build."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import cg_fused

    if CUDA_HOME is None:
        fail("no CUDA toolkit found (CUDA_HOME)")
    cg_fused.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in PTXAS_SOURCES:
        src = next(s for s in cg_fused.SOURCES if s.name == name)
        procs.append((name, subprocess.Popen(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), *cg_fused.CUDA_FLAGS,
             "-Xptxas", "-v", "-c", str(src),
             "-o", str(cg_fused.BUILD_DIR / f"{src.stem}_ptxas.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _smem_bytes(kernel, args):
    """Dynamic shared memory of one block, the launchers' formulas: (64 +
    4·64)·(HDP + 8)·2 B forward, (128 + 4·BK)·(HDP + 8)·2 B dQ, that + 16·BK
    B dK/dV, (128 + 8·BK)·(HDP + 8)·2 B JVP; the decode kernels' at one round
    of their ring (``Smem``); ``ssd_intra_kernel`` and ``dots_block_partial``
    (whose shared memory follows the launch's shape) at the slices' shapes,
    (Q, N, P) = (128, 64, 64), and the s-step Gram each instance is cut for
    (4 stages of 128 columns of the padded rows)."""
    if kernel in ("dot2_single", "x_update", "residual_dots_single"):
        return 0
    if kernel == "ssd_intra_kernel":
        from repro_torch.kernels import ssd_scan

        return ssd_scan.smem_bytes(128, 64, 64)
    if kernel == "dots_block_partial":  # <RU, RV, warps> at its s-step shape (or 32 x 32)
        su, sv = {(6, 7): (17, 20), (6, 6): (17, 17), (5, 6): (9, 12),
                  (5, 5): (9, 9)}.get(tuple(args[:2]), (32, 32))
        return 4 * 4 * 128 * (args[0] * -(-su // args[0]) + args[1] * -(-sv // args[1]))
    if kernel in ("fd_dense_kernel", "fd_paged_kernel"):
        esz, hd, rpw, wk = args
        rows = 4 // wk * rpw
        return (esz * 2 * 4 * 32 * hd
                + 4 * (rows * hd + 4 * rpw * 32 + 4 * 32 + 2 * wk * rows + 2 * rows) + 4 * 4)
    ld = args[0] + 8
    if kernel == "fa_forward_mma":
        return 2 * (64 + 4 * 64) * ld
    if kernel == "fa_jvp_mma":
        return 2 * (128 + 8 * args[1]) * ld
    return 2 * (128 + 4 * args[1]) * ld + (16 * args[1] if kernel == "fa_dkv_mma" else 0)


def _ptxas_instance(func):
    """(kernel, template shown, args) of a mangled entry name, or None."""
    k = re.search(r"(" + "|".join(PTXAS_KERNELS) + r")I(13__nv_bfloat16|f)?"
                  r"((?:Li\d+E)+)E", func or "")
    if k:
        args = [int(x) for x in re.findall(r"Li(\d+)E", k.group(3))]
        if k.group(2):
            args = [2 if k.group(2) == "13__nv_bfloat16" else 4] + args
        tmpl = ("bf16" if args[0] == 2 else "f32") if k.group(2) else None
        shown = ", ".join([tmpl] * bool(tmpl) + [str(a) for a in args[bool(tmpl):]])
        return k.group(1), shown, args
    k = re.search(r"\d(" + "|".join(BOOL_INSTANCES) + r")I((?:Lb[01]E)+)E", func or "")
    if k:
        bits = [int(b) for b in re.findall(r"Lb([01])E", k.group(2))]
        return k.group(1), ", ".join(
            labels[b] for labels, b in zip(BOOL_INSTANCES[k.group(1)], bits)), []
    return None


def print_ptxas(procs):
    """Registers, spills and shared memory of each instance of the four
    tensor-core flash kernels, the two decode kernels, ``ssd_intra_kernel``,
    ``dots_block_partial``, ``dot2_single``, ``x_update`` and
    ``residual_dots_single``; fails if one is
    missing, or if an instance of a ``NO_SPILL`` kernel spills."""
    seen = set()
    for name, proc in procs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v on {name} failed:\n{out[-3000:]}")
        func, frame = None, None
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function properties for )([\w]+)",
                          line)
            if m:
                func = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                frame = tuple(int(x) for x in m.groups())
                continue
            m = re.search(r"Used (\d+) registers", line)
            inst = _ptxas_instance(func)
            if not (m and inst):
                continue
            kernel, shown, args = inst
            stack, st, lo = frame or (None, None, None)
            print(f"[build] ptxas {kernel}<{shown}>: {m.group(1)} registers, spill stores "
                  f"{st} B, spill loads {lo} B, stack {stack} B, dynamic shared memory "
                  f"{_smem_bytes(kernel, args)} B", flush=True)
            seen.add(kernel)
            if kernel in NO_SPILL and (st or lo):
                fail(f"{kernel}<{shown}> spills: {st} B stored, {lo} B loaded")
    if seen != set(PTXAS_KERNELS):
        fail(f"ptxas reported {sorted(seen)}, not every kernel of {PTXAS_KERNELS}")


# ---------------------------------------------------------------- timing --
def time_cold(torch, fn, flush, reps=20, sleep_cycles=200_000):
    """Median ms of one call with L2 flushed before it. A device-side sleep
    after the flush keeps the GPU busy while the host enqueues the call, so
    no host gap enters the window (a call that enqueues many launches from
    Python needs a longer sleep)."""
    ts = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
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


def bound_ms(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sstep_krylov_syncs(K, s, solver, basis, overlap):
    """(schedule, ceiling) of the Gram reductions of an s-step solve of K
    iterations. The schedule is ``repro_torch.core.comm_model``'s blocking
    syncs at K and no line-search trial, less the gradient reduce where it
    blocks: the bootstrap cycles of the adaptive bases, then one Gram per
    full cycle of s (2s under overlap). The depth-resolved prefix guard of
    the adaptive and overlapped cycles may run shorter cycles, each of at
    least one iteration, so their count lies between the schedule and the
    ceiling of one Gram per iteration after the bootstraps (the invariant of
    the reference's ``benchmarks/sstep_bench.py``). Monomial cycles without
    overlap run whole or break down: their count is the schedule."""
    from repro_torch.core import comm_model

    schedule = comm_model.hf_sstep_syncs_per_iteration(
        K, 0, s, solver=solver, basis=basis, overlap=overlap) - (0 if overlap else 1)
    n_boot, covered = comm_model.sstep_bootstrap(2 * s if overlap else s, solver, basis)
    whole = basis == "monomial" and not overlap
    return schedule, schedule if whole else n_boot + max(K - covered, 0)


# ---------------------------------------------------------------- phases --
def phase_gram(torch, cg_fused, ref, label="kernel"):
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
        print(f"[{label}] dots_block: {json.dumps(rec)}", flush=True)
        if not rec["rel_err"] <= TOL or not rec["rel_err_f64"] <= TOL:
            fail(f"dots_block at {su}x{sv}, n={n}: relative error {rec['rel_err']} "
                 f"(float64: {rec['rel_err_f64']}) > {TOL}")
        first = first or rec
    del flush
    torch.cuda.empty_cache()
    return first


# Views of the Krylov kernels' inputs at element offsets into tensors of
# n + 3: all at 1 (16-byte body after a head of 3 elements) and at unequal
# offsets (the 4-byte body), as rows of an (s, n) block of odd n lie.
KRYLOV_OFFSETS = ((0, 0, 0), (1, 1, 1), (1, 2, 0))


# The Krylov kernels whose records the kernels line takes, and the name of
# ``residual_dots``' form with r0s = s (the CG call; three streams).
KRYLOV_NAMES = ("dot2", "x_update", "residual_dots")
RESIDUAL_ALIASED = "residual_dots r0s=s"


def _krylov_cases(torch, cg_fused, ref, x, p, s, alpha, gamma, names):
    """name: (kernel call, plain call, float64 call, Σ|terms| per output,
    bytes, flops, library call or None, yardstick) for the Krylov kernels in
    ``names``. The yardstick is a (key, call) of one PyTorch pass over half
    the kernel's bytes, timed under the same harness: ``p.sum()`` beside
    ``dot2``, a copy of x beside ``x_update`` and both forms of
    ``residual_dots`` (which computes r = x − γ·p with r0s = s, or r0s = x
    itself under ``RESIDUAL_ALIASED``)."""
    n = x.shape[0]
    d = lambda t: t.double()
    copy = torch.empty_like(x) if set(names) - {"dot2"} else None
    res = lambda w: (
        lambda: cg_fused.residual_dots(x, p, w, gamma),
        lambda: ref.residual_dots_ref(x, p, w, gamma),
        lambda: [d(x) - d(gamma) * d(p), ((d(x) - d(gamma) * d(p)) * d(w)).sum(),
                 ((d(x) - d(gamma) * d(p)) ** 2).sum()],
        lambda: [x.abs() + (gamma * p).abs(),
                 ((x - gamma * p) * w).abs().sum(),
                 ((x - gamma * p) ** 2).sum()],
        (4 if w is s else 3) * n * 4 + 3 * 4, 6 * n, None, ("copy_ms", lambda: copy.copy_(x)),
    )
    cases = {
        "dot2": (
            lambda: cg_fused.dot2(x, p), lambda: ref.dot2_ref(x, p),
            lambda: [(d(x) * d(p)).sum(), (d(p) * d(p)).sum()],
            lambda: [(x * p).abs().sum(), (p * p).sum()],
            2 * n * 4 + 2 * 4, 4 * n,
            lambda: (torch.dot(x, p), torch.dot(p, p)), ("sum_ms", lambda: p.sum()),
        ),
        "x_update": (
            lambda: [cg_fused.x_update(x, p, s, alpha, gamma)],
            lambda: [ref.x_update_ref(x, p, s, alpha, gamma)],
            lambda: [d(x) + d(alpha) * d(p) + d(gamma) * d(s)],
            lambda: [x.abs() + (alpha * p).abs() + (gamma * s).abs()],
            4 * n * 4 + 2 * 4, 4 * n, None, ("copy_ms", lambda: copy.copy_(x)),
        ),
        "residual_dots": res(s),
        RESIDUAL_ALIASED: res(x),
    }
    return {k: cases[k] for k in names}


def _krylov_errors(torch, name, kern, plain, exact, terms):
    """(max |kernel − plain|, its relative error, the relative error against
    float64), relative to Σ|terms|; fails unless the kernel gives the same
    bits on two more calls."""
    got, want, ref64, scale = kern(), plain(), exact(), terms()
    again = [kern(), kern()]
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for r in again for g, a in zip(got, r)):
        fail(f"{name}: two calls on the same inputs gave different bits")
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = lambda ws: max(float(((g.double() - w.double()).abs() / (t.double() + 1e-30)).max())
                         for g, w, t in zip(got, ws, scale))
    return abs_err, rel(want), rel(ref64)


def _check_aliased_bits(torch, cg_fused, x, p, gamma, where):
    """Fails unless ``residual_dots`` with r0s = x itself (the kernel's
    aliased form) gives the bits of the call with r0s a copy of x at x's
    offset mod 16 bytes (the general form, in the same order)."""
    n, off = x.shape[0], x.data_ptr() % 16 // 4
    copy = torch.empty(n + 3, device=x.device)[off:off + n].copy_(x)
    one, two = cg_fused.residual_dots(x, p, x, gamma), cg_fused.residual_dots(x, p, copy, gamma)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        fail(f"residual_dots {where}: r0s = s and a copy of s give different bits")


def phase_kernels(torch, cg_fused, ref, label="kernel"):
    """Each Krylov kernel, and ``residual_dots`` with r0s = s, against its
    plain version and float64 at N_MAIN and N_RAGGED, and at N_MAIN on the
    views of ``KRYLOV_OFFSETS``, r0s = s with the bits of r0s = a copy of
    s; returns the records of ``KRYLOV_NAMES`` at N_MAIN, aligned, keyed by
    name."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    alpha = torch.tensor([0.37], device="cuda")
    gamma = torch.tensor([-1.3], device="cuda")
    records = {}
    for n, offs in [(N_MAIN, (0, 0, 0)), (N_RAGGED, (0, 0, 0))] + [
            (N_MAIN, o) for o in KRYLOV_OFFSETS[1:]]:
        x, p, s = (torch.randn(n + 3, device="cuda", generator=gen)[o:o + n] for o in offs)
        cases = _krylov_cases(torch, cg_fused, ref, x, p, s, alpha, gamma,
                              KRYLOV_NAMES + (RESIDUAL_ALIASED,))
        for name, (kern, plain, exact, terms, nb, nf, library, yard) in cases.items():
            abs_err, rel_err, rel_f64 = _krylov_errors(torch, name, kern, plain, exact, terms)
            b_ms, b_by = bound_ms(nb, nf)
            rec = {
                "n": n, "offsets": list(offs), "rel_err": rel_err, "rel_err_f64": rel_f64,
                "max_abs_err": abs_err,
                "ms": time_cold(torch, kern, flush),
                "ms_l2_warm": time_warm(torch, kern),
                "plain_ms": time_cold(torch, plain, flush),
                "plain_ms_l2_warm": time_warm(torch, plain),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if library is None else time_cold(torch, library, flush),
            }
            if yard:
                rec[yard[0]] = time_cold(torch, yard[1], flush)
                rec[yard[0] + "_l2_warm"] = time_warm(torch, yard[1])
            print(f"[{label}] {name}: {json.dumps(rec)}", flush=True)
            if not (rel_err <= TOL and rel_f64 <= TOL):
                fail(f"{name} at n={n}, offsets {offs}: relative error {rel_err} "
                     f"(float64: {rel_f64}) > {TOL}")
            if n == N_MAIN and offs == (0, 0, 0) and name in KRYLOV_NAMES:
                records[name] = rec
        _check_aliased_bits(torch, cg_fused, x, p, gamma, f"at n={n}, offsets {offs}")
    del flush
    torch.cuda.empty_cache()
    return records


def phase_krylov_large(torch, cg_fused, ref, label="kernel"):
    """``dot2``, ``x_update`` and both forms of ``residual_dots`` at the
    transformer slice's flat length (QWEN_PARAMS) against their plain
    versions and float64, under the gates of ``phase_kernels``: ms with L2
    cold (median and least of 9 calls), the byte bound, the achieved GB/s,
    the plain version's ms, for ``dot2`` two ``torch.dot`` calls, and the
    yardstick of ``_krylov_cases``. Each
    kernel is timed first, after 10 calls back to back: right after
    ``torch.cuda.empty_cache()`` hands GB back to the driver, the same
    kernel ran up to 18% slower for several calls on an H100. Frees its
    vectors before it returns."""
    n, reps = QWEN_PARAMS, 9
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    alpha = torch.tensor([0.37], device="cuda")
    gamma = torch.tensor([-1.3], device="cuda")
    x, p, s = (torch.randn(n, device="cuda", generator=gen) for _ in range(3))
    cases = _krylov_cases(torch, cg_fused, ref, x, p, s, alpha, gamma,
                          KRYLOV_NAMES + (RESIDUAL_ALIASED,))
    for name, (kern, plain, exact, terms, nb, nf, library, yard) in cases.items():
        for _ in range(10):
            kern()
        ts = [time_cold(torch, kern, flush, reps=1) for _ in range(reps)]
        ms = statistics.median(ts)
        b_ms, b_by = bound_ms(nb, nf)
        rec = {
            "n": n, "ms": ms, "ms_min": min(ts), "gb_per_s": nb / ms / 1e6,
            "bound_ms": b_ms, "bound_by": b_by,
            yard[0]: time_cold(torch, yard[1], flush, reps=reps),
            "library_ms": None if library is None else time_cold(torch, library, flush,
                                                                 reps=reps),
            "plain_ms": time_cold(torch, plain, flush, reps=reps),
        }
        abs_err, rel_err, rel_f64 = _krylov_errors(torch, name, kern, plain, exact, terms)
        rec.update(rel_err=rel_err, rel_err_f64=rel_f64, max_abs_err=abs_err)
        print(f"[{label}] {name} large: {json.dumps(rec)}", flush=True)
        if not (rel_err <= TOL and rel_f64 <= TOL):
            fail(f"{name} at n={n}: relative error {rel_err} (float64: {rel_f64}) > {TOL}")
    _check_aliased_bits(torch, cg_fused, x, p, gamma, f"at n={n}")
    del x, p, s, cases, flush
    torch.cuda.empty_cache()


# Flash-attention cases: (tag, B, S, H, KV, hd, causal, window, valid_len, bias).
# "slice" is the transformer slice's gradient batch (Qwen1.5-0.5B's heads),
# "curvature" its curvature batch; "gqa" is Qwen2-1.5B's attention; "ragged"
# is S 130 padded to 256; "bias" has fully masked rows at the smoke head dim;
# "hd40" is a head dim that is a multiple of 8 but not of 16 (the tensor-core
# kernels pad it to 48).
FLASH_CASES = (
    ("slice", 8, 512, 16, 16, 64, True, None, None, False),
    ("curvature", 2, 512, 16, 16, 64, True, None, None, False),
    ("gqa", 2, 512, 12, 2, 128, True, None, None, False),
    ("ragged", 2, 256, 16, 16, 64, True, None, 130, False),
    ("window", 2, 512, 16, 16, 64, True, 64, None, False),
    ("bias", 2, 256, 4, 4, 32, False, None, None, True),
    ("hd40", 2, 384, 4, 2, 40, True, None, None, False),
)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
               "flash_attention_jvp")
# multiply-adds x 2 per (query, key) pair that the mask lets through
FLASH_FLOPS_PER_PAIR = {"flash_attention_fwd": 4, "flash_attention_dq": 6,
                        "flash_attention_dkv": 8, "flash_attention_jvp": 10}


def _flash_inputs(torch, case, dtype, gen):
    from repro_torch.kernels import ref

    tag, B, S, H, KV, hd, causal, window, valid_len, with_bias = case
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    q, do, qt = rnd(B, S, H, hd), rnd(B, S, H, hd), rnd(B, S, H, hd)
    k, v, kt, vt = (rnd(B, S, KV, hd) for _ in range(4))
    kw = dict(causal=causal, window=window, valid_len=valid_len, bias=None)
    mask = ref._ref_mask(S, S, causal=causal, window=window, valid_len=valid_len,
                         device="cuda")
    if with_bias:
        bias = torch.zeros(1, S, S, device="cuda")
        bias[0, 3] = ref.NEG_INF                     # fully masked rows
        bias[0, S // 2] = ref.NEG_INF
        bias[0, 10:40, 5:70] = ref.NEG_INF           # a masked patch
        kw["bias"] = bias
        mask = mask & (bias[0] > ref.NEG_INF / 2)
    pairs = int(mask.sum()) * B * H
    up = lambda t: t.float()
    o, lse = ref.flash_attention_fwd_ref(up(q), up(k), up(v), **kw)
    delta = (o * up(do)).sum(-1).transpose(1, 2).contiguous()
    return dict(q=q, k=k, v=v, do=do, qt=qt, kt=kt, vt=vt, o=o, lse=lse, delta=delta,
                kw=kw, pairs=pairs)


def _flash_calls(torch, x):
    """name: (kernel call, plain call given an upcast of the inputs, bytes the
    function must move, library call or None)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref

    q, k, v, do, qt, kt, vt = (x[n] for n in ("q", "k", "v", "do", "qt", "kt", "vt"))
    lse, delta, kw = x["lse"], x["delta"], x["kw"]
    B, S, H, hd = q.shape
    esz = q.element_size()
    lib = (None, None)
    if kw["bias"] is None and kw["window"] is None and kw["valid_len"] is None:
        gqa = dict(enable_gqa=True) if H != k.shape[2] else {}
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        lib_fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=kw["causal"],
                                                         **gqa)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qs, ks, vs))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=kw["causal"], **gqa)
        dos = do.transpose(1, 2)
        lib = (lib_fwd,
               lambda: torch.autograd.grad(out, (qg, kg, vg), dos, retain_graph=True))
    n_q, n_k = q.numel(), k.numel()
    rows = B * H * S * 4
    return {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, **kw),
            lambda up: ref.flash_attention_fwd_ref(up(q), up(k), up(v), **kw),
            (n_q + 2 * n_k) * esz + n_q * esz + rows, lib[0]),
        "flash_attention_dq": (
            lambda: (fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),),
            lambda up: (ref.flash_attention_dq_ref(up(q), up(k), up(v), up(do), lse, delta,
                                                   **kw),),
            (2 * n_q + 2 * n_k) * esz + 2 * rows + n_q * esz, lib[1]),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
            lambda up: ref.flash_attention_dkv_ref(up(q), up(k), up(v), up(do), lse, delta,
                                                   **kw),
            (2 * n_q + 2 * n_k) * esz + 2 * rows + 2 * B * S * H * hd * 4, lib[1]),
        "flash_attention_jvp": (
            lambda: fa.flash_attention_jvp(q, k, v, qt, kt, vt, lse, **kw),
            lambda up: ref.flash_attention_jvp_ref(up(q), up(k), up(v), up(qt), up(kt),
                                                   up(vt), lse, **kw),
            (2 * n_q + 4 * n_k) * esz + rows + n_q * 4 + rows, None),
    }


def _library_kernel(torch, library):
    """(the name of the device kernel that takes the most time in one call
    of ``library``, the SDPA backend that name shows) from torch.profiler;
    (None, "not seen") if two profiled calls show no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    library()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            library()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if kern:
            break
    else:
        return None, "not seen"
    name = max(kern, key=lambda e: e.self_device_time_total).key
    low = name.lower()
    backend = ("cudnn" if "cudnn" in low else "flash" if "flash" in low else
               "efficient" if ("fmha" in low or "cutlass" in low or "mem_eff" in low) else
               "math")
    return name[:120], backend


def _rel(got, want):
    """max |got - want| / max |want| over the outputs, and the max |got - want|."""
    rel = max(float((g.double() - w.double()).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(got, want))
    return rel, max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))


def phase_flash(torch, reps_cold=20, reps_warm=50, cases=FLASH_CASES, label="flash"):
    """The four flash kernels against their plain versions on every case, f32
    and bf16 (in bf16 also against the plain version run on the bf16 inputs
    themselves, rounding the weights where the reference rounds them);
    returns the records of the slice's case in bf16, keyed by name."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    records = {}
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = _flash_inputs(torch, case, dtype, gen)
            backends = {}  # one profile per library call (dQ and dK/dV share one)
            for name, (kern, plain_up, n_bytes, library) in _flash_calls(torch, x).items():
                plain = lambda: plain_up(lambda t: t.float())
                got, want = kern(), plain()
                rel, abs_err = _rel(got, want)
                rel64, _ = _rel(got, plain_up(lambda t: t.double()))
                rel_in = (_rel(got, plain_up(lambda t: t))[0] if dtype == torch.bfloat16
                          else rel)
                torch.cuda.synchronize()
                flops = FLASH_FLOPS_PER_PAIR[name] * case[5] * x["pairs"]
                rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
                b_ms, b_by = bound_ms(n_bytes, flops, rate)
                rec = {
                    "case": case[0], "dtype": dname,
                    "shape": dict(zip(("B", "S", "H", "KV", "hd"), case[1:6])),
                    "causal": case[6], "window": case[7], "valid_len": case[8],
                    "bias": case[9], "rel_err": rel, "rel_err_f64": rel64,
                    "rel_err_plain_in_dtype": rel_in, "max_abs_err": abs_err,
                    "ms": time_cold(torch, kern, flush, reps_cold),
                    "ms_l2_warm": time_warm(torch, kern, reps_warm),
                    "plain_ms": time_cold(torch, plain, flush, 5),
                    "bound_ms": b_ms, "bound_by": b_by,
                    # the library backward enqueues its kernels through autograd:
                    # a longer sleep keeps that host work out of the window
                    "library_ms": (None if library is None else
                                   time_cold(torch, library, flush, reps_cold,
                                             sleep_cycles=5_000_000)),
                }
                if library is not None:
                    if library not in backends:
                        backends[library] = _library_kernel(torch, library)
                    rec["library_kernel"], rec["library_backend"] = backends[library]
                print(f"[{label}] {name}: {json.dumps(rec)}", flush=True)
                if not max(rel, rel64, rel_in) <= FLASH_TOL[dname]:
                    fail(f"{name} on {case[0]} {dname}: relative error {rel} (against "
                         f"float64: {rel64}, against the plain version in {dname}: "
                         f"{rel_in}) > {FLASH_TOL[dname]}")
                if case[0] == "slice" and dtype == torch.bfloat16:
                    records[name] = rec
            del x
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
    from repro_torch.kernels import ops

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
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, iters = step("linearize")
    launches = dict(ops.LAUNCHES)
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
    # Each wrapper call is one launch of its kernel, so the profiler's counts
    # must equal the wrappers' counts over the profiled step.
    for name, wrapper in (("dot2_single", "dot2"), ("x_update", "x_update"),
                          ("residual_dots_single", "residual_dots")):
        own = [e for e in kern if name in e.key]
        count = sum(e.count for e in own)
        print(f"[profile] port kernel {name}: "
              f"{sum(e.self_device_time_total for e in own) / 1e3:.3f} ms in "
              f"{count} launches (LAUNCHES[{wrapper!r}] {launches[wrapper]})", flush=True)
        if count != launches[wrapper]:
            fail(f"{name}: {count} launches in the profiled step, but {launches[wrapper]} "
                 f"calls of {wrapper}")
    walls = {}
    for mode in ("naive", "linearize", "chunked"):
        step(mode)  # warm
        walls[mode] = step(mode)
    print("[profile] step wall per curvature mode: " + ", ".join(
        f"{k} {w:.1f} ms (cg_iters {i})" for k, (w, i) in walls.items()), flush=True)


# ------------------------------------------------- transformer slice --
QWEN = "qwen1.5-0.5b"
QWEN_PARAMS = 464_118_784
SLICE_KW = dict(smoke=False, use_flash_attention=True, krylov_backend="flat", batch_size=8,
                seq_len=512, hvp_batch_frac=0.25, max_cg_iters=8,
                curvature_mode="linearize")


def expected_flash_launches(solver, n_layers, K, E):
    """Launches of the four flash kernels in one outer step, from the code:
    the gradient runs forward, dQ and dK/dV once per layer; a gn_cg step's
    linearize-mode GN build runs the forward and the Jᵀu graph (dQ, dK/dV),
    then each of its 1 + K products (CG's initial residual and one per
    iteration) runs J·v (JVP) and Jᵀ (dQ, dK/dV); each of the E line-search
    trials runs the forward. Bi-CG-STAB's exact-Hessian products take the
    chunked torch route and launch none."""
    if solver == "gn_cg":
        return {"flash_attention_fwd": n_layers * (2 + E),
                "flash_attention_dq": n_layers * (3 + K),
                "flash_attention_dkv": n_layers * (3 + K),
                "flash_attention_jvp": n_layers * (1 + K)}
    return {"flash_attention_fwd": n_layers * (1 + E), "flash_attention_dq": n_layers,
            "flash_attention_dkv": n_layers, "flash_attention_jvp": 0}


def phase_transformer(torch, ops):
    """The transformer slice: Qwen1.5-0.5B at full width and depth (bf16),
    flash attention, flat backend, 2 gn_cg steps then 1 Bi-CG-STAB step
    through ``repro_torch.launch.train.train``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from torch.utils._pytree import tree_leaves

    cfg = get_config(QWEN)
    if cfg.param_count() != QWEN_PARAMS:
        fail(f"{QWEN}: param_count {cfg.param_count()} != {QWEN_PARAMS}")
    print(f"[transformer] {QWEN}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, "
          f"{cfg.dtype}; flash attention, flat backend, batch 8 x 512, curvature batch "
          f"2 x 512, max_cg_iters 8, linearize", flush=True)
    log = lambda line: print(f"[transformer] {line}", flush=True)
    ops.reset_launches()
    params, state, hist = train(QWEN, solver="gn_cg", steps=2, log_fn=log, **SLICE_KW)
    params, state, h2 = train(QWEN, solver="bicgstab", steps=3, start=2, params=params,
                              state=state, log_fn=log, **SLICE_KW)
    launches = dict(ops.LAUNCHES)
    hist = [dict(h, solver="gn_cg") for h in hist] + [dict(h, solver="bicgstab") for h in h2]
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[transformer] parameters {n_params} (param_count {cfg.param_count()})", flush=True)
    if n_params != QWEN_PARAMS:
        fail(f"{QWEN} has {n_params} parameters, expected {QWEN_PARAMS}")
    for h in hist:
        K, E = int(h["cg_iters"]), int(h["ls_evals"])
        want = expected_flash_launches(h["solver"], cfg.n_layers, K, E)
        got = {k: h["launches"][k] for k in want}
        print(f"[transformer] {h['solver']} step {h['step']}: loss {h['loss']:.6f} -> "
              f"{h['loss_new']:.6f}  |g| {h['grad_norm']:.4f}  lambda {h['lambda']:.4g}  "
              f"alpha {h['alpha']:.4g}  cg_iters {K}  ls_evals {E}  wall {h['wall_s']:.3f} s  "
              f"max_memory_allocated {h['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        print(f"[transformer]   launches {h['launches']}  flash launches from the code "
              f"{want}", flush=True)
        if not (math.isfinite(h["loss"]) and math.isfinite(h["loss_new"])):
            fail(f"step {h['step']}: non-finite loss {h['loss']} -> {h['loss_new']}")
        if h["alpha"] > 0 and not h["loss_new"] <= h["loss"]:
            fail(f"step {h['step']}: accepted step raised the loss "
                 f"({h['loss']} -> {h['loss_new']})")
        if got != want:
            fail(f"step {h['step']}: flash launches {got} differ from the code's {want}")
    if not hist[-1]["loss_new"] < hist[0]["loss"]:
        fail(f"the loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss_new']}")
    if not _finite_params(torch, tree_leaves, params):
        fail("non-finite parameters after the transformer slice")
    print(f"[transformer] launches {launches}", flush=True)
    for name in FLASH_NAMES + ("dot2", "residual_dots", "x_update"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the transformer slice")
    return params, state, launches


def phase_transformer_checks(torch):
    """granite-3-8b's smoke config (GQA, kv 2) in f32: the flash model against
    the _sdpa model on the card (loss, gradient, GN and Hessian products), and
    one hf_step on the card against the CPU's plain versions."""
    from torch.func import grad_and_value
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.curvature import make_gnvp_op, make_hvp_op
    from repro_torch.core.hf import HFConfig, hf_init, hf_step
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.transformer import build_model

    cfg = get_smoke_config("granite-3-8b")
    plain = build_model(cfg, device="cuda")
    flash = build_model(cfg.replace(use_flash_attention=True), device="cuda")
    params = plain.init(torch.Generator().manual_seed(0))
    batch = lm_batch(torch.Generator().manual_seed(1), cfg, 2, 256, device="cuda")
    tan = tree_map(lambda p: torch.sin(torch.arange(p.numel(), device="cuda",
                                                    dtype=torch.float32)).reshape(p.shape),
                   params)
    out = {}
    for tag, m in (("sdpa", plain), ("flash", flash)):
        g, f = grad_and_value(m.loss_fn)(params, batch)
        out[tag] = dict(
            loss=f, grad=g,
            gnvp=make_gnvp_op(m.logits_fn, m.out_loss_fn, params, batch)(tan),
            hvp=make_hvp_op(m.loss_fn, params, batch)(tan))
    worst = {k: (_worst_rel(torch, tree_leaves, out["flash"][k], out["sdpa"][k])
                 if k != "loss" else abs(float(out["flash"][k] - out["sdpa"][k])))
             for k in ("loss", "grad", "gnvp", "hvp")}
    print(f"[transformer-check] granite-3-8b smoke (d 128, 4 heads, kv 2, hd 32), f32, "
          f"2 x 256: flash against _sdpa on the card: loss |diff| {worst['loss']:.3e}, "
          f"worst relative diff: gradient {worst['grad']:.3e}, GN product "
          f"{worst['gnvp']:.3e}, Hessian product {worst['hvp']:.3e}", flush=True)
    if not max(worst.values()) <= 1e-4:
        fail(f"flash and _sdpa models differ: {worst}")

    hcfg = HFConfig(solver="gn_cg", krylov_backend="flat", init_damping=100.0, cg_tol=0.0,
                    max_cg_iters=4)
    res = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg.replace(use_flash_attention=True), device=dev)
        p = params_from_numpy(params_to_numpy(params), dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        res[dev] = hf_step(m.loss_fn, p, hf_init(p, hcfg, device=dev), b, b, hcfg,
                           model_out_fn=m.logits_fn, out_loss_fn=m.out_loss_fn, device=dev)
    worst = _worst_rel(torch, tree_leaves, [t.cpu() for t in tree_leaves(res["cuda"][0])],
                        tree_leaves(res["cpu"][0]))
    print(f"[transformer-check] one gn_cg hf_step (lambda 100, cg_tol 0, flat backend, flash) "
          f"card against CPU: loss_new {float(res['cuda'][2]['loss_new']):.7f} vs "
          f"{float(res['cpu'][2]['loss_new']):.7f}, cg_iters "
          f"{int(res['cuda'][2]['cg_iters'])} vs {int(res['cpu'][2]['cg_iters'])}, worst "
          f"parameter relative diff {worst:.3e}", flush=True)
    if not worst <= 1e-4:
        fail(f"card and CPU hf_steps differ by {worst} > 1e-4")


def phase_transformer_profile(torch, params, state):
    """One gn_cg step of the slice under torch.profiler: its wall, the
    device-busy share, the top kernels and the flash kernels' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import train

    def step():
        return train(QWEN, solver="gn_cg", steps=3, start=2, params=params, state=state,
                     log_fn=lambda line: None, **SLICE_KW)[2][0]

    plain = step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_h = step()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    flash = [e for e in kern if "fa_" in e.key and ("_kernel" in e.key or "_mma" in e.key)]
    flash_ms = sum(e.self_device_time_total for e in flash) / 1e3
    wall, prof_wall = plain["wall_s"] * 1e3, prof_h["wall_s"] * 1e3
    print(f"[transformer-profile] gn_cg step (cg_iters {int(plain['cg_iters'])}, ls_evals "
          f"{int(plain['ls_evals'])}): wall {wall:.1f} ms unprofiled, {prof_wall:.1f} ms "
          f"profiled; device busy {busy:.2f} ms = {100 * busy / wall:.2f}% of the unprofiled "
          f"wall ({100 * busy / prof_wall:.2f}% of the profiled); flash kernels "
          f"{flash_ms:.2f} ms = {100 * flash_ms / max(busy, 1e-9):.2f}% of device time",
          flush=True)
    if busy <= 0:
        fail("the profiler saw no device time in the transformer step")
    if not any("fa_jvp_mma" in e.key for e in flash):
        fail("the bf16 JVP did not run fa_jvp_mma in the transformer step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[transformer-profile] {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    for e in flash:
        print(f"[transformer-profile] flash kernel {e.key[:60]}: "
              f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} launches", flush=True)


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
    from repro_torch.kernels import ops

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
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ms, _ = step()
        n_dot2 = ops.LAUNCHES["dot2"]
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
        for name in ("dots_block_partial", "gram_final", "dot2_single"):
            own = [e for e in kern if name in e.key]
            print(f"[profile-sstep] {tag}: port kernel {name}: "
                  f"{sum(e.self_device_time_total for e in own) / 1e3:.3f} ms in "
                  f"{sum(e.count for e in own)} launches", flush=True)
        count = sum(e.count for e in kern if "dot2_single" in e.key)
        if count != n_dot2:
            fail(f"{tag}: {count} dot2_single launches, but {n_dot2} calls of dot2")
    return results


# ---------------------------------------------------- serving slice --
# Dense decode cases: (tag, B, W, H, KV, hd, blk_k, n_splits, window, ragged),
# the reference's FD_CASES (tests/test_flash_decode.py) of head dim >= 32 (the
# ragged ones with their last row fully masked, an idle slot), and the
# serving slice's shape: Qwen2-1.5B's 12 heads over 2 kv heads at hd 128, its
# 896 + 128 slots, every slot live (the last decode step). "fd5-long" gives
# the dense kernel splits of 512 keys (4 rounds of its ring: two rounds in
# flight in bf16, one at a time in f32) behind a window that masks the first
# splits wholly; "fd6-g12" and "fd7-g32" give it groups of 12 and 32 query
# heads a kv head (two and four groups of rows sharing each key tile).
DECODE_CASES = (
    ("fd0", 1, 128, 2, 2, 32, 64, 2, None, False),
    ("fd1-gqa", 2, 256, 4, 2, 32, 64, 4, None, False),
    ("fd2-window", 2, 300, 4, 1, 32, 64, 4, 90, False),
    ("fd3-ragged", 3, 200, 4, 2, 32, 64, 8, None, True),
    ("fd4-all", 2, 192, 8, 2, 64, 64, 3, 64, True),
    ("fd5-long", 2, 2048, 8, 2, 128, 128, 4, 700, False),
    ("fd6-g12", 2, 320, 24, 2, 64, 64, 8, 200, False),
    ("fd7-g32", 2, 256, 32, 1, 32, 128, 8, None, True),
    ("slice", 16, 1024, 12, 2, 128, 128, 8, None, False),
)
# Paged cases: (tag, B, P, ps, maxp, H, KV, hd, window, seq_lens), the
# reference's PAGED_CASES of head dim >= 32 (pages interleaved across the
# pool, non-aligned lengths, a window that frees early pages), one with
# unmapped pages between mapped ones and a fully masked row, and the slice's
# shape: page size 16, 64 pages a slot, placed at random in its 1041-page pool.
PAGED_CASES = (
    ("paged0", 2, 8, 64, 3, 4, 2, 32, None, (130, 57)),
    ("paged1-window", 3, 12, 64, 5, 2, 1, 32, 100, (320, 17, 64)),
    ("paged2-holes", 3, 40, 16, 12, 12, 2, 128, None, (190, 77, 30)),
    ("slice", 16, 1041, 16, 64, 12, 2, 128, None, tuple(1009 + i for i in range(16))),
)
DECODE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DECODE_NAMES = ("flash_decode", "flash_decode_paged")
QWEN2 = "qwen2-1.5b"
QWEN2_PARAMS = 1_543_910_912
SERVE_B, SERVE_S, SERVE_GEN, SERVE_REQ, SERVE_PS = 16, 896, 128, 32, 16


def _dense_case(torch, case, dtype, gen):
    from repro_torch.kernels import flash_decode as fd

    tag, B, W, H, KV, hd, blk_k, n_splits, window, ragged = case
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)
    q, k, v = rnd(B, H, hd), rnd(B, W, KV, hd), rnd(B, W, KV, hd)
    ns, span = fd.split_layout(W, blk_k, n_splits)
    pos = torch.arange(W, dtype=torch.int32, device="cuda")
    t = (torch.tensor([(7 * b + 11) % W for b in range(B)], dtype=torch.int32, device="cuda")
         if ragged else W - 1)
    bias = fd.decode_bias(pos, t, window=window)
    if ragged:
        bias[-1] = fd.NEG_INF                       # an idle slot
    live = int((bias > fd.NEG_INF / 2).expand(B, W).sum())
    kv_row = KV * hd * q.element_size()
    return dict(args=(q, k, v, bias), kw=dict(blk_k=blk_k, n_splits=n_splits),
                # the one launch that returns the merged (o, m, l)
                raw=lambda: fd.extension().flash_decode(q, k, v, bias, ns, span, hd ** -0.5),
                n_bytes=q.numel() * q.element_size() + 2 * live * kv_row + bias.numel() * 4)


def _paged_case(torch, case, dtype, gen):
    from repro_torch.kernels import flash_decode as fd

    tag, B, P, ps, maxp, H, KV, hd, window, seq_lens = case
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)
    q, kp, vp = rnd(B, H, hd), rnd(P, ps, KV, hd), rnd(P, ps, KV, hd)
    if tag == "slice":
        place = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(5)) + 1).tolist()
    else:
        place = [i % P for i in range(B * maxp)]
    tbl = torch.full((B, maxp), -1, dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(seq_lens):
        for j in range(-(-n // ps)):
            if tag == "paged2-holes" and j % 3 == 1:
                continue                            # unmapped between mapped pages
            tbl[b, j] = place[nxt]
            nxt += 1
        first_live = max(0, n - window) if window is not None else 0
        tbl[b, [j for j in range(maxp) if (j + 1) * ps <= first_live]] = -1
    tbl = tbl.cuda()
    bias = fd.paged_bias(tbl, torch.tensor(seq_lens, dtype=torch.int32, device="cuda"), ps,
                         window=window)
    if tag == "paged2-holes":
        bias[-1] = fd.NEG_INF                       # an idle slot
    live_pages = int((bias.reshape(B, maxp, ps) > fd.NEG_INF / 2).any(-1).sum())
    kv_page = ps * KV * hd * q.element_size()
    return dict(args=(q, kp, vp, tbl, bias), kw={},
                # the one launch that returns the merged (o, m, l)
                raw=lambda: fd.extension().flash_decode_paged(q, kp, vp, tbl, bias, hd ** -0.5),
                n_bytes=(q.numel() * q.element_size() + 2 * live_pages * kv_page
                         + bias.numel() * 4 + tbl.numel() * 4))


def _decode_library(torch, x):
    """``scaled_dot_product_attention`` on a dense case: q as (B, H, 1, hd)
    against K/V as (B, KV, W, hd) (laid out before the timing), the bias as
    its additive mask, GQA enabled."""
    import torch.nn.functional as F

    q, k, v, bias = x["args"]
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = bias[:, None, None, :].to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q[:, :, None], ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def phase_decode(torch, reps_cold=20, reps_warm=100, dense_cases=DECODE_CASES,
                 paged_cases=PAGED_CASES, label="decode"):
    """The two decode kernels against their plain versions on every case, f32
    and bf16: the output against the plain version in f32 and in float64,
    the return_stats (m, l) against the plain (m, l), and idle rows exactly
    (0, NEG_INF, 0); each kernel also against its plain split-and-merge
    (``flash_decode_split_ref``, ``flash_decode_paged_split_ref``) on the
    inputs in their own type, under the same gates. ``ms`` times the wrapper
    (its checks and its one launch), ``kernel_ms`` the binding's launch
    alone. Returns the records of the slice's cases in bf16."""
    from repro_torch.kernels import flash_decode as fd, ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    records = {}
    for name, cases, make, kern_fn, plain_fn, split_fn in (
            ("flash_decode", dense_cases, _dense_case, fd.flash_decode, ref.flash_decode_ref,
             ref.flash_decode_split_ref),
            ("flash_decode_paged", paged_cases, _paged_case, fd.flash_decode_paged,
             ref.flash_decode_paged_ref, ref.flash_decode_paged_split_ref)):
        for case in cases:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                x = make(torch, case, dtype, gen)
                args, kw = x["args"], x["kw"]
                up = lambda f: [f(a) for a in args[:3]] + list(args[3:])  # q, k, v upcast
                kern = lambda: kern_fn(*args, return_stats=True, **kw)
                plain = lambda: plain_fn(*up(lambda t: t.float()), return_stats=True)
                got, want = kern(), plain()
                want64 = plain_fn(*up(lambda t: t.double()), return_stats=True)
                torch.cuda.synchronize()
                rel, abs_err = _rel(got[:1], want[:1])
                rel64, _ = _rel(got[:1], want64[:1])
                live = want[1] > fd.NEG_INF / 2
                stats_rel = max(
                    float((got[1] - want[1])[live].abs().max() / want[1][live].abs().max()),
                    float((got[2] - want[2]).abs().max() / want[2].abs().max()))
                idle_ok = bool((got[1][~live] <= fd.NEG_INF / 2).all()
                               and (got[2][~live] == 0).all() and (got[0][~live] == 0).all())
                # the plain split-and-merge, inputs as given
                split = split_fn(*args, return_stats=True, **kw)
                split_rel = _rel(got[:1], split[:1])[0]
                split_stats = max(
                    float((got[1] - split[1])[live].abs().max() / split[1][live].abs().max()),
                    float((got[2] - split[2]).abs().max() / split[2].abs().max()))
                b_ms, b_by = bound_ms(x["n_bytes"] + got[0].numel() * got[0].element_size(), 0)
                library = _decode_library(torch, x) if name == "flash_decode" else None
                rec = {
                    "case": case[0], "dtype": dname, "rel_err": rel, "rel_err_f64": rel64,
                    "stats_rel_err": stats_rel, "idle_rows": int((~live).sum()),
                    "rel_err_split": split_rel, "stats_rel_err_split": split_stats,
                    "max_abs_err": abs_err,
                    # a 2M-cycle (~1 ms) sleep covers the wrapper's checks in
                    # Python, as 200k cycles may not
                    "ms": time_cold(torch, kern, flush, reps_cold, 2_000_000),
                    "ms_l2_warm": time_warm(torch, kern, reps_warm),
                    "kernel_ms": time_cold(torch, x["raw"], flush, reps_cold),
                    "kernel_ms_l2_warm": time_warm(torch, x["raw"], reps_warm),
                    "plain_ms": time_cold(torch, plain, flush, 5, 2_000_000),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": x["n_bytes"],
                    "library_ms": (None if library is None
                                   else time_cold(torch, library, flush, reps_cold,
                                                  2_000_000)),
                }
                print(f"[{label}] {name}: {json.dumps(rec)}", flush=True)
                tol = DECODE_TOL[dname]
                if not (max(rel, rel64, split_rel) <= tol and max(stats_rel, split_stats) <= TOL
                        and idle_ok):
                    fail(f"{name} on {case[0]} {dname}: relative error {rel} (float64 "
                         f"{rel64}, split-and-merge {split_rel}), stats {stats_rel} "
                         f"(split-and-merge {split_stats}), idle rows right: {idle_ok}")
                if case[0] == "slice" and dtype == torch.bfloat16:
                    records[name] = rec
                del x
    del flush
    torch.cuda.empty_cache()
    return records


def _decode_kernel_share(kern, steps, name="fd_dense_kernel"):
    """(ms, launches) a step of the decode kernel ``name`` in a profile of
    ``steps`` decode steps."""
    fdk = [e for e in kern if name in e.key]
    return (sum(e.self_device_time_total for e in fdk) / 1e3 / steps,
            sum(e.count for e in fdk) / steps)


def _serve_requests(torch, cfg):
    """The slice's 32 prompts of 896 tokens (``lm_batch`` from seed 1; the
    first 16 are the batch-at-once batch), generation lengths uniform in
    [32, 128] from seed 0, and arrivals every 4 steps."""
    from repro_torch.data.synthetic import lm_batch

    toks = lm_batch(torch.Generator().manual_seed(1), cfg, SERVE_REQ, SERVE_S + 1,
                    device="cuda")["tokens"][:, :SERVE_S]
    gen_lens = torch.randint(32, SERVE_GEN + 1, (SERVE_REQ,),
                             generator=torch.Generator().manual_seed(0)).tolist()
    return [toks[r:r + 1] for r in range(SERVE_REQ)], gen_lens, [4 * r for r in range(SERVE_REQ)]


def _peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2**30


def phase_serve(torch, ops):
    """The serving slice at full width and depth: Qwen2-1.5B (bf16, random
    weights from seed 0, flash attention) through ``launch.serve.serve``
    (batch-at-once, 16 x 896 + 128) and ``serve_continuous`` (32 requests on
    16 slots, pages of 16). Launch counts are zeroed just before each and
    read just after. Returns the weights, prompts and both runs' tokens and
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_continuous
    from repro_torch.models.transformer import build_model
    from torch.utils._pytree import tree_leaves

    cfg = get_config(QWEN2)
    params = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[serve] {QWEN2}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads} (kv {cfg.n_kv_heads}, head dim {cfg.resolved_head_dim}), d_ff "
          f"{cfg.d_ff}, vocab {cfg.padded_vocab}, {cfg.dtype}: {n_params} parameters; flash "
          f"attention and flash decode", flush=True)
    if n_params != QWEN2_PARAMS or cfg.param_count() != QWEN2_PARAMS:
        fail(f"{QWEN2} has {n_params} parameters (param_count {cfg.param_count()}), "
             f"expected {QWEN2_PARAMS}")
    prompts, gen_lens, arrivals = _serve_requests(torch, cfg)
    log = lambda line: print(f"[serve] {line}", flush=True)
    kw = dict(smoke=False, use_flash_attention=True, params=params, log_fn=log)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dense, st = serve(QWEN2, batch_size=SERVE_B, prompt_len=SERVE_S, gen_len=SERVE_GEN,
                      prompts=prompts[:SERVE_B], **kw)
    dense_launches = dict(ops.LAUNCHES)
    want = {"flash_attention_fwd": cfg.n_layers, "flash_decode": cfg.n_layers * (SERVE_GEN - 1)}
    print(f"[serve] batch-at-once {SERVE_B} x ({SERVE_S} + {SERVE_GEN}): prefill "
          f"{st['prefill_s']:.4f} s (time to first token), decode {st['decode_s']:.4f} s, "
          f"{st['tok_per_s']:.1f} tok/s end to end, {st['tok_per_s_decode']:.1f} tok/s decode, "
          f"{1e3 * st['decode_s'] / (SERVE_GEN - 1):.2f} ms per decode step, peak "
          f"{_peak_gib(torch):.2f} GiB; launches {dense_launches}, from the code {want}",
          flush=True)
    if {k: dense_launches[k] for k in want} != want:
        fail(f"batch-at-once launches {dense_launches} differ from the code's {want}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    cont, cs = serve_continuous(QWEN2, batch_size=SERVE_B, n_requests=SERVE_REQ,
                                prompt_len=SERVE_S, gen_len=SERVE_GEN, page_size=SERVE_PS,
                                arrival_steps=arrivals, gen_lens=gen_lens, prompts=prompts,
                                **kw)
    cont_launches = dict(ops.LAUNCHES)
    want = {"flash_attention_fwd": cfg.n_layers * SERVE_REQ,
            "flash_decode_paged": cfg.n_layers * cs["decode_steps"]}
    ttft = sorted(cs["ttft_s"])
    print(f"[serve] continuous {SERVE_REQ} requests ({sum(gen_lens)} tokens, lengths "
          f"{min(gen_lens)}-{max(gen_lens)}) on {SERVE_B} slots, pages of {SERVE_PS} "
          f"({cs['n_pages']} pages): {cs['steps']} steps ({cs['decode_steps']} decode), "
          f"{cs['wall_s']:.4f} s, {cs['tok_per_s']:.1f} tok/s, {cs['tok_per_step']:.3f} tok/step, "
          f"{1e3 * cs['wall_s'] / cs['steps']:.2f} ms per step, time to first token median "
          f"{1e3 * ttft[len(ttft) // 2]:.2f} ms max {1e3 * ttft[-1]:.2f} ms, peak "
          f"{_peak_gib(torch):.2f} GiB, pages free at the end {cs['pages_free']} of "
          f"{cs['n_pages'] - 1} (invariants held); launches {cont_launches}, from the code "
          f"{want}", flush=True)
    if {k: cont_launches[k] for k in want} != want:
        fail(f"continuous launches {cont_launches} differ from the code's {want}")
    if cs["pages_free"] != cs["n_pages"] - 1:
        fail(f"continuous batching leaked pages: {cs['pages_free']} free")
    for r in range(SERVE_REQ):
        if not (cont[r, :gen_lens[r]] >= 0).all() or (cont[r, gen_lens[r]:] != 0).any():
            fail(f"request {r}: tokens outside its {gen_lens[r]} generated")
    same = sum(int((dense[r, :gen_lens[r]] == cont[r, :gen_lens[r]]).sum())
               for r in range(SERVE_B))
    prefix = [next((i for i in range(gen_lens[r]) if dense[r, i] != cont[r, i]), gen_lens[r])
              for r in range(SERVE_B)]
    print(f"[serve] dense against continuous greedy tokens (requests 0-{SERVE_B - 1}, bf16 "
          f"random weights, not gated): {same} of {sum(gen_lens[:SERVE_B])} equal, first "
          f"tokens {sum(int(dense[r, 0] == cont[r, 0]) for r in range(SERVE_B))} of {SERVE_B}, "
          f"common prefix median {sorted(prefix)[SERVE_B // 2]}", flush=True)
    _serve_with_sink(torch, ops, kw, prompts, gen_lens, arrivals, (dense, st, dense_launches),
                     (cont, cs, cont_launches))
    return params, prompts, {"flash_decode": dense_launches["flash_decode"],
                             "flash_decode_paged": cont_launches["flash_decode_paged"]}


def _serve_with_sink(torch, ops, kw, prompts, gen_lens, arrivals, dense_run, cont_run):
    """Both serving runs again with a telemetry sink, on the same parameters,
    prompts and arrivals (operations phase, part e): the same tokens and
    launches, one ``request`` span per request with a finite time to first
    token, the ``queue_depth`` and ``pages_free`` counters on every
    scheduler tick; tok/s with and without the sink."""
    import tempfile

    import numpy as np

    from repro_torch.launch.serve import serve, serve_continuous
    from repro_torch.obs import telemetry, trace

    print(f"[serve-sink] {card_line()}", flush=True)
    (dense, st, dense_launches), (cont, cs, cont_launches) = dense_run, cont_run
    with tempfile.TemporaryDirectory() as td:
        sink = telemetry.Telemetry(td, meta=dict(kind="serve", arch=QWEN2))
        ops.reset_launches()
        with _SinkClock() as dense_spent:
            dense_s, st_s = serve(QWEN2, batch_size=SERVE_B, prompt_len=SERVE_S,
                                  gen_len=SERVE_GEN, prompts=prompts[:SERVE_B], telemetry=sink,
                                  **kw)
        dl = dict(ops.LAUNCHES)
        ops.reset_launches()
        with _SinkClock() as cont_spent:
            cont_s, cs_s = serve_continuous(QWEN2, batch_size=SERVE_B, n_requests=SERVE_REQ,
                                            prompt_len=SERVE_S, gen_len=SERVE_GEN,
                                            page_size=SERVE_PS, arrival_steps=arrivals,
                                            gen_lens=gen_lens, prompts=prompts, telemetry=sink,
                                            **kw)
        cl = dict(ops.LAUNCHES)
        sink.close()
        print(f"[serve-sink] host time inside the sink: batch-at-once "
              f"{1e6 * dense_spent['total']:.1f} us in all "
              f"({1e6 * dense_spent['total'] / st_s['n_tok']:.4f} us a token), continuous "
              f"{1e3 * cont_spent['total']:.3f} ms in all "
              f"({1e6 * cont_spent['total'] / cs_s['n_tok']:.3f} us a token, "
              f"{1e6 * cont_spent['total'] / cs_s['steps']:.2f} us a tick)", flush=True)
        out = trace.merge_dir(td)
        evs = trace.load_events(td)
        print(f"[serve-sink] walls (host-bound decode, noisy between runs): batch-at-once "
              f"{st['tok_per_s']:.1f} tok/s without the sink, "
              f"{st_s['tok_per_s']:.1f} with it (decode {st['tok_per_s_decode']:.1f} and "
              f"{st_s['tok_per_s_decode']:.1f}); continuous: {cs['tok_per_s']:.1f} and "
              f"{cs_s['tok_per_s']:.1f} tok/s; launches with the sink {dl} and {cl}; "
              f"{len(evs)} events, trace {Path(out).stat().st_size} bytes", flush=True)
        if not (np.array_equal(dense_s, dense) and np.array_equal(cont_s, cont)):
            fail("serving with a telemetry sink gave other tokens than without it")
        if dl != dense_launches or cl != cont_launches:
            fail(f"launches with the sink {dl} {cl} differ from {dense_launches} "
                 f"{cont_launches}")
        reqs = [e for e in evs if e["ev"] == "span" and e["name"] == "request"]
        ttfts = [e["ttft_s"] for e in reqs]
        if sorted(e["req"] for e in reqs) != list(range(SERVE_REQ)) or not all(
                isinstance(t, float) and math.isfinite(t) and t > 0 for t in ttfts):
            fail(f"request spans {[(e['req'], e['ttft_s']) for e in reqs]}")
        for name in ("queue_depth", "pages_free"):
            n = sum(1 for e in evs if e["ev"] == "counter" and e["name"] == name)
            if n != cs_s["steps"]:
                fail(f"{n} {name} counters for {cs_s['steps']} scheduler ticks")
        spans = sorted(e["name"] for e in evs if e["ev"] == "span" and e["name"] != "request")
        if spans != ["decode", "prefill"]:
            fail(f"batch-at-once spans {spans}")
        print(f"[serve-sink] {len(reqs)} request spans, time to first token median "
              f"{1e3 * sorted(ttfts)[len(ttfts) // 2]:.2f} ms; queue_depth and pages_free on "
              f"all {cs_s['steps']} ticks", flush=True)


def _rel_logits(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_serve_fullwidth(torch, params, prompts):
    """From one prefilled state of the slice (16 x 896, bf16, flash): the
    first decode step's logits through the kernels against the plain route
    (``_sdpa`` and the paged gather), and the paged path against the dense
    one. In bf16 each route is also held against the same step in f32 (the
    bf16 weights and caches upcast, plain route), and the comparisons are
    repeated in f32 end to end. The prefill runs under torch.profiler (its
    device time and the flash forward's share). Then 8 dense decode steps
    are timed, profiled and their host reads counted, and 8 paged decode
    steps from the same prompts timed and profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._pytree import tree_map

    from repro_torch.configs import get_config
    from repro_torch.models.attention import KVCache
    from repro_torch.models.transformer import build_model

    cfg = get_config(QWEN2)
    max_len = SERVE_S + SERVE_GEN
    flash = build_model(cfg.replace(use_flash_attention=True), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            logits, cache = flash.prefill(params, {"tokens": torch.cat(prompts[:SERVE_B])},
                                          max_len)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    fa_ms = sum(e.self_device_time_total for e in kern if "fa_forward" in e.key) / 1e3
    print(f"[serve-profile] prefill ({SERVE_B} x {SERVE_S}): device busy {busy:.3f} ms; flash "
          f"forward kernel {fa_ms:.3f} ms = {100 * fa_ms / max(busy, 1e-9):.2f}% of device "
          f"time; {sum(e.count for e in kern)} device kernels", flush=True)
    with torch.no_grad():
        tok = logits[:, -1:].argmax(-1)
        pc = flash.init_cache_paged(SERVE_B, max_len, 1 + SERVE_B * (max_len // SERVE_PS + 1),
                                    SERVE_PS)
        for b in range(SERVE_B):
            _, pc = flash.prefill_paged(params, {"tokens": prompts[b]}, pc, b)

    def dense_copy(dt):
        kv = cache["b0_attn"]
        return {"b0_attn": KVCache(kv.k.to(dt, copy=True), kv.v.to(dt, copy=True),
                                   kv.pos.clone())}

    out = {}
    for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        c = cfg.replace(dtype=dname)
        fl = build_model(c.replace(use_flash_attention=True), device="cuda")
        pl = build_model(c, device="cuda")
        pp = tree_map(lambda t: t.to(dt), params)
        with torch.no_grad():
            out[dname] = {
                "kernels": fl.decode_step(pp, tok, SERVE_S, dense_copy(dt))[0],
                "plain": pl.decode_step(pp, tok, SERVE_S, dense_copy(dt))[0],
                "paged": fl.decode_step_paged(pp, tok, pc._replace(
                    k_pool=pc.k_pool.to(dt, copy=True), v_pool=pc.v_pool.to(dt, copy=True)))[0]}
        del pp
    torch.cuda.empty_cache()
    b16, f32 = out["bfloat16"], out["float32"]
    rel = {"f32 kernels/plain": _rel_logits(f32["kernels"], f32["plain"]),
           "f32 paged/dense": _rel_logits(f32["paged"], f32["kernels"]),
           "bf16 kernels/plain": _rel_logits(b16["kernels"], b16["plain"]),
           "bf16 paged/dense": _rel_logits(b16["paged"], b16["kernels"])}
    to_f32 = {k: _rel_logits(v, f32["plain"]) for k, v in b16.items()}
    same = lambda a, b: int((a.argmax(-1) == b.argmax(-1)).sum())
    print(f"[serve-check] {QWEN2}, {SERVE_B} x {SERVE_S}, first decode step's logits, "
          f"relative to max|logit|: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + "; bf16 routes against the f32 step: "
          + ", ".join(f"{k} {v:.3e}" for k, v in to_f32.items())
          + f"; bf16 argmax equal kernels/plain {same(b16['kernels'], b16['plain'])}, paged/"
          f"dense {same(b16['paged'], b16['kernels'])} of {SERVE_B}", flush=True)
    # f32: the kernels against the plain route without bf16 rounding. bf16:
    # two routes that round attention differently part by ~1 bf16 ulp per
    # layer in the bf16 residual stream, so each is held to the f32 step
    # no worse than 1.5x the plain route is.
    if not (rel["f32 kernels/plain"] <= 1e-4 and rel["f32 paged/dense"] <= 1e-4
            and max(to_f32["kernels"], to_f32["paged"]) <= 1.5 * to_f32["plain"]):
        fail(f"full-width first-step logits differ: {rel}, against f32 {to_f32}")

    def steps(t0, n=8):
        nonlocal cache, tok
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            for i in range(n):
                lg, cache = flash.decode_step(params, tok, t0 + i, cache)
                tok = lg.argmax(-1)
                tok.cpu()
        return (time.perf_counter() - t) * 1e3 / n

    ptok = tok.clone()
    steps(SERVE_S, 4)  # warm
    step_ms = steps(SERVE_S + 4)
    reads = count_host_reads(torch, lambda: steps(SERVE_S + 12, 1))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = steps(SERVE_S + 13)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / 8
    fd_ms, fd_n = _decode_kernel_share(kern, 8)
    print(f"[serve-profile] decode step ({SERVE_B} x 1 token, {cfg.n_layers} layers): wall "
          f"{step_ms:.3f} ms unprofiled, {prof_ms:.3f} ms profiled; device busy {busy:.3f} ms = "
          f"{100 * busy / step_ms:.2f}% of the unprofiled wall; flash_decode kernel "
          f"{fd_ms:.4f} ms = {100 * fd_ms / max(busy, 1e-9):.2f}% of device time in {fd_n:g} "
          f"launches; "
          f"{sum(e.count for e in kern) / 8:.0f} device kernels and {reads} host reads a step",
          flush=True)
    if busy <= 0:
        fail("the profiler saw no device time in the decode steps")
    if fd_n != cfg.n_layers:
        fail(f"{fd_n} dense decode launches a step, not one per layer ({cfg.n_layers})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[serve-profile] {e.self_device_time_total / 1e3 / 8:9.4f} ms/step  "
              f"x{e.count // 8:<4d} {e.key[:90]}", flush=True)
    del cache

    def paged_steps(n=8):
        nonlocal pc, ptok
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            for _ in range(n):
                lg, pc = flash.decode_step_paged(params, ptok, pc)
                ptok = lg.argmax(-1)
                ptok.cpu()
        return (time.perf_counter() - t) * 1e3 / n

    paged_steps(4)  # warm
    step_ms = paged_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = paged_steps()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / 8
    fd_ms, fd_n = _decode_kernel_share(kern, 8, "fd_paged_kernel")
    print(f"[serve-profile] paged decode step ({SERVE_B} slots x 1 token, pages of {SERVE_PS}, "
          f"{cfg.n_layers} layers): wall {step_ms:.3f} ms unprofiled, {prof_ms:.3f} ms "
          f"profiled; device busy {busy:.3f} ms = {100 * busy / step_ms:.2f}% of the "
          f"unprofiled wall; flash_decode_paged kernel {fd_ms:.4f} ms = "
          f"{100 * fd_ms / max(busy, 1e-9):.2f}% of device time in {fd_n:g} launches; "
          f"{sum(e.count for e in kern) / 8:.0f} device kernels a step", flush=True)
    if busy <= 0:
        fail("the profiler saw no device time in the paged decode steps")
    if fd_n != cfg.n_layers:
        fail(f"{fd_n} paged decode launches a step, not one per layer ({cfg.n_layers})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[serve-profile] paged {e.self_device_time_total / 1e3 / 8:9.4f} ms/step  "
              f"x{e.count // 8:<4d} {e.key[:90]}", flush=True)
    del pc


def phase_serve_checks(torch):
    """qwen2-1.5b's smoke config (d 128, 4 heads, kv 2, hd 32) in f32, flash
    on the card: continuous batching gives batch-at-once's tokens, the card
    gives the CPU's tokens for both, and the first decode step's logits
    agree with the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve, serve_continuous
    from repro_torch.models.transformer import build_model
    from repro_torch.data.synthetic import lm_batch

    quiet = lambda line: None
    kw = dict(smoke=True, prompt_len=8, gen_len=5, use_flash_attention=True, log_fn=quiet)
    toks = {}
    for dev in ("cuda", "cpu"):
        toks[dev] = (serve(QWEN2, batch_size=3, device=dev, **kw)[0],
                     serve_continuous(QWEN2, batch_size=2, n_requests=3, arrival_steps=[0, 0, 2],
                                      device=dev, **kw)[0])
    ok = {"continuous == batch-at-once (card)": (toks["cuda"][1] == toks["cuda"][0]).all(),
          "batch-at-once card == CPU": (toks["cuda"][0] == toks["cpu"][0]).all(),
          "continuous card == CPU": (toks["cuda"][1] == toks["cpu"][1]).all()}
    cfg = get_smoke_config(QWEN2).replace(use_flash_attention=True)
    out = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, device=dev)
        p = m.init(torch.Generator().manual_seed(0))
        batch = lm_batch(torch.Generator().manual_seed(1), cfg, 3, 9, device=dev)
        with torch.no_grad():
            lg0, c = m.prefill(p, {"tokens": batch["tokens"][:, :8]}, 13)
            lg1, _ = m.decode_step(p, lg0[:, -1:].argmax(-1), 8, c)
        out[dev] = (lg0.cpu(), lg1.cpu())
    rel = max(_rel_logits(a, b) for a, b in zip(out["cuda"], out["cpu"]))
    print(f"[serve-check] {QWEN2} smoke (d 128, 4 heads, kv 2, hd 32), f32, flash: "
          + ", ".join(f"{k}: {bool(v)}" for k, v in ok.items())
          + f"; prefill and first decode logits card against CPU {rel:.3e} (limit 1e-4)",
          flush=True)
    if not all(ok.values()) or not rel <= 1e-4:
        fail(f"serving checks failed: {ok}, logits {rel}")


# ------------------------------------------------------- the hybrid slice --
# SSD cases: (tag, B, nc, H, Q, N, P). The reference's four of
# tests/test_ssd_kernel.py (chunk 16-128, N 16-64, P 16-64), the smoke
# config's layer (Q 16, N 16, P 16), a chunk the model's fallback picks for
# an odd prompt (Q 7), the widest shape at Q 128 with a last block of one
# head ("wide"), dims that fill no tile and no 16-byte copy ("odd", also in
# bf16) and the slice's prefill: zamba2-7b at full width, 8 prompts of 896
# tokens (7 chunks of 128, 112 heads of 64, N 64).
SSD_CASES = (
    ("ref-chunk16", 1, 4, 1, 16, 16, 16),
    ("ref-chunk32", 2, 4, 4, 32, 32, 64),
    ("ref-chunk128", 1, 2, 2, 128, 64, 64),
    ("ref-chunk64", 2, 1, 3, 64, 16, 32),
    ("smoke", 2, 2, 16, 16, 16, 16),
    ("fallback", 2, 3, 4, 7, 16, 16),
    ("wide", 1, 2, 9, 128, 128, 128),
    ("odd", 2, 2, 3, 48, 5, 7),
    ("slice", 8, 7, 112, 128, 64, 64),
)
SSD_TOL = 1e-5
# The flash kernels at head dims between their register widths: zamba2-7b's
# attention (32 heads over 32, hd 112, S 896) and phi-3-vision's hd 96.
HEAD_FLASH_CASES = (
    ("hd112", 2, 896, 32, 32, 112, True, None, None, False),
    ("hd96", 2, 896, 32, 32, 96, True, None, None, False),
)
HEAD_DECODE_CASES = (
    ("hd112", 8, 1024, 32, 32, 112, 128, 8, None, False),
    ("hd96", 8, 1024, 32, 32, 96, 128, 8, None, True),
)
HEAD_PAGED_CASES = (
    ("hd112", 8, 8 * 64 + 1, 16, 64, 32, 32, 112, None, tuple(1009 + i for i in range(8))),
    ("hd96", 8, 8 * 64 + 1, 16, 64, 32, 32, 96, None, tuple(977 + 5 * i for i in range(8))),
)
ZAMBA = "zamba2-7b"
ZAMBA_TREE_PARAMS = 6_751_130_832   # the parameter tree, in both packages
ZAMBA_PARAM_COUNT = 6_749_917_776   # param_count(): the reference's analytic count
HYB_B, HYB_S, HYB_GEN = 8, 896, 128


def _tri(q):
    return q * (q + 1) // 2


def ssd_cost(B, nc, H, Q, N, P, bc_bytes):
    """(bytes, f32 operations) the SSD intra-chunk function needs: u, log_a,
    B and C read once, y, S, g and l written once; C·Bᵀ on the causal
    triangle once per (b, c), and per head y on the triangle and S."""
    n_bytes = 4 * (2 * B * nc * H * Q * P + B * nc * H * N * P + 2 * B * nc * H * Q
                   + B * nc * H) + 2 * B * nc * Q * N * bc_bytes
    flops = B * nc * (2 * N * _tri(Q) + H * (2 * P * _tri(Q) + 2 * N * Q * P))
    return n_bytes, flops


def ssd_route_ms(B, nc, H, Q, N, P, bc_bytes):
    """(ms at the byte bound, ms at the operation bound of the kernel's
    route): the function's products on the causal triangle, each f32 product
    as the route runs it on the tensor cores: C·Bᵀ as one bf16 product (bf16
    B and C) or three TF32 ones, y as three TF32 products, S as two (bf16 B,
    exact in TF32) or three."""
    n_bytes, _ = ssd_cost(B, nc, H, Q, N, P, bc_bytes)
    cb = 2 * N * _tri(Q) * B * nc
    y = 2 * P * _tri(Q) * B * nc * H
    st = 2 * N * Q * P * B * nc * H
    if bc_bytes == 2:
        ops_s = cb / BF16_FLOPS_PER_S + (3 * y + 2 * st) / TF32_FLOPS_PER_S
    else:
        ops_s = 3 * (cb + y + st) / TF32_FLOPS_PER_S
    return n_bytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def _ssd_rel(i, got, want):
    """max |got - want| / max |want| of output i of (y, S, g, l). For g the
    denominator is at least f32's smallest normal, 2^-126: a chunk of 128
    steps of the reference test's decay has l_Q near -100 and g near
    e^-100, a denormal that f32 holds to a few bits, in the kernel and the
    plain version alike (which give it the same bits)."""
    floor = 2.0 ** -126 if i == 2 else 1e-30
    return float((got.double() - want.double()).abs().max()
                 / max(float(want.double().abs().max()), floor))


def phase_ssd(torch, reps_cold=20, reps_warm=50, cases=SSD_CASES, label="ssd"):
    """``ssd_intra`` against ``ssd_intra_ref`` in f32 (TF32 off) and in
    float64 on every case of ``cases`` (``SSD_CASES``), with log_a = -softplus(x) (the
    reference test's draw) and -softplus(x - 2) (the model's regime, dt about
    0.13): y, S, g and l each within 1e-5 of max|.|; the slice's case with
    bf16 B and C as well (and on "odd"), the slice's timed (L2 cold and warm;
    the plain version).
    Then ``ssd_chunked_pallas`` against the plain ``ssd_chunked`` with and
    without h0, within 2e-4 (rtol and atol, the reference test's gate).
    Returns the slice's record (bf16 B/C, the model's regime). Its bound is
    the larger of the byte bound and the operation bound of the kernel's
    route (``ssd_route_ms``), both kept in the record."""
    import torch.nn.functional as F

    from repro_torch.kernels import cg_fused, ops, ref, ssd_scan
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    record = None
    for tag, B, nc, H, Q, N, P in cases:
        if cg_fused.extension().ssd_intra_smem_bytes(Q, N, P) != ssd_scan.smem_bytes(Q, N, P):
            fail(f"ssd_intra shared memory at {(Q, N, P)}: the kernel's layout and the "
                 f"wrapper's check differ")
        for regime, shift in (("reference", 0.0), ("model", 2.0)):
            for bdt in ((torch.float32, torch.bfloat16) if tag in ("slice", "odd")
                        else (torch.float32,)):
                rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
                u, la = rnd(B, nc, H, Q, P), -F.softplus(rnd(B, nc, H, Q) - shift)
                Bv, Cv = (rnd(B, nc, Q, N) * 0.5).to(bdt), (rnd(B, nc, Q, N) * 0.5).to(bdt)
                kern = lambda: ops.ssd_intra(u, la, Bv, Cv)
                plain = lambda: ref.ssd_intra_ref(u, la, Bv, Cv)
                got, want = kern(), plain()
                want64 = ref.ssd_intra_ref(u.double(), la, Bv.double(), Cv.double())
                torch.cuda.synchronize()
                rels = [_ssd_rel(i, g, w) for i, (g, w) in enumerate(zip(got, want))]
                rels64 = [_ssd_rel(i, g, w) for i, (g, w) in enumerate(zip(got, want64))]
                rec = {"case": tag, "shape": dict(zip("B nc H Q N P".split(),
                                                      (B, nc, H, Q, N, P))),
                       "log_a": regime, "bc_dtype": str(bdt).split(".")[-1],
                       "rel_err": dict(zip("ySgl", rels)), "rel_err_f64": dict(zip("ySgl", rels64)),
                       "max_abs_err": _rel(got, want)[1]}
                if tag == "slice" and regime == "model":
                    rec["ms"] = time_cold(torch, kern, flush, reps_cold)
                    rec["ms_l2_warm"] = time_warm(torch, kern, reps_warm)
                    rec["plain_ms"] = time_cold(torch, plain, flush, 5, 2_000_000)
                    t_bytes, t_ops = ssd_route_ms(B, nc, H, Q, N, P, Bv.element_size())
                    rec["bound_bytes_ms"], rec["bound_ops_ms"] = t_bytes, t_ops
                    rec["bound_ms"] = max(t_bytes, t_ops)
                    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                    rec["library_ms"] = None  # no single PyTorch call computes this function
                    if bdt == torch.bfloat16:
                        record = rec
                print(f"[{label}] ssd_intra: {json.dumps(rec)}", flush=True)
                if not max(rels + rels64) <= SSD_TOL:
                    fail(f"ssd_intra on {tag} ({regime}, {bdt}): relative errors {rels}, "
                         f"against float64 {rels64} > {SSD_TOL}")
                del u, la, Bv, Cv, got, want, want64
    del flush
    torch.cuda.empty_cache()

    for tag, B, nc, H, Q, N, P in cases:
        L = nc * Q
        rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
        u, la = rnd(B, L, H, P), -F.softplus(rnd(B, L, H) - 2.0)
        Bv, Cv, h0 = rnd(B, L, N) * 0.5, rnd(B, L, N) * 0.5, rnd(B, H, N, P) * 0.3
        worst = 0.0
        for h in (None, h0):
            with torch.no_grad():
                got = ops.ssd_chunked_pallas(u, la, Bv, Cv, Q, h0=h)
                want = ssd_chunked(u, la, Bv, Cv, Q, h0=h)
            for g, w in zip(got, want):
                worst = max(worst, float(((g - w).abs() / (2e-4 + 2e-4 * w.abs())).max()))
        print(f"[{label}] ssd_chunked_pallas against ssd_chunked on {tag} (L {L}, chunk {Q}), "
              f"with and without h0: worst |diff| / (2e-4 + 2e-4 |plain|) {worst:.3e} "
              f"(limit 1)", flush=True)
        if not worst <= 1.0:
            fail(f"ssd_chunked_pallas differs from ssd_chunked on {tag}: {worst}")
        del u, la, Bv, Cv, h0, got, want
    torch.cuda.empty_cache()
    return record


def phase_heads(torch):
    """The six flash kernels at head dims 112 and 96 (between the kernels'
    register widths) against their plain versions and float64, f32 and bf16,
    under the gates of the flash and decode phases."""
    phase_flash(torch, reps_cold=5, reps_warm=10, cases=HEAD_FLASH_CASES, label="heads")
    phase_decode(torch, reps_cold=5, reps_warm=10, dense_cases=HEAD_DECODE_CASES,
                 paged_cases=HEAD_PAGED_CASES, label="heads")


def _hybrid_launches(cfg):
    """The launches one batch-at-once ``serve`` of the hybrid makes, from the
    code: one SSD kernel per Mamba layer and one flash forward per group in
    the prefill, one flash decode per group in each decode step."""
    from repro_torch.models.transformer import hybrid_layout

    G = hybrid_layout(cfg)[0]
    return {"ssd_intra": cfg.n_layers, "flash_attention_fwd": G,
            "flash_decode": G * (HYB_GEN - 1)}


def phase_hybrid_serve(torch, ops):
    """The hybrid's main path: zamba2-7b at full width and depth (bf16,
    random weights from seed 0 on the card, flash attention and the SSD
    kernel) through ``launch.serve.serve``, batch-at-once 8 x (896 + 128).
    Launch counts are zeroed just before and read just after. Then a
    profiled prefill, and 8 decode steps from it, timed and profiled. Returns the weights, the
    prompts and the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import build_model, hybrid_layout

    cfg = get_config(ZAMBA)
    params = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[hybrid-serve] {ZAMBA}: {cfg.n_layers} Mamba2 layers (d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner}: {cfg.ssm_n_heads} SSD heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}), groups/per group/tail "
          f"{hybrid_layout(cfg)}, shared attention {cfg.n_heads} heads (kv {cfg.n_kv_heads}, "
          f"head dim {cfg.resolved_head_dim}), d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, "
          f"{cfg.dtype}: {n_params} parameters in the tree, param_count() "
          f"{cfg.param_count()}", flush=True)
    if n_params != ZAMBA_TREE_PARAMS or cfg.param_count() != ZAMBA_PARAM_COUNT:
        fail(f"{ZAMBA} has {n_params} parameters (param_count {cfg.param_count()}), expected "
             f"{ZAMBA_TREE_PARAMS} ({ZAMBA_PARAM_COUNT})")
    toks = lm_batch(torch.Generator().manual_seed(1), cfg, HYB_B, HYB_S + 1,
                    device="cuda")["tokens"][:, :HYB_S]
    prompts = [toks[r:r + 1] for r in range(HYB_B)]
    log = lambda line: print(f"[hybrid-serve] {line}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, st = serve(ZAMBA, smoke=False, batch_size=HYB_B, prompt_len=HYB_S, gen_len=HYB_GEN,
                    use_flash_attention=True, params=params, prompts=prompts, log_fn=log)
    launches = dict(ops.LAUNCHES)
    want = _hybrid_launches(cfg)
    print(f"[hybrid-serve] batch-at-once {HYB_B} x ({HYB_S} + {HYB_GEN}): prefill "
          f"{st['prefill_s']:.4f} s (time to first token), decode {st['decode_s']:.4f} s, "
          f"{1e3 * st['decode_s'] / (HYB_GEN - 1):.2f} ms per decode step, "
          f"{st['tok_per_s_decode']:.1f} tok/s decode, {st['tok_per_s']:.1f} tok/s end to end, "
          f"peak {_peak_gib(torch):.2f} GiB; launches {launches}, from the code {want}",
          flush=True)
    if {k: launches[k] for k in want} != want:
        fail(f"hybrid serve launches {launches} differ from the code's {want}")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("hybrid serve produced tokens outside the vocabulary")

    model = build_model(cfg.replace(use_flash_attention=True), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": toks}, HYB_S + HYB_GEN)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    share = lambda name: sum(e.self_device_time_total for e in kern if name in e.key) / 1e3
    print(f"[hybrid-profile] prefill ({HYB_B} x {HYB_S}): wall {1e3 * prof_s:.1f} ms profiled; "
          f"device busy {busy:.3f} ms = {100 * busy / (1e3 * prof_s):.2f}%; ssd_intra kernel "
          f"{share('ssd_intra_kernel'):.3f} ms, flash forward kernel "
          f"{share('fa_forward'):.3f} ms; {sum(e.count for e in kern)} device kernels",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[hybrid-profile] prefill {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    tok = logits[:, -1:].argmax(-1)
    if not bool(torch.isfinite(logits).all()):
        fail("hybrid prefill logits are not finite")

    def steps(t0, n=8):
        nonlocal cache, tok
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            for i in range(n):
                lg, cache = model.decode_step(params, tok, t0 + i, cache)
                tok = lg.argmax(-1)
                tok.cpu()
        return (time.perf_counter() - t) * 1e3 / n

    steps(HYB_S, 2)  # warm
    step_ms = steps(HYB_S + 2)
    reads = count_host_reads(torch, lambda: steps(HYB_S + 10, 1))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = steps(HYB_S + 11)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / 8
    fd_ms, fd_n = _decode_kernel_share(kern, 8)
    print(f"[hybrid-profile] decode step ({HYB_B} x 1 token, {cfg.n_layers} Mamba2 layers + "
          f"{hybrid_layout(cfg)[0]} shared attention blocks): wall {step_ms:.3f} ms "
          f"unprofiled, {prof_ms:.3f} ms profiled; device busy {busy:.3f} ms = "
          f"{100 * busy / step_ms:.2f}% of the unprofiled wall; flash_decode kernel "
          f"{fd_ms:.4f} ms in {fd_n:g} launches; "
          f"{sum(e.count for e in kern) / 8:.0f} device kernels and {reads} host reads a step",
          flush=True)
    if busy <= 0:
        fail("the profiler saw no device time in the hybrid decode steps")
    if fd_n != hybrid_layout(cfg)[0]:
        fail(f"{fd_n} dense decode launches a step, not one per attention block")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[hybrid-profile] {e.self_device_time_total / 1e3 / 8:9.4f} ms/step  "
              f"x{e.count // 8:<4d} {e.key[:90]}", flush=True)
    del cache, logits
    torch.cuda.empty_cache()
    return params, prompts, {k: launches[k] for k in ("ssd_intra",)}


def _hybrid_outputs(torch, model, params, toks, max_len):
    """The prefill's last-token logits, its final Mamba states (every layer's,
    concatenated) and the first decode step's logits."""
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, max_len)
        states = torch.cat([cache["groups_mamba"]["b0_mamba"].state.flatten(0, 1),
                            cache["tail"]["b0_mamba"].state])
        first, _ = model.decode_step(params, logits[:, -1:].argmax(-1), toks.shape[1], cache)
    return {"prefill logits": logits.float(), "final states": states.float(),
            "first decode logits": first.float()}


def phase_hybrid_check(torch, params, prompts):
    """Full width, from the first 2 prompts, in f32 and bf16: the kernel route
    (SSD kernel and flash kernels) against the plain route (``ssd_chunked``
    and ``_sdpa``), on the prefill's last-token logits, its final Mamba
    states and the first decode step's logits. f32 within 1e-4 of max|.|; in
    bf16 each route no farther from the f32 plain route than 1.5x the plain
    route is. Then the smoke config (f32) on the card against the CPU:
    prefill logits within 1e-4, 8 greedy tokens equal, one gn_cg hf_step
    (flash on, λ 100, cg_tol 0, krylov_jitter 0) within 1e-4."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.hf import HFConfig, hf_init, hf_step
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.transformer import build_model

    toks = torch.cat(prompts[:2])
    max_len = HYB_S + HYB_GEN
    out = {}
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = get_config(ZAMBA).replace(dtype=dname)
        p = params if dt == torch.bfloat16 else tree_map(
            lambda t: t.float() if t.dtype == torch.bfloat16 else t, params)
        for route, flash in (("kernels", True), ("plain", False)):
            out[(dname, route)] = _hybrid_outputs(
                torch, build_model(cfg.replace(use_flash_attention=flash), device="cuda"), p,
                toks, max_len)
        del p
        torch.cuda.empty_cache()
    names = list(out[("float32", "plain")])
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    f32 = {n: rel(out[("float32", "kernels")][n], out[("float32", "plain")][n]) for n in names}
    b16 = {(r, n): rel(out[("bfloat16", r)][n], out[("float32", "plain")][n])
           for r in ("kernels", "plain") for n in names}
    print(f"[hybrid-check] {ZAMBA} full width, 2 x {HYB_S}, kernel route against plain route "
          f"in f32, relative to max|.|: " + ", ".join(f"{n} {v:.3e}" for n, v in f32.items())
          + "; bf16 routes against the f32 plain route: "
          + ", ".join(f"{r} {n} {v:.3e}" for (r, n), v in b16.items()), flush=True)
    bad = [n for n in names if not (f32[n] <= 1e-4
                                    and b16[("kernels", n)] <= 1.5 * b16[("plain", n)])]
    if bad:
        fail(f"hybrid kernel route differs on {bad}: f32 {f32}, bf16 against f32 {b16}")
    del out
    torch.cuda.empty_cache()

    cfg = get_smoke_config(ZAMBA).replace(use_flash_attention=True)
    batch = lm_batch(torch.Generator().manual_seed(1), cfg, 3, 33, device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, device=dev)
        p = m.init(torch.Generator().manual_seed(0))
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            lg, c = m.prefill(p, {"tokens": b["tokens"][:, :32]}, 40)
            tok, gen_toks = lg[:, -1:].argmax(-1), []
            for i in range(8):
                lg1, c = m.decode_step(p, tok, 32 + i, c)
                tok = lg1.argmax(-1)
                gen_toks.append(tok)
        hcfg = HFConfig(solver="gn_cg", krylov_backend="flat", init_damping=100.0, cg_tol=0.0,
                        max_cg_iters=4, krylov_jitter=0.0)
        step = hf_step(m.loss_fn, p, hf_init(p, hcfg, device=dev), b, b, hcfg,
                       model_out_fn=m.logits_fn, out_loss_fn=m.out_loss_fn, device=dev)
        res[dev] = (lg.cpu(), torch.cat(gen_toks, 1).cpu(),
                    [t.cpu() for t in tree_leaves(step[0])], step[2])
    logit_rel = _rel_logits(res["cuda"][0], res["cpu"][0])
    same = bool((res["cuda"][1] == res["cpu"][1]).all())
    worst = _worst_rel(torch, tree_leaves, res["cuda"][2], res["cpu"][2])
    print(f"[hybrid-check] {ZAMBA} smoke (5 layers, d 128, hd 32, N 16, chunk 16), f32, "
          f"kernels on the card against the CPU: prefill logits {logit_rel:.3e} (limit 1e-4), "
          f"8 greedy tokens equal: {same}; one gn_cg hf_step (flash, lambda 100, cg_tol 0): "
          f"loss_new {float(res['cuda'][3]['loss_new']):.7f} vs "
          f"{float(res['cpu'][3]['loss_new']):.7f}, worst parameter relative diff {worst:.3e} "
          f"(limit 1e-4)", flush=True)
    if not (logit_rel <= 1e-4 and same and worst <= 1e-4):
        fail(f"hybrid smoke card against CPU: logits {logit_rel}, tokens equal {same}, "
             f"hf_step {worst}")


# ------------------------------------------------------ data parallel --
# The fig5 combos of the data-parallel phase and their initial damping. The
# standard solves run at the series' λ₀ 1. The overlapped s-step combo runs
# at SSTEP_LAM, where its solve carries signal; at λ₀ 1 (and 0.1) its
# residual reaches f32 round-off within K = 8 and the prefix guard's
# verdicts, so its cycle count, follow round-off (at full width on the
# card: 4 Gram reductions at 1 rank, 5 at 2, on the first step).
DP_RUNS = (("cg_s1", 1.0), ("bicgstab_s1", 1.0), ("cg_s2_overlap", SSTEP_LAM))
DP_KERNELS = ("dot2", "x_update", "residual_dots", "dots_block")
DP_DECODE_CASES = (("full", 1100), ("half-empty", 300))   # (name, positions before t)
DP_DECODE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _dp_env():
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root / "src"), str(root)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _dp_records(out, n):
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


def dp_decode_worker(out_dir):
    """One rank of the sharded-decode check (``--dp-worker decode``): writes
    ``decode.rank<r>.json``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import multiproc
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models.attention import KVCache, attn_init, decode_attend
    from repro_torch.models.decode_sharded import sharded_decode_attend

    torch.set_float32_matmul_precision("highest")
    dev = multiproc.initialize_from_env("cuda")
    mesh = make_data_mesh("model")
    cfg = get_config("qwen2-1.5b")
    B, W, KV, hd = 16, 1024, cfg.n_kv_heads, cfg.resolved_head_dim
    Wl = W // mesh.size
    own = slice(mesh.rank * Wl, (mesh.rank + 1) * Wl)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(0)
        p = attn_init(gen, cfg, dtype)
        for name, npos in DP_DECODE_CASES:
            fill = min(npos, W)
            ppos = torch.arange(npos - fill, npos, device=dev)
            full = KVCache(torch.zeros(B, W, KV, hd, dtype=dtype, device=dev),
                           torch.zeros(B, W, KV, hd, dtype=dtype, device=dev),
                           torch.full((W,), -1, dtype=torch.int32, device=dev))
            full.k[:, ppos % W] = torch.randn(B, fill, KV, hd, generator=gen, device=dev).to(dtype)
            full.v[:, ppos % W] = torch.randn(B, fill, KV, hd, generator=gen, device=dev).to(dtype)
            full.pos[ppos % W] = ppos.to(torch.int32)
            x = torch.randn(B, 1, cfg.d_model, generator=gen, device=dev).to(dtype)
            shard = KVCache(*(c[:, own].clone() for c in full[:2]), full.pos[own].clone())
            y_full, _ = decode_attend(p, x, npos, KVCache(*(c.clone() for c in full)),
                                      cfg.replace(use_flash_attention=True))
            before = ops.LAUNCHES["flash_decode"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_sh, shard = sharded_decode_attend(p, x, npos, shard, cfg, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = float((y_sh.float() - y_full.float()).abs().max()
                        / y_full.float().abs().max())
            live = int((shard.pos >= 0).sum())
            rows.append(dict(case=name, dtype=str(dtype).split(".")[1], rank=mesh.rank,
                             rel_err=err, live_slots=live, wall_ms=wall * 1e3,
                             launches=ops.LAUNCHES["flash_decode"] - before,
                             finite=bool(torch.isfinite(y_sh.float()).all())))
    Path(out_dir, f"decode.rank{mesh.rank}.json").write_text(json.dumps(rows))
    torch.distributed.destroy_process_group()


def _dp_fig5(multiproc, tmp, env):
    """The TIMIT combos at 1 and 2 ranks; returns {n: [rank records]}, each
    a list of ``DP_RUNS``' records. A first pass over the combos, not
    recorded, takes each process's first CUDA calls (about 10 s of library
    start-up in the first step, a few hundred ms in the first s-step one)."""
    from repro_torch.configs.paper_mlp import TIMIT_FIG5

    runs = ",".join(f"{name}:flat:{lam}:0" for name, lam in DP_RUNS + DP_RUNS)
    recs = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        multiproc.spawn(n, "repro_torch.launch.fig5", [
            "--runs", runs, "--dims", ",".join(map(str, TIMIT_FIG5)), "--batch", "4096",
            "--device", "cuda", "--out", str(tmp / f"n{n}")],
            env=env, timeout_s=300)
        recs[n] = [rank[len(DP_RUNS):] for rank in _dp_records(tmp / f"n{n}", n)]
        print(f"[dp] fig5 combos at {n} rank(s): {time.perf_counter() - t0:.1f} s with the "
              f"processes' start", flush=True)
    return recs


def _dp_check_syncs(name, rec, st, comm_model):
    """``blocking_syncs`` against the sync model at the executed K and E: the
    formula itself for a standard solve; for an s-step solve its Gram
    reductions between the schedule and the ceiling of ``sstep_krylov_syncs``
    (the prefix guard may shorten cycles, as phase 4 allows) and the step's
    blocking syncs built from them as ``hf_step`` builds them."""
    K, E, ks = int(st["cg_iters"]), int(st["ls_evals"]), int(st["krylov_syncs"])
    family = "bicgstab" if rec["solver"] == "bicgstab" else "cg"
    want = comm_model.hf_sstep_syncs_per_iteration(
        K, E, rec["s"], solver=family, basis=rec["basis"], overlap=rec["overlap"])
    if rec["s"] == 1:
        ok = int(st["blocking_syncs"]) == want
    else:
        lo, hi = sstep_krylov_syncs(K, rec["s"], family, rec["basis"], rec["overlap"])
        built = ks + (E + 1) // 2 if rec["overlap"] else 1 + ks + E
        ok = lo <= ks <= hi and int(st["blocking_syncs"]) == built
    if not ok:
        fail(f"dp {name} rank {rec['rank']} of {rec['n_processes']}: blocking_syncs "
             f"{st['blocking_syncs']} (krylov_syncs {ks}) against the sync model {want} at "
             f"K={K}, E={E}")
    if st["executed"].get("loss") != 1 + E:
        fail(f"dp {name}: the loss reduced {st['executed'].get('loss')} times, not 1 + E")
    if not (math.isfinite(st["loss"]) and math.isfinite(st["loss_new"])):
        fail(f"dp {name}: non-finite loss {st['loss']} -> {st['loss_new']}")


def _dp_gates(comm_model, recs):
    """The phase's gates on the fig5 records; returns each rank's launches."""
    totals = {r: dict.fromkeys(DP_KERNELS, 0) for r in range(2)}
    for i, (name, lam) in enumerate(DP_RUNS):
        one, ranks = recs[1][0][i], [recs[2][r][i] for r in range(2)]
        for rec in (one, *ranks):
            walls = [st["wall_s"] * 1e3 for st in rec["steps"]]
            print(f"[dp] {name} λ0={lam} rank {rec['rank']} of {rec['n_processes']}: step "
                  f"walls {[round(w, 1) for w in walls]} ms (median "
                  f"{statistics.median(walls):.1f}), preduce host "
                  f"{[round(st['preduce_s'] * 1e3, 2) for st in rec['steps']]} ms a step, "
                  f"hidden-reduce wait "
                  f"{[round(st['grad_wait_s'] * 1e3, 3) for st in rec['steps']]} ms, "
                  f"bytes an all-reduce {rec['bytes_per_reduce']}, collectives "
                  f"{rec['collectives']}, counted {rec['executed']}, cg_iters "
                  f"{[int(st['cg_iters']) for st in rec['steps']]}, ls_evals "
                  f"{[int(st['ls_evals']) for st in rec['steps']]}, krylov/blocking syncs "
                  f"{[(int(st['krylov_syncs']), int(st['blocking_syncs'])) for st in rec['steps']]}"
                  f", loss {[(st['loss'], st['loss_new']) for st in rec['steps']]}, launches "
                  f"{[st['launches'] for st in rec['steps']]}", flush=True)
            for st in rec["steps"]:
                _dp_check_syncs(name, rec, st, comm_model)
        a, b = ranks
        for sa, sb in zip(a["steps"], b["steps"]):
            if sa["executed"] != sb["executed"] or sa["launches"] != sb["launches"]:
                fail(f"dp {name}: the ranks differ: {sa['executed']} {sa['launches']} vs "
                     f"{sb['executed']} {sb['launches']}")
        same = (a["steps"][0]["executed"] == one["steps"][0]["executed"]
                and a["steps"][0]["launches"] == one["steps"][0]["launches"])
        print(f"[dp] {name}: step 1 at 2 ranks {a['steps'][0]['executed']} "
              f"{a['steps'][0]['launches']}, at 1 rank {one['steps'][0]['executed']} "
              f"{one['steps'][0]['launches']}", flush=True)
        if one["s"] == 1 and not same:
            fail(f"dp {name}: step 1's collectives or launches differ between 1 and 2 ranks")
        f1, f2 = one["steps"][0]["loss_new"], a["steps"][0]["loss_new"]
        print(f"[dp] {name}: step 1 loss_new 1 rank {f1!r}, 2 ranks {f2!r}, |diff| "
              f"{abs(f1 - f2):.3e} (limit {1e-4 * max(1.0, abs(f1)):.3e})", flush=True)
        if not abs(f1 - f2) <= 1e-4 * max(1.0, abs(f1)):
            fail(f"dp {name}: step 1 loss_new {f2} at 2 ranks vs {f1} at 1 rank")
        for r, rec in enumerate(ranks):
            for st in rec["steps"]:
                for k in DP_KERNELS:
                    totals[r][k] += st["launches"].get(k, 0)
    for r, tot in totals.items():
        if not all(tot[k] > 0 for k in DP_KERNELS):
            fail(f"dp: rank {r} launched {tot}: a Krylov kernel never ran")
    print(f"[dp] launches per rank over the combos: {totals}", flush=True)
    return totals


def _dp_cli(tmp, env):
    hist = tmp / "cli.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
           "--smoke", "--num-processes", "2", "--flash-attention", "--solver", "gn_cg",
           "--krylov-backend", "flat", "--steps", "2", "--history-out", str(hist)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step")]
    print(f"[dp] train --num-processes 2: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; primary: {lines}", flush=True)
    if res.returncode != 0 or len(lines) != 2:
        fail(f"train --num-processes 2: exit {res.returncode}, step lines {lines}\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    ranks = [json.loads(hist.read_text()), json.loads(Path(f"{hist}.rank1").read_text())]
    flash = [{k: sum(h["launches"][k] for h in rank) for k in FLASH_NAMES} for rank in ranks]
    print(f"[dp] train --num-processes 2: flash launches per rank {flash}, step walls "
          f"{[[round(h['wall_s'] * 1e3, 1) for h in rank] for rank in ranks]} ms", flush=True)
    if flash[0] != flash[1] or not all(n > 0 for n in flash[0].values()):
        fail(f"train --num-processes 2: flash launches per rank {flash}")


def _dp_decode(multiproc, tmp, env):
    multiproc.spawn(2, "chip_smoke", ["--dp-worker", "decode", str(tmp)], env=env,
                    timeout_s=300)
    for r in range(2):
        for row in json.loads((tmp / f"decode.rank{r}.json").read_text()):
            tol = DP_DECODE_TOL[row["dtype"]]
            print(f"[dp] sharded decode {json.dumps(row)} (limit {tol})", flush=True)
            if not (row["finite"] and row["rel_err"] <= tol and row["launches"] == 1):
                fail(f"sharded decode on rank {r}: {row}")
            if row["case"] == "half-empty" and r == 1 and row["live_slots"] != 0:
                fail(f"sharded decode: rank 1 holds {row['live_slots']} live slots, not 0")


def phase_data_parallel(torch):
    """The data-parallel path on 2 gloo ranks sharing the card (phase 6b)."""
    import tempfile

    from repro_torch.core import comm_model
    from repro_torch.launch import multiproc

    t0 = time.perf_counter()
    env = _dp_env()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        recs = _dp_fig5(multiproc, tmp, env)
        _dp_gates(comm_model, recs)
        _dp_cli(tmp, env)
        _dp_decode(multiproc, tmp, env)
    print(f"[dp] phase wall {time.perf_counter() - t0:.1f} s ({card_line()})", flush=True)


# ------------------------------------------------------------ operations --
OPS_TRAIN = ["--arch", QWEN, "--full", "--flash-attention", "--solver", "gn_cg",
             "--krylov-backend", "flat", "--batch-size", "8", "--seq-len", "512",
             "--hvp-batch-frac", "0.25", "--max-cg-iters", "8"]
# The chaos runs: the reference's chaos arguments (benchmarks/chaos_check.py
# BASE_ARGS) on the smoke Qwen1.5-0.5B, gn_cg through the flat and flash
# kernels, 2 gloo ranks on the card.
OPS_CHAOS = ["--arch", QWEN, "--smoke", "--batch-size", "4", "--seq-len", "16",
             "--max-cg-iters", "4", "--solver", "gn_cg", "--krylov-backend", "flat",
             "--flash-attention", "--steps", "4", "--num-processes", "2"]
GN_PHASES = ["grad_build", "curvature_primal", "krylov_solve", "line_search", "update_damping"]
OPS_KERNELS = ("dot2", "residual_dots") + FLASH_NAMES   # gn_cg: CG launches no x_update
OPS_HANG_TIMEOUT = 300


def _ops_run(cmd, env, timeout, what):
    """One train CLI run; returns (completed process, wall seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *cmd],
                         capture_output=True, text=True, timeout=timeout, env=env)
    wall = time.perf_counter() - t0
    print(f"[ops] {what}: exit {res.returncode} in {wall:.1f} s", flush=True)
    if res.returncode != 0:
        fail(f"{what}: exit {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res, wall


def _ops_launches(hist):
    return {k: sum(h["launches"][k] for h in hist) for k in OPS_KERNELS}


def _ops_telemetry_gates(trace, tel, hist, phases):
    """Run 1's telemetry: the reference's phase order a step, every marker
    inside its step's host_step span (1 ms for clock alignment), one solve
    event a step equal to its metrics, and the merged trace.json."""
    evs = trace.load_events(str(tel))
    hosts = {e["step"]: e for e in evs if e["ev"] == "span" and e["name"] == "host_step"}
    for h in hist:
        i = h["step"]
        spans = [sp for sp in trace.phase_spans(evs) if sp["step"] == i]
        names = [sp["name"] for sp in spans]
        marks = [e for e in evs if e["ev"] == "phase" and e["step"] == i]
        host = hosts.get(i)
        outside = [e for e in marks if host is None
                   or not host["t0"] - 1e-3 <= e["ts"] <= host["t1"] + 1e-3]
        solves = [e for e in evs if e["ev"] == "solve" and e["step"] == i]
        print(f"[ops] step {i} phases (device-timed): "
              + ", ".join(f"{sp['name']} {1e3 * (sp['t1'] - sp['t0']):.2f} ms" for sp in spans)
              + f"; host_step {1e3 * (host['t1'] - host['t0']):.2f} ms; solve "
              f"{[(e['iters'], e['syncs']) for e in solves]}", flush=True)
        if names != phases:
            fail(f"step {i}: phases {names}, the reference's order is {phases}")
        if outside:
            fail(f"step {i}: markers outside host_step {host}: {outside}")
        if len(solves) != 1 or (solves[0]["iters"], solves[0]["syncs"]) != (
                int(h["cg_iters"]), int(h["krylov_syncs"])):
            fail(f"step {i}: solve events {solves} against cg_iters {h['cg_iters']}, "
                 f"krylov_syncs {h['krylov_syncs']}")
    compile_spans = [e for e in evs if e["ev"] == "span" and e["name"] == "compile"]
    if len(compile_spans) != 1 or not (tel / "trace.json").exists():
        fail(f"compile spans {compile_spans}; trace.json written: {(tel / 'trace.json').exists()}")


def _ops_resume(tmp, env):
    """Part (a): full-width gn_cg, a checkpoint a step, the newest one
    corrupted; a fresh process resumes from the one before and replays its
    step to the same loss."""
    from repro_torch.checkpoint import (CheckpointCorruptError, latest_step, latest_valid_step,
                                        verify_checkpoint)
    from repro_torch.obs import trace

    ck, tel, h1, h2 = tmp / "ckpt", tmp / "tel", tmp / "run1.json", tmp / "run2.json"
    _ops_run(OPS_TRAIN + ["--steps", "2", "--ckpt-dir", str(ck), "--ckpt-every", "1",
                          "--telemetry-dir", str(tel), "--history-out", str(h1)],
             dict(env, REPRO_TORCH_FAULTS="corrupt_ckpt@step=2"), 900,
             "run 1 (2 steps, a checkpoint a step, corrupt_ckpt@step=2)")
    run1 = json.loads(h1.read_text())
    newest, valid = latest_step(str(ck)), latest_valid_step(str(ck))
    try:
        verify_checkpoint(str(ck / f"ckpt_{newest:08d}.npz"))
        fail(f"the corrupted checkpoint of step {newest} verified")
    except CheckpointCorruptError as e:
        print(f"[ops] newest checkpoint (step {newest}) refused: {str(e)[-120:]}", flush=True)
    if valid != 1:
        fail(f"latest_valid_step {valid}, expected 1")
    path = ck / f"ckpt_{valid:08d}.npz"
    t0 = time.perf_counter()
    manifest = verify_checkpoint(str(path))
    verify_s = time.perf_counter() - t0
    _ops_run(OPS_TRAIN + ["--steps", "2", "--ckpt-dir", str(ck), "--history-out", str(h2)],
             env, 900, "run 2 (a fresh process, resume)")
    run2 = json.loads(h2.read_text())
    if [h["step"] for h in run2] != [1]:
        fail(f"run 2 ran steps {[h['step'] for h in run2]}, expected [1]")
    a, b = run1[1]["loss"], run2[0]["loss"]
    saves = [round(h["ckpt_save_s"], 3) for h in run1]
    print(f"[ops] checkpoint {path.stat().st_size} bytes ({len(manifest['checksums'])} arrays); "
          f"save {saves} s, verify {verify_s:.3f} s, restore {run2[0]['restore_s']:.3f} s; "
          f"kernel build before the first step {run1[0]['compile_s']:.2f} s; step walls run 1 "
          f"{[round(h['wall_s'], 3) for h in run1]} s, run 2 {run2[0]['wall_s']:.3f} s; "
          f"replayed step 1 loss {b!r} against {a!r}, |diff| {abs(a - b):.3e} (limit 1e-6)",
          flush=True)
    print(f"[ops] launches run 1 {_ops_launches(run1)}, run 2 {_ops_launches(run2)}", flush=True)
    if not all(n > 0 for n in _ops_launches(run1).values()):
        fail(f"run 1 did not launch every kernel of its path: {_ops_launches(run1)}")
    if not abs(a - b) <= 1e-6:
        fail(f"the replayed step 1 loss {b} differs from run 1's {a}")
    _ops_telemetry_gates(trace, tel, run1, GN_PHASES)


def _ops_chaos(tmp, env, fault, extra, what, baseline):
    """Parts (c) and (d): the 2-rank chaos run through the train CLI under
    the supervisor; returns the restarts and the supervisor's log."""
    from repro_torch.obs import trace

    tel, hist = tmp / f"{what}_tel", tmp / f"{what}.json"
    res, wall = _ops_run(OPS_CHAOS + ["--ckpt-dir", str(tmp / f"{what}_ckpt"),
                                      "--ckpt-every", "1", "--telemetry-dir", str(tel),
                                      "--history-out", str(hist), *extra],
                         dict(env, REPRO_TORCH_FAULTS=fault), 600, f"{what}: {fault}")
    m = re.search(r"run completed after (\d+) restart", res.stderr)
    restarts = int(m.group(1)) if m else -1
    failures = [ln for ln in res.stderr.splitlines() if "failed:" in ln]
    resumed = {h["step"]: h for h in json.loads(hist.read_text())}
    deltas = {i: abs(baseline[i]["loss"] - h["loss"]) for i, h in resumed.items()}
    evs = trace.load_events(str(tel))
    faults = trace.fault_events(evs)
    injected = [e for e in faults if e.get("injected")]
    restart_meta = [e for e in evs if e["ev"] == "meta" and e.get("attempt") == 1]
    t_fault = injected[0]["ts"] if injected else float("nan")
    to_restart = min(e["ts"] for e in restart_meta) - t_fault if restart_meta else float("inf")
    signals = [e["ts"] - t_fault for e in faults if e["kind"] == "signal"]
    print(f"[ops] {what}: restarts {restarts}; supervisor {failures}; resumed steps "
          f"{sorted(resumed)} losses {[resumed[i]['loss'] for i in sorted(resumed)]} against "
          f"the baseline's {[baseline[i]['loss'] for i in sorted(resumed)]}, max |diff| "
          f"{max(deltas.values()) if deltas else float('nan'):.3e}; injected "
          f"{[(e['kind'], e['step'], e['proc']) for e in injected]}; teardown signals "
          f"{[round(t, 2) for t in signals]} s after the fault; the restarted attempt's sinks "
          f"{to_restart:.2f} s after it; launches {_ops_launches(resumed.values())}", flush=True)
    if restarts < 1:
        fail(f"{what}: no restart ({res.stderr[-2000:]})")
    if not all(n > 0 for n in _ops_launches(resumed.values()).values()):
        fail(f"{what}: the resumed steps did not launch every kernel of their path")
    if not resumed or min(resumed) > 2 or max(resumed) != 3:
        fail(f"{what}: resumed steps {sorted(resumed)}")
    if not max(deltas.values()) <= 1e-6:
        fail(f"{what}: resumed losses differ from the baseline by {deltas}")
    if not injected or injected[0]["step"] != 2:
        fail(f"{what}: the injected fault is not in the telemetry at step 2: {faults}")
    return restarts, failures, to_restart


def _ops_ritz(torch, ops, tmp):
    """Part (b), second half: one TIMIT s-step gn_cg step (s 4, newton,
    λ₀ 0.01, as phase 4) with a sink: one Ritz event per executed cycle."""
    from repro_torch.configs.paper_mlp import TIMIT_FIG5
    from repro_torch.core.hf import HFConfig, hf_init, hf_step
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models.mlp import build_mlp
    from repro_torch.obs import telemetry, trace

    model = build_mlp(TIMIT_FIG5)
    params = _timit_start(torch, model)
    batch = classification_dataset(torch.Generator().manual_seed(1), 4096, TIMIT_FIG5[0],
                                   TIMIT_FIG5[-1])
    hvp_batch = {k: v[:1024] for k, v in batch.items()}
    cfg = HFConfig(solver="gn_cg", krylov_backend="flat", max_cg_iters=SSTEP_K, cg_tol=0.0,
                   sstep_s=4, sstep_basis="newton", init_damping=SSTEP_LAM)
    d = tmp / "ritz"
    sink = telemetry.Telemetry(str(d))
    ops.reset_launches()
    with telemetry.install(sink):
        _, _, m = hf_step(model.loss_fn, params, hf_init(params, cfg), batch, hvp_batch, cfg,
                          model_out_fn=model.logits_fn, out_loss_fn=model.out_loss_fn)
        torch.cuda.synchronize()
    sink.close()
    cycles = ops.LAUNCHES["dots_block"]
    ritz = [e for e in trace.load_events(str(d)) if e["ev"] == "ritz"]
    print(f"[ops] TIMIT gn_cg s=4 newton λ0={SSTEP_LAM} with a sink: cg_iters "
          f"{int(m['cg_iters'])}, krylov_syncs {int(m['krylov_syncs'])}, executed cycles (Gram "
          f"launches) {cycles}, ritz events {len(ritz)}, sstep_fallback "
          f"{bool(m['sstep_fallback'])}; first Ritz values "
          f"{ritz[0]['values'] if ritz else None}", flush=True)
    if len(ritz) != cycles or cycles == 0 or not all(e["basis"] == "newton" for e in ritz):
        fail(f"{len(ritz)} ritz events for {cycles} executed cycles")


class _SinkClock:
    """Host seconds spent inside the telemetry code while it is active: the
    step's hooks (``_record``, ``anchor``), ``flush`` and every ``emit``
    (the outermost call of each nest counted once in ``total``). A
    measuring harness: it wraps the functions and restores them."""

    def __init__(self):
        from repro_torch.obs import telemetry

        self.tel = telemetry
        self.spent = {"hooks": 0.0, "flush": 0.0, "emit": 0.0, "total": 0.0}
        self._depth = 0
        self._real = {"_record": telemetry._record, "anchor": telemetry.anchor,
                      "flush": telemetry.flush}
        self._real_emit = telemetry.Telemetry.emit

    def _wrap(self, key, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            self._depth += 1
            try:
                return fn(*a, **k)
            finally:
                self._depth -= 1
                dt = time.perf_counter() - t0
                self.spent[key] += dt
                if self._depth == 0:
                    self.spent["total"] += dt
        return timed

    def __enter__(self):
        for name, key in (("_record", "hooks"), ("anchor", "hooks"), ("flush", "flush")):
            setattr(self.tel, name, self._wrap(key, self._real[name]))
        self.tel.Telemetry.emit = self._wrap("emit", self._real_emit)
        return self.spent

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(self.tel, name, fn)
        self.tel.Telemetry.emit = self._real_emit
        return False


def phase_operations_sink(torch, ops, params, state):
    """Operations, part (b): from one full-width state, gn_cg steps without
    a telemetry sink and with it, alternated twice, give the same loss bits,
    parameters and launches; the walls' difference is what the sink
    costs."""
    import tempfile

    from repro_torch.launch.train import train
    from torch.utils._pytree import tree_leaves

    print(f"[ops] {card_line()}", flush=True)
    log = lambda line: None  # noqa: E731
    runs = {False: [], True: []}
    for sink in (False, True, False, True):   # alternated: the first call warms up
        with tempfile.TemporaryDirectory() as td, _SinkClock() as spent:
            p, _, (h,) = train(QWEN, solver="gn_cg", steps=3, start=2, params=params,
                               state=state, telemetry_dir=td if sink else None, log_fn=log,
                               **SLICE_KW)
            if sink:
                h["events"] = sum(1 for _ in open(Path(td) / "events-p0.jsonl"))
        h["sink_s"] = dict(spent)
        runs[sink].append((p, h))
    ref_p, ref = runs[False][0]
    for sink, (p, h) in [(s_, r) for s_ in (False, True) for r in runs[s_]]:
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(ref_p), tree_leaves(p)))
        if (h["loss"], h["loss_new"]) != (ref["loss"], ref["loss_new"]) or not same:
            fail(f"a gn_cg step {'with' if sink else 'without'} a telemetry sink differs: "
                 f"loss {h['loss']!r} -> {h['loss_new']!r} against {ref['loss']!r} -> "
                 f"{ref['loss_new']!r}, parameters equal {same}")
        if h["launches"] != ref["launches"]:
            fail(f"launches {h['launches']} against {ref['launches']}")
    walls = {k: [h["wall_s"] for _, h in v] for k, v in runs.items()}
    print(f"[ops] full-width gn_cg step from one state, alternating without / with a sink: "
          f"walls without {[round(w, 4) for w in walls[False]]} s, with "
          f"{[round(w, 4) for w in walls[True]]} s (second pair's difference "
          f"{1e3 * (walls[True][1] - walls[False][1]):.2f} ms); the same loss bits "
          f"{ref['loss']!r} -> {ref['loss_new']!r}, parameters and launches {ref['launches']}; "
          f"{runs[True][0][1]['events']} events a step", flush=True)
    for sink, pairs in runs.items():
        print(f"[ops] host time inside the telemetry code a step {'with' if sink else 'without'}"
              f" a sink (the train loop's sink set-up, hooks, flush, emits): "
              + "; ".join(", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in h["sink_s"].items())
                          for _, h in pairs), flush=True)
    if any(v != 0.0 for _, h in runs[False] for v in h["sink_s"].values()):
        fail("the telemetry code ran in a step without a sink")


def phase_operations(torch, ops):
    """Operations, parts (a), (b: Ritz events), (c) and (d)."""
    import tempfile

    t0 = time.perf_counter()
    print(f"[ops] {card_line()}", flush=True)
    env = _dp_env()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        _ops_ritz(torch, ops, tmp)
        _ops_resume(tmp, env)
        base = tmp / "base.json"
        _ops_run(OPS_CHAOS + ["--history-out", str(base)], env, 600,
                 "chaos baseline (2 ranks, 4 steps, unsupervised)")
        baseline = {h["step"]: h for h in json.loads(base.read_text())}
        print(f"[ops] baseline losses {[baseline[i]['loss'] for i in sorted(baseline)]}",
              flush=True)
        _ops_chaos(tmp, env, "kill@step=2,proc=1",
                   ["--max-restarts", "2", "--hang-timeout", str(OPS_HANG_TIMEOUT)], "kill",
                   baseline)
        _, failures, to_restart = _ops_chaos(
            tmp, env, "hang@step=2,proc=1,secs=600",
            ["--watchdog-s", "5", "--max-restarts", "1", "--hang-timeout",
             str(OPS_HANG_TIMEOUT)], "watchdog", baseline)
        if not any("process 0: exit 87" in ln for ln in failures):
            fail(f"watchdog: rank 0 did not exit with 87: {failures}")
        if not to_restart < OPS_HANG_TIMEOUT / 5:
            fail(f"watchdog: the restart came {to_restart:.1f} s after the hang")
    print(f"[ops] phase wall {time.perf_counter() - t0:.1f} s ({card_line()})", flush=True)


def main() -> None:
    t_start = time.perf_counter()
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
    ptxas = start_ptxas()
    cg_fused.extension()
    print(f"[build] cg_fused ({', '.join(s.name for s in cg_fused.SOURCES)}) in "
          f"{cg_fused.build_seconds:.1f} s", flush=True)
    print_ptxas(ptxas)
    print(f"[card] {card}", flush=True)

    records = phase_kernels(torch, cg_fused, ref)
    phase_krylov_large(torch, cg_fused, ref)
    records["dots_block"] = phase_gram(torch, cg_fused, ref)
    records.update(phase_flash(torch))
    model, params, state, batch, hvp_batch, launches = phase_slice(torch, ops)
    launches["dots_block"] = phase_sstep(torch, ops, model, batch, hvp_batch)["dots_block"]
    phase_checks(torch, model, params, state, batch, hvp_batch)
    phase_profile(torch, model, params, state, batch, hvp_batch)
    phase_profile_sstep(torch, model, batch, hvp_batch)
    phase_data_parallel(torch)
    del model, params, state, batch, hvp_batch
    qparams, qstate, t_launches = phase_transformer(torch, ops)
    launches.update({name: t_launches[name] for name in FLASH_NAMES})
    phase_transformer_profile(torch, qparams, qstate)
    phase_operations_sink(torch, ops, qparams, qstate)
    del qparams, qstate
    torch.cuda.empty_cache()
    phase_operations(torch, ops)
    phase_transformer_checks(torch)
    torch.cuda.empty_cache()
    records.update(phase_decode(torch))
    sparams, prompts, s_launches = phase_serve(torch, ops)
    launches.update(s_launches)
    phase_serve_fullwidth(torch, sparams, prompts)
    del sparams, prompts
    torch.cuda.empty_cache()
    phase_serve_checks(torch)
    torch.cuda.empty_cache()
    print(f"[card] {card_line()}", flush=True)
    records["ssd_intra"] = phase_ssd(torch)
    phase_heads(torch)
    torch.cuda.empty_cache()
    zparams, zprompts, z_launches = phase_hybrid_serve(torch, ops)
    launches.update(z_launches)
    torch.cuda.empty_cache()
    phase_hybrid_check(torch, zparams, zprompts)
    del zparams, zprompts
    torch.cuda.empty_cache()

    replaces = {
        "dot2": "cg_fused.py:146", "x_update": "cg_fused.py:42",
        "residual_dots": "cg_fused.py:71", "dots_block": "cg_fused.py:114",
        "flash_attention_fwd": "flash_attention.py:310",
        "flash_attention_dq": "flash_attention.py:363",
        "flash_attention_dkv": "flash_attention.py:397",
        "flash_attention_jvp": "flash_attention.py:443",
        "flash_decode": "flash_decode.py:209", "flash_decode_paged": "flash_decode.py:271",
        "ssd_intra": "ssd_scan.py:56",
    }
    source = lambda name: ("flash_attention.cu" if name in FLASH_NAMES else
                           "flash_decode.cu" if name in DECODE_NAMES else
                           "ssd_scan.cu" if name == "ssd_intra" else "cg_fused.cu")
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source(name)}",
        "replaces": f"src/repro/kernels/{replaces[name]}",
        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
    } for name, rec in records.items()]
    print(f"[time] chip_smoke.py wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_decode_worker(sys.argv[3])
    else:
        main()
