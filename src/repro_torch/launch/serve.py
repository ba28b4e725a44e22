"""Serving entry points, single process (twin of ``repro/launch/serve.py``).

``serve`` prefills a batch of prompts together and greedy-decodes them in
lockstep (batch-at-once) over the dense rolling cache; the decode steps
write the cache in place and the tokens land in a (B, gen_len) host buffer,
one device-to-host copy of the token column per step.

``serve`` takes the zamba2 hybrid too; ``serve_continuous`` takes the
dense decoders only and raises ``ValueError`` for the hybrid, as the
reference does.

``serve_continuous`` is the slot scheduler over the paged KV cache
(``models/kv_paged.py``): requests arrive on a step clock, are admitted into
free slots as pages allow (``prefill_paged`` writes their pages), every live
slot advances in one decode step (occupancy mask, per-slot ``seq_len``), and
finished sequences retire through ``release_slots``, so short requests
never wait on long ones and the pool holds about the live tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --flash-attention [--continuous] [--full] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --flash-attention [--full] [--device cpu]

The run is on the card unless ``--device cpu`` is given; ``--flash-attention``
routes prefill and decode through the flash-attention and flash-decode
kernels (their plain versions on the CPU), as the reference's
``cfg.use_flash_attention`` does, and the hybrid's Mamba prefill through
the SSD intra-chunk kernel (``ops.ssd_chunked_pallas``, the reference's
drop-in for ``ssd_chunked``). ``--telemetry-dir D`` writes
``D/events-p0.jsonl`` and the merged ``D/trace.json``
(``obs.telemetry``): ``serve`` emits ``prefill`` and ``decode`` spans and a
``tok_per_s`` counter; ``serve_continuous`` emits ``queue_depth`` and
``pages_free`` counters on every scheduler tick and one ``request`` span per
finished request, with its ``ttft_s`` and ``n_tok``. Read it with
``python -m repro_torch.obs.report D``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import ARCH_IDS, UNPORTED_ARCH_IDS, get_config, get_smoke_config
from ..data.synthetic import lm_batch
from ..models.kv_paged import check_invariants, pages_needed, release_slots
from ..models.transformer import build_model
from ..obs import telemetry as telemetry_mod
from ..obs import trace as trace_mod


def _setup(arch, smoke, use_flash_attention, device, params):
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if use_flash_attention:
        cfg = cfg.replace(use_flash_attention=True)
    model = build_model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    return dev, cfg, model, params


def _prompts(cfg, n, prompt_len, dev, prompts):
    """``prompts`` (a list of (1, prompt_len) token arrays or tensors) on
    ``dev``, or by default the rows of one ``lm_batch`` draw from seed 1."""
    if prompts is None:
        batch = lm_batch(torch.Generator().manual_seed(1), cfg, n, prompt_len + 1, device=dev)
        return [batch["tokens"][r:r + 1, :prompt_len] for r in range(n)]
    return [(p if isinstance(p, torch.Tensor) else torch.from_numpy(np.array(p)))
            .to(device=dev, dtype=torch.long) for p in prompts]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def serve(arch: str, *, smoke=True, batch_size=4, prompt_len=16, gen_len=16,
          use_flash_attention=False, device="cuda", params=None, prompts=None,
          telemetry=None, log_fn=print):
    """Batch-at-once greedy decode. Returns (tokens (B, gen_len) int32 host
    array, stats with prefill_s, decode_s, n_tok, tok_per_s and
    tok_per_s_decode). Parameters come from ``init`` with generator seed 0
    unless ``params`` is given, prompts from ``lm_batch`` with seed 1 unless
    ``prompts`` is. With a ``obs.telemetry.Telemetry`` sink the two phases
    are also emitted as spans and tok/s as a counter."""
    dev, cfg, model, params = _setup(arch, smoke, use_flash_attention, device, params)
    prompt = {"tokens": torch.cat(_prompts(cfg, batch_size, prompt_len, dev, prompts))}
    max_len = prompt_len + gen_len

    out = np.zeros((batch_size, gen_len), np.int32)
    _sync(dev)
    w_start = time.time()
    t_start = time.perf_counter()
    logits, cache = model.prefill(params, prompt, max_len)
    tok = logits[:, -1:].argmax(dim=-1)
    out[:, 0] = tok[:, 0].cpu().numpy()
    t_mid = time.perf_counter()
    w_mid = time.time()
    t_prefill = t_mid - t_start

    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, tok, prompt_len + i, cache)
        tok = logits.argmax(dim=-1)
        out[:, i + 1] = tok[:, 0].cpu().numpy()
    t_decode = time.perf_counter() - t_mid
    n_tok = batch_size * gen_len            # every generated token counts
    stats = {"prefill_s": t_prefill, "decode_s": t_decode, "n_tok": n_tok,
             "tok_per_s": n_tok / max(t_prefill + t_decode, 1e-9),
             "tok_per_s_decode": batch_size * (gen_len - 1) / max(t_decode, 1e-9)}
    if telemetry is not None:
        telemetry.emit({"ev": "span", "name": "prefill", "t0": w_start, "t1": w_mid,
                        "batch": batch_size, "prompt_len": prompt_len})
        telemetry.emit({"ev": "span", "name": "decode", "t0": w_mid, "t1": time.time(),
                        "batch": batch_size, "gen_len": gen_len})
        telemetry.counter("tok_per_s", stats["tok_per_s"])
    log_fn(f"prefill {prompt_len} toks x{batch_size}: {t_prefill:.3f}s; "
           f"decode {gen_len - 1} steps: {t_decode:.3f}s "
           f"({stats['tok_per_s']:.1f} tok/s end-to-end, "
           f"{stats['tok_per_s_decode']:.1f} tok/s decode)")
    return out, stats


@torch.no_grad()
def serve_continuous(arch: str, *, smoke=True, batch_size=4, n_requests=8, prompt_len=16,
                     gen_len=16, arrival_steps=None, gen_lens=None, prompts=None, page_size=8,
                     n_pages=None, use_flash_attention=False, device="cuda",
                     params=None, telemetry=None, log_fn=print):
    """Continuous batching over the paged cache.

    ``arrival_steps``: the decode step from which each request may be
    admitted (default 0 for all); ``gen_lens``: per-request generation
    lengths (default ``gen_len`` each); ``prompts``: (1, prompt_len) token
    arrays (default the rows of one ``lm_batch`` draw from seed 1). The
    reference's ``gang`` baseline of its decode benchmark is not ported.
    Returns (tokens (n_requests, gen_len)
    int32 host array, rows past a request's own length zero, stats). The
    stats hold the reference's wall_s, steps, n_tok, tok_per_s,
    tok_per_step, n_pages and page_size, and the decode steps run
    (``decode_steps``), each request's time to first token (``ttft_s``, its
    admission to its prefill's token on the host) and the pages free at the
    end (``pages_free``), after ``check_invariants`` held on the final
    pool."""
    dev, cfg, model, params = _setup(arch, smoke, use_flash_attention, device, params)
    if model.decode_step_paged is None:
        raise ValueError(f"{arch}: continuous batching needs a plain decoder stack "
                         "(dense/moe family)")
    prompts = _prompts(cfg, n_requests, prompt_len, dev, prompts)
    if arrival_steps is None:
        arrival_steps = [0] * n_requests
    if gen_lens is None:
        gen_lens = [gen_len] * n_requests
    assert max(gen_lens) <= gen_len, (gen_lens, gen_len)
    max_len = prompt_len + gen_len
    if n_pages is None:
        # live pages per slot + one step of slack, + the null page
        n_pages = 1 + batch_size * (pages_needed(max_len, page_size, cfg.sliding_window) + 1)
    B = batch_size
    cache = model.init_cache_paged(B, max_len, n_pages, page_size)
    need_pages = pages_needed(prompt_len, page_size, cfg.sliding_window)

    out = np.zeros((n_requests, gen_len), np.int32)
    slot_req = [-1] * B                     # request per slot (-1 free)
    n_gen = [0] * B
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    next_req, done, step, decode_steps = 0, 0, 0, 0
    ttft = [None] * n_requests
    req_t0 = [None] * n_requests            # admission, on the wall clock
    _sync(dev)
    t0 = time.perf_counter()
    while done < n_requests:
        # admit arrived requests into free slots while pages last
        for b in range(B):
            if slot_req[b] >= 0 or next_req >= n_requests:
                continue
            if arrival_steps[next_req] > step:
                break                       # in-order admission
            if int(cache.n_free) < need_pages + 1:
                break                       # backpressure: wait for frees
            t_admit = time.perf_counter()
            req_t0[next_req] = time.time()
            logits, cache = model.prefill_paged(params, {"tokens": prompts[next_req]}, cache, b)
            t0k = logits[0, -1].argmax()
            tok[b, 0] = t0k
            slot_req[b], n_gen[b] = next_req, 1
            out[next_req, 0] = int(t0k)     # host read: the first token is real
            ttft[next_req] = time.perf_counter() - t_admit
            next_req += 1
        if telemetry is not None:
            queued = sum(1 for r in range(next_req, n_requests) if arrival_steps[r] <= step)
            telemetry.counter("queue_depth", queued)
            telemetry.counter("pages_free", int(cache.n_free))
        active_h = [s >= 0 for s in slot_req]
        if not any(active_h):
            step += 1                       # idle: nothing arrived yet
            continue
        logits, cache = model.decode_step_paged(params, tok, cache,
                                                torch.tensor(active_h, device=dev))
        tok = logits.argmax(dim=-1)
        toks = tok[:, 0].cpu().numpy()
        decode_steps += 1
        retire = []
        for b in range(B):
            if slot_req[b] < 0:
                continue
            out[slot_req[b], n_gen[b]] = toks[b]
            n_gen[b] += 1
            if n_gen[b] == gen_lens[slot_req[b]]:   # finished: free the slot and pages
                rid = slot_req[b]
                if telemetry is not None:
                    telemetry.emit({"ev": "span", "name": "request", "req": rid, "slot": b,
                                    "t0": req_t0[rid], "t1": time.time(),
                                    "ttft_s": ttft[rid], "n_tok": gen_lens[rid]})
                retire.append(b)
                done += 1
                slot_req[b] = -1
        if retire:
            mask = torch.zeros((B,), dtype=torch.bool)
            mask[retire] = True
            cache = release_slots(cache, mask.to(dev))
        step += 1
    _sync(dev)
    wall = time.perf_counter() - t0
    check_invariants(cache)
    n_tok = sum(gen_lens)
    stats = {"wall_s": wall, "steps": step, "n_tok": n_tok,
             "tok_per_s": n_tok / max(wall, 1e-9), "tok_per_step": n_tok / max(step, 1),
             "n_pages": n_pages, "page_size": page_size, "decode_steps": decode_steps,
             "ttft_s": ttft, "pages_free": int(cache.n_free)}
    log_fn(f"continuous: {n_requests} reqs x {gen_len} toks on {B} slots, "
           f"{step} steps, {wall:.3f}s ({stats['tok_per_s']:.1f} tok/s)")
    return out, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCH_IDS + UNPORTED_ARCH_IDS), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-scheduled continuous batching (paged cache)")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--flash-attention", action="store_true",
                    help="route attention through the flash-attention and flash-decode "
                         "kernels and the hybrid's Mamba prefill through the SSD kernel "
                         "(their plain versions on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--telemetry-dir", default=None,
                    help="write serving telemetry (request spans with TTFT, queue-depth and "
                         "page-pool counters) as events-p0.jsonl and the merged trace.json; "
                         "read with python -m repro_torch.obs.report DIR")
    args = ap.parse_args(argv)
    sink = None
    if args.telemetry_dir:
        sink = telemetry_mod.Telemetry(
            args.telemetry_dir, meta=dict(kind="serve", arch=args.arch,
                                          continuous=args.continuous))
    kw = dict(smoke=args.smoke, batch_size=args.batch_size, prompt_len=args.prompt_len,
              gen_len=args.gen_len, use_flash_attention=args.flash_attention,
              device=args.device, telemetry=sink)
    if args.continuous:
        gen = serve_continuous(args.arch, n_requests=args.n_requests, **kw)[0]
    else:
        gen = serve(args.arch, **kw)[0]
    if sink is not None:
        sink.close()
        trace_mod.merge_dir(args.telemetry_dir)
    print("generated token ids (first row):", gen[0].tolist())


if __name__ == "__main__":
    main()
