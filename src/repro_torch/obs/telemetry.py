"""Per-process structured telemetry sink and the step's instrumentation
hooks (twin of ``repro/obs/telemetry.py``).

Two halves:

  * **Host side** — :class:`Telemetry` appends JSON events to
    ``events-p{N}.jsonl`` (one object per line) and offers a wall-clock
    ``span`` context manager plus instant/counter emitters for host code
    (train loop, serve scheduler). The same schema as the reference's.

  * **Step side** — module-level state, as ``core.collectives``'
    ``count_executed``: while a sink is installed (:func:`install`), the
    optimizer step's hooks record phase end-markers (:func:`marker`),
    Krylov solve summaries (:func:`solve_event`), divergence-sentinel
    rejections (:func:`reject_event`) and per-cycle Ritz snapshots
    (:func:`ritz_event`); ``core.collectives`` stamps each all-reduce's
    begin and end. With no sink installed every hook returns before it
    touches torch: no CUDA event is recorded, nothing is read back from the
    device, and the step's launches and outputs are those of the program
    without hooks.

Timing on an eager program. The reference stamps a marker from a debug
callback that depends on the phase's outputs. Here the step runs eagerly
and the host runs ahead of the card, so a host clock at the hook would
time the launch, not the work. On the card a marker therefore records a
``torch.cuda.Event(enable_timing=True)`` on the current stream after the
phase's work has been queued: it completes when the phase's kernels do.
The records wait, with every device scalar a hook was handed (solve
iterations, residuals, Ritz values), in a list until :func:`flush`, which
the train loop calls after the synchronize it already does after each
step: nothing adds a sync. Each event is placed on the host clock as
anchor wall + ``anchor.elapsed_time(event)``, where the anchor
(:func:`anchor`) is an event recorded right after the synchronize before
the step, beside ``time.time()``. On the CPU a marker reads ``time.time()``
itself. Every timestamp is ``time.time()`` seconds, so ``obs.trace`` puts
host spans, markers and collectives on one timeline.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

__all__ = [
    "Telemetry", "install", "active", "collective_label",
    "current_collective_label", "step_scope", "marker", "solve_event",
    "ritz_event", "reject_event", "register_crash_flush", "anchor", "flush",
]


class Telemetry:
    """Append-only JSONL event sink for one process.

    Thread-safe: collective completions land on gloo's threads while the
    host loop emits spans. Events are flushed line by line so a crashed or
    killed process still leaves a parseable file.
    """

    def __init__(self, out_dir: str, process_index: int = 0,
                 meta: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.process_index = process_index
        self.path = os.path.join(out_dir, f"events-p{process_index}.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a", buffering=1)
        # Pending collective begins, FIFO per (tag, label); a leftover begin
        # (a process killed mid-step) is dropped at close().
        self._pending: dict = {}
        self.emit({"ev": "meta", "process": process_index,
                   "ts": time.time(), **(meta or {})})

    # -- raw emission ----------------------------------------------------
    def emit(self, event: dict) -> None:
        line = json.dumps(event, separators=(",", ":"), default=float)
        with self._lock:
            self._f.write(line + "\n")

    # -- host-side API ---------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **fields):
        t0 = time.time()
        try:
            yield
        finally:
            t1 = time.time()
            self.emit({"ev": "span", "name": name, "t0": t0, "t1": t1, **fields})

    def instant(self, name: str, **fields) -> None:
        self.emit({"ev": "instant", "name": name, "ts": time.time(), **fields})

    def counter(self, name: str, value, ts: Optional[float] = None) -> None:
        self.emit({"ev": "counter", "name": name, "value": float(value),
                   "ts": time.time() if ts is None else ts})

    def log(self, msg: str) -> None:
        self.emit({"ev": "log", "msg": str(msg), "ts": time.time()})

    # -- step-side receivers -----------------------------------------------
    def phase_event(self, name: str, step: int, ts: Optional[float] = None) -> None:
        self.emit({"ev": "phase", "name": name, "step": int(step),
                   "ts": time.time() if ts is None else ts})

    def collective_begin(self, tag: str, label: str) -> None:
        key = (tag, label)
        with self._lock:
            self._pending.setdefault(key, deque()).append(time.time())

    def collective_end(self, tag: str, label: str) -> None:
        t1 = time.time()
        key = (tag, label)
        with self._lock:
            q = self._pending.get(key)
            t0 = q.popleft() if q else t1
        self.emit({"ev": "coll", "tag": tag, "label": label, "t0": t0, "t1": t1})

    def solve_event(self, step: int, ts: Optional[float] = None, **fields) -> None:
        self.emit({"ev": "solve", "step": int(step),
                   "ts": time.time() if ts is None else ts, **fields})

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- step-side state -------------------------------------------------------
_active: Optional[Telemetry] = None
_labels: list = []        # collective_label stack
_steps: list = []         # step_scope stack (the step counter, maybe a tensor)
_records: list = []       # (kind, sink, payload, stamp) awaiting flush()
_anchors: dict = {}       # device -> (wall seconds, torch.cuda.Event)


def active() -> Optional[Telemetry]:
    """The installed sink, or None. Checked first by every hook."""
    return _active


@contextlib.contextmanager
def install(sink: Telemetry):
    """Instrument the optimizer steps run inside this context; on exit the
    records still waiting are flushed into ``sink``."""
    global _active
    prev = _active
    _active = sink
    try:
        yield sink
    finally:
        flush()
        _active = prev


@contextlib.contextmanager
def collective_label(label: str):
    """Relabel the telemetry events of ``preduce`` calls made inside this
    context (the gradient all-reduce, whose count tag stays ``grad_hvp``)."""
    _labels.append(label)
    try:
        yield
    finally:
        _labels.pop()


def current_collective_label() -> Optional[str]:
    return _labels[-1] if _labels else None


@contextlib.contextmanager
def step_scope(step):
    """Provide the outer-step index to markers emitted from code (e.g. the
    curvature engine) that has no access to ``HFState``."""
    _steps.append(step)
    try:
        yield
    finally:
        _steps.pop()


def _device_of(deps):
    """The device of the first tensor among ``deps`` (trees allowed)."""
    import torch
    from torch.utils._pytree import tree_leaves

    for d in deps:
        for leaf in (d,) if isinstance(d, torch.Tensor) else tree_leaves(d):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return torch.device("cpu")


def anchor(device) -> None:
    """Tie the card's event clock to the host's: record an event on
    ``device``'s current stream and read ``time.time()`` beside it. Call it
    right after a synchronize (the train loop does, before each step). A
    no-op on the CPU or with no sink installed."""
    if _active is None:
        return
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    _anchors[dev] = (time.time(), ev)


def _stamp(deps):
    """A timestamp for a record: ``time.time()`` on the CPU; on the card a
    timing event recorded on the current stream, resolved by :func:`flush`."""
    dev = _device_of(deps)
    if dev.type != "cuda":
        return time.time()
    import torch

    if dev not in _anchors:
        # No anchor since the last synchronize: take one now, at the cost of
        # one synchronize (the train loop anchors every step itself).
        torch.cuda.synchronize(dev)
        anchor(dev)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return (dev, ev)


def _resolve(stamp) -> float:
    if isinstance(stamp, float):
        return stamp
    dev, ev = stamp
    wall, anc = _anchors[dev]
    ev.synchronize()
    return wall + anc.elapsed_time(ev) / 1e3


def _record(kind: str, deps, payload) -> None:
    _records.append((kind, _active, payload, _stamp(deps)))


def marker(name: str, *deps, step=None) -> None:
    """Record a phase end-marker stamped when ``deps``' work has run.

    No-op when no sink is installed. The marker closes the phase named
    ``name``; ``obs.trace`` reconstructs phase spans as the interval
    between consecutive markers of one (process, step)."""
    if _active is None:
        return
    if step is None:
        step = _steps[-1] if _steps else -1
    _record("phase", deps, (name, step))


def solve_event(step, *, iters, residual, syncs, residual_history,
                nc_found, breakdown) -> None:
    """Record the per-step Krylov solve summary (iteration count, final
    residual, per-iteration residual curve); read at :func:`flush`."""
    if _active is None:
        return
    _record("solve", (residual,), (step, iters, residual, syncs, residual_history,
                                   nc_found, breakdown))


def reject_event(step, rejected, lam, f_new) -> None:
    """Divergence-sentinel hook: a ``fault`` event is emitted at
    :func:`flush` only when the step was rejected (non-finite or
    non-descending update, see ``core/hf.py``)."""
    if _active is None:
        return
    _record("reject", (lam,), (step, rejected, lam, f_new))


def ritz_event(ritz, ok, *, basis: str) -> None:
    """Per-cycle Ritz-value snapshot from the adaptive s-step Gram (the
    eigenvalues the cycle computes anyway to refresh its basis)."""
    if _active is None:
        return
    step = _steps[-1] if _steps else -1
    _record("ritz", (ritz,), (step, ritz, ok, basis))


def _int(x) -> int:
    return int(x.item()) if hasattr(x, "item") else int(x)


def _emit(kind, sink, payload, ts) -> None:
    import numpy as np

    if kind == "phase":
        name, step = payload
        sink.phase_event(name, _int(step), ts=ts)
    elif kind == "solve":
        step, it, res, sy, hist, nc, brk = payload
        h = np.asarray([] if hist is None else hist.detach().double().cpu()
                       if hasattr(hist, "detach") else hist, dtype=np.float64).ravel()
        h = h[np.isfinite(h)]
        sink.solve_event(
            _int(step), ts=ts, iters=_int(it), residual=float(res), syncs=_int(sy),
            residual_history=[round(float(v), 8) for v in h],
            nc_found=bool(nc), breakdown=bool(brk))
    elif kind == "reject":
        step, rej, lam, f = payload
        if bool(rej):
            sink.emit({"ev": "fault", "kind": "step_reject", "step": _int(step),
                       "lam": float(lam), "loss_new": float(f), "ts": ts})
    elif kind == "ritz":
        step, vals, okv, basis = payload
        v = np.asarray(vals.detach().double().cpu(), dtype=np.float64)
        sink.emit({"ev": "ritz", "step": _int(step), "basis": basis, "ok": bool(okv),
                   "ts": ts, "values": [round(float(x), 8) for x in v.ravel()]})


def flush() -> None:
    """Turn the records of the steps run since the last flush into events:
    device timestamps onto the host clock, device scalars into numbers. Call
    it after the step's synchronize (on the CPU, any time)."""
    global _records
    pending, _records = _records, []
    for kind, sink, payload, stamp in pending:
        _emit(kind, sink, payload, _resolve(stamp))


def register_crash_flush(sink: Telemetry):
    """Close ``sink`` on abnormal exit so a SIGTERM'd or interrupted worker
    still leaves a flushed, parseable event file.

    Installs an ``atexit`` hook plus SIGTERM/SIGINT handlers that flush the
    sink, emit a final ``fault`` event recording the signal, then re-raise
    the default disposition (so the supervisor still sees a signal death).
    Handlers chain to any previously installed callable handler. Outside
    the main thread the signal handlers cannot be installed; the atexit
    hook still covers normal interpreter shutdown.
    """
    import atexit
    import signal

    atexit.register(sink.close)

    def _make(signum, prev):
        def _handler(num, frame):
            try:
                sink.emit({"ev": "fault", "kind": "signal",
                           "signal": int(num), "ts": time.time()})
                sink.close()
            except Exception:
                pass
            if callable(prev):
                prev(num, frame)
            else:
                signal.signal(num, signal.SIG_DFL)
                os.kill(os.getpid(), num)
        return _handler

    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            prev = signal.getsignal(signum)
            signal.signal(signum, _make(signum, prev))
        except ValueError:
            pass
