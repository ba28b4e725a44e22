"""Tagged collectives of the data-parallel HF step (twin of
``repro/core/collectives.py``).

Every reduction of ``core.distributed`` goes through :func:`preduce`: one
all-reduce per call over a pytree, tagged so that the executed schedule can
be counted (:func:`count_executed`) and held against ``metrics
["blocking_syncs"]`` and ``core.comm_model``. The reference counts
executions with debug callbacks baked into its traced program; here the
step runs eagerly, so a call is an execution, counted per process. The
reference's callback fires once per vmapped tangent, so a block product of
w stacked tangents counts w there though one all-reduce carries it: the
port's ``counts`` follow that (``preduce(..., count=w)``), and
``collectives`` counts the all-reduce calls themselves.

Reductions run over a :class:`DataMesh`: the process group, its size under
``shape[axis]`` and this process's rank (``launch.mesh.make_data_mesh``).
The mean is a SUM followed by a division by the group's size, the same on
every backend (gloo takes CUDA tensors and stages them through host memory;
its ``AVG`` on CUDA tensors is not relied on).

:func:`preduce_value` wraps a loss: its forward is the all-reduced mean of
the value, its backward passes the gradient through unchanged. Each process
is left with the gradient of its own shard, as the reference's transpose of
``pmean`` leaves it, and ``grad_reduce`` then takes the mean, one
all-reduce for g and one per curvature product. The backward is
differentiable, so the double-backward graphs of the curvature engine
(``core.curvature``) run through it. (``torch.distributed.nn``'s
``all_reduce`` would all-reduce again in its backward.)

The reference's jaxpr walk has no twin: the executed count is the audit.

**Telemetry and the watchdog.** While a telemetry sink is installed
(``obs.telemetry.install``) every reduce emits a ``coll`` span, and while
:func:`collective_watchdog` is installed every reduce arms the watchdog:
both begin when the all-reduce is issued and end when it completes. For a
blocking :func:`preduce` that is when the host's wait returns; for a reduce
started ahead (:func:`preduce_start`, the hidden gradient reduce) it is
when gloo's work completes (its future's callback), not when the host gets
round to waiting, which is what the reference's output-ready callback
measures. The span's label is ``telemetry.collective_label``'s, else the
tag.
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..obs import telemetry as _telemetry

# Exit code of a worker whose collective watchdog fired. Distinct from
# Python's 0/1/2 and from signal deaths, so the supervisor
# (launch/multiproc.py, which keeps a copy) can tell it from a crash.
EXIT_WATCHDOG = 87

_OPS = {"mean": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DataMesh:
    """A 1-D mesh of processes: ``group`` (None: the default group), its
    size under ``shape[axis]`` and this process's ``rank`` in it."""

    def __init__(self, group=None, axis: str = "data", *, size=None, rank=None):
        self.group = group
        self.axis_names = (axis,)
        self.size = dist.get_world_size(group) if size is None else int(size)
        self.rank = dist.get_rank(group) if rank is None else int(rank)
        self.shape = {axis: self.size}

    def all_reduce(self, buf: torch.Tensor, op: str):
        """Start one in-place all-reduce of ``buf``; returns its work handle."""
        return dist.all_reduce(buf, op=_OPS[op], group=self.group, async_op=True)


class CollectiveCounts:
    """Tally of executed tagged reductions of this process, per tag: the
    reference's count (``counts``), the all-reduce calls (``collectives``),
    their bytes, the host seconds inside ``preduce`` and the host's seconds
    waiting on reduces started ahead (:func:`preduce_start`)."""

    def __init__(self) -> None:
        self.counts: collections.Counter = collections.Counter()
        self.collectives: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()
        self.wait_seconds: collections.Counter = collections.Counter()

    def add(self, tag: str, nbytes: int = 0, count: int = 1, calls: int = 1) -> None:
        self.counts[tag] += count
        self.collectives[tag] += calls
        self.nbytes[tag] += nbytes

    def total(self) -> int:
        return sum(self.counts.values())

    def per_device(self, n_local_devices: int = 1) -> dict:
        """The reference's per-device normalization; one device a process."""
        out = {}
        for tag, n in self.counts.items():
            if n % n_local_devices:
                raise ValueError(f"{tag}: {n} calls over {n_local_devices} devices")
            out[tag] = n // n_local_devices
        return out


_active: CollectiveCounts | None = None


@contextlib.contextmanager
def count_executed() -> Iterator[CollectiveCounts]:
    """Count every ``preduce`` call made inside this region."""
    global _active
    prev, _active = _active, CollectiveCounts()
    try:
        yield _active
    finally:
        _active = prev


class Watchdog:
    """Turn an indefinitely blocking collective into a detectable death.

    A gloo all-reduce whose peer died may block for ``PG_TIMEOUT_S`` inside
    a C++ call, where no Python exception can be raised and no signal
    handler runs. A side thread notices that a collective has been
    outstanding too long and hard-exits the process with
    ``EXIT_WATCHDOG``; the supervisor (``launch.multiproc.spawn_supervised``)
    then restarts the job from its newest valid checkpoint.

    :func:`preduce` arms it when an all-reduce is issued and disarms it when
    that reduce completes, pairing per tag in FIFO order. ``on_timeout``
    (tests) replaces the hard exit with a callable ``(tag, waited_s)``.
    """

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[str, float], None]] = None,
                 poll_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout
        self._poll_s = poll_s if poll_s is not None else max(0.05, self.timeout_s / 4.0)
        self._lock = threading.Lock()
        self._outstanding: dict = {}   # tag -> deque of arm timestamps
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False
        self.fired_tag: Optional[str] = None

    def arm(self, tag: str) -> None:
        with self._lock:
            self._outstanding.setdefault(tag, collections.deque()).append(time.time())

    def disarm(self, tag: str) -> None:
        with self._lock:
            q = self._outstanding.get(tag)
            if q:
                q.popleft()

    def _oldest_overdue(self, now: float):
        with self._lock:
            for tag, q in self._outstanding.items():
                if q and now - q[0] > self.timeout_s:
                    return tag, now - q[0]
        return None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="collective-watchdog")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            hit = self._oldest_overdue(time.time())
            if hit is None:
                continue
            tag, waited = hit
            self.fired, self.fired_tag = True, tag
            if self.on_timeout is not None:
                self.on_timeout(tag, waited)
                return
            sys.stderr.write(
                f"[watchdog] collective {tag!r} blocked {waited:.1f}s "
                f"(> {self.timeout_s:.1f}s); peer presumed dead: exiting {EXIT_WATCHDOG}\n")
            sys.stderr.flush()
            # os._exit, not sys.exit: the main thread is wedged in gloo's C++
            # wait and would never unwind a SystemExit.
            os._exit(EXIT_WATCHDOG)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


_watchdog: Optional[Watchdog] = None


@contextlib.contextmanager
def collective_watchdog(timeout_s: float, on_timeout: Optional[Callable] = None,
                        poll_s: Optional[float] = None):
    """Arm a :class:`Watchdog` around every ``preduce`` issued inside this
    context. The monitor thread starts at once and stops when the context
    exits."""
    global _watchdog
    wd = Watchdog(timeout_s, on_timeout, poll_s).start()
    prev, _watchdog = _watchdog, wd
    try:
        yield wd
    finally:
        _watchdog = prev
        wd.stop()


class _Watch:
    """One reduce's telemetry span and watchdog window: begun when it is
    built (at the issue), ended once by :meth:`end`, or by
    :meth:`one_done` when the last of its all-reduces completes."""

    def __init__(self, sink, wd, tag, n_works):
        self.sink, self.wd, self.tag = sink, wd, tag
        self.label = _telemetry.current_collective_label() or tag
        self._left, self._lock = n_works, threading.Lock()
        if wd is not None:
            wd.arm(tag)
        if sink is not None:
            sink.collective_begin(tag, self.label)

    def end(self) -> None:
        if self.wd is not None:
            self.wd.disarm(self.tag)
        if self.sink is not None:
            self.sink.collective_end(self.tag, self.label)

    def one_done(self, _fut=None) -> None:
        with self._lock:
            self._left -= 1
            last = self._left == 0
        if last:
            self.end()


def _mesh(mesh_or_group) -> DataMesh:
    return mesh_or_group if isinstance(mesh_or_group, DataMesh) else DataMesh(mesh_or_group)


class PendingReduce:
    """A reduce in flight: :meth:`wait` returns the reduced tree."""

    def __init__(self, works, bufs, leaves, spec, divisor, tag, counter, t_issue, ahead,
                 watch):
        self._works, self._bufs, self._leaves, self._spec = works, bufs, leaves, spec
        self._divisor, self._tag, self._counter, self._t_issue = divisor, tag, counter, t_issue
        self._ahead, self._watch = ahead, watch

    def wait(self):
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        if self._watch is not None and not self._ahead:
            self._watch.end()
        if self._counter is not None and self._ahead:
            self._counter.wait_seconds[self._tag] += time.perf_counter() - t0
        out = [None] * len(self._leaves)
        for (idx, buf) in self._bufs:
            if self._divisor != 1:
                buf.div_(self._divisor)
            parts = torch.split(buf, [self._leaves[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view(self._leaves[i].shape)
        if self._counter is not None:
            self._counter.seconds[self._tag] += self._t_issue + time.perf_counter() - t0
        return tree_unflatten(out, self._spec)


def preduce_start(tree: Any, mesh_or_group, tag: str = "reduce", *, op: str = "mean",
                  count: int = 1) -> PendingReduce:
    """Start one logical collective over ``tree`` (its leaves concatenated
    into one buffer per dtype, the inputs never written) and return the
    handle to wait on; the host's time in that wait is counted in
    ``wait_seconds``. ``op``: "mean" (the reference's ``pmean``), "sum" or
    "max". ``count``: the reference's executions it stands for (the width
    of a block of stacked tangents)."""
    return _issue(tree, mesh_or_group, tag, op, count, ahead=True)


def _issue(tree, mesh_or_group, tag, op, count, ahead) -> PendingReduce:
    if op not in _OPS:
        raise ValueError(f"op must be one of {tuple(_OPS)}, got {op!r}")
    t0 = time.perf_counter()
    mesh = _mesh(mesh_or_group)
    leaves, spec = tree_flatten(tree)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    bufs = [(idx, torch.cat([leaves[i].detach().reshape(-1) for i in idx]))
            for idx in by_dtype.values()]
    sink, wd = _telemetry.active(), _watchdog
    watch = None if sink is None and wd is None else _Watch(sink, wd, tag, len(bufs))
    works = [mesh.all_reduce(buf, op) for _, buf in bufs]
    if watch is not None and ahead:
        # Ended by gloo's thread when the last all-reduce completes.
        for w in works:
            w.get_future().add_done_callback(watch.one_done)
    counter = _active
    if counter is not None:
        counter.add(tag, sum(buf.numel() * buf.element_size() for _, buf in bufs), count,
                    len(bufs))
    divisor = mesh.size if op == "mean" else 1
    return PendingReduce(works, bufs, leaves, spec, divisor, tag, counter,
                         time.perf_counter() - t0, ahead, watch)


def preduce(tree: Any, mesh_or_group, tag: str = "reduce", *, op: str = "mean",
            count: int = 1):
    """One tagged all-reduce of a pytree: the mean over the mesh (or "sum",
    "max"). Returns new tensors; the inputs are not written."""
    return _issue(tree, mesh_or_group, tag, op, count, ahead=False).wait()


class _MeanValue(torch.autograd.Function):
    """Forward: the all-reduced mean of the value; backward: the identity."""

    @staticmethod
    def forward(x, mesh, tag):
        return preduce(x.detach(), mesh, tag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def preduce_value(x: torch.Tensor, mesh_or_group, tag: str = "loss") -> torch.Tensor:
    """The mean of a scalar over the mesh, whose gradient is the local one
    (module docstring). Runs under ``torch.func`` transforms and through
    ``create_graph`` double backwards."""
    return _MeanValue.apply(x, _mesh(mesh_or_group), tag)
