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
The collective watchdog (reference :102-206) serves the supervised restarts
and comes with them (ROADMAP item 23).
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

# Exit code of a worker whose collective watchdog fired (the reference's;
# the watchdog itself comes with the supervisor, ROADMAP item 23).
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


def _mesh(mesh_or_group) -> DataMesh:
    return mesh_or_group if isinstance(mesh_or_group, DataMesh) else DataMesh(mesh_or_group)


class PendingReduce:
    """A reduce in flight: :meth:`wait` returns the reduced tree."""

    def __init__(self, works, bufs, leaves, spec, divisor, tag, counter, t_issue, ahead):
        self._works, self._bufs, self._leaves, self._spec = works, bufs, leaves, spec
        self._divisor, self._tag, self._counter, self._t_issue = divisor, tag, counter, t_issue
        self._ahead = ahead

    def wait(self):
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
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
    bufs, works = [], []
    for idx in by_dtype.values():
        buf = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        works.append(mesh.all_reduce(buf, op))
        bufs.append((idx, buf))
    counter = _active
    if counter is not None:
        counter.add(tag, sum(buf.numel() * buf.element_size() for _, buf in bufs), count,
                    len(bufs))
    divisor = mesh.size if op == "mean" else 1
    return PendingReduce(works, bufs, leaves, spec, divisor, tag, counter,
                         time.perf_counter() - t0, ahead)


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
