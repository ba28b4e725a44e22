"""Multi-process launcher: the data-parallel HF step on N real processes
(twin of ``repro/launch/multiproc.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --num-processes 2 --solver gn_cg --krylov-backend flat --steps 2

:func:`spawn` re-executes ``python -m module`` N times in fresh interpreters
(never a fork of a process that may have started CUDA) with
``REPRO_TORCH_MULTIPROC_*`` set; each child calls
:func:`initialize_from_env`, which joins a gloo process group at a local TCP
address. Gloo's all-reduce takes CPU and CUDA tensors (staged through host
memory), so N ranks may share one card: the card's host has one H100, and
NCCL takes one card a rank (NCCL is not tried). The mesh is then
``launch.mesh.make_data_mesh()``.

Placement: every process builds the SAME global batch and parameters from
the same seeds; :func:`shard_batch` keeps this rank's contiguous
leading-dim slice (what ``NamedSharding(P("data"))`` hands process i in the
reference) and :func:`replicate` makes a tree rank 0's on every rank.

The supervised restarts (``heartbeat``, ``restart_attempt``,
``spawn_supervised``) are ROADMAP item 23.
"""
from __future__ import annotations

import collections
import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from .._device import resolve_device

ENV_NUM = "REPRO_TORCH_MULTIPROC_NUM"
ENV_ID = "REPRO_TORCH_MULTIPROC_ID"
ENV_COORD = "REPRO_TORCH_MULTIPROC_COORD"

# Seconds the other children get to end after one failed.
GRACE_S = 10.0
# Seconds a collective (and the rendezvous) may wait for a peer.
PG_TIMEOUT_S = 300.0

# The directory that holds ``repro_torch``: put on every child's path.
_SRC = str(Path(__file__).resolve().parents[2])


def active() -> bool:
    """True in a child process started by :func:`spawn`."""
    return ENV_NUM in os.environ


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(stream, tail, sink):
    for line in stream:
        tail.append(line)
        if sink is not None:
            sink.write(line)
            sink.flush()


def spawn(
    num_processes: int,
    module: str,
    args: Sequence[str] = (),
    *,
    env: dict | None = None,
    timeout_s: float = 1800.0,
) -> None:
    """Run ``python -m module *args`` as ``num_processes`` coordinated
    processes and wait for them.

    Process 0 is the logging primary: its output (stdout and stderr) is
    passed on to this process's stdout line by line; the others' is kept
    and shown only on failure. If a child exits non-zero the others get
    ``GRACE_S`` to end (a peer left in a collective never does) and are then
    killed; if ``timeout_s`` of wall clock pass, all are killed. Either way
    this raises RuntimeError with each failed child's last lines."""
    coord = f"127.0.0.1:{_free_port()}"
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join([_SRC] + (
        [base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    # The rendezvous and the collectives stay on the loopback interface.
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, tails, pumps = [], [], []
    for pid in range(num_processes):
        child_env = dict(base)
        child_env[ENV_NUM] = str(num_processes)
        child_env[ENV_ID] = str(pid)
        child_env[ENV_COORD] = coord
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], env=child_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        tail = collections.deque(maxlen=40)
        pump = threading.Thread(target=_pump, args=(
            proc.stdout, tail, sys.stdout if pid == 0 else None), daemon=True)
        pump.start()
        procs.append(proc)
        tails.append(tail)
        pumps.append(pump)
    deadline = time.monotonic() + timeout_s
    why = None
    try:
        while None in [p.poll() for p in procs]:
            now = time.monotonic()
            if why is None and any(p.returncode not in (None, 0) for p in procs):
                why = "a child failed"
                deadline = min(deadline, now + GRACE_S)
            if now > deadline:
                why = why or f"timed out after {timeout_s:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for pump in pumps:
            pump.join(timeout=5.0)
    rcs = [p.returncode for p in procs]
    if why is not None or any(rcs):
        report = [f"--- process {pid} (exit {rc}) ---\n" + "".join(tails[pid])
                  for pid, rc in enumerate(rcs) if rc]
        raise RuntimeError(f"multiproc children failed ({why or 'non-zero exit'}): exit codes "
                           f"{rcs}\n" + "\n".join(report))


def initialize_from_env(device="cuda"):
    """Join the gloo process group that :func:`spawn` set up; returns this
    process's device (``cuda:rank % device_count``, or the CPU if the
    caller asks for it), or None outside a spawned child."""
    if not active():
        return None
    dev = resolve_device(device)
    rank, world = int(os.environ[ENV_ID]), int(os.environ[ENV_NUM])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ[ENV_COORD]}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return dev


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_batch(batch: Any, mesh):
    """This rank's contiguous slice of the leading dim of every leaf of the
    (global, same on every rank) batch."""
    n, r = mesh.size, mesh.rank

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by mesh size {n}")
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]

    return tree_map(take, batch)


def replicate(tree: Any, mesh):
    """A copy of ``tree`` holding rank 0's values on every rank (one
    broadcast a tensor leaf; other leaves pass through)."""
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = x.detach().clone()
        dist.broadcast(y, src=src, group=mesh.group)
        return y

    return tree_map(bcast, tree)
