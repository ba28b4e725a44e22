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

:func:`spawn_supervised` runs the same children under a liveness
supervisor: a dead, hung or watchdog-ended worker (``EXIT_WATCHDOG``, see
``core.collectives.collective_watchdog``) tears the attempt down and starts
a fresh one, whose workers resume from their newest valid checkpoint
(``launch/train.py``). Workers beat with :func:`heartbeat` from the train
loop and read their attempt with :func:`restart_attempt`.
"""
from __future__ import annotations

import collections
import datetime
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from .._device import resolve_device

ENV_NUM = "REPRO_TORCH_MULTIPROC_NUM"
ENV_ID = "REPRO_TORCH_MULTIPROC_ID"
ENV_COORD = "REPRO_TORCH_MULTIPROC_COORD"
# The supervisor's attempt counter: 0 on the first launch, k after the k-th
# restart. launch/faults.py gates injected faults on it.
ENV_RESTART = "REPRO_TORCH_MULTIPROC_RESTART"
# The directory where workers touch per-process heartbeat files; the
# supervisor reads their mtimes to find a hang (a worker wedged in a dead
# collective stops beating but never exits on its own).
ENV_HEARTBEAT_DIR = "REPRO_TORCH_MULTIPROC_HEARTBEAT"

# Exit code of a worker whose collective watchdog fired; equal to
# core.collectives.EXIT_WATCHDOG (held by tests/test_torch_faults.py), kept
# here so the supervisor needs nothing of the step's modules.
EXIT_WATCHDOG = 87

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


def _base_env(env: dict | None) -> dict:
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join([_SRC] + (
        [base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    # The rendezvous and the collectives stay on the loopback interface.
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return base


def _start(num_processes, module, args, base, extra=None):
    """Start the children of one launch on a fresh rendezvous port; each
    child's output goes to a pump thread that keeps its last lines (and
    passes process 0's on to this process's stdout)."""
    coord = f"127.0.0.1:{_free_port()}"
    procs, tails, pumps = [], [], []
    for pid in range(num_processes):
        child_env = dict(base, **(extra or {}))
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
    return procs, tails, pumps


def _report(procs, tails, only_failed: bool = True) -> str:
    """Each (failed) child's exit and last lines."""
    return "\n".join(f"--- process {pid} ({_rc_desc(p.returncode)}) ---\n" + "".join(tails[pid])
                     for pid, p in enumerate(procs) if p.returncode or not only_failed)


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
    procs, tails, pumps = _start(num_processes, module, args, _base_env(env))
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
        raise RuntimeError(f"multiproc children failed ({why or 'non-zero exit'}): exit codes "
                           f"{rcs}\n" + _report(procs, tails))


def restart_attempt() -> int:
    """Which supervisor attempt this worker belongs to (0 = first launch)."""
    return int(os.environ.get(ENV_RESTART, "0"))


def heartbeat(step: Optional[int] = None) -> None:
    """Touch this worker's heartbeat file (a no-op outside supervision).

    Called from the train loop itself (once a step, and once after the
    kernel build), never from a side thread: a thread would keep beating
    while the main thread sits wedged in a dead collective, the very state
    the heartbeat exists to expose."""
    d = os.environ.get(ENV_HEARTBEAT_DIR)
    if not d:
        return
    path = os.path.join(d, f"hb-p{os.environ.get(ENV_ID, '0')}")
    try:
        with open(path, "w") as f:
            f.write(f"{'' if step is None else int(step)} {time.time()}\n")
    except OSError:
        pass  # a torn-down heartbeat directory must never end the worker


def _newest_heartbeat(directory: str) -> float:
    newest = 0.0
    try:
        for name in os.listdir(directory):
            if name.startswith("hb-p"):
                newest = max(newest, os.path.getmtime(os.path.join(directory, name)))
    except OSError:
        pass
    return newest


def _terminate_all(procs, grace_s: float = 5.0) -> None:
    """SIGTERM every live child (its telemetry handler flushes), wait up to
    ``grace_s``, then SIGKILL what is left (a worker blocked in gloo's C++
    wait never runs a Python signal handler) and reap every child, so the
    card's memory of a killed attempt is released before the next starts."""
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.time() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
            p.wait()


def _rc_desc(rc: Optional[int]) -> str:
    if rc is None:
        return "running"
    if rc == EXIT_WATCHDOG:
        return f"exit {rc} (collective watchdog)"
    if rc < 0:
        try:
            return f"signal {signal.Signals(-rc).name}"
        except ValueError:
            return f"signal {-rc}"
    return f"exit {rc}"


def spawn_supervised(
    num_processes: int,
    module: str,
    args: Sequence[str] = (),
    *,
    max_restarts: int = 2,
    hang_timeout_s: Optional[float] = None,
    backoff_s: float = 1.0,
    poll_s: float = 0.2,
    heartbeat_dir: Optional[str] = None,
    env: dict | None = None,
    timeout_s: Optional[float] = None,
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True),
) -> int:
    """:func:`spawn` under a liveness supervisor. Returns the restarts used.

    Each attempt gets a fresh rendezvous port (the old one is poisoned by
    the dead peer), fresh interpreters and ``ENV_RESTART`` = its index. The
    supervisor polls the children's exits and, when ``hang_timeout_s`` is
    set, the heartbeat files' mtimes; on a death, a hang or a watchdog exit
    it tears the survivors down (:func:`_terminate_all`) and starts everyone
    again after an exponential backoff. The workers resume from their newest
    valid checkpoint; the supervisor holds no training state. An all-zero
    exit returns; once ``max_restarts`` are spent this raises RuntimeError
    with each process's exit code and last lines.

    Staleness counts from max(newest heartbeat, the attempt's launch), so
    ``hang_timeout_s`` must cover the start-up (rendezvous, the kernel
    build) as well as a step. ``timeout_s`` bounds the wall clock of all
    attempts together: past it the children are torn down and this
    raises."""
    own_dir = heartbeat_dir is None
    if own_dir:
        heartbeat_dir = tempfile.mkdtemp(prefix="repro-torch-hb-")
    os.makedirs(heartbeat_dir, exist_ok=True)
    base = _base_env(env)
    base[ENV_HEARTBEAT_DIR] = heartbeat_dir
    last_failure, report = "never launched", ""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for attempt in range(max_restarts + 1):
            launched = time.time()
            procs, tails, pumps = _start(num_processes, module, args, base,
                                         {ENV_RESTART: str(attempt)})
            failure = None
            while failure is None:
                time.sleep(poll_s)
                rcs = [p.poll() for p in procs]
                if all(rc == 0 for rc in rcs):
                    for pump in pumps:
                        pump.join(timeout=5.0)
                    return attempt
                dead = [(pid, rc) for pid, rc in enumerate(rcs) if rc not in (None, 0)]
                if dead:
                    failure = ", ".join(f"process {pid}: {_rc_desc(rc)}" for pid, rc in dead)
                elif deadline is not None and time.monotonic() > deadline:
                    _terminate_all(procs)
                    raise RuntimeError(f"multiproc supervision timed out after {timeout_s:.0f} s "
                                       f"in attempt {attempt}\n"
                                       + _report(procs, tails, only_failed=False))
                elif hang_timeout_s is not None:
                    alive_since = max(_newest_heartbeat(heartbeat_dir), launched)
                    if time.time() - alive_since > hang_timeout_s:
                        failure = (f"no heartbeat for {hang_timeout_s:.0f}s "
                                   "(workers presumed hung)")
            log(f"[supervisor] attempt {attempt} failed: {failure}; tearing down survivors")
            _terminate_all(procs)
            for pump in pumps:
                pump.join(timeout=5.0)
            last_failure = failure
            report = _report(procs, tails, only_failed=False)
            if attempt < max_restarts:
                delay = backoff_s * (2 ** attempt)
                log(f"[supervisor] restarting in {delay:.1f}s "
                    f"(attempt {attempt + 1}/{max_restarts})")
                time.sleep(delay)
    finally:
        if own_dir:
            shutil.rmtree(heartbeat_dir, ignore_errors=True)
    raise RuntimeError(
        f"multiproc supervision exhausted {max_restarts} restart(s); last failure: "
        f"{last_failure}\n{report}")


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
