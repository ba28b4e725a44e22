"""Deterministic fault injection for chaos-testing the training stack (twin
of ``repro/launch/faults.py``).

Faults are declared in the ``REPRO_TORCH_FAULTS`` environment variable (the
port's prefix, as ``REPRO_TORCH_MULTIPROC_*``: a reference run in the same
shell is never armed by a spec meant for the port) as a ``;``-separated
list of specs:

    kind@step=N[,proc=K][,secs=S][,attempt=A]

    kill          hard-kill the process (``os._exit``) at the top of step N:
                  a preempted or OOM-killed worker; the survivors wedge in
                  the next collective and the supervisor restarts all.
    hang          stop making progress at the top of step N (sleep ``secs``,
                  default an hour): a wedged worker; caught by heartbeat
                  staleness or the collective watchdog, never by an exit
                  code.
    delay         sleep ``secs`` (default 1.0) at the top of step N, then
                  continue: a straggler; must not trip a sanely configured
                  supervisor.
    corrupt_ckpt  after the step-N checkpoint save, overwrite bytes in the
                  middle of the newest checkpoint file: damage after the
                  fsync that only the CRC manifest finds at restore.
    nan_batch     poison the step-N training batch with NaN: a corrupted
                  data shard; must surface as a rejected outer step (the
                  divergence sentinel of ``core/hf.py``), not NaN
                  parameters. Only floating tensors can carry NaN; integer
                  token ids pass through.

``proc`` restricts the fault to one process index (default: every process);
``attempt`` gates on the supervisor's restart counter
(``multiproc.ENV_RESTART``), default 0, so a kill that took down attempt 0
does not fire again in every restart.

Same spec and same step sequence give the same fault, so a chaos check can
hold the trajectory after a restart equal to the uninterrupted one. Each
fired fault is emitted as a telemetry ``fault`` event before it acts (the
sink writes line by line: the event survives the kill).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, List, Optional

ENV_FAULTS = "REPRO_TORCH_FAULTS"

KINDS = ("kill", "hang", "delay", "corrupt_ckpt", "nan_batch")


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    proc: Optional[int] = None   # None = every process
    secs: float = 1.0
    attempt: int = 0

    def spec(self) -> str:
        parts = [f"{self.kind}@step={self.step}"]
        if self.proc is not None:
            parts.append(f"proc={self.proc}")
        if self.secs != 1.0:
            parts.append(f"secs={self.secs:g}")
        if self.attempt != 0:
            parts.append(f"attempt={self.attempt}")
        return parts[0] + ("," + ",".join(parts[1:]) if parts[1:] else "")


def parse_faults(spec: str) -> List[Fault]:
    """Parse a fault spec string; raises ValueError on a bad spec so that a
    mistyped chaos run fails instead of injecting nothing."""
    out = []
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(f"fault spec {item!r}: missing '@step=N'")
        kind, _, rest = item.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(f"fault spec {item!r}: unknown kind {kind!r} "
                             f"(have {', '.join(KINDS)})")
        fields = {}
        for kv in rest.split(","):
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in ("step", "proc", "secs", "attempt"):
                raise ValueError(f"fault spec {item!r}: unknown field {k!r}")
            fields[k] = v.strip()
        if "step" not in fields:
            raise ValueError(f"fault spec {item!r}: missing step=")
        out.append(Fault(
            kind=kind,
            step=int(fields["step"]),
            proc=int(fields["proc"]) if "proc" in fields else None,
            secs=float(fields.get("secs", 1.0)),
            attempt=int(fields.get("attempt", 0)),
        ))
    return out


def corrupt_file(path: str, magic: bytes = b"\xde\xad\xbe\xef") -> None:
    """Overwrite bytes in the middle of ``path`` in place (no size change,
    no rename): the kind of damage only a checksum finds."""
    size = os.path.getsize(path)
    blob = magic * 8
    with open(path, "r+b") as f:
        f.seek(max(0, size // 2 - len(blob) // 2))
        f.write(blob[:max(1, min(len(blob), size))])
        f.flush()
        os.fsync(f.fileno())


class FaultPlan:
    """The faults that apply to THIS process on THIS supervisor attempt.

    Hook placement (``launch/train.py``): ``on_step_begin`` at the top of
    every outer step, ``poison_batch`` on the freshly built batch,
    ``corrupt_checkpoint`` right after a checkpoint save. Every hook is a
    cheap no-op when the plan is empty.
    """

    def __init__(self, faults: List[Fault], process_index: int = 0,
                 attempt: int = 0, telemetry: Any = None):
        self.process_index = int(process_index)
        self.attempt = int(attempt)
        self.telemetry = telemetry
        self.faults = [
            f for f in faults
            if (f.proc is None or f.proc == self.process_index)
            and f.attempt == self.attempt
        ]
        self._fired: set = set()

    @classmethod
    def from_env(cls, process_index: int = 0, telemetry: Any = None) -> "FaultPlan":
        from . import multiproc
        spec = os.environ.get(ENV_FAULTS, "")
        return cls(parse_faults(spec), process_index, multiproc.restart_attempt(), telemetry)

    def active(self) -> bool:
        return bool(self.faults)

    def _take(self, kind: str, step: int) -> Optional[Fault]:
        for f in self.faults:
            key = (f.kind, f.step, f.proc)
            if f.kind == kind and f.step == int(step) and key not in self._fired:
                self._fired.add(key)
                return f
        return None

    def _emit(self, fault: Fault, step: int, **extra) -> None:
        if self.telemetry is not None:
            self.telemetry.emit({
                "ev": "fault", "kind": fault.kind, "injected": True,
                "step": int(step), "proc": self.process_index,
                "attempt": self.attempt, "ts": time.time(), **extra})

    def on_step_begin(self, step: int) -> None:
        """Fire any kill/hang/delay scheduled for this step. ``kill`` uses
        ``os._exit`` (no atexit, no flush beyond the line already written):
        a real preemption, not a polite shutdown."""
        f = self._take("delay", step)
        if f is not None:
            self._emit(f, step, secs=f.secs)
            time.sleep(f.secs)
        f = self._take("hang", step)
        if f is not None:
            secs = f.secs if f.secs > 1.0 else 3600.0
            self._emit(f, step, secs=secs)
            time.sleep(secs)
        f = self._take("kill", step)
        if f is not None:
            self._emit(f, step)
            os._exit(1)

    def poison_batch(self, step: int, batch: Any) -> Any:
        """Return the batch, its floating tensors NaN if ``nan_batch`` fires
        here (integer tensors unchanged)."""
        f = self._take("nan_batch", step)
        if f is None:
            return batch
        self._emit(f, step)
        import torch
        from torch.utils._pytree import tree_map

        return tree_map(
            lambda x: (x * float("nan") if isinstance(x, torch.Tensor)
                       and x.is_floating_point() else x), batch)

    def corrupt_checkpoint(self, step: int, directory: str) -> Optional[str]:
        """After the step-``step`` save: damage the newest checkpoint file.
        Returns the corrupted path (or None if no fault fires)."""
        f = self._take("corrupt_ckpt", step)
        if f is None:
            return None
        from ..checkpoint import latest_step
        newest = latest_step(directory)
        if newest is None:
            return None
        path = os.path.join(directory, f"ckpt_{newest:08d}.npz")
        corrupt_file(path)
        self._emit(f, step, path=path)
        return path
