"""Durable flat-npz pytree checkpointing (twin of
``repro/checkpoint/checkpoint.py``, format v2): atomic writes, per-array
checksums, a validated manifest, and newest-*valid* fallback restore.

Leaves are addressed by their tree path ("blocks/attn/wq/w"; a NamedTuple
field by its name, a list entry by its index), the same strings the
reference builds, so a restore rebuilds any tree of the same structure,
the whole ``HFState`` included (damping λ, the Krylov warm start δ_{k-1},
the hybrid flag, the step counter). That is what makes a resumed run
step-deterministic: the continuation runs the same step on the same state
and the same step-indexed batches as the uninterrupted run.

Files are byte-compatible with the reference's in both directions: the
same keys, the same ``__meta__`` and ``__manifest__`` records, CRC32s over
the same bytes. numpy has no bf16: the reference writes a bf16 leaf as its
``ml_dtypes`` array, which ``np.savez`` records as a 2-byte void (``V2``),
and the port writes a ``torch.bfloat16`` tensor as the same void view of
its bits; on restore, ``V2`` (or ``uint16``) data becomes bf16 again by a
view, never by a value cast.

Durability contract (what a ``kill -9`` mid-write can and cannot leave):

  * writes go to a temp file in the SAME directory, are flushed and
    fsync'd, and land under the final name by ``os.replace`` (atomic on
    POSIX); the directory entry is fsync'd so the rename survives a crash
    of the host;
  * every array carries a CRC32 in the ``__manifest__`` record, so a torn
    or bit-flipped file is detected at restore (``verify_checkpoint`` /
    ``CheckpointCorruptError``);
  * ``restore_latest_valid`` scans steps newest-first and restores the
    first checkpoint that verifies;
  * the manifest records a config fingerprint and the writing process
    count; ``restore_checkpoint`` refuses (``CheckpointMismatchError``) to
    restore state into an incompatible run;
  * ``save_checkpoint`` checks the free space of the target directory
    first and raises ``CheckpointError`` naming both sizes when it is short.

Leaves are moved to the host to be written (``.detach().cpu()``); a
restored leaf lands on its template leaf's device and dtype.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_unflatten

FORMAT_VERSION = 2

# Room kept free beyond the payload when a checkpoint is written: the zip
# headers and the JSON records.
_SLACK_BYTES = 16 << 20


class CheckpointError(Exception):
    """Base class for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """The checkpoint file is torn, unreadable, or fails its checksums."""


class CheckpointMismatchError(CheckpointError):
    """The checkpoint is valid but belongs to an incompatible run
    (config fingerprint or process count differ from the restorer's)."""


def config_fingerprint(obj: Any) -> str:
    """Stable short fingerprint of a run configuration: the SHA-256 of the
    canonical JSON form (sorted keys; a dataclass as its type's name and
    its fields), the reference's digest for the same dictionary."""

    def canon(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return {"__dc__": type(x).__name__,
                    **{f.name: canon(getattr(x, f.name))
                       for f in dataclasses.fields(x)}}
        if isinstance(x, dict):
            return {str(k): canon(v) for k, v in sorted(x.items())}
        if isinstance(x, (list, tuple)):
            return [canon(v) for v in x]
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        return repr(x)

    blob = json.dumps(canon(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _path_str(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return str(p.idx)
    if hasattr(p, "name"):
        return str(p.name)
    return str(p)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the reference would write: bf16 as a 2-byte
    void view of its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree):
    flat, _ = tree_flatten_with_path(tree)
    return {"/".join(_path_str(p) for p in path): _to_numpy(leaf) for path, leaf in flat}


def _crc(arr: np.ndarray) -> int:
    flat = np.ascontiguousarray(arr).reshape(-1)
    return zlib.crc32(flat.view(np.uint8).data if flat.size else b"") & 0xFFFFFFFF


def _check_free_space(directory: str, n_bytes: int) -> None:
    free = shutil.disk_usage(directory).free
    if free < n_bytes + _SLACK_BYTES:
        raise CheckpointError(
            f"{directory}: a checkpoint of {n_bytes:,} bytes needs "
            f"{n_bytes + _SLACK_BYTES:,} bytes free there, and {free:,} are; "
            "point --ckpt-dir at a larger disk")


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    extra: dict | None = None,
    *,
    fingerprint: Optional[str] = None,
    processes: int = 1,
) -> str:
    """Atomically write ``ckpt_{step:08d}.npz`` with checksums and manifest.

    ``fingerprint`` (see :func:`config_fingerprint`) and ``processes`` are
    recorded in the manifest and validated on restore. ``extra`` rides in
    both the manifest and the ``__meta__`` record."""
    os.makedirs(directory, exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten_with_paths(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v for k, v in _flatten_with_paths(opt_state).items()})
    _check_free_space(directory, sum(v.nbytes for v in payload.values()))
    meta = {"step": int(step), **(extra or {})}
    manifest = {
        "format": FORMAT_VERSION,
        "step": int(step),
        "fingerprint": fingerprint,
        "processes": int(processes),
        "checksums": {k: _crc(v) for k, v in payload.items()},
        "extra": dict(extra or {}),
    }
    final = _step_path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta),
                     __manifest__=json.dumps(manifest), **payload)
            # The bytes reach the disk before the rename makes the name
            # visible: a crash never leaves a named, half-written file.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return final


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def all_steps(directory: str) -> list:
    """Every checkpoint step present on disk (no validity check), sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(f[len("ckpt_"):-len(".npz")])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
    )


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _read(path: str, verify: bool = True):
    """(manifest, meta, arrays) of one checkpoint file, read once. With
    ``verify``, raises :class:`CheckpointCorruptError` on a torn or
    unreadable file, a missing manifest, a key set that disagrees with the
    manifest, or any per-array CRC32 mismatch."""
    try:
        with np.load(path, allow_pickle=False) as z:
            if verify and "__manifest__" not in z.files:
                raise CheckpointCorruptError(
                    f"{path}: no __manifest__ record (pre-durability format or torn write)")
            manifest = json.loads(str(z["__manifest__"])) if "__manifest__" in z.files else {}
            meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
            data = {k: z[k] for k in z.files if k not in ("__meta__", "__manifest__")}
    except CheckpointCorruptError:
        raise
    except Exception as e:  # zipfile/json/numpy errors: a torn or garbled file
        raise CheckpointCorruptError(f"{path}: unreadable ({e})") from e
    if verify:
        checksums = manifest.get("checksums", {})
        if set(data) != set(checksums):
            raise CheckpointCorruptError(
                f"{path}: manifest/key mismatch "
                f"(missing={sorted(set(checksums) - set(data))[:3]} "
                f"extra={sorted(set(data) - set(checksums))[:3]})")
        for k, want in checksums.items():
            got = _crc(data[k])
            if got != int(want):
                raise CheckpointCorruptError(
                    f"{path}: checksum mismatch on {k!r} (stored {want}, computed {got})")
    return manifest, meta, data


def verify_checkpoint(path: str) -> dict:
    """Integrity-check one checkpoint file; return its manifest. Raises
    :class:`CheckpointCorruptError` on a torn or unreadable file, a missing
    manifest, a key set that disagrees with the manifest, or any per-array
    CRC32 mismatch."""
    return _read(path)[0]


def valid_steps(directory: str) -> list:
    """Steps whose checkpoint files pass :func:`verify_checkpoint`."""
    out = []
    for step in all_steps(directory):
        try:
            verify_checkpoint(_step_path(directory, step))
        except CheckpointCorruptError:
            continue
        out.append(step)
    return out


def latest_valid_step(directory: str) -> int | None:
    """Newest step that verifies clean; None when there is none."""
    for step in reversed(all_steps(directory)):
        try:
            verify_checkpoint(_step_path(directory, step))
        except CheckpointCorruptError:
            continue
        return step
    return None


def _check_manifest(manifest: dict, path: str, expect_fingerprint: Optional[str],
                    expect_processes: Optional[int]) -> None:
    if (expect_fingerprint is not None
            and manifest.get("fingerprint") is not None
            and manifest["fingerprint"] != expect_fingerprint):
        raise CheckpointMismatchError(
            f"{path}: config fingerprint {manifest['fingerprint']!r} does not match this "
            f"run's {expect_fingerprint!r}: the checkpoint was written by a different "
            "model/optimizer configuration; refusing to restore incompatible state (point "
            "--ckpt-dir at a fresh directory, or rerun with the original config)")
    if (expect_processes is not None
            and manifest.get("processes") is not None
            and int(manifest["processes"]) != int(expect_processes)):
        raise CheckpointMismatchError(
            f"{path}: written by {manifest['processes']} process(es), restoring into "
            f"{expect_processes}: replicated optimizer state is only step-deterministic at "
            f"the writing process count; refusing (restart with --num-processes "
            f"{manifest['processes']})")


def _to_leaf(arr: np.ndarray, template):
    """A saved array as a leaf shaped like ``template``: bf16 bits (``V2``
    or ``uint16``) by a view, anything else by a cast to the template's
    dtype, on the template's device."""
    if not isinstance(template, torch.Tensor):
        return torch.as_tensor(np.array(arr))
    if ((arr.dtype.kind == "V" and arr.dtype.itemsize == 2)
            or (arr.dtype == np.uint16 and template.dtype == torch.bfloat16)):
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=template.device, dtype=template.dtype)


def _rebuild(path: str, data: dict, template, prefix: str):
    flat, spec = tree_flatten_with_path(template)
    leaves = []
    for p, leaf in flat:
        key = prefix + "/".join(_path_str(x) for x in p)
        if key not in data:
            raise CheckpointMismatchError(
                f"{path}: missing leaf {key!r}: the restore template's tree structure "
                "differs from the saved one")
        arr = data[key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if arr.shape != shape:
            raise CheckpointMismatchError(
                f"{path}: shape mismatch on {key!r} (saved {arr.shape}, template {shape})")
        leaves.append(_to_leaf(arr, leaf))
    return tree_unflatten(leaves, spec)


def _restore(path, manifest, meta, data, params_like, opt_state_like, expect_fingerprint,
             expect_processes, verify):
    if verify:
        _check_manifest(manifest, path, expect_fingerprint, expect_processes)
    params = _rebuild(path, data, params_like, "params/")
    opt_state = (_rebuild(path, data, opt_state_like, "opt/")
                 if opt_state_like is not None else None)
    return params, opt_state, meta


def restore_checkpoint(
    directory: str,
    step: int,
    params_like: Any,
    opt_state_like: Any = None,
    *,
    expect_fingerprint: Optional[str] = None,
    expect_processes: Optional[int] = None,
    verify: bool = True,
):
    """Restore into templates (structure, dtype and device donors). Returns
    (params, opt_state, meta).

    ``verify=True`` (default) checksums every array and validates the
    manifest against ``expect_fingerprint`` / ``expect_processes`` before
    any state is rebuilt; the file is read once."""
    path = _step_path(directory, step)
    return _restore(path, *_read(path, verify), params_like, opt_state_like,
                    expect_fingerprint, expect_processes, verify)


def restore_latest_valid(
    directory: str,
    params_like: Any,
    opt_state_like: Any = None,
    *,
    expect_fingerprint: Optional[str] = None,
    expect_processes: Optional[int] = None,
):
    """Restore the newest checkpoint that passes integrity checks.

    Corrupt or torn files are skipped (falling back to older steps); a
    manifest *mismatch* is not skipped but raises
    :class:`CheckpointMismatchError`, because resuming older compatible
    state would hide the operator's error. Returns (params, opt_state,
    meta, step), or None when the directory holds no valid checkpoint."""
    for step in reversed(all_steps(directory)):
        path = _step_path(directory, step)
        try:
            read = _read(path)
        except CheckpointCorruptError:
            continue
        params, opt_state, meta = _restore(path, *read, params_like, opt_state_like,
                                           expect_fingerprint, expect_processes, True)
        return params, opt_state, meta, step
    return None
