"""Merge per-process events.jsonl files into a Chrome/Perfetto trace.json
and reconstruct phase / collective spans for programmatic checks (a copy of
``repro/obs/trace.py``: the port keeps its own copy of the event schema).

Span reconstruction
-------------------
The step emits *end-markers* only (``{"ev": "phase"}``), each stamped when
its phase's work has run (on the card, a CUDA event recorded after the
phase's launches); a phase span is the interval between consecutive
markers of one (process, step), named after the closing marker.
``step_begin`` opens the chain and is not itself a phase. Collectives
arrive as ready-made ``{"ev": "coll", t0, t1}`` spans, begun when the
all-reduce is issued and ended when it completes, so in overlap mode the
hidden grad-reduce span brackets the curvature primal build, and
:func:`grad_reduce_overlap` measures the schedule.

Trace layout: pid = process index; tids: 0 phases, 1 collectives,
2 host spans, 3 counters/instants. Chrome "X" complete events, ts/dur in
microseconds relative to the earliest event in the directory.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

__all__ = [
    "load_events", "phase_spans", "collective_spans", "overlap_seconds",
    "grad_reduce_overlap", "fault_events", "build_trace", "merge_dir",
]

_LANES = {"phase": 0, "coll": 1, "span": 2, "counter": 3, "instant": 3,
          "fault": 3}


def fault_events(events):
    """``[{pid, kind, ts, ...}]`` for every fault/rejection event: injected
    faults (launch/faults.py), divergence-sentinel step rejections
    (core/hf.py via telemetry.reject_event), signal deaths. Sorted by
    time; used by chaos checks to assert faults landed where planned."""
    return sorted((dict(e) for e in events if e.get("ev") == "fault"),
                  key=lambda e: (e.get("ts", 0.0), e["pid"]))


def load_events(events_dir: str):
    """All events from every ``events-p*.jsonl`` in ``events_dir``, each
    annotated with its process index under ``"pid"``. Unparseable lines
    (torn writes from a killed process) are skipped."""
    events = []
    for path in sorted(glob.glob(os.path.join(events_dir, "events-p*.jsonl"))):
        m = re.search(r"events-p(\d+)\.jsonl$", path)
        pid = int(m.group(1)) if m else 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                ev["pid"] = pid
                events.append(ev)
    return events


def phase_spans(events):
    """Reconstruct ``[{pid, step, name, t0, t1}]`` from phase end-markers.

    Markers are grouped by (pid, step) and sorted by timestamp; each
    marker closes the span opened by its predecessor. Consecutive markers
    with the same name (e.g. the hybrid solver building two curvature
    operators) collapse into one span ending at the last marker.
    """
    groups: dict = {}
    for ev in events:
        if ev.get("ev") == "phase":
            groups.setdefault((ev["pid"], ev.get("step", -1)), []).append(ev)
    spans = []
    for (pid, step), marks in groups.items():
        marks.sort(key=lambda e: e["ts"])
        out = []
        for mk in marks:
            if mk["name"] == "step_begin":
                out.append(dict(pid=pid, step=step, name=mk["name"],
                                t0=mk["ts"], t1=mk["ts"]))
            elif out and out[-1]["name"] == mk["name"]:
                out[-1]["t1"] = mk["ts"]
            elif out:
                out.append(dict(pid=pid, step=step, name=mk["name"],
                                t0=out[-1]["t1"], t1=mk["ts"]))
            else:
                out.append(dict(pid=pid, step=step, name=mk["name"],
                                t0=mk["ts"], t1=mk["ts"]))
        spans.extend(s for s in out if s["name"] != "step_begin")
    spans.sort(key=lambda s: (s["pid"], s["t0"]))
    return spans


def collective_spans(events):
    """``[{pid, tag, label, t0, t1}]`` for every executed collective."""
    return sorted((dict(pid=e["pid"], tag=e["tag"], label=e["label"],
                        t0=e["t0"], t1=e["t1"])
                   for e in events if e.get("ev") == "coll"),
                  key=lambda s: (s["pid"], s["t0"]))


def overlap_seconds(a, b) -> float:
    """Temporal intersection of two spans (dicts with t0/t1), >= 0."""
    return max(0.0, min(a["t1"], b["t1"]) - max(a["t0"], b["t0"]))


def grad_reduce_overlap(events, *, phase: str = "curvature_primal",
                        label: str = "grad_reduce"):
    """Per (pid, step): how much of the grad-reduce collective span hides
    inside the curvature-primal phase span.

    Returns ``[{pid, step, overlap_s, phase_s, coll_s, frac}]`` where
    ``frac`` = overlap / phase duration — ~0 under the blocking schedule
    (the reduce completes before the primal build starts), substantial
    under ``HFConfig.overlap`` (the reduce span brackets the build).
    """
    phases = [s for s in phase_spans(events) if s["name"] == phase]
    colls = [c for c in collective_spans(events) if c["label"] == label]
    rows = []
    for p in phases:
        # the step's grad-reduce: same process, begin at/before the
        # primal phase ends (the hidden reduce issues before the build)
        cands = [c for c in colls
                 if c["pid"] == p["pid"] and c["t0"] <= p["t1"]
                 and c["t1"] >= p["t0"] - 1.0]
        if not cands:
            continue
        c = max(cands, key=lambda c: overlap_seconds(c, p))
        ov = overlap_seconds(c, p)
        dur = max(p["t1"] - p["t0"], 1e-12)
        rows.append(dict(pid=p["pid"], step=p["step"], overlap_s=ov,
                         phase_s=p["t1"] - p["t0"], coll_s=c["t1"] - c["t0"],
                         frac=ov / dur))
    return rows


def _us(t: float, t_base: float) -> float:
    return (t - t_base) * 1e6


def build_trace(events) -> dict:
    """Chrome/Perfetto trace dict (``traceEvents`` JSON) from raw events."""
    times = [v for e in events for k, v in e.items()
             if k in ("ts", "t0") and isinstance(v, (int, float))]
    t_base = min(times) if times else 0.0
    out = []
    pids = sorted({e["pid"] for e in events})
    for pid in pids:
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": f"process {pid}"}})
        for tid, lane in ((0, "phases"), (1, "collectives"),
                          (2, "host"), (3, "events")):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": lane}})

    for s in phase_spans(events):
        out.append({"ph": "X", "pid": s["pid"], "tid": _LANES["phase"],
                    "name": s["name"], "ts": _us(s["t0"], t_base),
                    "dur": max(_us(s["t1"], t_base) - _us(s["t0"], t_base), 1),
                    "args": {"step": s["step"]}})
    for c in collective_spans(events):
        out.append({"ph": "X", "pid": c["pid"], "tid": _LANES["coll"],
                    "name": c["label"], "ts": _us(c["t0"], t_base),
                    "dur": max(_us(c["t1"], t_base) - _us(c["t0"], t_base), 1),
                    "args": {"tag": c["tag"]}})
    for e in events:
        kind = e.get("ev")
        if kind == "span":
            args = {k: v for k, v in e.items()
                    if k not in ("ev", "name", "t0", "t1", "pid")}
            out.append({"ph": "X", "pid": e["pid"], "tid": _LANES["span"],
                        "name": e["name"], "ts": _us(e["t0"], t_base),
                        "dur": max(_us(e["t1"], t_base)
                                   - _us(e["t0"], t_base), 1),
                        "args": args})
        elif kind == "counter":
            out.append({"ph": "C", "pid": e["pid"], "tid": _LANES["counter"],
                        "name": e["name"], "ts": _us(e["ts"], t_base),
                        "args": {e["name"]: e["value"]}})
        elif kind == "instant":
            args = {k: v for k, v in e.items()
                    if k not in ("ev", "name", "ts", "pid")}
            out.append({"ph": "i", "pid": e["pid"], "tid": _LANES["instant"],
                        "name": e["name"], "ts": _us(e["ts"], t_base),
                        "s": "p", "args": args})
        elif kind == "fault":
            # Process-scoped instant ("s": "p") named fault:<kind> so
            # injected faults, step rejections, and signal deaths stand
            # out on the events lane next to the spans they interrupt.
            args = {k: v for k, v in e.items()
                    if k not in ("ev", "kind", "ts", "pid")}
            out.append({"ph": "i", "pid": e["pid"], "tid": _LANES["fault"],
                        "name": f"fault:{e.get('kind', '?')}",
                        "ts": _us(e.get("ts", t_base), t_base),
                        "s": "p", "args": args})
    out.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def merge_dir(events_dir: str, out_path: Optional[str] = None) -> str:
    """Merge every events-p*.jsonl under ``events_dir`` into one
    ``trace.json`` (written into the same dir by default)."""
    events = load_events(events_dir)
    trace = build_trace(events)
    if out_path is None:
        out_path = os.path.join(events_dir, "trace.json")
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path
