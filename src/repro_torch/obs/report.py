"""Render a telemetry events dir: phase breakdown, collective timeline,
Krylov solve convergence, serve latency summary.

    python -m repro_torch.obs.report <events_dir> [--check]

(a copy of ``repro/obs/report.py``.)

``--check`` (CI smoke) exits non-zero unless both the phase and the
collective sections are non-empty — the merged artifact from the
2-process train smoke must actually contain the measured schedule.
"""
from __future__ import annotations

import argparse
import sys

from . import trace as _trace


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:9.3f}"


def _table(rows, header):
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    lines = ["  ".join(str(c).ljust(w) for c, w in zip(header, widths))]
    lines.append("  ".join("-" * w for w in widths))
    lines.extend("  ".join(str(c).ljust(w) for c, w in zip(r, widths))
                 for r in rows)
    return "\n".join(lines)


def phase_breakdown(events):
    agg: dict = {}
    for s in _trace.phase_spans(events):
        n, tot = agg.get(s["name"], (0, 0.0))
        agg[s["name"]] = (n + 1, tot + (s["t1"] - s["t0"]))
    total = sum(t for _, t in agg.values()) or 1.0
    rows = [(name, n, _fmt_ms(t), _fmt_ms(t / n), f"{100 * t / total:5.1f}%")
            for name, (n, t) in sorted(agg.items(),
                                       key=lambda kv: -kv[1][1])]
    return rows


def collective_breakdown(events):
    agg: dict = {}
    for c in _trace.collective_spans(events):
        key = (c["label"], c["tag"])
        n, tot = agg.get(key, (0, 0.0))
        agg[key] = (n + 1, tot + (c["t1"] - c["t0"]))
    rows = [(label, tag, n, _fmt_ms(t), _fmt_ms(t / n))
            for (label, tag), (n, t) in sorted(agg.items(),
                                               key=lambda kv: -kv[1][1])]
    return rows


def solve_summary(events):
    rows = []
    for e in sorted((e for e in events if e.get("ev") == "solve"),
                    key=lambda e: (e["pid"], e.get("step", -1))):
        hist = [h for h in e.get("residual_history", [])
                if isinstance(h, (int, float))]
        first = hist[0] if hist else float("nan")
        last = hist[-1] if hist else e.get("residual", float("nan"))
        red = first / last if hist and last else float("nan")
        rows.append((e["pid"], e.get("step", -1), e.get("iters", 0),
                     e.get("syncs", 0), f"{first:.3e}", f"{last:.3e}",
                     f"{red:9.2f}", e.get("nc_found", False),
                     e.get("breakdown", False)))
    return rows


def serve_summary(events):
    reqs = [e for e in events if e.get("ev") == "span"
            and e.get("name") == "request"]
    if not reqs:
        return None
    lat = sorted(e["t1"] - e["t0"] for e in reqs)
    ttft = sorted(e["ttft_s"] for e in reqs if "ttft_s" in e)

    def pct(xs, p):
        return xs[min(int(p * len(xs)), len(xs) - 1)] if xs else float("nan")

    free = [e["value"] for e in events
            if e.get("ev") == "counter" and e.get("name") == "pages_free"]
    depth = [e["value"] for e in events
             if e.get("ev") == "counter" and e.get("name") == "queue_depth"]
    return dict(n_requests=len(reqs),
                latency_p50_ms=pct(lat, 0.5) * 1e3,
                latency_p95_ms=pct(lat, 0.95) * 1e3,
                ttft_p50_ms=pct(ttft, 0.5) * 1e3,
                min_pages_free=min(free) if free else None,
                mean_queue_depth=(sum(depth) / len(depth)) if depth else None)


def render(events_dir: str, out=None) -> dict:
    out = out if out is not None else sys.stdout
    events = _trace.load_events(events_dir)
    phases = phase_breakdown(events)
    colls = collective_breakdown(events)
    solves = solve_summary(events)
    print(f"telemetry report: {events_dir} "
          f"({len(events)} events, "
          f"{len({e['pid'] for e in events})} process(es))\n", file=out)

    print("== phase breakdown ==", file=out)
    print(_table(phases, ("phase", "count", "total_ms", "mean_ms", "share"))
          if phases else "(no phase events)", file=out)

    print("\n== collective timeline ==", file=out)
    print(_table(colls, ("label", "tag", "count", "total_ms", "mean_ms"))
          if colls else "(no collective events)", file=out)

    ov = _trace.grad_reduce_overlap(events)
    if ov:
        mean_frac = sum(r["frac"] for r in ov) / len(ov)
        print(f"\ngrad-reduce ∩ curvature-primal: mean overlap "
              f"{mean_frac * 100:.1f}% of primal build "
              f"({len(ov)} step(s))", file=out)

    print("\n== solve convergence ==", file=out)
    print(_table(solves, ("pid", "step", "iters", "syncs", "r_first",
                          "r_last", "reduction", "nc", "breakdown"))
          if solves else "(no solve events)", file=out)

    ritz = [e for e in events if e.get("ev") == "ritz"]
    if ritz:
        lo = min(min(e["values"]) for e in ritz if e["values"])
        hi = max(max(e["values"]) for e in ritz if e["values"])
        print(f"\nritz snapshots: {len(ritz)} cycle(s), "
              f"eigenvalue range [{lo:.3e}, {hi:.3e}]", file=out)

    srv = serve_summary(events)
    if srv:
        print("\n== serve ==", file=out)
        for k, v in srv.items():
            print(f"  {k}: {v:.3f}" if isinstance(v, float)
                  else f"  {k}: {v}", file=out)

    return dict(n_phases=len(phases), n_collectives=len(colls),
                n_solves=len(solves), overlap_rows=len(ov))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a telemetry events directory.")
    ap.add_argument("events_dir")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless phase AND collective sections "
                         "are non-empty (CI artifact smoke)")
    args = ap.parse_args(argv)
    stats = render(args.events_dir)
    if args.check and (stats["n_phases"] == 0 or stats["n_collectives"] == 0):
        print("report --check FAILED: empty phase or collective section",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
