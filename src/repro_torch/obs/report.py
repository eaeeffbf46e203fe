"""Snapshot + renderer: where a run's time and data actually went.

`phase_breakdown` turns the recorded spans into the
Bendechache-et-al.-style per-phase table (local mining vs aggregation
vs I/O — here: parse, sweep, merge, checkpoint, scoring), one row per
span name with count, total wall time, and p50/p99.  Two sources:

  * **live** (``events=None``) — the in-process ``span.*`` histograms:
    quantiles derived from the log buckets, nothing retained per call;
  * **a JSONL sink file** (``events=load_jsonl(path)``) — exact
    durations from the event stream, for post-mortem rendering of a
    finished run (``python -m repro_torch.obs.report --jsonl <file>``).

`snapshot` is the programmatic API a serving plane reads its p50/p99
numbers from (the ``span.serve.assign`` histogram).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import metrics, trace

__all__ = ["snapshot", "phase_breakdown", "render_report", "main"]

_SPAN_PREFIX = "span."


def snapshot() -> dict:
    """Everything at once: the metrics snapshot + the buffered events."""
    return {"metrics": metrics.snapshot(), "events": trace.ring_events()}


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def phase_breakdown(events: Optional[List[dict]] = None) -> List[dict]:
    """Per-phase rows, longest total first: ``{"phase", "count",
    "total_s", "mean_ms", "p50_ms", "p99_ms"}``."""
    rows = []
    if events is None:
        snap = metrics.snapshot()["histograms"]
        for key, h in snap.items():
            if not key.startswith(_SPAN_PREFIX) or not h["count"]:
                continue
            rows.append({"phase": key[len(_SPAN_PREFIX):],
                         "count": h["count"],
                         "total_s": h["sum"],
                         "mean_ms": h["sum"] / h["count"] * 1e3,
                         "p50_ms": h["p50"] * 1e3,
                         "p99_ms": h["p99"] * 1e3})
    else:
        by_name: dict = {}
        for ev in events:
            if ev.get("kind") == "span" and "dur_s" in ev:
                by_name.setdefault(ev["name"], []).append(
                    float(ev["dur_s"]))
        for name, durs in by_name.items():
            durs.sort()
            total = sum(durs)
            rows.append({"phase": name, "count": len(durs),
                         "total_s": total,
                         "mean_ms": total / len(durs) * 1e3,
                         "p50_ms": _percentile(durs, 0.50) * 1e3,
                         "p99_ms": _percentile(durs, 0.99) * 1e3})
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def _fmt_phase_table(rows: List[dict]) -> List[str]:
    if not rows:
        return ["  (no spans recorded)"]
    head = f"  {'phase':<28}{'count':>8}{'total_s':>10}" \
           f"{'mean_ms':>10}{'p50_ms':>10}{'p99_ms':>10}"
    out = [head, "  " + "-" * (len(head) - 2)]
    for r in rows:
        out.append(f"  {r['phase']:<28}{r['count']:>8}"
                   f"{r['total_s']:>10.3f}{r['mean_ms']:>10.3f}"
                   f"{r['p50_ms']:>10.3f}{r['p99_ms']:>10.3f}")
    return out


def _metrics_from_events(events: List[dict]) -> Optional[dict]:
    """The trailing metrics-snapshot line of a JSONL sink, if present
    (the newest wins when a file somehow holds several)."""
    snap = None
    for ev in events:
        if ev.get("kind") == "snapshot" and isinstance(
                ev.get("metrics"), dict):
            snap = ev["metrics"]
    return snap


def render_report(events: Optional[List[dict]] = None, *,
                  top_events: int = 0) -> str:
    """The human-readable run report: phase breakdown, counters,
    gauges — from the live registry, or from a JSONL event list."""
    snap = (_metrics_from_events(events) if events is not None
            else metrics.snapshot()) or {"counters": {}, "gauges": {}}
    lines = ["== phase breakdown (spans) =="]
    lines += _fmt_phase_table(phase_breakdown(events))
    if snap["counters"]:
        lines.append("== counters ==")
        for k in sorted(snap["counters"]):
            lines.append(f"  {k:<44}{snap['counters'][k]:>14,.0f}")
    if snap["gauges"]:
        lines.append("== gauges (last / max) ==")
        for k in sorted(snap["gauges"]):
            g = snap["gauges"][k]
            lines.append(f"  {k:<44}{g['value']:>8.0f} /"
                         f" {g['max']:>8.0f}")
    if top_events:
        evs = events if events is not None else trace.ring_events()
        point = [e for e in evs if e.get("kind") == "event"]
        if point:
            lines.append(f"== last {min(top_events, len(point))} "
                         "events ==")
            for e in point[-top_events:]:
                extra = {k: v for k, v in e.items()
                         if k not in ("kind", "name", "ts", "thread")}
                lines.append(f"  {e['name']}: {extra}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a run's observability report (phase "
                    "breakdown + latency quantiles + counters).")
    p.add_argument("--jsonl", default=None,
                   help="events.jsonl sink file to render (default: "
                        "$REPRO_OBS_DIR/events.jsonl, else the live "
                        "in-process registry)")
    p.add_argument("--events", type=int, default=0, metavar="N",
                   help="also print the last N point events")
    args = p.parse_args(argv)
    path = args.jsonl or trace.default_jsonl_path()
    events = trace.load_jsonl(path) if path else None
    print(render_report(events, top_events=args.events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
