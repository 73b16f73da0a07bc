"""``python -m repro_torch.obs report <run_dir>``: render a run's telemetry.

Reads whatever observability artifacts the run directory holds —
``trace.json`` (Chrome trace events), ``metrics.jsonl`` (per-round
registry snapshots), ``records.jsonl`` (round records) — and prints a
per-phase time breakdown table plus the top-k slowest clients from the
virtual-clock task spans.  A copy of the JAX package's ``obs/report.py``:
either package's report renders either package's run directory.  Robust
to partial runs: each table is skipped with a note when its source file is
absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Iterable, TextIO

TRACE_FILE = "trace.json"
METRICS_FILE = "metrics.jsonl"
RECORDS_FILE = "records.jsonl"


def _fmt_table(rows: list[list[str]], header: list[str], out: TextIO) -> None:
    widths = [len(h) for h in header]
    for row in rows:
        widths = [max(w, len(cell)) for w, cell in zip(widths, row)]
    line = "  ".join(h.ljust(w) for h, w in zip(header, widths))
    out.write(line.rstrip() + "\n")
    out.write("  ".join("-" * w for w in widths) + "\n")
    for row in rows:
        out.write("  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip() + "\n")


def _load_trace_events(path: str) -> list[dict[str, Any]]:
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [ev for ev in events if isinstance(ev, dict)]


def phase_breakdown(events: Iterable[dict[str, Any]]) -> dict[str, dict[str, dict[str, float]]]:
    """Per-clock (``cat``), per-phase-name count/total from complete spans."""
    out: dict[str, dict[str, dict[str, float]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        clock = ev.get("cat", "host")
        row = out.setdefault(clock, {}).setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        row["count"] += 1
        row["total_s"] += ev.get("dur", 0.0) / 1e6
    return out


def slowest_tracks(events: Iterable[dict[str, Any]], top_k: int) -> list[tuple[str, float, int]]:
    """Top-k tracks by total virtual 'task' span time (slowest clients)."""
    names: dict[tuple[int, int], str] = {}
    totals: dict[tuple[int, int], tuple[float, int]] = {}
    for ev in events:
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[key] = ev.get("args", {}).get("name", str(key))
        elif ev.get("ph") == "X" and ev.get("cat") == "virtual" and ev.get("name") == "task":
            total, count = totals.get(key, (0.0, 0))
            totals[key] = (total + ev.get("dur", 0.0) / 1e6, count + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top_k]
    return [(names.get(key, str(key)), total, count) for key, (total, count) in ranked]


def _read_jsonl(path: str) -> list[dict[str, Any]]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def render_report(run_dir: str, top_k: int = 5, out: TextIO | None = None) -> int:
    out = out or sys.stdout
    if not os.path.isdir(run_dir):
        out.write(f"error: run dir not found: {run_dir}\n")
        return 2
    out.write(f"# observability report: {run_dir}\n")

    records_path = os.path.join(run_dir, RECORDS_FILE)
    if os.path.exists(records_path):
        records = _read_jsonl(records_path)
        total = sum(r.get("round_time_s", r.get("wall_time_s", 0.0)) for r in records)
        out.write(f"\nrounds: {len(records)}   total round time: {total:.3f}s\n")
    else:
        out.write(f"\n(no {RECORDS_FILE})\n")

    trace_path = os.path.join(run_dir, TRACE_FILE)
    if os.path.exists(trace_path):
        events = _load_trace_events(trace_path)
        breakdown = phase_breakdown(events)
        for clock in ("host", "virtual"):
            phases = breakdown.get(clock)
            if not phases:
                continue
            grand = sum(row["total_s"] for row in phases.values())
            out.write(f"\n## per-phase time breakdown ({clock} clock)\n")
            rows = [
                [
                    name,
                    f"{int(row['count'])}",
                    f"{row['total_s']:.4f}",
                    f"{100.0 * row['total_s'] / grand:.1f}%" if grand else "-",
                ]
                for name, row in sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])
            ]
            _fmt_table(rows, ["phase", "count", "total_s", "share"], out)
        slow = slowest_tracks(events, top_k)
        if slow:
            out.write(f"\n## top-{top_k} slowest clients (virtual task time)\n")
            _fmt_table(
                [[track, f"{total:.4f}", f"{count}"] for track, total, count in slow],
                ["client", "task_s", "tasks"],
                out,
            )
    else:
        out.write(f"\n(no {TRACE_FILE}: submit with an 'observability' section to record spans)\n")

    metrics_path = os.path.join(run_dir, METRICS_FILE)
    if os.path.exists(metrics_path):
        lines = _read_jsonl(metrics_path)
        if lines:
            last = lines[-1]
            out.write(f"\n## final metrics snapshot ({len(lines)} rounds streamed)\n")
            rows = [[name, f"{value}"] for name, value in sorted(last.get("counters", {}).items())]
            rows += [[name, f"{value:.6g}"] for name, value in sorted(last.get("gauges", {}).items())]
            _fmt_table(rows, ["metric", "value"], out)
    else:
        out.write(f"\n(no {METRICS_FILE})\n")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description="Observability report tooling."
    )
    sub = parser.add_subparsers(dest="command", required=True)
    report = sub.add_parser("report", help="render a run directory's telemetry")
    report.add_argument("run_dir", help="run directory (job.json, records.jsonl, ...)")
    report.add_argument("--top", type=int, default=5, help="top-k slowest clients")
    args = parser.parse_args(argv)
    if args.command == "report":
        return render_report(args.run_dir, top_k=args.top)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
