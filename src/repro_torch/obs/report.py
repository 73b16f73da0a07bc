"""``python -m repro_torch.obs report <run_dir>``: render a run's telemetry.

Reads whatever observability artifacts the run directory holds —
``trace.json`` (Chrome trace events), ``metrics.jsonl`` (per-round
registry snapshots), ``records.jsonl`` (round records) — and prints a
per-phase time breakdown table plus the top-k slowest clients from the
virtual-clock task spans.  A copy of the JAX package's ``obs/report.py``:
either package's report renders either package's run directory.  Robust
to partial runs: each table is skipped with a note when its source file is
absent.

The port's report adds one table where the run traced device spans (its
``trace.json`` carries ``baseTimeNanoseconds``) and ``RoundProfiler`` wrote
``torch_profile/rounds_*.pt.trace.json``: the device's idle gaps in the
profiled rounds, each put down to the innermost host span open at the
gap's start on the clock both documents share, summed by span name.
Without those files it prints what the reference prints.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import sys
from typing import Any, Iterable, TextIO

TRACE_FILE = "trace.json"
METRICS_FILE = "metrics.jsonl"
RECORDS_FILE = "records.jsonl"
PROFILE_GLOB = os.path.join("torch_profile", "rounds_*.pt.trace.json")
# The profiler's event categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "(no span)"


def _fmt_table(rows: list[list[str]], header: list[str], out: TextIO) -> None:
    widths = [len(h) for h in header]
    for row in rows:
        widths = [max(w, len(cell)) for w, cell in zip(widths, row)]
    line = "  ".join(h.ljust(w) for h, w in zip(header, widths))
    out.write(line.rstrip() + "\n")
    out.write("  ".join("-" * w for w in widths) + "\n")
    for row in rows:
        out.write("  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip() + "\n")


def _trace_events(doc: Any) -> list[dict[str, Any]]:
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


def idle_by_span(trace_doc: dict[str, Any], profile_doc: dict[str, Any]
                 ) -> dict[str, dict[str, float]] | None:
    """The device's idle gaps in ``profile_doc`` (a ``torch.profiler``
    Chrome export), each put down to the innermost host span of
    ``trace_doc`` (the tracer's export) open at the gap's start, summed by
    span name: ``{name: {"gaps", "idle_s"}}``, :data:`NO_SPAN` where none is
    open.  Both documents' ``ts`` are put on ``trace_doc``'s through their
    ``baseTimeNanoseconds``; None when either lacks it."""
    base, other = trace_doc.get("baseTimeNanoseconds"), profile_doc.get("baseTimeNanoseconds")
    if base is None or other is None:
        return None
    shift = (int(other) - int(base)) / 1e3   # microseconds, taken exactly
    ops = sorted((e["ts"] + shift, e["ts"] + shift + e.get("dur", 0.0))
                 for e in profile_doc.get("traceEvents", [])
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    gaps, end = [], None
    for start, stop in ops:
        if end is not None and start > end:
            gaps.append((end, start))
        end = stop if end is None else max(end, stop)
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
             for e in trace_doc.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("cat") == "host"]
    # The innermost span over each piece between two span boundaries: the
    # spans painted longest first, so a shorter one inside overwrites.
    bounds = sorted({t for start, stop, _ in spans for t in (start, stop)})
    owner: list[str] = [NO_SPAN] * len(bounds)
    for start, stop, name in sorted(spans, key=lambda s: s[0] - s[1]):
        for k in range(bisect.bisect_left(bounds, start), bisect.bisect_left(bounds, stop)):
            owner[k] = name
    out: dict[str, dict[str, float]] = {}
    for start, stop in gaps:
        k = bisect.bisect_right(bounds, start) - 1
        row = out.setdefault(owner[k] if k >= 0 else NO_SPAN, {"gaps": 0, "idle_s": 0.0})
        row["gaps"] += 1
        row["idle_s"] += (stop - start) / 1e6
    return out


def _idle_table(run_dir: str, events: list[dict[str, Any]], base: Any, out: TextIO) -> None:
    """The idle-by-span table over the run's profiled rounds, if any."""
    paths = sorted(glob.glob(os.path.join(run_dir, PROFILE_GLOB)))
    if base is None or not paths:
        return
    totals: dict[str, dict[str, float]] = {}
    for path in paths:
        with open(path) as fh:
            rows = idle_by_span({"traceEvents": events, "baseTimeNanoseconds": base},
                                json.load(fh)) or {}
        for name, row in rows.items():
            total = totals.setdefault(name, {"gaps": 0, "idle_s": 0.0})
            total["gaps"] += row["gaps"]
            total["idle_s"] += row["idle_s"]
    grand = sum(row["idle_s"] for row in totals.values())
    if not grand:
        return
    out.write(f"\n## device idle by host span ({len(paths)} profiled segment(s))\n")
    rows = [[name, f"{int(row['gaps'])}", f"{row['idle_s']:.4f}",
             f"{100.0 * row['idle_s'] / grand:.1f}%"]
            for name, row in sorted(totals.items(), key=lambda kv: -kv[1]["idle_s"])]
    _fmt_table(rows, ["span", "gaps", "idle_s", "share"], out)


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
        with open(trace_path) as fh:
            doc = json.load(fh)
        events = _trace_events(doc)
        breakdown = phase_breakdown(events)
        for clock in ("host", "virtual", "device"):
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
        base = doc.get("baseTimeNanoseconds") if isinstance(doc, dict) else None
        _idle_table(run_dir, events, base, out)
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
