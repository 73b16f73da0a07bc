"""The traced segment: ``torch.profiler`` around a fixed amount of work,
reduced to device operations, busy time and the longest idle gaps."""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class Session:
    """``torch.profiler`` over the device alone (kernels, copies, memsets and
    the CUDA runtime calls that launch them; no host operator is recorded,
    though CUPTI's record of each kernel still lengthens a replayed graph)
    from a synchronize to
    ``finish``, which waits for the device and reduces the trace: the
    device events ``(name, start_s, dur_s)``, the runtime calls, the traced
    window's host seconds and the device's busy seconds (the union of its
    operations' intervals).  A trivial traced operation first takes the
    profiler's own start-up out of the window."""

    def __init__(self, device):
        import torch

        self.device = device
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        torch.cuda.synchronize(device)
        self.t0 = time.perf_counter()

    def finish(self) -> dict:
        import torch

        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text())
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        return reduce_events(events, window_s)


def profile(work, device) -> dict:
    """``work()`` traced by a :class:`Session`."""
    session = Session(device)
    work()
    return session.finish()


def reduce_events(events: list, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        item = (e.get("name", "?"), float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
        if cat in DEVICE_CATS:
            dev.append(item)
        elif cat in HOST_CATS:
            host.append(item)
    dev.sort(key=lambda x: x[1])
    busy, gaps = 0.0, []
    cur_start = cur_end = None
    for _, start, dur in dev:
        end = start + dur
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy += cur_end - cur_start
            gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return {"device": dev, "host": host, "window_s": window_s, "busy_s": busy, "gaps": gaps}


def by_name(dev: list) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, _, dur in dev:
        out[name] = out.get(name, 0.0) + dur
    return out


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps,
    each named by what the host was doing: the runtime call it was in at
    the gap's start, or else the call that ended the gap, after host work
    (``host, then cudaGraphLaunch``)."""
    ops = sorted(by_name(trace["device"]).items(), key=lambda kv: -kv[1])[:top]
    host = sorted(trace["host"], key=lambda x: x[1])
    gaps = sorted(trace["gaps"], key=lambda g: g[0] - g[1])[:top]
    named = []
    for start, end in gaps:
        covering = [h for h in host if h[1] <= start <= h[1] + h[2]]
        if covering:
            name = min(covering, key=lambda h: h[2])[0]
        else:
            later = [h for h in host if h[1] > start]
            name = f"host, then {later[0][0]}" if later else "host"
        named.append([name, end - start])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def family_seconds(trace: dict, patterns: list[str]) -> float:
    """Device seconds of the operations whose names contain any pattern."""
    return sum(d for n, _, d in trace["device"] if any(p in n for p in patterns))
