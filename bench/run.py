"""The port's benchmark: one cell of ``BENCHMARK.json``, one run, one result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The cell's configuration, traffic and per-layer metrics are
files under ``bench/`` found by the names in ``BENCHMARK.json``; the traffic
file's ``kind`` names the driver in ``bench/drivers/``.  With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read by ``bench/metrics/<name>.py`` from the driver's
context and a profiled segment after the window.  Every run checks what the
timed path produced against the configuration's plain reference and prints
each compared number beside its limit.  Exits non-zero, printing no result,
without enough CUDA devices, or when JAX or the JAX package ``repro`` was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from harness import common  # noqa: E402


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def per_layer(cell: dict, ctx: dict) -> dict:
    """Each per-layer metric's reader, run on the driver's context; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for metric in cell["per_layer"]:
        path = BENCH / "metrics" / f"{metric['name']}.py"
        reader = common.load_module(path, "metric_" + metric["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def execute(cell: dict, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> tuple[dict, list[dict]]:
    """One run of ``cell`` on ``device``: the result line's fields and the
    compared numbers."""
    driver = common.load_module(BENCH / "drivers" / f"{cell['traffic']['kind']}.py",
                                "driver_" + cell["traffic"]["kind"])
    out = driver.run(cell, seed, seconds, trace, device, t_start)
    if trace:
        metrics = per_layer(cell, out["ctx"])
    else:
        wanted = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {k: {"value": values[k], "unit": unit} for k, unit in wanted.items()}
    result = {
        "correct": all(c["ok"] for c in out["checks"]),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": out["peak_bytes"]},
    }
    traced = out["ctx"].get("trace")
    if trace and traced is not None:
        from harness import profile

        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = profile.breakdown(traced)
    return result, out["checks"]


def main(argv=None) -> int:
    args = parse(argv)
    try:
        common.cache_dirs()
        cell = common.find_cell(args.workload)
        kind = common.cuda_devices(cell["chips"])
        result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                 T_START)
        found = common.forbidden_modules(list(sys.modules))
        if found:
            raise common.RunFailed(f"modules of JAX or the JAX package were loaded: {found}")
    except common.RunFailed as err:
        print(f"bench: {err}", file=sys.stderr)
        return 2
    result["device"] = {"platform": "gpu", "kind": kind, "count": cell["chips"],
                        **result["device"]}
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
