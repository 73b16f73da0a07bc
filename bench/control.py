"""The readings that a cell's correctness limits are set from, on the card.

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--modes program,control,half_batch]

For each seed, in one process: ``program`` runs the cell with a window of
the traffic's ``control_seconds`` (none where it has none) and prints the
compared numbers (the lower readings);
``control`` puts the configuration's reference in the program's place in
the nearest precision below the configuration's (the upper readings);
every other mode plants that fault in the reference put in the program's
place (``half_batch``: every step trains on half its batch, the mean taken
over that half; ``params_unwritten``, a train cell's: every step updates
AdamW's moments and leaves the params as they were).  One JSON line a seed and mode.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import run as bench_run  # noqa: E402
from harness import common  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--modes", default="program,control")
    args = parser.parse_args(argv)
    common.cache_dirs()
    cell = common.find_cell(args.workload)
    common.cuda_devices(cell["chips"])
    driver = common.load_module(BENCH / "drivers" / f"{cell['traffic']['kind']}.py",
                                "driver_" + cell["traffic"]["kind"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            if mode == "program":
                seconds = cell["traffic"].get("control_seconds", 0.0)
                result, checks = bench_run.execute(cell, seed, seconds, False, "cuda", t0)
                extra = {"correct": result["correct"], "setup_s": result["metrics"]["setup_s"]}
            else:
                checks = driver.control(cell, seed, "cuda", mode)
                extra = {}
            print(json.dumps({"workload": cell["name"], "seed": seed, "mode": mode,
                              "seconds": time.perf_counter() - t0,
                              "numbers": {c["name"]: c["value"] for c in checks}, **extra}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
