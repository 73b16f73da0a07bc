#!/usr/bin/env python3
"""Times of the GRU kernels on one card: per call and on the device alone,
at B=128, T=24, N=32, for one client and for 35 clients in one launch.

    python3 tools/time_gru_kernels.py [--src DIR] [--steps 1,12,24,48]

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
timed (default: this checkout's), so that two trees can be timed in turns
on one card, each in its own process.  The timing is ``chip_smoke.py``'s
``gru_times``, and, where the tree's backward has stage wrappers, its
``gru_stage_ms``; ``--steps`` adds the stages' device times at each T
listed (B=128, N=32), which separates a launch's fixed cost from its cost
a step.  Prints the card's name and power limit, then one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory that holds repro_torch")
    parser.add_argument("--steps", default="",
                        help="comma-separated T at which to time the backward's stages")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_gru_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.gru_scan import kernel as K

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": str(args.src), "times": chip_smoke.gru_times(torch, dev, K)}
    if hasattr(K, "stage_recur"):  # the two-stage backward: each stage's device time
        out["bwd_stage_device_ms"] = {
            f"C{c}": chip_smoke.gru_stage_ms(torch, dev, K, c, 128, 24, 32)
            for c in (1, chip_smoke.COHORT)}
        out["bwd_stage_device_ms_by_T"] = {
            f"C{c}": {t: chip_smoke.gru_stage_ms(torch, dev, K, c, 128, t, 32)
                      for t in (int(x) for x in args.steps.split(",") if x)}
            for c in (1, chip_smoke.COHORT)} if args.steps else {}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
