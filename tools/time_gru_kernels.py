#!/usr/bin/env python3
"""Times of the GRU kernels on one card: per call and on the device alone,
at B=128, T=24, N=32, for one client and for 35 clients in one launch.

    python3 tools/time_gru_kernels.py [--src DIR] [--steps 1,12,24,48]

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
timed (default: this checkout's), so that two trees can be timed in turns
on one card, each in its own process.  The timing is ``chip_smoke.py``'s
``gru_times``, and, where the tree's backward has this tree's stage
entry points, its ``gru_stage_ms``; ``--steps`` adds the forward's and the backward stages'
device times at each T listed (B=128, N=32, one client and 35), which
separates a launch's fixed cost from its cost a step.  Prints the card's
name and power limit, then one JSON line, which also holds ptxas' registers
and spills for each GRU kernel of the tree's build.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


TEMPLATE_ARG = re.compile(r"(f)|13__nv_bfloat16|6__half|Li(\d+)E|Lb([01])E")


def template_args(mangled: str) -> str:
    """``<float,4,true>`` from the mangled template arguments ``IfLi4ELb1EE``."""
    names = []
    for m in TEMPLATE_ARG.finditer(mangled):
        if m.group(1):
            names.append("float")
        elif m.group(2):
            names.append(m.group(2))
        elif m.group(3):
            names.append("true" if m.group(3) == "1" else "false")
        else:
            names.append("bf16" if "bfloat16" in m.group(0) else "half")
    return f"<{','.join(names)}>" if names else ""


def ptxas_report(log: str) -> dict[str, str]:
    """``kernel<args> -> "R registers, S bytes spill stores, L bytes spill
    loads"`` from an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            k = re.search(r"\d+((?:gru|ssd)_\w*?kernel)((?:I(?:f|13__nv_bfloat16|6__half|Li\d+E"
                          r"|Lb[01]E)+E)?)", m.group(1))
            name = k.group(1) + template_args(k.group(2)) if k else m.group(1)
            out[name] = ""
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name] += f"{m.group(1)} bytes spill stores, {m.group(2)} bytes spill loads"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{m.group(1)} registers, " + out[name]
    return out


def fwd_call(torch, dev, K, c: int, b: int, t: int):
    """A ``gru_scan`` call at N=32 on seeded inputs (C clients, B rows, T steps)."""
    import chip_smoke

    xg, w, bias, _ = chip_smoke.gru_inputs(torch, dev, None if c == 1 else c, b, t, 32,
                                           seed=400 + c)
    return lambda: K.gru_scan(xg, w, bias)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory that holds repro_torch")
    parser.add_argument("--steps", default="",
                        help="comma-separated T at which to time the forward and the backward's stages")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_gru_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import backend
    from repro_torch.kernels.gru_scan import kernel as K

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    steps = [int(x) for x in args.steps.split(",") if x]
    out = {"src": str(args.src),
           "ptxas": ptxas_report(backend.build("gru_scan").with_suffix(".log").read_text()),
           "times": chip_smoke.gru_times(torch, dev, K)}
    predict = fwd_call(torch, dev, K, 1, 2048, 24)   # the predict batches' shape
    out["fwd_B2048"] = {"call_ms": chip_smoke.time_ms(torch, predict, iters=200),
                        "device_ms": chip_smoke.graph_ms(torch, predict)}
    out["fwd_device_ms_by_T"] = {
        f"C{c}": {t: chip_smoke.graph_ms(torch, fwd_call(torch, dev, K, c, 128, t)) for t in steps}
        for c in (1, chip_smoke.COHORT)}
    # The two-stage backward with this tree's stage entry points (each taking
    # the wide kernels' scratch): each stage's device time.
    if hasattr(K, "stage_recur") and "gru_wide_scratch" in K._SIGNATURES:
        out["bwd_stage_device_ms"] = {
            f"C{c}": chip_smoke.gru_stage_ms(torch, dev, K, c, 128, 24, 32)
            for c in (1, chip_smoke.COHORT)}
        out["bwd_stage_device_ms_by_T"] = {
            f"C{c}": {t: chip_smoke.gru_stage_ms(torch, dev, K, c, 128, t, 32) for t in steps}
            for c in (1, chip_smoke.COHORT)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
