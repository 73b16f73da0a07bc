#!/usr/bin/env python3
"""The SSD kernels' float32 outputs and times on one card, for holding two
trees against each other.

    python3 tools/time_ssd_kernels.py [--src DIR] [--save FILE] [--against FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
run (default: this checkout's), so that two trees can be run in turns on
one card, each in its own process.  At phase 3's five float32 shapes at or
below L = 256, P = 64, N = 128 (the Mamba2 and zamba2 calls, the reduced
config, three chunks of three heads, and an odd one) it runs the forward
with its entry states and the backward on seeded inputs; ``--save`` writes
the SHA-256 of each output's bytes (JSON), ``--against`` reports whether
each equals the saved one's, that is, the same bits.  Then the forward's
and the backward's device times at the Mamba2 and zamba2 shapes
(``chip_smoke.time_ms``: back-to-back calls under CUDA events).  Prints
the card's name and power limit, then one JSON line, which also holds
ptxas' registers and spills for each SSD kernel of the tree's build.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {  # B, NC, L, H, P, N
    "mamba2": (8, 8, 256, 24, 64, 128), "zamba2": (8, 8, 256, 112, 64, 64),
    "reduced": (2, 4, 16, 16, 32, 16), "nc3-h3": (2, 3, 256, 3, 64, 128),
    "odd": (1, 3, 100, 3, 48, 33),
}
TIMED = ("mamba2", "zamba2")


def inputs(torch, dev, shape, seed):
    """chip_smoke's SSD inputs, chunked, with a standard normal dy."""
    import chip_smoke

    x, dt, a, bm, cm = chip_smoke.ssd_inputs(torch, dev, shape, seed)
    dy = torch.randn(tuple(x.shape), generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    return [x, dt, torch.cumsum(dt * a, dim=2), bm, cm], dy


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory that holds repro_torch")
    parser.add_argument("--save", type=Path, help="write the outputs' digests here")
    parser.add_argument("--against", type=Path, help="compare the outputs' digests with these")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_ssd_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import backend
    from repro_torch.kernels.ssd import kernel as SK
    from tools.time_gru_kernels import ptxas_report

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": str(args.src),
           "ptxas": ptxas_report(backend.build("ssd").with_suffix(".log").read_text())}
    outputs = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        xs, dy = inputs(torch, dev, shape, seed=500 + i)
        y, states = SK.ssd_chunk_scan(*xs, return_states=True)
        grads = SK.ssd_chunk_scan_bwd(*xs, states, dy)
        outputs[name] = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                         for t in (y, states, *grads)]
        if name in TIMED:
            out[f"{name}_ms"] = {
                "ssd_chunk_scan": chip_smoke.time_ms(torch, lambda: SK.ssd_chunk_scan(*xs),
                                                     iters=20, warmup=3),
                "ssd_chunk_scan_bwd": chip_smoke.time_ms(
                    torch, lambda: SK.ssd_chunk_scan_bwd(*xs, states, dy), iters=10, warmup=2)}
        del xs, dy, y, states, grads
    if args.save:
        args.save.write_text(json.dumps(outputs))
    if args.against:
        saved = json.loads(args.against.read_text())
        out["bitwise_equal"] = {name: [a == b for a, b in zip(outputs[name], saved[name])]
                                for name in SHAPES}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
