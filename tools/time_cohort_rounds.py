#!/usr/bin/env python3
"""Round times of the cohort engine in one process, on one card: the
federated-arc rounds of ``chip_smoke.py``'s phases 13 and 19.

    python3 tools/time_cohort_rounds.py [--src DIR] [--rounds 2]

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
timed (default: this checkout's), so that two trees can be timed in turns
on one card, each in its own process.  From the seed-0 init at the paper's
width (2×GRU N=32, F=38, T=24, batch 128, 4 local epochs), on the full
synthetic cohort, it runs federated-arc's 35 clients for ``--rounds``
rounds three ways: resident staging, rebuild staging, and resident under
``DPConfig(1.0, 1.0)``.  Only the public facade is called, with no mesh, so
a tree from before the client axis was split runs it too.  Prints the
card's name and power limit, then one JSON line: each run's round times
(host seconds, ended by the round's own synchronize), its batched steps
and its mean local losses.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = {
    "resident": {},
    "rebuild": {"staging": "rebuild"},
    "dp": {"privacy": {"clip_norm": 1.0, "noise_multiplier": 1.0}},
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory that holds repro_torch")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_cohort_rounds: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.experiments.paper import ExperimentConfig, build_cohort, policies_for
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.kernels import backend
    from repro_torch.kernels.gru_scan import kernel as K
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend.build("gru_scan")
    K._library()
    exp = ExperimentConfig(rounds=args.rounds, local_epochs=4)
    clients = build_client_datasets(build_cohort(exp, seed=0))
    out = {"src": str(args.src), "rounds": args.rounds, "runs": {}}
    for name, config in RUNS.items():
        fed = Federation(
            FederationConfig(rounds=exp.rounds, local_epochs=exp.local_epochs,
                             batch_size=exp.batch_size, seed=0,
                             **policies_for("federated-arc", exp), **config),
            clients, make_loss_fn(GRUConfig()),
            AdamW(exp.learning_rate, weight_decay=exp.weight_decay), device="cuda")
        steps = []
        params0 = init_gru(torch.Generator().manual_seed(0), GRUConfig(), "cuda")
        torch.cuda.synchronize()
        result = fed.run(params0, progress=lambda r: steps.append(
            fed.cohort_trainer.last_round_stats["cohort_steps"]))
        out["runs"][name] = {
            "round_times_s": [r.round_time_s for r in result.history],
            "cohort_steps": steps,
            "mean_local_loss": [r.mean_local_loss for r in result.history],
        }
        del fed, result
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
