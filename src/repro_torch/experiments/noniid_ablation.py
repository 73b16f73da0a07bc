"""Beyond-paper ablation: how non-IID strength drives recruitment's value.

The paper's SRC-beats-SC result depends on how heterogeneous the hospitals
are.  We sweep the generator's per-hospital LoS shift (mu_shift) and compare
standard FedAvg (SC) with recruited FedAvg (SRC) at each level: recruitment
should matter more as heterogeneity grows.

    python -m repro_torch.experiments.noniid_ablation --scale 0.3 --seeds 0 1

The port of the JAX package's ``experiments/noniid_ablation.py``: the same
flags, rows and files, plus ``--device`` (default ``cuda``).  The sweep is
``run_noniid_ablation``, which takes an ``ExperimentConfig`` (its
``cohort_scale`` sizes the cohorts, its ``device`` says where to train).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Sequence

import numpy as np

from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
from repro_torch.experiments.paper import ExperimentConfig, run_setting
from repro_torch.experiments.tables import save


def run_noniid_ablation(
    exp: ExperimentConfig,
    shifts: Sequence[float],
    seeds: Sequence[int],
    toxic_clients: bool = False,
) -> list[dict[str, Any]]:
    """One row per ``mu_shift``: SC and SRC test MSLE and tau, means over
    seeds.  ``toxic_clients`` is the real-eICU fidelity mode (tiny
    hospitals, uneven charting quality)."""
    rows = []
    for shift in shifts:
        per_setting = {"federated-sc": [], "federated-src": []}
        taus = {"federated-sc": [], "federated-src": []}
        recruited = None
        for seed in seeds:
            base = CohortConfig(hospital_mu_shift=shift)
            if toxic_clients:
                base = dataclasses.replace(
                    base, min_hospital_size=5, hospital_noise_scale=(0.7, 2.5)
                )
            base = base.scaled(exp.cohort_scale)
            if toxic_clients:
                base = dataclasses.replace(base, min_hospital_size=5)
            cohort = generate_cohort(base, seed=seed)
            for setting in per_setting:
                out = run_setting(setting, exp, cohort, seed=seed)
                per_setting[setting].append(out["metrics"]["msle"])
                taus[setting].append(out["tau_s"])
                if setting == "federated-src":
                    recruited = out["recruited"]
        row = {
            "mu_shift": shift,
            "recruited": recruited,
            "sc_msle": float(np.mean(per_setting["federated-sc"])),
            "src_msle": float(np.mean(per_setting["federated-src"])),
            "sc_tau": float(np.mean(taus["federated-sc"])),
            "src_tau": float(np.mean(taus["federated-src"])),
        }
        row["src_advantage"] = row["sc_msle"] - row["src_msle"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--shifts", type=float, nargs="+", default=[0.1, 0.35, 0.8, 1.4])
    ap.add_argument(
        "--toxic-clients",
        action="store_true",
        help="real-eICU fidelity mode: tiny hospitals (min 5 stays) with "
        "heterogeneous charting quality (feature noise x0.7-2.5)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    exp = ExperimentConfig(cohort_scale=args.scale, device=args.device)
    rows = run_noniid_ablation(exp, args.shifts, args.seeds, args.toxic_clients)

    suffix = "_toxic" if args.toxic_clients else ""
    save(rows, f"noniid_ablation_scale{args.scale}{suffix}.json")
    print("\n| mu_shift | recruited | SC msle | SRC msle | SRC advantage | SC tau | SRC tau |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['mu_shift']} | {r['recruited']} | {r['sc_msle']:.4f} | {r['src_msle']:.4f} "
            f"| {r['src_advantage']:+.4f} | {r['sc_tau']:.0f}s | {r['src_tau']:.0f}s |"
        )


if __name__ == "__main__":
    main()
