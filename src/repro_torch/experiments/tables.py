"""Produce the paper's tables/figures from experiment runs.

  Table 4 — central + Federated-{AC, SC, ARC, SRC} with significance stars
            vs Federated-SC (Welch, * p<0.05, ** p<0.01 across seeds)
  Table 5 — quality-greedy / data-greedy recruitment ablations
  Fig. 2  — gamma_th sweep: runtime vs MSLE / MAE vs number recruited

The port of the JAX package's ``experiments/tables.py``: the same tables
from the port's ``run_seeds``, on ``exp.device`` (the card unless it says
``"cpu"``).  Results go to ``results/torch/paper/`` at the repo root.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.experiments.paper import ExperimentConfig, run_seeds
from repro_torch.metrics.stats import significance_stars, welch_t_test

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch" / "paper"

TABLE4_SETTINGS = ("central", "federated-ac", "federated-sc", "federated-arc", "federated-src")
TABLE5_SETTINGS = ("federated-src-qg", "federated-src-dg")
FIG2_GAMMA_THS = (0.05, 0.1, 0.2, 0.4, 0.7, 1.0)


def run_table4(exp: ExperimentConfig, seeds: list[int]) -> dict[str, Any]:
    results = {s: run_seeds(s, exp, seeds) for s in TABLE4_SETTINGS}
    _attach_significance(results, baseline="federated-sc")
    return results


def run_table5(exp: ExperimentConfig, seeds: list[int]) -> dict[str, Any]:
    return {s: run_seeds(s, exp, seeds) for s in TABLE5_SETTINGS}


def run_fig2(exp: ExperimentConfig, seeds: list[int], gamma_ths: list[float]) -> list[dict]:
    points = []
    for gth in gamma_ths:
        e = dataclasses.replace(exp, gamma_th=gth)
        agg = run_seeds("federated-src", e, seeds)
        points.append(
            {
                "gamma_th": gth,
                "recruited": agg["recruited"],
                "msle": agg["msle"],
                "mae": agg["mae"],
                "tau_s": agg["tau_s"],
                "local_steps": agg["local_steps"],
            }
        )
        print(f"  [fig2 gamma_th={gth}] recruited={agg['recruited']} "
              f"msle={agg['msle']['mean']:.3f} tau={agg['tau_s']['mean']:.1f}s", flush=True)
    return points


def _attach_significance(results: dict[str, Any], baseline: str) -> None:
    base = results[baseline]
    for name, agg in results.items():
        stars = {}
        if name != baseline:
            for metric in ("mae", "mape", "mse", "msle"):
                _, p = welch_t_test(
                    np.asarray(agg[metric]["values"]), np.asarray(base[metric]["values"])
                )
                stars[metric] = {"p": p, "stars": significance_stars(p)}
        agg["significance_vs_sc"] = stars


LABELS = {
    "central": "Central", "federated-ac": "Federated-AC", "federated-sc": "Federated-SC",
    "federated-arc": "Federated-ARC", "federated-src": "Federated-SRC",
    "federated-src-qg": "Federated-SRC-QG", "federated-src-dg": "Federated-SRC-DG",
}


def to_markdown_table4(results: dict[str, Any]) -> str:
    header = "| Model | MAE | MAPE | MSE | MSLE | tau(s) | clients | steps |\n|---|---|---|---|---|---|---|---|"
    rows = [header]
    for name, agg in results.items():
        sig = agg.get("significance_vs_sc", {})

        def cell(metric):
            s = sig.get(metric, {}).get("stars", "")
            return f"{agg[metric]['mean']:.2f} ± {agg[metric]['std']:.2f}{s}"

        fed = agg["federation_size"] if agg["federation_size"] is not None else "-"
        rows.append(
            f"| {LABELS.get(name, name)} | {cell('mae')} | {cell('mape')} | {cell('mse')} "
            f"| {cell('msle')} | {agg['tau_s']['mean']:.0f} ± {agg['tau_s']['std']:.0f} "
            f"| {fed} | {agg['local_steps']} |"
        )
    return "\n".join(rows)


def save(obj: Any, name: str) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / name
    out.write_text(json.dumps(obj, indent=1))
    return out
