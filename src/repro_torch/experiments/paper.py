"""The paper's experiments, end to end, on the synthetic eICU cohort.

Five model settings (paper section 6):

  central        — pooled training, 15 epochs (upper bound)
  federated-ac   — all 189 clients, all participate each round
  federated-sc   — all clients in federation, 10% sampled per round
  federated-arc  — recruited clients only, all participate
  federated-src  — recruited clients only, 10% sampled per round

plus the section 6.2 ablations (quality-greedy / data-greedy).  Every
federated setting is a (recruitment, selection, aggregator) triple of
specs for the ``Federation`` facade (``policies_for``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.recruitment import DATA_GREEDY, QUALITY_GREEDY
from repro_torch.data.pipeline import ArrayDataset, build_client_datasets, global_dataset
from repro_torch.data.synth_eicu import Cohort, CohortConfig, generate_cohort
from repro_torch.device import resolve_device
from repro_torch.federated.api import Federation, FederationConfig
from repro_torch.federated.central import CentralConfig, train_central
from repro_torch.metrics.regression import evaluate_predictions
from repro_torch.models.gru import GRUConfig, gru_apply, init_gru, make_loss_fn
from repro_torch.optim.adamw import AdamW

MODEL_SETTINGS = (
    "central",
    "federated-ac",
    "federated-sc",
    "federated-arc",
    "federated-src",
    "federated-src-qg",
    "federated-src-dg",
)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Paper-faithful defaults (Tables 1 and 3)."""

    cohort_scale: float = 1.0      # 1.0 = full 89,127-stay cohort
    rounds: int = 15
    local_epochs: int = 4
    central_epochs: int = 15
    batch_size: int = 128
    learning_rate: float = 5e-3
    weight_decay: float = 5e-3
    participation_fraction: float = 0.1
    gamma_dv: float = 0.5
    gamma_sa: float = 0.5
    gamma_th: float = 0.1
    # Federated training engine; only "sequential" is ported so far.
    engine: str = "sequential"
    # Policy overrides for the Federation facade (None = the paper's sampling).
    selection: Any = None
    aggregator: Any = "fedavg"
    # Where to train: None is the card; "cpu" runs the plain versions.
    device: str | None = None


def policies_for(setting: str, exp: ExperimentConfig) -> dict[str, Any]:
    """One paper setting -> the three policy specs of the Federation facade."""
    if setting == "federated-src-qg":
        rec: Any = f"nu-greedy:{QUALITY_GREEDY.gamma_dv},{QUALITY_GREEDY.gamma_sa},{exp.gamma_th}"
    elif setting == "federated-src-dg":
        rec = f"nu-greedy:{DATA_GREEDY.gamma_dv},{DATA_GREEDY.gamma_sa},{exp.gamma_th}"
    elif setting in ("federated-arc", "federated-src"):
        rec = f"nu-greedy:{exp.gamma_dv},{exp.gamma_sa},{exp.gamma_th}"
    else:
        rec = "all"
    if exp.selection is not None:
        sel: Any = exp.selection
    elif setting in ("federated-ac", "federated-arc"):
        sel = "uniform"  # everyone, every round
    else:
        # float() keeps the spec grammar honest: an int is a count.
        sel = f"uniform:{float(exp.participation_fraction)}"
    return {"recruitment": rec, "selection": sel, "aggregator": exp.aggregator}


def build_cohort(exp: ExperimentConfig, seed: int) -> Cohort:
    cfg = CohortConfig()
    if exp.cohort_scale != 1.0:
        cfg = cfg.scaled(exp.cohort_scale)
    return generate_cohort(cfg, seed=seed)


def run_setting(
    setting: str,
    exp: ExperimentConfig,
    cohort: Cohort,
    seed: int,
    progress: Any | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Train one model setting and evaluate on the hold-out test split.

    ``device`` (else ``exp.device``) defaults to the card and raises where
    there is none.  ``progress`` receives each federated ``RoundRecord``.
    """
    if setting not in MODEL_SETTINGS:
        raise ValueError(f"unknown setting {setting}; choose from {MODEL_SETTINGS}")
    dev = resolve_device(device if device is not None else exp.device)

    model_cfg = GRUConfig()
    loss_fn = make_loss_fn(model_cfg)
    optimizer = AdamW(learning_rate=exp.learning_rate, weight_decay=exp.weight_decay)
    init_params = init_gru(torch.Generator().manual_seed(seed), model_cfg, dev)
    test = global_dataset(cohort, Cohort.TEST)

    info: dict[str, Any] = {"setting": setting, "seed": seed}
    if setting == "central":
        result = train_central(
            CentralConfig(epochs=exp.central_epochs, batch_size=exp.batch_size, seed=seed),
            global_dataset(cohort, Cohort.TRAIN),
            init_params,
            loss_fn,
            optimizer,
            device=dev,
        )
        params = result.params
        info.update(
            tau_s=result.total_wall_time_s,
            local_steps=result.total_steps,
            federation_size=None,
            federation_ids=None,
            recruited=None,
            engine=None,
            round_times_s=None,
        )
    else:
        fed_cfg = FederationConfig(
            rounds=exp.rounds,
            local_epochs=exp.local_epochs,
            batch_size=exp.batch_size,
            **policies_for(setting, exp),
            seed=seed,
            engine=exp.engine,
        )
        federation = Federation(
            fed_cfg, build_client_datasets(cohort), loss_fn, optimizer, device=dev
        )
        result = federation.run(init_params, progress=progress)
        params = result.params
        summary = result.summary()
        info.update(
            tau_s=result.total_wall_time_s,
            local_steps=result.total_local_steps,
            federation_size=int(result.federation_ids.size),
            federation_ids=result.federation_ids.tolist(),
            recruited=None if result.recruitment is None else result.recruitment.num_recruited,
            engine=federation.effective_engine,
            round_times_s=[r.wall_time_s for r in result.history],
            comm={k: summary[k] for k in ("params_down", "params_up", "bytes_transferred")},
            epsilon=summary["epsilon"],
        )

    y_hat = _predict(params, model_cfg, test)
    info["metrics"] = evaluate_predictions(test.y, y_hat)
    return info


@torch.no_grad()
def _predict(params, model_cfg: GRUConfig, dataset: ArrayDataset, batch: int = 2048) -> np.ndarray:
    """Predictions for ``dataset`` in batches of ``batch``, on the params' device."""
    dev = params["head"]["w"].device
    outs = []
    for start in range(0, len(dataset), batch):
        x = torch.from_numpy(np.ascontiguousarray(dataset.x[start : start + batch])).to(dev)
        outs.append(gru_apply(params, model_cfg, x).cpu().numpy())
    return np.concatenate(outs)


def run_seeds(
    setting: str, exp: ExperimentConfig, seeds: list[int], verbose: bool = True
) -> dict[str, Any]:
    """Multi-seed runs -> mean/std per metric (paper reports mean +/- std)."""
    runs = []
    for seed in seeds:
        cohort = build_cohort(exp, seed=seed)
        out = run_setting(setting, exp, cohort, seed=seed)
        if verbose:
            m = out["metrics"]
            print(
                f"  [{setting} seed={seed}] mae={m['mae']:.3f} mape={m['mape']:.3f} "
                f"mse={m['mse']:.2f} msle={m['msle']:.3f} tau={out['tau_s']:.1f}s",
                flush=True,
            )
        runs.append(out)
    agg: dict[str, Any] = {"setting": setting, "seeds": seeds, "runs": runs}
    for key in ("mae", "mape", "mse", "msle"):
        vals = np.array([r["metrics"][key] for r in runs])
        agg[key] = {"mean": float(vals.mean()), "std": float(vals.std(ddof=1) if len(vals) > 1 else 0.0),
                    "values": vals.tolist()}
    taus = np.array([r["tau_s"] for r in runs])
    agg["tau_s"] = {"mean": float(taus.mean()), "std": float(taus.std(ddof=1) if len(taus) > 1 else 0.0),
                    "values": taus.tolist()}
    agg["local_steps"] = int(np.mean([r["local_steps"] for r in runs]))
    agg["federation_size"] = runs[0]["federation_size"]
    agg["recruited"] = runs[0]["recruited"]
    return agg
