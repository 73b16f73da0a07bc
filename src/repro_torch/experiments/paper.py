"""The paper's experiments, end to end, on the synthetic eICU cohort.

Five model settings (paper section 6):

  central        — pooled training, 15 epochs (upper bound)
  federated-ac   — all 189 clients, all participate each round
  federated-sc   — all clients in federation, 10% sampled per round
  federated-arc  — recruited clients only, all participate
  federated-src  — recruited clients only, 10% sampled per round

plus the section 6.2 ablations (quality-greedy / data-greedy).  Every
federated setting is a (recruitment, selection, aggregator) triple of
specs for the ``Federation`` facade (``policies_for``).  ``run_paper_scale``
runs the five settings at 189 clients on both engines,
``run_staging_comparison`` the vectorized engine's staging variants,
``run_facade_overhead`` and ``run_obs_overhead`` the facade's and the
observability tier's cost over the bare cohort loop,
``run_privacy_frontier`` the privacy tier's utility and robustness
frontiers, and ``run_async_comparison`` recruited against all-clients
federations on the async runtime's virtual clock (``time_to_target``).
``job_spec_for`` renders a setting as a control-plane job spec,
``run_settings_as_jobs`` submits settings through the control plane and
``run_service_overhead`` times the control plane against a direct run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.capture import GraphCache, capture_enabled
from repro_torch.core.recruitment import DATA_GREEDY, QUALITY_GREEDY
from repro_torch.data.pipeline import (
    ArrayDataset,
    build_client_datasets,
    cohort_steps_per_epoch,
    global_dataset,
)
from repro_torch.data.synth_eicu import NUM_HOSPITALS, Cohort, CohortConfig, generate_cohort
from repro_torch.device import resolve_device
from repro_torch.federated.api import Federation, FederationConfig
from repro_torch.federated.cohort import CohortTrainer, client_generators
from repro_torch.federated.central import CentralConfig, train_central
from repro_torch.federated.runtime.async_federation import (
    AsyncFederation,
    AsyncFederationConfig,
)
from repro_torch.launch.mesh import resolve_mesh
from repro_torch.metrics.regression import evaluate_predictions
from repro_torch.models.gru import GRUConfig, gru_apply, init_gru, make_loss_fn
from repro_torch.optim.adamw import AdamW
from repro_torch.privacy.adversary import ScenarioConfig, apply_scenario
from repro_torch.privacy.dp import DPConfig
from repro_torch.tree import tree_leaves

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
    # Federated training engine: "vectorized" (batched steps over a chunk of
    # clients) or "sequential" (one client at a time).
    engine: str = "vectorized"
    # Vectorized engine: clients per batched step (None = whole cohort).
    cohort_chunk: int | None = None
    # Vectorized engine: the client axis over several processes (None, a
    # launch/mesh.py DataMesh, or "auto" for the default process group's
    # world when it has more than one rank).
    mesh: Any = None
    # Vectorized engine: in-place accumulator, staged chunks released early.
    donate_buffers: bool = True
    # Vectorized engine: "resident" uploads client data once and stages int32
    # index plans per round (batches gathered on the device); "rebuild"
    # re-stages the whole schedule every round (the staging reference).
    staging: str = "resident"
    # Resident staging: build and copy the next chunk's plan while one trains.
    prefetch: bool = True
    # Policy overrides for the Federation facade (None = the paper's sampling).
    selection: Any = None
    aggregator: Any = "fedavg"
    # DP-SGD: None (unprotected), a DPConfig, or a job-spec dict
    # ({"clip_norm": ..., "noise_multiplier": ..., "delta": ...}).
    privacy: Any = None
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
            cohort_stats=None,
            cohort_steps=None,
        )
    else:
        fed_cfg = FederationConfig(
            rounds=exp.rounds,
            local_epochs=exp.local_epochs,
            batch_size=exp.batch_size,
            **policies_for(setting, exp),
            seed=seed,
            engine=exp.engine,
            cohort_chunk=exp.cohort_chunk,
            mesh=exp.mesh,
            donate_buffers=exp.donate_buffers,
            staging=exp.staging,
            prefetch=exp.prefetch,
            privacy=exp.privacy,
        )
        federation = Federation(
            fed_cfg, build_client_datasets(cohort), loss_fn, optimizer, device=dev
        )
        vectorized = federation.effective_engine == "vectorized"
        cohort_steps = 0

        def on_round(record) -> None:
            nonlocal cohort_steps
            if vectorized:
                cohort_steps += federation.cohort_trainer.last_round_stats["cohort_steps"]
            if progress is not None:
                progress(record)

        result = federation.run(init_params, progress=on_round)
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
            cohort_stats=federation.cohort_trainer.last_round_stats,
            # Batched steps the vectorized engine ran, over all rounds and chunks.
            cohort_steps=cohort_steps if vectorized else None,
            comm={k: summary[k] for k in ("params_down", "params_up", "bytes_transferred")},
            epsilon=summary["epsilon"],
        )

    y_hat = _predict(params, model_cfg, test)
    info["metrics"] = evaluate_predictions(test.y, y_hat)
    return info


@torch.no_grad()
def _predict(params, model_cfg: GRUConfig, dataset: ArrayDataset, batch: int = 2048) -> np.ndarray:
    """Predictions for ``dataset`` in batches of ``batch``, on the params' device.

    On the card the forward is captured as a CUDA graph (the port of the
    reference's ``jax.jit`` of its predict function, traced afresh for each
    call): one :class:`GraphCache` a call, one graph a batch shape (the
    full batch, and a ragged last one), each reading its rows from a
    static buffer and the params in place; on the CPU, and inside
    ``capture.disable_capture()``, it runs eagerly."""
    dev = params["head"]["w"].device
    forward = lambda x: gru_apply(params, model_cfg, x)
    if capture_enabled(dev):
        forward = _CapturedForward(GraphCache(dev), forward)
    outs = []
    for start in range(0, len(dataset), batch):
        x = torch.from_numpy(np.ascontiguousarray(dataset.x[start : start + batch])).to(dev)
        outs.append(forward(x).cpu().numpy())
    return np.concatenate(outs)


class _CapturedForward:
    """``forward(x)`` through one captured graph per shape of ``x``: the
    rows are copied into the graph's static buffer, and the graph (warmed
    up on that buffer, zeros, before the rows go in) is replayed."""

    def __init__(self, graphs: GraphCache, forward):
        self.graphs, self.forward = graphs, forward

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        def build():
            static = torch.zeros_like(x)
            return static, self.graphs.capture(lambda: self.forward(static))

        static, graph = self.graphs.lookup((tuple(x.shape), x.dtype), build)
        static.copy_(x)
        return graph.replay()


def paper_scale_cohort_config(total_stays: int = 189 * 23) -> CohortConfig:
    """A 189-hospital cohort with ~23 stays each.

    The scale the engines care about is the client count, so this keeps all
    189 hospitals and shrinks each one's data: the many-small-hospitals
    regime the vectorized engine is for.  The split is hospital-stratified,
    so every client survives the ``min_train=2`` cut and has the same local
    train size (the schedule's step axis is every client's real step count).
    """
    num = NUM_HOSPITALS
    return CohortConfig(
        total_stays=max(total_stays, num * 8),
        min_hospital_size=max(total_stays // num, 8),
        split_mode="stratified",
    )


PAPER_SCALE_SETTINGS = (
    "central",
    "federated-ac",
    "federated-sc",
    "federated-arc",
    "federated-src",
)


def _mean_round_time(info: dict[str, Any]) -> float:
    """Steady-state seconds per round: drop round 0 (it pays the first
    build and allocations) and take the median."""
    times = info.get("round_times_s")
    if not times:
        return float(info["tau_s"])
    return float(np.median(times[1:] if len(times) > 1 else times))


def run_paper_scale(
    *,
    rounds: int = 3,
    local_epochs: int = 1,
    batch_size: int = 4,
    seed: int = 0,
    total_stays: int = 189 * 23,
    engines: tuple[str, ...] = ("vectorized", "sequential"),
    mesh: Any = None,
    settings: tuple[str, ...] = PAPER_SCALE_SETTINGS,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The paper's five settings at 189 clients, each federated one on every engine.

    Records each setting's steady-state round time (central: time per
    epoch), test metrics and the vectorized engine's round stats.  A
    donation probe runs one all-clients round in two chunks with donation
    on and off and records both rounds' stats; ``peak_device_bytes`` is
    None on the CPU.  ``device`` defaults to the card; ``mesh`` splits the
    vectorized engine's client axis over the process group's ranks.
    """
    dev = resolve_device(device)
    cohort_cfg = paper_scale_cohort_config(total_stays=total_stays)
    cohort = generate_cohort(cohort_cfg, seed=seed)
    clients = build_client_datasets(cohort)
    base = ExperimentConfig(
        rounds=rounds,
        local_epochs=local_epochs,
        central_epochs=rounds * local_epochs,
        batch_size=batch_size,
        mesh=mesh,
        device=str(dev),
    )

    report: dict[str, Any] = {}
    for setting in settings:
        row: dict[str, Any] = {}
        setting_engines = ("vectorized",) if setting == "central" else engines
        for engine in setting_engines:
            exp = dataclasses.replace(base, engine=engine)
            out = run_setting(setting, exp, cohort, seed=seed)
            if setting == "central":
                # central has no rounds; its comparable unit is one epoch
                unit_time = out["tau_s"] / max(base.central_epochs, 1)
                time_unit = "epoch"
            else:
                unit_time = _mean_round_time(out)
                time_unit = "round"
            entry = {
                "tau_s": out["tau_s"],
                "round_time_s": unit_time,
                "time_unit": time_unit,
                "metrics": out["metrics"],
                "local_steps": out["local_steps"],
                "federation_size": out["federation_size"],
                "recruited": out["recruited"],
                "cohort_stats": out.get("cohort_stats"),
            }
            row["n/a" if setting == "central" else engine] = entry
            if verbose:
                print(
                    f"  [paper189 {setting}/{engine}] round={entry['round_time_s']:.3f}s "
                    f"tau={out['tau_s']:.1f}s msle={out['metrics']['msle']:.4f}",
                    flush=True,
                )
        if setting != "central" and {"vectorized", "sequential"} <= set(row):
            row["speedup"] = row["sequential"]["round_time_s"] / row["vectorized"]["round_time_s"]
        report[setting] = row

    # Donation probe: one all-participants round, donated against plain buffers.
    model_cfg = GRUConfig()
    loss_fn = make_loss_fn(model_cfg)
    memory: dict[str, Any] = {}
    for donate in (True, False):
        trainer = CohortTrainer(
            loss_fn=loss_fn,
            optimizer=AdamW(learning_rate=base.learning_rate, weight_decay=base.weight_decay),
            batch_size=batch_size,
            local_epochs=local_epochs,
            cohort_chunk=max(1, (len(clients) + 1) // 2),  # 2 chunks: cross-chunk peak
            mesh=mesh,
            donate=donate,
            device=dev,
        )
        params = init_gru(torch.Generator().manual_seed(seed), model_cfg, dev)
        generators = client_generators(np.random.default_rng([seed, 2]), len(clients), dev)
        trainer.train_cohort(params, clients, np.random.default_rng(seed), generators)
        memory["donated" if donate else "plain"] = trainer.last_round_stats
    peaks = [memory[k]["peak_device_bytes"] for k in ("donated", "plain")]
    memory["donated_peak_lower"] = None if None in peaks else peaks[0] < peaks[1]

    return {
        "bench": "paper189",
        "num_clients": len(clients),
        "rounds": rounds,
        "local_epochs": local_epochs,
        "batch_size": batch_size,
        "total_stays": cohort_cfg.total_stays,
        "seed": seed,
        "device": str(dev),
        "settings": report,
        "memory": memory,
    }


STAGING_VARIANTS = ("rebuild", "rebuild-chunked", "resident", "resident-noprefetch")


def run_staging_comparison(
    *,
    rounds: int = 4,
    local_epochs: int = 1,
    batch_size: int = 32,
    seed: int = 0,
    total_stays: int = 189 * 64,
    mesh: Any = None,
    cohort_chunk: int | None = 48,
    variants: tuple[str, ...] = STAGING_VARIANTS,
    repeats: int = 2,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Rebuild-per-round against device-resident staging at 189 clients.

    The full 189-hospital federation trains ``rounds`` all-participant
    rounds under each staging variant of the vectorized engine; the report
    records each variant's steady-state round time, bytes staged per round
    and prefetch hits, the two ratios ``speedup`` (rebuild round time over
    resident) and ``bytes_ratio`` (rebuild bytes over resident), and
    ``max_param_diff`` across variants, so a fast but wrong staging path
    cannot pass unseen.  ``rebuild`` runs the whole cohort per step;
    ``resident`` runs chunked (``cohort_chunk``) with prefetch;
    ``rebuild-chunked`` and ``resident-noprefetch`` isolate the two terms.
    The model is small (hidden 8, one layer): the client axis and the
    staging path are what is measured.  ``device`` defaults to the card.
    ``mesh`` (``"auto"`` resolved here, so the report's ``"mesh"`` names the
    mesh that ran: ``"data"`` or None) splits the client axis over the
    process group's ranks; chunking stays on under it.
    """
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh)
    cohort_cfg = paper_scale_cohort_config(total_stays=total_stays)
    clients = build_client_datasets(generate_cohort(cohort_cfg, seed=seed))
    model_cfg = GRUConfig(hidden_dim=8, num_layers=1)
    loss_fn = make_loss_fn(model_cfg)
    params0 = init_gru(torch.Generator().manual_seed(seed), model_cfg, dev)
    configs: dict[str, dict[str, Any]] = {
        "rebuild": {"staging": "rebuild", "cohort_chunk": None},
        "rebuild-chunked": {"staging": "rebuild", "cohort_chunk": cohort_chunk},
        "resident": {"staging": "resident", "prefetch": True, "cohort_chunk": cohort_chunk},
        "resident-noprefetch": {
            "staging": "resident", "prefetch": False, "cohort_chunk": cohort_chunk,
        },
    }
    results: dict[str, Any] = {}
    params_by_variant: dict[str, Any] = {}
    for variant in variants:
        fed_cfg = FederationConfig(
            rounds=rounds,
            local_epochs=local_epochs,
            batch_size=batch_size,
            selection="uniform",  # all 189 clients, every round
            seed=seed,
            engine="vectorized",
            mesh=mesh,
            **configs[variant],
        )
        # Best of ``repeats`` whole federations (the least steady-state round
        # time); the entry's every number comes from that one run.
        best: dict[str, Any] | None = None
        for _ in range(max(repeats, 1)):
            federation = Federation(
                fed_cfg, clients, loss_fn,
                AdamW(learning_rate=5e-3, weight_decay=5e-3), device=dev,
            )
            out = federation.run(params0)
            stats = federation.cohort_trainer.last_round_stats or {}
            round_time = _mean_round_time(
                {"round_times_s": [r.wall_time_s for r in out.history],
                 "tau_s": out.total_wall_time_s}
            )
            if best is not None and round_time >= best["round_time_s"]:
                continue
            best = {
                "round_time_s": round_time,
                "tau_s": out.total_wall_time_s,
                "bytes_staged_per_round": stats.get("bytes_staged", 0),
                "bytes_resident": stats.get("bytes_resident", 0),
                "plans_prefetched": stats.get("plans_prefetched", 0),
                "chunks": stats.get("chunks", 0),
                "shards": stats.get("shards", 1),
                "params": out.params,
            }
        entry = {k: v for k, v in best.items() if k != "params"}
        results[variant] = entry
        params_by_variant[variant] = best["params"]
        if verbose:
            print(
                f"  [pipeline {variant}] round={entry['round_time_s']:.3f}s "
                f"staged={entry['bytes_staged_per_round']:,}B "
                f"prefetched={entry['plans_prefetched']}",
                flush=True,
            )

    report: dict[str, Any] = {
        "bench": "staging_pipeline",
        "num_clients": len(clients),
        "rounds": rounds,
        "local_epochs": local_epochs,
        "batch_size": batch_size,
        "cohort_chunk": cohort_chunk,
        "total_stays": cohort_cfg.total_stays,
        "mesh": "data" if mesh is not None else None,
        "seed": seed,
        "repeats": repeats,
        "device": str(dev),
        "variants": results,
    }
    if "rebuild" in results and "resident" in results:
        report["speedup"] = (
            results["rebuild"]["round_time_s"] / results["resident"]["round_time_s"]
        )
        report["bytes_ratio"] = results["rebuild"]["bytes_staged_per_round"] / max(
            results["resident"]["bytes_staged_per_round"], 1
        )
        if "rebuild-chunked" in results:
            report["speedup_vs_chunked_rebuild"] = (
                results["rebuild-chunked"]["round_time_s"]
                / results["resident"]["round_time_s"]
            )
        ref = tree_leaves(params_by_variant["rebuild"])
        report["max_param_diff"] = max(
            float((a - b).abs().max())
            for other in params_by_variant.values()
            for a, b in zip(ref, tree_leaves(other))
        )
    return report


def _bare_rounds(
    clients, loss_fn, params0, *, rounds: int, local_epochs: int, batch_size: int,
    seed: int, dev: torch.device,
) -> list[float]:
    """The bare hot loop: one ``client_generators`` draw and one resident
    ``train_cohort`` over every client per round, no policy, record or
    accounting; the card is synchronized each round, as ``Federation.run``
    does.  Returns each round's seconds."""
    trainer = CohortTrainer(
        loss_fn=loss_fn,
        optimizer=AdamW(learning_rate=5e-3, weight_decay=5e-3),
        batch_size=batch_size,
        local_epochs=local_epochs,
        staging="resident",
        device=dev,
    )
    trainer.attach_device_cohort(clients)
    rng = np.random.default_rng(seed)
    generator_rng = np.random.default_rng([seed, 2])
    spe = cohort_steps_per_epoch([c.n_train for c in clients], batch_size)
    params, times = params0, []
    for _ in range(rounds):
        t0 = time.perf_counter()
        generators = client_generators(generator_rng, len(clients), dev)
        params, _, _ = trainer.train_cohort(params, clients, rng, generators, steps_per_epoch=spe)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return times


def _floor(times: list[float]) -> float:
    """The least steady-state round (the first round pays first-call costs)."""
    return float(np.min(times[1:] if len(times) > 1 else times))


def _overhead_workload(total_stays: int, seed: int, dev: torch.device):
    """The overhead probes' workload: the 189-client cohort of
    ``total_stays``, a GRU of hidden 8 and one layer."""
    cohort_cfg = paper_scale_cohort_config(total_stays=total_stays)
    clients = build_client_datasets(generate_cohort(cohort_cfg, seed=seed))
    model_cfg = GRUConfig(hidden_dim=8, num_layers=1)
    params0 = init_gru(torch.Generator().manual_seed(seed), model_cfg, dev)
    return clients, make_loss_fn(model_cfg), params0


def run_facade_overhead(
    *,
    rounds: int = 9,
    local_epochs: int = 1,
    batch_size: int = 8,
    seed: int = 0,
    total_stays: int = 189 * 16,
    repeats: int = 3,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The facade tax: ``Federation.run`` against the bare hot loop.

    Both drive the identical workload (the full 189-client federation, all
    participants every round, resident staging, one ``client_generators``
    draw and one ``train_cohort`` per round), but the bare loop has no
    policy dispatch, no selection call, no comm accounting and no
    ``RoundRecord``.  The reference's budget for the round program is 2%
    over that floor.

    A 2% budget is below round-to-round host noise, so the estimator is
    the *floor*: the least steady-state round over ``repeats`` alternating
    bare/facade runs.  The per-repeat floors (``bare_floors`` /
    ``facade_floors``) are in the report: their spread is the probe's own
    resolution, and an ``overhead_frac`` inside it, negative values
    included, reads as "no overhead resolvable".  ``device`` defaults to
    the card.
    """
    dev = resolve_device(device)
    clients, loss_fn, params0 = _overhead_workload(total_stays, seed, dev)

    def facade_rounds() -> list[float]:
        federation = Federation(
            FederationConfig(
                rounds=rounds, local_epochs=local_epochs, batch_size=batch_size,
                recruitment="all", selection="uniform", aggregator="fedavg", seed=seed,
            ),
            clients,
            loss_fn,
            AdamW(learning_rate=5e-3, weight_decay=5e-3),
            device=dev,
        )
        return [r.wall_time_s for r in federation.run(params0).history]

    # Alternate the two paths so a throttling window cannot hit only one.
    bare_floors, facade_floors = [], []
    for _ in range(max(repeats, 1)):
        bare_floors.append(_floor(_bare_rounds(
            clients, loss_fn, params0, rounds=rounds, local_epochs=local_epochs,
            batch_size=batch_size, seed=seed, dev=dev)))
        facade_floors.append(_floor(facade_rounds()))
    bare, facade = min(bare_floors), min(facade_floors)
    overhead = facade / bare - 1.0
    report = {
        "bench": "facade_overhead",
        "device": str(dev),
        "num_clients": len(clients),
        "rounds": rounds,
        "batch_size": batch_size,
        "repeats": repeats,
        "bare_round_s": bare,
        "facade_round_s": facade,
        "bare_floors": bare_floors,
        "facade_floors": facade_floors,
        "overhead_frac": overhead,
        "budget_frac": 0.02,
        "within_budget": bool(overhead <= 0.02),
    }
    if verbose:
        print(
            f"  [facade] bare={bare:.4f}s facade={facade:.4f}s "
            f"overhead={100 * overhead:+.2f}% (budget 2%)",
            flush=True,
        )
    return report


def run_obs_overhead(
    *,
    rounds: int = 10,
    flushes: int = 10,
    local_epochs: int = 1,
    batch_size: int = 8,
    seed: int = 0,
    total_stays: int = 189 * 16,
    buffer_size: int = 32,
    repeats: int = 3,
    trace_capacity: int = 262144,
    trace_path: str | None = None,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The observability tax: tracer off and tracer on against the bare loop.

    Three sync variants drive the identical 189-client workload (the bare
    hot loop of :func:`run_facade_overhead`, ``Federation.run`` with the
    default null tracer, and ``Federation.run`` with a live
    :class:`repro_torch.obs.trace.Tracer`), plus an off/on pair through the
    async virtual-clock engine (fedbuff, constant latency, no dropout, so
    every flush is the same unit of work).  The reference's budgets:
    instrumented-off <= 1% over the bare loop and tracer-on <= 5% over
    tracer-off in both engines.  The async off path reuses the sync path's
    null-tracer primitives, so its off budget rides the sync probe.

    The estimator is :func:`run_facade_overhead`'s floor over alternating
    repeats.  ``trace_path``, when given, is where the last async tracer's
    Chrome trace is written.  ``device`` defaults to the card.
    """
    from repro_torch.obs.trace import Tracer

    dev = resolve_device(device)
    clients, loss_fn, params0 = _overhead_workload(total_stays, seed, dev)

    def optimizer() -> AdamW:
        return AdamW(learning_rate=5e-3, weight_decay=5e-3)

    def sync_rounds(tracer: Tracer | None) -> list[float]:
        federation = Federation(
            FederationConfig(
                rounds=rounds, local_epochs=local_epochs, batch_size=batch_size,
                recruitment="all", selection="uniform", aggregator="fedavg", seed=seed,
            ),
            clients,
            loss_fn,
            optimizer(),
            device=dev,
            tracer=tracer,
        )
        return [r.wall_time_s for r in federation.run(params0).history]

    def async_flushes(tracer: Tracer | None) -> list[float]:
        federation = AsyncFederation(
            AsyncFederationConfig(
                rounds=flushes, local_epochs=local_epochs, batch_size=batch_size,
                recruitment="all", aggregator=f"fedbuff:{buffer_size}",
                latency="constant", dropout="never", seed=seed,
            ),
            clients,
            loss_fn,
            optimizer(),
            device=dev,
            tracer=tracer,
        )
        return [r.wall_time_s for r in federation.run(params0).history]

    # Alternate every variant inside each repeat so a throttling window
    # cannot hit only one path.
    floors: dict[str, list[float]] = {
        "bare": [], "sync_off": [], "sync_on": [], "async_off": [], "async_on": [],
    }
    trace_stats: dict[str, Any] = {}
    last_async_tracer: Tracer | None = None
    for _ in range(max(repeats, 1)):
        floors["bare"].append(_floor(_bare_rounds(
            clients, loss_fn, params0, rounds=rounds, local_epochs=local_epochs,
            batch_size=batch_size, seed=seed, dev=dev)))
        floors["sync_off"].append(_floor(sync_rounds(None)))
        sync_tracer = Tracer(capacity=trace_capacity)
        floors["sync_on"].append(_floor(sync_rounds(sync_tracer)))
        floors["async_off"].append(_floor(async_flushes(None)))
        async_tracer = Tracer(capacity=trace_capacity)
        floors["async_on"].append(_floor(async_flushes(async_tracer)))
        trace_stats = {
            "sync_events": len(sync_tracer.events()),
            "async_events": len(async_tracer.events()),
            "sync_dropped": sync_tracer.dropped,
            "async_dropped": async_tracer.dropped,
        }
        last_async_tracer = async_tracer
    best = {name: min(values) for name, values in floors.items()}
    sync_off = best["sync_off"] / best["bare"] - 1.0
    sync_on = best["sync_on"] / best["sync_off"] - 1.0
    async_on = best["async_on"] / best["async_off"] - 1.0
    budget_off, budget_on = 0.01, 0.05
    report = {
        "bench": "obs_overhead",
        "device": str(dev),
        "num_clients": len(clients),
        "rounds": rounds,
        "flushes": flushes,
        "batch_size": batch_size,
        "repeats": repeats,
        "floors": floors,
        "sync": {
            "bare_round_s": best["bare"],
            "off_round_s": best["sync_off"],
            "on_round_s": best["sync_on"],
            "overhead_off_frac": sync_off,
            "overhead_on_frac": sync_on,
        },
        "async": {
            "off_flush_s": best["async_off"],
            "on_flush_s": best["async_on"],
            "overhead_on_frac": async_on,
        },
        "trace": trace_stats,
        "budget_off_frac": budget_off,
        "budget_on_frac": budget_on,
        "within_budget": bool(
            sync_off <= budget_off and sync_on <= budget_on and async_on <= budget_on
        ),
    }
    if trace_path is not None and last_async_tracer is not None:
        report["trace"]["sample_path"] = last_async_tracer.export_chrome(trace_path)
    if verbose:
        print(
            f"  [obs sync] bare={best['bare']:.4f}s off={best['sync_off']:.4f}s "
            f"on={best['sync_on']:.4f}s off_overhead={100 * sync_off:+.2f}% "
            f"on_overhead={100 * sync_on:+.2f}% (budgets 1%/5%)",
            flush=True,
        )
        print(
            f"  [obs async] off={best['async_off']:.4f}s on={best['async_on']:.4f}s "
            f"on_overhead={100 * async_on:+.2f}% (budget 5%)",
            flush=True,
        )
    return report


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


def run_privacy_frontier(
    exp: ExperimentConfig | None = None,
    *,
    setting: str = "federated-ac",
    clip_norm: float = 1.0,
    noise_multipliers: tuple = (0.5, 1.0, 2.0),
    attacks: tuple = ("label-flip", "scaled-update"),
    attack_fractions: tuple = (0.1, 0.2, 0.3),
    aggregators: tuple = ("fedavg", "trimmed-mean:0.35", "krum:4"),
    attack_scale: float = 50.0,
    scenario_seed: int = 5,
    seed: int = 0,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The two privacy-tier frontiers on one cohort.

    ``utility``: test metrics vs the accountant's final ``(epsilon,
    delta)`` across noise multipliers, with the unprotected run as the
    epsilon = None anchor — the utility cost of DP at the paper's
    setting.  ``robustness``: test metrics for every (aggregator, attack,
    attacker fraction) cell, with each aggregator's clean run as its own
    baseline — what plain FedAvg loses under attack and the robust rules
    retain.  Metrics come from the hold-out test split, which no attacker
    touches.  ``device`` (else ``exp.device``) defaults to the card.
    """
    exp = exp or ExperimentConfig()
    dev = resolve_device(device if device is not None else exp.device)
    cohort = build_cohort(exp, seed=seed)
    clients = build_client_datasets(cohort)
    test = global_dataset(cohort, Cohort.TEST)
    model_cfg = GRUConfig()
    loss_fn = make_loss_fn(model_cfg)
    optimizer = AdamW(learning_rate=exp.learning_rate, weight_decay=exp.weight_decay)
    init_params = init_gru(torch.Generator().manual_seed(seed), model_cfg, dev)

    def one_run(privacy=None, aggregator=None, scenario=None) -> dict[str, Any]:
        policies = policies_for(setting, exp)
        if aggregator is not None:
            policies["aggregator"] = aggregator
        fed_cfg = FederationConfig(
            rounds=exp.rounds,
            local_epochs=exp.local_epochs,
            batch_size=exp.batch_size,
            **policies,
            seed=seed,
            engine=exp.engine,
            cohort_chunk=exp.cohort_chunk,
            mesh=exp.mesh,
            donate_buffers=exp.donate_buffers,
            staging=exp.staging,
            prefetch=exp.prefetch,
            privacy=privacy,
        )
        federation = Federation(fed_cfg, clients, loss_fn, optimizer, device=dev)
        if scenario is not None:
            apply_scenario(federation, scenario)
        result = federation.run(init_params)
        y_hat = _predict(result.params, model_cfg, test)
        return {
            "metrics": evaluate_predictions(test.y, y_hat),
            "epsilon": result.summary()["epsilon"],
            "tau_s": result.total_wall_time_s,
            "engine": federation.effective_engine,
        }

    out: dict[str, Any] = {
        "setting": setting,
        "seed": seed,
        "clip_norm": clip_norm,
        "utility": [],
        "robustness": [],
    }

    baseline = one_run()
    out["utility"].append({"privacy": None, "epsilon": None, **baseline})
    if verbose:
        m = baseline["metrics"]
        print(f"  [privacy {setting}] unprotected mae={m['mae']:.3f}", flush=True)
    for nm in noise_multipliers:
        dp = DPConfig(clip_norm=clip_norm, noise_multiplier=float(nm))
        run = one_run(privacy=dp)
        out["utility"].append({"privacy": dp.to_state(), **run})
        if verbose:
            m = run["metrics"]
            print(
                f"  [privacy {setting}] sigma/C={nm:g} "
                f"eps={run['epsilon']:.2f} mae={m['mae']:.3f}",
                flush=True,
            )

    for aggregator in aggregators:
        clean = one_run(aggregator=aggregator)
        out["robustness"].append(
            {"aggregator": aggregator, "attack": None, "fraction": 0.0, **clean}
        )
        for attack in attacks:
            for fraction in attack_fractions:
                scenario = ScenarioConfig(
                    attack=attack,
                    fraction=float(fraction),
                    scale=attack_scale,
                    seed=scenario_seed,
                )
                run = one_run(aggregator=aggregator, scenario=scenario)
                out["robustness"].append(
                    {
                        "aggregator": aggregator,
                        "attack": attack,
                        "fraction": float(fraction),
                        **run,
                    }
                )
                if verbose:
                    m = run["metrics"]
                    print(
                        f"  [privacy {setting}] {aggregator} {attack}@{fraction:g} "
                        f"mae={m['mae']:.3f} (clean {clean['metrics']['mae']:.3f})",
                        flush=True,
                    )
    return out


ASYNC_LATENCY_MODELS = ("lognormal:0.6", "pareto:1.2")

ASYNC_FEDERATIONS = (("all-clients", "all"), ("recruited", None))  # None -> nu-greedy


def time_to_target(history, target_loss: float) -> float | None:
    """First virtual time the *running best* flush loss reaches the target.

    The running minimum makes the crossing monotone (per-flush losses are
    noisy at small buffer sizes), so two federations compared at the same
    target answer exactly the paper's question: which one got there first
    on the simulated clock.  ``None`` if the run never reached the target.
    """
    best = float("inf")
    for record in history:
        if np.isfinite(record.mean_local_loss):
            best = min(best, record.mean_local_loss)
        if best <= target_loss:
            return record.virtual_time
    return None


def shared_time_to_target(
    histories: dict[str, Any],
) -> tuple[float, dict[str, float | None]]:
    """Shared target loss + per-run virtual time to reach it.

    The target is the *worse* of the runs' best finite flush losses — the
    first level every run demonstrably reaches, so the comparison never
    rewards a run for a target only it attained.  If any run posts no
    finite loss at all (divergence, or zero flushes) no shared target
    exists: the target is NaN and every time is ``None``.
    """
    finals = {}
    for name, history in histories.items():
        finite = [r.mean_local_loss for r in history if np.isfinite(r.mean_local_loss)]
        finals[name] = min(finite) if finite else float("nan")
    comparable = bool(finals) and all(np.isfinite(v) for v in finals.values())
    target = max(finals.values()) if comparable else float("nan")
    times = {
        name: time_to_target(history, target) if comparable else None
        for name, history in histories.items()
    }
    return target, times


def run_async_comparison(
    *,
    flushes: int = 8,
    local_epochs: int = 1,
    batch_size: int = 16,
    seed: int = 0,
    cohort_scale: float = 0.05,
    buffer_frac: float = 0.25,
    dropout: float = 0.05,
    latency_models: tuple[str, ...] = ASYNC_LATENCY_MODELS,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Recruited vs all-clients federations on simulated time-to-target-loss.

    The paper's section-6 claim — recruiting fewer, better clients cuts
    *training time* without sacrificing predictive power — measured on a
    virtual wall clock with per-client straggler latencies and dropout.  For
    each latency model the ``"all"`` and nu-greedy federations each run a
    ``fedbuff`` async federation (buffer = ``buffer_frac`` of the
    federation, so both flush at the same *relative* cadence), and the
    report records the loss trajectory against virtual time plus the
    headline number: the simulated time to reach a shared target loss (the
    worse of the two final running-best losses) and the recruited
    federation's speedup on that clock.

    The cohort is the heterogeneous synthetic eICU population: recruitment
    needs real disclosure spread to choose from, and the straggler models
    need real size spread to punish.  The model is bench-scale (hidden 8):
    the dimension under test is the timeline.  The timeline fields
    (federation and buffer sizes, flushes, tasks, dropped tasks and each
    trajectory point's virtual time) come from numpy streams alone and equal
    the JAX package's.  ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    cohort = generate_cohort(CohortConfig().scaled(cohort_scale), seed=seed)
    clients = build_client_datasets(cohort)
    model_cfg = GRUConfig(hidden_dim=8, num_layers=1)
    loss_fn = make_loss_fn(model_cfg)
    params0 = init_gru(torch.Generator().manual_seed(seed), model_cfg, dev)

    report: dict[str, Any] = {
        "bench": "async_runtime",
        "num_clients": len(clients),
        "flushes": flushes,
        "local_epochs": local_epochs,
        "batch_size": batch_size,
        "buffer_frac": buffer_frac,
        "dropout": dropout,
        "cohort_scale": cohort_scale,
        "seed": seed,
        "latency": {},
    }
    base = ExperimentConfig()
    recruited_spec = f"nu-greedy:{base.gamma_dv},{base.gamma_sa},{base.gamma_th}"
    for latency in latency_models:
        row: dict[str, Any] = {}
        histories: dict[str, Any] = {}
        for name, rec in ASYNC_FEDERATIONS:
            federation = AsyncFederation(
                AsyncFederationConfig(
                    rounds=flushes,
                    local_epochs=local_epochs,
                    batch_size=batch_size,
                    recruitment=rec if rec is not None else recruited_spec,
                    # A fractional buffer resolves against the federation
                    # that actually forms, so both settings flush at the
                    # same relative cadence.
                    aggregator=f"fedbuff:{float(buffer_frac)}",
                    latency=latency,
                    dropout=dropout,
                    seed=seed,
                ),
                clients,
                loss_fn,
                AdamW(learning_rate=base.learning_rate, weight_decay=base.weight_decay),
                device=dev,
            )
            out = federation.run(params0)
            stats = federation.last_run_stats or {}
            losses = [r.mean_local_loss for r in out.history]
            row[name] = {
                "federation_size": int(out.federation_ids.size),
                "recruited": None
                if out.recruitment is None
                else out.recruitment.num_recruited,
                "buffer_size": federation.aggregator.buffer_size,
                "flushes": len(out.history),
                "virtual_time": stats.get("virtual_time"),
                "mean_staleness": out.summary()["mean_staleness"],
                "tasks": stats.get("tasks"),
                "dropped": stats.get("dropped"),
                "final_loss": float(np.nanmin(losses)) if losses else float("nan"),
                "trajectory": [
                    (r.virtual_time, r.mean_local_loss) for r in out.history
                ],
                "tau_s": out.total_wall_time_s,
            }
            histories[name] = out.history
        target, times = shared_time_to_target(histories)
        for name, _ in ASYNC_FEDERATIONS:
            row[name]["time_to_target"] = times[name]
        row["target_loss"] = target
        t_all = row["all-clients"]["time_to_target"]
        t_rec = row["recruited"]["time_to_target"]
        row["recruited_speedup"] = (
            t_all / t_rec if t_all is not None and t_rec is not None and t_rec > 0 else None
        )
        report["latency"][latency] = row
        if verbose:
            for name, _ in ASYNC_FEDERATIONS:
                entry = row[name]
                reached = entry["time_to_target"]
                stale = entry["mean_staleness"]
                print(
                    f"  [async {latency} {name}] fed={entry['federation_size']} "
                    f"t_target="
                    + (f"{reached:.2f}s(v) " if reached is not None else "unreached ")
                    + (f"stale={stale:.2f} " if stale is not None else "")
                    + f"dropped={entry['dropped']}",
                    flush=True,
                )
            if row["recruited_speedup"] is not None:
                print(
                    f"  [async {latency}] recruited reaches loss<="
                    f"{target:.4f} {row['recruited_speedup']:.2f}x sooner "
                    "on the virtual clock",
                    flush=True,
                )
    return report


def job_spec_for(setting: str, exp: ExperimentConfig, seed: int = 0) -> dict[str, Any]:
    """One section-6 setting -> a control-plane job spec (a submit file).

    The declarative twin of :func:`run_setting`: the same ``policies_for``
    translation table rendered as the JSON the
    :mod:`repro_torch.launch.federation_service` CLI accepts, so every paper
    setting can run as a submitted job with checkpoint/resume and a
    streamed record file.  ``central`` is pooled training, not a federation
    — it has no job-spec form.  The port's ``ExperimentConfig`` has no
    ``use_pallas``, so the spec carries the reference's default for it
    (``false``) and equals (and hashes as) the reference's for the same
    settings; ``exp.mesh`` must be None or ``"auto"`` (a spec is JSON);
    ``exp.device`` and ``exp.privacy`` are not part of it, as in the
    reference.
    """
    if setting == "central":
        raise ValueError("'central' is pooled training, not a federated job")
    if setting not in MODEL_SETTINGS:
        raise ValueError(f"unknown setting {setting}; choose from {MODEL_SETTINGS}")
    if exp.mesh not in (None, "auto"):
        raise ValueError(
            "job specs are JSON: mesh must be null or 'auto' (drive the "
            "Federation facade directly to pass a DataMesh)"
        )
    policies = policies_for(setting, exp)
    if not all(isinstance(v, str) for v in policies.values()):
        raise ValueError(
            "job specs are JSON: policy overrides must be spec strings, "
            "not instances"
        )
    return {
        "name": setting,
        "mode": "sync",
        "rounds": exp.rounds,
        "local_epochs": exp.local_epochs,
        "batch_size": exp.batch_size,
        "seed": seed,
        **policies,
        "engine": exp.engine,
        "cohort_chunk": exp.cohort_chunk,
        "mesh": exp.mesh,
        "staging": exp.staging,
        "prefetch": exp.prefetch,
        "donate_buffers": exp.donate_buffers,
        "data": {"scale": exp.cohort_scale, "seed": seed},
        "model": {"use_pallas": False},
        "optimizer": {
            "learning_rate": exp.learning_rate,
            "weight_decay": exp.weight_decay,
        },
    }


def run_settings_as_jobs(
    exp: ExperimentConfig,
    run_root: str,
    *,
    settings: tuple[str, ...] = ("federated-ac", "federated-src"),
    seed: int = 0,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Submit section-6 settings through the control plane, on ``device``
    (``None``: ``exp.device``, whose ``None`` is the card).

    Each setting becomes one run directory under ``run_root`` (job.json,
    records.jsonl, metrics.jsonl, checkpoint/, final/, result.json).
    Test-split metric evaluation stays with :func:`run_setting`.
    """
    import os

    from repro_torch.launch.federation_service import submit_job

    dev = resolve_device(device if device is not None else exp.device)
    results: dict[str, Any] = {}
    for setting in settings:
        spec = job_spec_for(setting, exp, seed=seed)
        out = submit_job(spec, os.path.join(run_root, setting), device=dev)
        if verbose:
            s = out["summary"]
            print(
                f"  [job {setting}] rounds={s['rounds']} "
                f"federation={s['federation_size']} "
                f"tau={s['total_wall_time_s']:.1f}s",
                flush=True,
            )
        results[setting] = out
    return results


def run_service_overhead(
    *,
    rounds: int = 6,
    local_epochs: int = 1,
    batch_size: int = 8,
    seed: int = 0,
    scale: float = 0.02,
    checkpoint_every: int = 2,
    repeats: int = 3,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The control-plane tax: a submitted job vs direct ``Federation.run``.

    Both paths execute the identical workload — ``build_workload`` on the
    same normalized spec, then the same facade run on ``device`` (``None``
    is the card) — but the submitted job also pays validation and spec
    hashing, job.json, the per-round JSONL record and metrics streams,
    snapshots at ``checkpoint_every`` and the final-params save.  The
    reference's budget for that envelope is 2% over the direct run.

    Each path's *floor* over alternating end-to-end repeats (the first
    repeat of each excluded: it pays first-call costs) isolates the
    systematic cost from additive timing noise; per-repeat totals ship in
    the report so the probe's own resolution is visible.
    """
    import tempfile

    from repro_torch.launch.federation_service import (
        build_workload,
        federation_config_from_spec,
        submit_job,
        validate_job_spec,
    )

    dev = resolve_device(device)
    spec = validate_job_spec(
        {
            "name": "service-overhead",
            "mode": "sync",
            "rounds": rounds,
            "local_epochs": local_epochs,
            "batch_size": batch_size,
            "seed": seed,
            "recruitment": "all",
            "selection": "uniform",
            "checkpoint_every": checkpoint_every,
            "data": {"scale": scale, "seed": seed, "split_mode": "stratified"},
            "model": {"hidden_dim": 8, "num_layers": 1},
        }
    )

    def direct_total() -> float:
        t0 = time.perf_counter()
        workload = build_workload(spec, dev)
        federation = Federation(
            federation_config_from_spec(spec),
            workload.clients,
            workload.loss_fn,
            workload.optimizer,
            device=dev,
        )
        federation.run(workload.init_params)  # synchronizes the card each round
        return time.perf_counter() - t0

    def service_total() -> float:
        with tempfile.TemporaryDirectory() as run_dir:
            t0 = time.perf_counter()
            submit_job(spec, run_dir, device=dev)
            return time.perf_counter() - t0

    # Alternate the paths so a throttling window cannot hit only one.
    direct_totals, service_totals = [], []
    for _ in range(max(repeats, 1) + 1):
        direct_totals.append(direct_total())
        service_totals.append(service_total())
    direct = float(np.min(direct_totals[1:]))
    service = float(np.min(service_totals[1:]))
    overhead = service / direct - 1.0
    report = {
        "bench": "service_overhead",
        "device": str(dev),
        "rounds": rounds,
        "batch_size": batch_size,
        "checkpoint_every": checkpoint_every,
        "repeats": repeats,
        "direct_total_s": direct,
        "service_total_s": service,
        "direct_totals": direct_totals,
        "service_totals": service_totals,
        "overhead_frac": overhead,
        "budget_frac": 0.02,
        "within_budget": bool(overhead <= 0.02),
    }
    if verbose:
        print(
            f"  [service] direct={direct:.4f}s submitted={service:.4f}s "
            f"overhead={100 * overhead:+.2f}% (budget 2%)",
            flush=True,
        )
    return report
