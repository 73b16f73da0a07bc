"""Federation control plane: declarative jobs, streamed records, resume.

The port of the JAX package's ``launch/federation_service.py``.  It is the
*job service* in front of the federation facades: a federated training run
is described by one JSON **job spec** (policy spec strings, engine/staging
knobs, data/model/optimizer sections), validated against the policy
registries up front (unknown names fail with did-you-mean suggestions
before any cohort is built), and executed through
:class:`~repro_torch.federated.api.Federation` (``mode="sync"``) or
:class:`~repro_torch.federated.runtime.AsyncFederation` (``mode="async"``).
Validation, normalization and ``job_spec_hash`` are the reference's, so a
spec hashes to the same string in both packages.

What differs from the reference:

* ``submit_job``, ``resume_job`` and the CLI take a device (``--device``,
  default ``cuda``; ``cpu`` runs the plain versions).  The device is not
  part of the spec, so it never enters the hash.
* Params are initialized from the torch init (``init_gru`` with
  ``torch.Generator().manual_seed(seed)``), so a run dir of the port differs
  from a reference run dir of the same spec unless the init is carried
  across.
* ``model.use_pallas`` is accepted and hashed as in the reference, and
  chooses nothing: the tensors' device routes every GRU call (the CUDA
  kernels on the card, their plain versions on the CPU).
* ``mesh: "auto"`` maps to ``FederationConfig.mesh="auto"``: under a
  process group of more than one rank (``torchrun``) the job's client axis
  is split over the ranks (``launch/mesh.py``), and in one process it is
  the ``null`` job, bit for bit.  Every rank runs the job; only rank 0
  writes its files (job.json, records, metrics.jsonl, snapshots,
  trace.json, profiles, final/, result.json), and the other ranks' facades
  get the null tracer and no profiler.  On resume every rank reads the
  snapshot, and rank 0 overwrites it only after all have.  The package
  creates no process group, the CLI included: a job over several ranks is
  submitted from a launcher script that creates one (as
  ``examples/torch_federated_recruitment.py`` does under ``torchrun``).
* ``observability.jax_profile_rounds`` (the key is the reference's, so
  specs hash alike) profiles rounds with ``torch.profiler`` into
  ``torch_profile/`` where the reference writes ``jax_profile/``.

Not to be confused with :mod:`repro_torch.launch.serve`, the decode loop.
"Serve" there means serving predictions; the control plane here serves
*training jobs*.

Each job owns a **run directory**:

    run_dir/
      job.json         # normalized spec + its sha256 spec_hash
      records.jsonl    # the RoundRecord stream, one JSON line per round
      metrics.jsonl    # the metrics registry's snapshot, one line per record
      trace.json       # the span trace (observability.trace; Chrome/Perfetto)
      torch_profile/   # profiled rounds (observability.jax_profile_rounds)
      checkpoint/      # latest federation snapshot (atomic, overwritten)
      final/           # final parameter tree (repro_torch.checkpoint layout)
      result.json      # terminal status + run summary

Records stream *live*: every round/flush appends one JSONL line and fans
out to in-process subscribers before the next round starts, so a watcher
tails progress without waiting for the run.  The snapshot written after
every round (``checkpoint_every`` thins it) carries the job's spec hash;
``resume`` re-validates the spec, rejects a hash mismatch (a resumed job
must be *the same experiment*), truncates the record stream to the
snapshot's prefix, and continues bit-identically — the kill-and-resume
parity contract of the tier-1 suite.

CLI::

    python -m repro_torch.launch.federation_service submit --spec job.json --run-dir d [--device cuda|cpu]
    python -m repro_torch.launch.federation_service status --run-dir d
    python -m repro_torch.launch.federation_service resume --run-dir d [--device cuda|cpu]
    python -m repro_torch.launch.federation_service diff d1 d2
    python -m repro_torch.launch.federation_service registries [--check docs/API_SPEC.md]

``submit``/``resume`` exit 75 (EX_TEMPFAIL) when preempted — the shell
convention for "retry me" — and ``--preempt-after N`` injects a
deterministic preemption after the round-``N`` snapshot for drills.
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import hashlib
import json
import os
import sys
from typing import Any, Callable, Iterable, Sequence

import numpy as np

EX_TEMPFAIL = 75

JOB_FILE = "job.json"
RECORDS_FILE = "records.jsonl"
METRICS_FILE = "metrics.jsonl"
TRACE_FILE = "trace.json"
PROFILE_DIR = "torch_profile"
CHECKPOINT_DIR = "checkpoint"
FINAL_DIR = "final"
RESULT_FILE = "result.json"

REGISTRY_BEGIN = "<!-- registry-table:begin -->"
REGISTRY_END = "<!-- registry-table:end -->"


class JobPreempted(Exception):
    """The run was cut at a snapshot boundary; resume from the run dir."""

    def __init__(self, run_dir: str, round_index: int) -> None:
        super().__init__(
            f"job preempted at round {round_index}; resume with "
            f"`federation_service resume --run-dir {run_dir}`"
        )
        self.run_dir = run_dir
        self.round_index = round_index


# ---------------------------------------------------------------------------
# job-spec schema + validation
# ---------------------------------------------------------------------------

MODES = ("sync", "async")

# Top-level defaults shared by both modes.  Values mirror the facade
# configs so a minimal spec ({"mode": "sync"}) is a runnable job.
_COMMON_DEFAULTS: dict[str, Any] = {
    "name": "job",
    "mode": "sync",
    "rounds": 15,
    "local_epochs": 4,
    "batch_size": 128,
    "seed": 0,
    "recruitment": "all",
    "aggregator": None,  # mode-dependent: "fedavg" sync, "fedbuff" async
    "engine": "vectorized",
    "cohort_chunk": None,
    "mesh": None,  # null or "auto" (device meshes are runtime objects)
    "staging": "resident",
    "prefetch": True,
    "donate_buffers": True,
    "resident_budget_bytes": None,  # null = bake the full cohort resident
    "checkpoint_every": 1,
    "data": None,
    "model": None,
    "optimizer": None,
    "privacy": None,  # null = unprotected; object = in-jit DP-SGD section
    "observability": None,  # null = uninstrumented; object = tracing/profiling
}
_SYNC_DEFAULTS: dict[str, Any] = {"selection": "uniform"}
_ASYNC_DEFAULTS: dict[str, Any] = {
    "latency": "constant",
    "dropout": "never",
    "concurrency": None,
    "target_loss": None,
    "max_virtual_time": None,
}
_DATA_DEFAULTS: dict[str, Any] = {
    "scale": 1.0,          # CohortConfig.scaled factor (1.0 = full cohort)
    "seed": 0,             # cohort generation seed (independent of job seed)
    "split_mode": "global",
    "num_hospitals": None,  # None = the paper's 189
}
_MODEL_DEFAULTS: dict[str, Any] = {
    "hidden_dim": 32,
    "num_layers": 2,
    "dropout": 0.05,
    "use_pallas": False,
}
_PRIVACY_DEFAULTS: dict[str, Any] = {
    "clip_norm": 1.0,          # per-example L2 clip (null = no clipping)
    "noise_multiplier": 1.0,   # sigma / clip_norm (0 = clip-only, no noise)
    "delta": 1e-5,             # accountant's target delta
}
_OPT_DEFAULTS: dict[str, Any] = {
    "learning_rate": 5e-3,
    "weight_decay": 5e-3,
    "b1": 0.9,
    "b2": 0.999,
    "eps": 1e-8,
    "clip_norm": None,
}


def _check_keys(given: Iterable[str], allowed: Iterable[str], where: str) -> None:
    allowed = sorted(allowed)
    for key in given:
        if key in allowed:
            continue
        close = difflib.get_close_matches(key, allowed, n=1)
        hint = f"; did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown key {key!r} in {where}{hint} (allowed: {allowed})"
        )


def _merge_section(spec: dict, key: str, defaults: dict[str, Any]) -> dict:
    section = spec.get(key) or {}
    if not isinstance(section, dict):
        raise ValueError(f"job spec section {key!r} must be an object")
    _check_keys(section, defaults, f"job spec section {key!r}")
    return {**defaults, **section}


def validate_job_spec(spec: dict) -> dict:
    """Validate a raw job spec and return its normalized (complete) form.

    Normalization fills every default so two specs that mean the same job
    hash identically.  Validation is front-loaded: unknown keys and policy
    spec strings fail here with did-you-mean suggestions; numeric
    constraints are enforced by building the actual facade config.
    """
    # Imported lazily so `federation_service --help` stays torch-free.
    from repro_torch.federated.api import (
        resolve_aggregator,
        resolve_recruitment,
        resolve_selection,
    )
    from repro_torch.federated.runtime import (
        AsyncAggregator,
        resolve_dropout,
        resolve_latency,
    )

    if not isinstance(spec, dict):
        raise ValueError(f"job spec must be a JSON object, got {type(spec).__name__}")
    mode = spec.get("mode", _COMMON_DEFAULTS["mode"])
    if mode not in MODES:
        close = difflib.get_close_matches(str(mode), MODES, n=1)
        hint = f"; did you mean {close[0]!r}?" if close else ""
        raise ValueError(f"unknown mode {mode!r}{hint} (choose from {MODES})")
    defaults = dict(_COMMON_DEFAULTS)
    defaults.update(_SYNC_DEFAULTS if mode == "sync" else _ASYNC_DEFAULTS)
    for key in spec:
        if mode == "sync" and key in _ASYNC_DEFAULTS:
            raise ValueError(
                f"job spec key {key!r} is only valid for mode 'async' "
                f"(this job has mode 'sync')"
            )
        if mode == "async" and key in _SYNC_DEFAULTS:
            raise ValueError(
                f"job spec key {key!r} is only valid for mode 'sync' "
                f"(async dispatch replaces per-round selection)"
            )
    _check_keys(spec, defaults, "job spec")

    out = {**defaults, **spec}
    out["mode"] = mode
    if out["aggregator"] is None:
        out["aggregator"] = "fedavg" if mode == "sync" else "fedbuff"
    out["data"] = _merge_section(out, "data", _DATA_DEFAULTS)
    out["model"] = _merge_section(out, "model", _MODEL_DEFAULTS)
    out["optimizer"] = _merge_section(out, "optimizer", _OPT_DEFAULTS)
    # privacy is tri-state: null stays null (unprotected — and hashes
    # differently from any DP job), an object merges over the defaults.
    if out["privacy"] is not None:
        out["privacy"] = _merge_section(out, "privacy", _PRIVACY_DEFAULTS)
        # Strict number validation (rejects JSON strings and booleans,
        # negative clip norms, negative noise) lives with the DP config.
        from repro_torch.privacy.dp import resolve_dp

        resolve_dp(out["privacy"])
    # observability is tri-state like privacy: null means the run is
    # uninstrumented (the hash of an unobserved job stays stable), an
    # object merges over the defaults and is strictly type-checked.
    if out["observability"] is not None:
        from repro_torch.obs.profile import OBSERVABILITY_DEFAULTS, resolve_observability

        out["observability"] = _merge_section(
            out, "observability", OBSERVABILITY_DEFAULTS
        )
        resolve_observability(out["observability"])

    # Policy spec strings: resolve them now so typos die with suggestions.
    resolve_recruitment(out["recruitment"])
    aggregator = resolve_aggregator(out["aggregator"])
    if mode == "sync":
        resolve_selection(out["selection"])
        if isinstance(aggregator, AsyncAggregator):
            raise ValueError(
                f"aggregator {out['aggregator']!r} is buffered/asynchronous; "
                "set mode='async' to run it on the virtual-clock runtime"
            )
    else:
        resolve_latency(out["latency"])
        resolve_dropout(out["dropout"])
        if not isinstance(aggregator, AsyncAggregator):
            raise ValueError(
                f"aggregator {out['aggregator']!r} is synchronous; mode='async' "
                "needs a buffered aggregator ('fedbuff:K', "
                "'hierarchical-async:R') — or set mode='sync'"
            )
    if int(out["checkpoint_every"]) < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {out['checkpoint_every']}"
        )
    if not isinstance(out["model"]["use_pallas"], bool):
        # bool() would truthy-coerce "false" to True — reject anything but
        # a JSON boolean before it reaches the kernel-path switch.
        raise ValueError(
            "model.use_pallas must be a JSON boolean (true/false), "
            f"got {out['model']['use_pallas']!r}"
        )
    if not (float(out["data"]["scale"]) > 0):
        raise ValueError(f"data.scale must be > 0, got {out['data']['scale']}")
    if out["mesh"] not in (None, "auto"):
        raise ValueError(
            f"mesh must be null or 'auto' in a job spec, got {out['mesh']!r} "
            "(device meshes are runtime objects; pass one via the Python API)"
        )
    # Everything numeric flows through the frozen facade configs, whose
    # __post_init__ owns the constraints — build one to fail fast.
    federation_config_from_spec(out)
    return out


def job_spec_hash(spec: dict) -> str:
    """sha256 of the canonical JSON form of a *normalized* spec."""
    canon = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def federation_config_from_spec(spec: dict):
    """Normalized spec -> FederationConfig / AsyncFederationConfig."""
    from repro_torch.federated.api import FederationConfig
    from repro_torch.federated.runtime import AsyncFederationConfig

    common = dict(
        rounds=int(spec["rounds"]),
        local_epochs=int(spec["local_epochs"]),
        batch_size=int(spec["batch_size"]),
        recruitment=spec["recruitment"],
        aggregator=spec["aggregator"],
        seed=int(spec["seed"]),
        engine=spec["engine"],
        cohort_chunk=spec["cohort_chunk"],
        mesh=spec.get("mesh"),
        donate_buffers=bool(spec["donate_buffers"]),
        staging=spec["staging"],
        prefetch=bool(spec["prefetch"]),
        resident_budget_bytes=(
            None
            if spec["resident_budget_bytes"] is None
            else int(spec["resident_budget_bytes"])
        ),
        # .get(): snapshots written before the privacy tier existed carry
        # specs without the key — they resume as unprotected jobs.
        privacy=spec.get("privacy"),
    )
    if spec["mode"] == "sync":
        return FederationConfig(selection=spec["selection"], **common)
    return AsyncFederationConfig(
        latency=spec["latency"],
        dropout=spec["dropout"],
        concurrency=spec["concurrency"],
        target_loss=spec["target_loss"],
        max_virtual_time=spec["max_virtual_time"],
        **common,
    )


# ---------------------------------------------------------------------------
# workload construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Workload:
    """Everything a facade needs beyond its config, built from one spec."""

    clients: list
    loss_fn: Callable[..., Any]
    optimizer: Any
    init_params: Any
    model_cfg: Any


def build_workload(spec: dict, device=None) -> Workload:
    """Materialize the spec's data/model/optimizer sections.

    The cohort is the synthetic eICU generator (``data.seed`` keeps it
    independent of the training seed so the same federation can be trained
    under many seeds), the model is the paper's GRU with ``input_dim``
    derived from the cohort's feature layout, and params are initialized on
    ``device`` (``None`` is the card) from the *job* seed with the torch
    init, as ``experiments/paper.py::run_async_comparison`` does — all
    deterministic, so resume rebuilds the exact same workload from job.json
    alone.  ``model.use_pallas`` chooses nothing here.
    """
    import torch

    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
    from repro_torch.device import resolve_device
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    dev = resolve_device(device)
    data = spec["data"]
    cohort_cfg = CohortConfig(split_mode=data["split_mode"])
    if data["num_hospitals"] is not None:
        cohort_cfg = dataclasses.replace(
            cohort_cfg, num_hospitals=int(data["num_hospitals"])
        )
    if float(data["scale"]) != 1.0:
        cohort_cfg = cohort_cfg.scaled(float(data["scale"]))
    cohort = generate_cohort(cohort_cfg, seed=int(data["seed"]))
    clients = build_client_datasets(cohort)

    model = spec["model"]
    model_cfg = GRUConfig(
        input_dim=cohort_cfg.num_temporal + cohort_cfg.num_static,
        hidden_dim=int(model["hidden_dim"]),
        num_layers=int(model["num_layers"]),
        dropout=float(model["dropout"]),
    )
    opt = spec["optimizer"]
    optimizer = AdamW(
        learning_rate=float(opt["learning_rate"]),
        weight_decay=float(opt["weight_decay"]),
        b1=float(opt["b1"]),
        b2=float(opt["b2"]),
        eps=float(opt["eps"]),
        clip_norm=None if opt["clip_norm"] is None else float(opt["clip_norm"]),
    )
    init_params = init_gru(torch.Generator().manual_seed(int(spec["seed"])), model_cfg, dev)
    return Workload(
        clients=clients,
        loss_fn=make_loss_fn(model_cfg),
        optimizer=optimizer,
        init_params=init_params,
        model_cfg=model_cfg,
    )


# ---------------------------------------------------------------------------
# record streaming
# ---------------------------------------------------------------------------


class RecordStream:
    """Fans each RoundRecord out to a JSONL sink and live subscribers.

    The JSONL line is written and flushed *before* subscribers run, so an
    external tail sees every round the in-process watchers saw even if a
    subscriber (or the run) dies mid-round.
    """

    def __init__(
        self,
        path: str | None,
        subscribers: Sequence[Callable[[Any], None]] = (),
        append: bool = False,
    ) -> None:
        self.path = path
        self.subscribers = list(subscribers)
        if path is not None and not append:
            with open(path, "w", encoding="utf-8"):
                pass  # truncate: a fresh run owns the whole stream
        self.count = 0

    def emit(self, record) -> None:
        if self.path is not None:
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(record.to_state(), sort_keys=True) + "\n")
                fh.flush()
        self.count += 1
        for fn in self.subscribers:
            fn(record)


def read_records(path: str) -> list:
    """Parse a records.jsonl stream back into RoundRecords."""
    from repro_torch.federated.api import RoundRecord

    records = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(RoundRecord.from_state(json.loads(line)))
    return records


def _rewrite_records(path: str, history: list) -> None:
    """Truncate the stream to a snapshot's record prefix (atomic)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        for record in history:
            fh.write(json.dumps(record.to_state(), sort_keys=True) + "\n")
    os.replace(tmp, path)


def _truncate_jsonl_prefix(path: str, count: int) -> None:
    """Keep only the first ``count`` lines of a JSONL stream (atomic).

    The metrics stream emits exactly one line per record, so truncating it
    to the snapshot's record count keeps the two files in lockstep when a
    preempted run rolls back past rounds the cut already streamed.
    """
    if not os.path.exists(path):
        return
    with open(path, encoding="utf-8") as fh:
        lines = [line for line in fh if line.strip()]
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.writelines(lines[:count])
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# job execution
# ---------------------------------------------------------------------------


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _run_job(
    job: dict,
    run_dir: str,
    workload: Workload,
    device,
    *,
    resume_snapshot=None,
    subscribers: Sequence[Callable[[Any], None]] = (),
    preempt_after: int | None = None,
) -> dict:
    """Shared submit/resume engine: run, snapshot, finalize."""
    from repro_torch.checkpoint.store import (
        federation_snapshot_state,
        has_federation_snapshot,
        save_pytree,
    )
    from repro_torch.federated.api import Federation
    from repro_torch.federated.runtime import AsyncFederation
    from repro_torch.launch.mesh import is_writer, resolve_mesh
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.profile import RoundProfiler, resolve_observability
    from repro_torch.obs.trace import Tracer

    spec = job["spec"]
    spec_hash = job["spec_hash"]
    cfg = federation_config_from_spec(spec)
    ckpt_dir = os.path.join(run_dir, CHECKPOINT_DIR)
    # Under a mesh of several ranks only rank 0 writes the run dir.
    writer = is_writer(resolve_mesh(spec.get("mesh")))

    # Observability: the metrics registry always exists (metrics.jsonl is
    # part of the run-dir contract); the tracer and profiler only when the
    # spec's observability section asks for them, and only on the writer.
    # .get(): job.json files written before the observability tier existed
    # resume uninstrumented.
    obs = resolve_observability(spec.get("observability")) if writer else None
    metrics = MetricsRegistry()
    if resume_snapshot is not None and has_federation_snapshot(ckpt_dir):
        # Continue the series: counters resume from the snapshot instead of
        # restarting at zero (the metrics.jsonl prefix was truncated to the
        # same snapshot by resume_job).
        metrics.load_snapshot(federation_snapshot_state(ckpt_dir).get("metrics"))
    tracer = Tracer(capacity=obs.trace_capacity) if obs is not None and obs.trace else None
    profiler = (
        RoundProfiler(obs.jax_profile_rounds, os.path.join(run_dir, PROFILE_DIR), device)
        if obs is not None and obs.jax_profile_rounds > 0
        else None
    )

    metrics_path = os.path.join(run_dir, METRICS_FILE)
    if resume_snapshot is None and writer:
        with open(metrics_path, "w", encoding="utf-8"):
            pass  # truncate: a fresh run owns the whole series

    def stream_metrics(record) -> None:
        # Runs after the facade absorbed the round into the registry, so
        # the line is the cumulative state *through* this record.
        line = {"round_index": int(record.round_index), **metrics.snapshot()}
        with open(metrics_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(line, sort_keys=True) + "\n")
            fh.flush()

    stream = RecordStream(
        os.path.join(run_dir, RECORDS_FILE) if writer else None,
        [stream_metrics, *subscribers] if writer else subscribers,
        append=resume_snapshot is not None,
    )
    every = int(spec["checkpoint_every"])

    def snapshot_hook(snap) -> None:
        index = int(snap.round_index)
        preempt = preempt_after is not None and index >= preempt_after
        if writer and (index % every == 0 or preempt):
            snap.save(
                ckpt_dir,
                extra_state={"spec_hash": spec_hash, "metrics": metrics.snapshot()},
            )
        if preempt:
            if writer:
                _write_json(
                    os.path.join(run_dir, RESULT_FILE),
                    {"status": "preempted", "round_index": index, "spec_hash": spec_hash},
                )
            raise JobPreempted(run_dir, index)

    facade_cls = Federation if spec["mode"] == "sync" else AsyncFederation
    federation = facade_cls(
        cfg,
        workload.clients,
        workload.loss_fn,
        workload.optimizer,
        device=device,
        tracer=tracer,
        metrics=metrics,
        profiler=profiler,
    )
    try:
        result = federation.run(
            workload.init_params,
            progress=stream.emit,
            snapshot_hook=snapshot_hook,
            resume=resume_snapshot,
        )
    finally:
        # Preempted runs keep their partial trace too: the ring holds
        # whatever happened up to the cut.
        if tracer is not None:
            tracer.export_chrome(os.path.join(run_dir, TRACE_FILE))
        if profiler is not None:
            profiler.stop()

    if writer:
        save_pytree(
            os.path.join(run_dir, FINAL_DIR),
            result.params,
            metadata={"spec_hash": spec_hash, "rounds": len(result.history)},
        )
    summary = result.summary()
    out = {
        "status": "completed",
        "spec_hash": spec_hash,
        "name": spec["name"],
        "mode": spec["mode"],
        "summary": summary,
        "resumed_from": None
        if resume_snapshot is None
        else int(resume_snapshot.round_index),
    }
    if writer:
        _write_json(os.path.join(run_dir, RESULT_FILE), out)
    return out


def submit_job(
    spec: dict,
    run_dir: str,
    *,
    subscribers: Sequence[Callable[[Any], None]] = (),
    preempt_after: int | None = None,
    device=None,
) -> dict:
    """Validate a spec, persist it, and run the job in ``run_dir``.

    ``device`` is where the job trains (``None`` is the card, ``"cpu"`` the
    plain versions).  Returns the result dict (also written to
    ``result.json``).  Raises :class:`JobPreempted` if ``preempt_after``
    cuts the run — the run dir then holds everything :func:`resume_job`
    needs.
    """
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import is_writer, resolve_mesh

    normalized = validate_job_spec(spec)
    device = resolve_device(device)
    job = {"spec": normalized, "spec_hash": job_spec_hash(normalized)}
    if is_writer(resolve_mesh(normalized["mesh"])):
        os.makedirs(run_dir, exist_ok=True)
        _write_json(os.path.join(run_dir, JOB_FILE), job)
    return _run_job(
        job,
        run_dir,
        build_workload(normalized, device),
        device,
        subscribers=subscribers,
        preempt_after=preempt_after,
    )


def resume_job(
    run_dir: str,
    *,
    spec: dict | None = None,
    subscribers: Sequence[Callable[[Any], None]] = (),
    preempt_after: int | None = None,
    device=None,
) -> dict:
    """Continue a preempted job from its latest snapshot, on ``device``.

    The snapshot's embedded spec hash must match the job's (and the
    optional caller-supplied ``spec``): resuming under a different spec
    would silently produce a run that is neither experiment.  The record
    stream is truncated to the snapshot's prefix, so the resumed
    ``records.jsonl`` matches the uninterrupted one (host times aside).
    """
    from repro_torch.checkpoint.store import (
        federation_snapshot_state,
        has_federation_snapshot,
    )
    from repro_torch.device import resolve_device
    from repro_torch.federated.api import FederationSnapshot
    from repro_torch.federated.runtime import AsyncFederationSnapshot
    from repro_torch.launch.mesh import barrier, is_writer, resolve_mesh

    device = resolve_device(device)
    job = _read_json(os.path.join(run_dir, JOB_FILE))
    stored_hash = job["spec_hash"]
    if job_spec_hash(job["spec"]) != stored_hash:
        raise ValueError(f"job.json in {run_dir} is corrupt: spec_hash mismatch")
    if spec is not None:
        supplied = job_spec_hash(validate_job_spec(spec))
        if supplied != stored_hash:
            raise ValueError(
                f"supplied spec (hash {supplied[:12]}…) does not match the "
                f"submitted job (hash {stored_hash[:12]}…); a resumed job "
                "must run the exact spec it was submitted with"
            )
    ckpt_dir = os.path.join(run_dir, CHECKPOINT_DIR)
    if not has_federation_snapshot(ckpt_dir):
        raise FileNotFoundError(
            f"no federation snapshot in {ckpt_dir}; nothing to resume"
        )
    snap_hash = federation_snapshot_state(ckpt_dir).get("spec_hash")
    if snap_hash != stored_hash:
        raise ValueError(
            f"snapshot spec_hash {str(snap_hash)[:12]}… does not match job "
            f"spec_hash {stored_hash[:12]}…; refusing to resume a different "
            "experiment's checkpoint"
        )
    workload = build_workload(job["spec"], device)
    snapshot_cls = (
        FederationSnapshot if job["spec"]["mode"] == "sync" else AsyncFederationSnapshot
    )
    snapshot = snapshot_cls.load(ckpt_dir, workload.init_params)
    mesh = resolve_mesh(job["spec"].get("mesh"))
    if is_writer(mesh):
        _rewrite_records(os.path.join(run_dir, RECORDS_FILE), snapshot.history)
        _truncate_jsonl_prefix(os.path.join(run_dir, METRICS_FILE), len(snapshot.history))
    if mesh is not None:
        # Rank 0 overwrites the snapshot at its next checkpoint: not before
        # every rank has read this one.
        barrier(mesh)
    return _run_job(
        job,
        run_dir,
        workload,
        device,
        resume_snapshot=snapshot,
        subscribers=subscribers,
        preempt_after=preempt_after,
    )


def status_job(run_dir: str) -> dict:
    """Inspect a run dir from its JSON manifests (no array payloads read)."""
    from repro_torch.checkpoint.store import (
        federation_snapshot_state,
        has_federation_snapshot,
    )

    out: dict[str, Any] = {"run_dir": run_dir, "status": "unknown"}
    job_path = os.path.join(run_dir, JOB_FILE)
    if not os.path.exists(job_path):
        out["status"] = "missing"
        return out
    job = _read_json(job_path)
    out["name"] = job["spec"]["name"]
    out["mode"] = job["spec"]["mode"]
    out["spec_hash"] = job["spec_hash"]
    out["rounds_budget"] = job["spec"]["rounds"]
    records_path = os.path.join(run_dir, RECORDS_FILE)
    out["rounds_recorded"] = 0
    if os.path.exists(records_path):
        with open(records_path, encoding="utf-8") as fh:
            out["rounds_recorded"] = sum(1 for line in fh if line.strip())
    ckpt_dir = os.path.join(run_dir, CHECKPOINT_DIR)
    if has_federation_snapshot(ckpt_dir):
        state = federation_snapshot_state(ckpt_dir)
        out["checkpoint_round"] = state.get("round_index", state.get("version"))
    result_path = os.path.join(run_dir, RESULT_FILE)
    if os.path.exists(result_path):
        result = _read_json(result_path)
        out["status"] = result["status"]
        if "summary" in result:
            out["summary"] = result["summary"]
        if "round_index" in result:
            out["preempted_at"] = result["round_index"]
    else:
        out["status"] = "submitted"
    return out


def diff_runs(run_a: str, run_b: str, atol: float = 1e-5) -> list[str]:
    """Compare two finished runs; returns human-readable mismatches.

    Used by the CI kill-and-resume drill: a resumed run dir must match the
    uninterrupted one — records pairwise (virtual clock and participants
    exact, losses to ``atol``) and final params to ``atol``.
    """
    problems: list[str] = []
    recs_a = read_records(os.path.join(run_a, RECORDS_FILE))
    recs_b = read_records(os.path.join(run_b, RECORDS_FILE))
    if len(recs_a) != len(recs_b):
        problems.append(f"record count: {len(recs_a)} vs {len(recs_b)}")
    for ra, rb in zip(recs_a, recs_b):
        tag = f"round {ra.round_index}"
        if ra.round_index != rb.round_index:
            problems.append(f"{tag}: index mismatch ({rb.round_index})")
        if ra.participant_ids != rb.participant_ids:
            problems.append(f"{tag}: participant_ids differ")
        if ra.virtual_time != rb.virtual_time:
            problems.append(
                f"{tag}: virtual_time {ra.virtual_time} vs {rb.virtual_time}"
            )
        la, lb = ra.mean_local_loss, rb.mean_local_loss
        if np.isnan(la) != np.isnan(lb) or (
            not np.isnan(la) and abs(la - lb) > atol
        ):
            problems.append(f"{tag}: mean_local_loss {la} vs {lb}")
    for name in ("arrays.npz",):
        pa = os.path.join(run_a, FINAL_DIR, name)
        pb = os.path.join(run_b, FINAL_DIR, name)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            problems.append(f"final params missing ({name})")
            continue
        with np.load(pa) as za, np.load(pb) as zb:
            if sorted(za.files) != sorted(zb.files):
                problems.append("final params: tensor sets differ")
                continue
            for key in za.files:
                if not np.allclose(za[key], zb[key], atol=atol, rtol=0):
                    worst = float(np.max(np.abs(za[key] - zb[key])))
                    problems.append(f"final params: {key} differs (max {worst:.3e})")
    return problems


# ---------------------------------------------------------------------------
# registry table (docs drift check)
# ---------------------------------------------------------------------------


def registry_table() -> str:
    """The generated markdown table of every registered spec name.

    docs/API_SPEC.md embeds this between the ``registry-table`` markers;
    `federation_service registries --check` fails CI when a registry gains
    or loses a name without the committed table following.
    """
    from repro_torch.federated.api import available_policies
    from repro_torch.federated.runtime import available_runtime_models

    rows = {**available_policies(), **available_runtime_models()}
    lines = ["| Stage | Registered specs |", "| --- | --- |"]
    for stage in sorted(rows):
        specs = ", ".join(f"`{name}`" for name in rows[stage])
        lines.append(f"| {stage} | {specs} |")
    return "\n".join(lines)


def check_registry_table(path: str) -> list[str]:
    """Compare the committed table in ``path`` against the generated one."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if REGISTRY_BEGIN not in text or REGISTRY_END not in text:
        return [f"{path} has no {REGISTRY_BEGIN} … {REGISTRY_END} block"]
    committed = text.split(REGISTRY_BEGIN, 1)[1].split(REGISTRY_END, 1)[0].strip()
    generated = registry_table().strip()
    if committed != generated:
        return [
            f"{path} registry table is stale; regenerate with "
            "`python -m repro_torch.launch.federation_service registries "
            f"--write {path}`"
        ]
    return []


def write_registry_table(path: str) -> None:
    """Rewrite the marked block in ``path`` with the generated table."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if REGISTRY_BEGIN not in text or REGISTRY_END not in text:
        raise ValueError(f"{path} has no {REGISTRY_BEGIN} … {REGISTRY_END} block")
    head, rest = text.split(REGISTRY_BEGIN, 1)
    _, tail = rest.split(REGISTRY_END, 1)
    new = f"{head}{REGISTRY_BEGIN}\n{registry_table()}\n{REGISTRY_END}{tail}"
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(new)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _progress_printer(record) -> None:
    vt = "" if record.virtual_time is None else f"  vt={record.virtual_time:.2f}"
    print(
        f"round {record.round_index:3d}  loss={record.mean_local_loss:.4f}  "
        f"clients={len(record.participant_ids)}{vt}",
        flush=True,
    )


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="federation_service",
        description="Declarative federated-training job service "
        "(submit / status / resume / diff / registries).",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_submit = sub.add_parser("submit", help="validate a job spec and run it")
    p_submit.add_argument("--spec", required=True, help="path to the job-spec JSON")
    p_submit.add_argument("--run-dir", required=True)
    p_submit.add_argument("--preempt-after", type=int, default=None, metavar="N",
                          help="deterministically preempt after the round-N snapshot")
    p_submit.add_argument("--quiet", action="store_true")
    p_submit.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                          help="where the job trains (default: the card)")

    p_status = sub.add_parser("status", help="summarize a run directory")
    p_status.add_argument("--run-dir", required=True)

    p_resume = sub.add_parser("resume", help="continue from the latest snapshot")
    p_resume.add_argument("--run-dir", required=True)
    p_resume.add_argument("--spec", default=None,
                          help="optional spec to re-verify against the job's hash")
    p_resume.add_argument("--preempt-after", type=int, default=None, metavar="N")
    p_resume.add_argument("--quiet", action="store_true")
    p_resume.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                          help="where the job trains (default: the card)")

    p_diff = sub.add_parser("diff", help="compare two finished run dirs")
    p_diff.add_argument("run_a")
    p_diff.add_argument("run_b")
    p_diff.add_argument("--atol", type=float, default=1e-5)

    p_reg = sub.add_parser("registries", help="print or check the registry table")
    p_reg.add_argument("--check", default=None, metavar="FILE",
                       help="fail if FILE's registry-table block is stale")
    p_reg.add_argument("--write", default=None, metavar="FILE",
                       help="rewrite FILE's registry-table block in place")

    args = parser.parse_args(argv)

    if args.command == "submit":
        with open(args.spec, encoding="utf-8") as fh:
            spec = json.load(fh)
        subscribers = () if args.quiet else (_progress_printer,)
        try:
            result = submit_job(
                spec, args.run_dir,
                subscribers=subscribers, preempt_after=args.preempt_after,
                device=args.device,
            )
        except JobPreempted as exc:
            print(exc, file=sys.stderr)
            return EX_TEMPFAIL
        print(json.dumps(result["summary"], indent=2, sort_keys=True))
        return 0

    if args.command == "status":
        print(json.dumps(status_job(args.run_dir), indent=2, sort_keys=True))
        return 0

    if args.command == "resume":
        spec = None
        if args.spec is not None:
            with open(args.spec, encoding="utf-8") as fh:
                spec = json.load(fh)
        subscribers = () if args.quiet else (_progress_printer,)
        try:
            result = resume_job(
                args.run_dir, spec=spec,
                subscribers=subscribers, preempt_after=args.preempt_after,
                device=args.device,
            )
        except JobPreempted as exc:
            print(exc, file=sys.stderr)
            return EX_TEMPFAIL
        print(json.dumps(result["summary"], indent=2, sort_keys=True))
        return 0

    if args.command == "diff":
        problems = diff_runs(args.run_a, args.run_b, atol=args.atol)
        if problems:
            for p in problems:
                print(f"DIFF: {p}", file=sys.stderr)
            return 1
        print(f"runs match: {args.run_a} == {args.run_b}")
        return 0

    if args.command == "registries":
        if args.write is not None:
            write_registry_table(args.write)
            print(f"updated registry table in {args.write}")
            return 0
        if args.check is not None:
            problems = check_registry_table(args.check)
            if problems:
                for p in problems:
                    print(f"DRIFT: {p}", file=sys.stderr)
                return 1
            print(f"registry table in {args.check} is current")
            return 0
        print(registry_table())
        return 0

    raise AssertionError(f"unhandled command {args.command!r}")  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
