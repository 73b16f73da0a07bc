"""The port's federation control plane against the JAX package's.

The port of ``tests/test_federation_service.py`` case by case, run on the
port (``device="cpu"``): spec validation with did-you-mean suggestions,
spec-hash identity, JSONL record round trips, kill-and-resume parity of a
sync job and of an async ``fedbuff:K`` job under straggler latency and
dropout (``diff_runs(cut, full) == []``: virtual times and participants
exact, losses and final params within 1e-5), the preempted run dir's
state, the resume rejections, the CLI flow (exit 75 on preemption, ``diff``
exit codes) and the generated registry table.  Then, against the reference:

* ``validate_job_spec`` and ``job_spec_hash`` equal on the reference's
  test specs, the privacy specs and ``job_spec_for`` of every federated
  setting (hashes string-equal), the rejection messages equal, and
  ``registry_table()`` equal;
* the same job from the same initial params (the reference's
  ``init_gru(jax.random.key(seed))`` carried into the port's service), at
  model dropout 0: participants, local steps, virtual times and staleness
  exact, losses within 1e-5, final params within 1e-4 — except the sync
  spec at its own AdamW eps (1e-8), whose params sit 2.62e-4 apart at one
  entry where a client's gradient is ~1e-8 and AdamW turns the float
  association of two libraries into a step difference (ROADMAP Queue 3):
  that case is held to ``ADAMW_EPS_DRIFT_TOL`` (about twice the gap), the
  same job at eps 1e-4 to 1e-4 (it measures 7.2e-7), and the workload's
  step gradients to 1e-6 of the reference's.  The reference runs rebuild
  staging: its resident path traces anew for every one-client task on the
  CPU;
* a DP job cut and resumed gives the uninterrupted epsilons; the metrics
  stream has one line per record and continues across a resume;
* a job killed with SIGKILL in a subprocess resumes to the uninterrupted
  run; the options not ported yet raise before any training.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.experiments import paper as jax_paper  # noqa: E402
from repro.launch import federation_service as R  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.federated.api import RoundRecord  # noqa: E402
from repro_torch.launch.federation_service import (  # noqa: E402
    EX_TEMPFAIL,
    JobPreempted,
    RecordStream,
    build_workload,
    check_registry_table,
    diff_runs,
    federation_config_from_spec,
    job_spec_hash,
    main,
    read_records,
    registry_table,
    resume_job,
    status_job,
    submit_job,
    validate_job_spec,
)
from repro_torch.models import gru  # noqa: E402

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = 1e-5
PARAMS_TOL = 1e-4
GRAD_TOL = 1e-6
# The sync spec at AdamW eps 1e-8 measured 2.62e-4 (one w_ih entry); see the
# module docstring.
ADAMW_EPS_DRIFT_TOL = 5e-4

# The reference's test specs: 8 hospitals, a 2-unit GRU, a handful of rounds.
SYNC_SPEC = {
    "name": "t-sync",
    "mode": "sync",
    "rounds": 3,
    "local_epochs": 1,
    "batch_size": 8,
    "seed": 3,
    "recruitment": "all",
    "selection": "loss-weighted:2",
    "data": {"scale": 0.002, "num_hospitals": 8, "split_mode": "stratified"},
    "model": {"hidden_dim": 2, "num_layers": 1},
}
ASYNC_SPEC = {
    "name": "t-async",
    "mode": "async",
    "rounds": 4,
    "local_epochs": 1,
    "batch_size": 8,
    "seed": 3,
    "recruitment": "all",
    "aggregator": "fedbuff:3",
    "latency": "lognormal:0.6",
    "dropout": "bernoulli:0.1",
    "concurrency": 4,
    "data": {"scale": 0.002, "num_hospitals": 8, "split_mode": "stratified"},
    "model": {"hidden_dim": 2, "num_layers": 1},
}
# The privacy specs of tests/test_privacy_spec.py.
PRIVACY_SPECS = [
    {"mode": "sync", "privacy": {}},
    {"mode": "sync", "privacy": {"noise_multiplier": 0.5}},
    {"mode": "sync", "privacy": {"noise_multiplier": 1.3}},
    {"mode": "sync", "privacy": {"noise_multiplier": 0.7}},
    {"mode": "sync", "privacy": {"clip_norm": 2.0}},
    {"mode": "async", "privacy": {"noise_multiplier": 0.0, "clip_norm": None}},
    {"mode": "sync", "privacy": {"clip_norm": None, "noise_multiplier": 0.0}},
    {"mode": "sync", "privacy": {"clip_norm": 2.0, "noise_multiplier": 0.5, "delta": 1e-6}},
]
FEDERATED_SETTINGS = tuple(s for s in paper.MODEL_SETTINGS if s != "central")


def submit(spec, run_dir, **kw):
    return submit_job(copy.deepcopy(spec), str(run_dir), device=CPU, **kw)


def final_params(run_dir):
    with np.load(os.path.join(run_dir, "final", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------
# spec validation + hashing (the reference's cases)
# --------------------------------------------------------------------------


def test_validate_fills_defaults_and_normalizes():
    out = validate_job_spec({"mode": "sync"})
    assert out["rounds"] == 15
    assert out["selection"] == "uniform"
    assert out["aggregator"] == "fedavg"
    assert out["optimizer"]["learning_rate"] == 5e-3
    assert out["data"]["scale"] == 1.0
    out_async = validate_job_spec({"mode": "async"})
    assert out_async["aggregator"] == "fedbuff"
    assert out_async["latency"] == "constant"


def test_validate_rejects_unknown_keys_with_suggestion():
    with pytest.raises(ValueError, match="did you mean 'recruitment'"):
        validate_job_spec({"mode": "sync", "recrutment": "all"})
    with pytest.raises(ValueError, match="did you mean 'hidden_dim'"):
        validate_job_spec({"mode": "sync", "model": {"hiden_dim": 4}})
    with pytest.raises(ValueError, match="did you mean 'async'"):
        validate_job_spec({"mode": "asink"})
    with pytest.raises(ValueError, match="did you mean 'nu-greedy'"):
        validate_job_spec({"mode": "sync", "recruitment": "nu-greedee"})
    with pytest.raises(ValueError, match="did you mean 'lognormal'"):
        validate_job_spec({"mode": "async", "latency": "lognormel:0.5"})


def test_validate_cross_checks_mode_and_policies():
    with pytest.raises(ValueError, match="mode='async'"):
        validate_job_spec({"mode": "sync", "aggregator": "fedbuff:4"})
    with pytest.raises(ValueError, match="buffered aggregator"):
        validate_job_spec({"mode": "async", "aggregator": "fedavg"})
    with pytest.raises(ValueError, match="only valid for mode 'sync'"):
        validate_job_spec({"mode": "async", "selection": "uniform"})
    with pytest.raises(ValueError, match="only valid for mode 'async'"):
        validate_job_spec({"mode": "sync", "latency": "constant"})
    with pytest.raises(ValueError, match="checkpoint_every"):
        validate_job_spec({"mode": "sync", "checkpoint_every": 0})
    with pytest.raises(ValueError, match="mesh"):
        validate_job_spec({"mode": "sync", "mesh": "ring"})
    with pytest.raises(ValueError, match="must be a JSON object"):
        validate_job_spec(["not", "a", "dict"])


def test_spec_hash_is_canonical_and_sensitive():
    a = validate_job_spec(copy.deepcopy(SYNC_SPEC))
    reordered = validate_job_spec(dict(reversed(list(SYNC_SPEC.items()))))
    assert job_spec_hash(a) == job_spec_hash(reordered)
    explicit = copy.deepcopy(SYNC_SPEC)
    explicit["engine"] = "vectorized"  # already the default
    assert job_spec_hash(validate_job_spec(explicit)) == job_spec_hash(a)
    changed = copy.deepcopy(SYNC_SPEC)
    changed["seed"] = 4
    assert job_spec_hash(validate_job_spec(changed)) != job_spec_hash(a)


def test_model_use_pallas_round_trips_through_spec_hash():
    """Accepted and hashed as in the reference; in the port it chooses
    nothing (the tensors' device routes every GRU call)."""
    out = validate_job_spec(copy.deepcopy(SYNC_SPEC))
    assert out["model"]["use_pallas"] is False
    flagged = copy.deepcopy(SYNC_SPEC)
    flagged["model"]["use_pallas"] = True
    a = validate_job_spec(flagged)
    assert a["model"]["use_pallas"] is True
    assert job_spec_hash(a) != job_spec_hash(out)
    assert job_spec_hash(validate_job_spec(copy.deepcopy(a))) == job_spec_hash(a)
    explicit = copy.deepcopy(SYNC_SPEC)
    explicit["model"]["use_pallas"] = False
    assert job_spec_hash(validate_job_spec(explicit)) == job_spec_hash(out)
    with pytest.raises(ValueError, match="use_pallas must be a JSON boolean"):
        validate_job_spec({"mode": "sync", "model": {"use_pallas": "false"}})
    with pytest.raises(ValueError, match="did you mean 'use_palas'|did you mean 'use_pallas'"):
        validate_job_spec({"mode": "sync", "model": {"use_palas": True}})
    assert build_workload(a, CPU).model_cfg == build_workload(out, CPU).model_cfg


def test_paper_settings_render_as_valid_job_specs():
    exp = paper.ExperimentConfig(cohort_scale=0.01, rounds=2, local_epochs=1, batch_size=8)
    for setting in ("federated-ac", "federated-sc", "federated-arc", "federated-src"):
        spec = validate_job_spec(paper.job_spec_for(setting, exp, seed=1))
        assert spec["mode"] == "sync"
        assert spec["data"]["scale"] == 0.01
    src = validate_job_spec(paper.job_spec_for("federated-src", exp))
    assert src["recruitment"].startswith("nu-greedy:")
    assert src["selection"] == "uniform:0.1"
    with pytest.raises(ValueError, match="pooled training"):
        paper.job_spec_for("central", exp)


# --------------------------------------------------------------------------
# spec validation + hashing against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [SYNC_SPEC, ASYNC_SPEC, {"mode": "sync"}, {"mode": "async"},
                                  *PRIVACY_SPECS, {"mode": "sync", "observability": {}},
                                  {"mode": "sync", "observability": {"trace": False}}],
                         ids=lambda s: s.get("name", json.dumps(s, sort_keys=True)))
def test_normalized_spec_and_hash_equal_the_references(spec):
    ours = validate_job_spec(copy.deepcopy(spec))
    ref = R.validate_job_spec(copy.deepcopy(spec))
    assert ours == ref
    assert job_spec_hash(ours) == R.job_spec_hash(ref)


@pytest.mark.parametrize("setting", FEDERATED_SETTINGS)
def test_job_spec_for_equals_the_references(setting):
    for kw in ({}, {"rounds": 3, "cohort_scale": 0.05, "staging": "rebuild",
                    "aggregator": "trimmed-mean:0.1", "selection": "round-robin:3"}):
        spec = paper.job_spec_for(setting, paper.ExperimentConfig(**kw), seed=2)
        ref = jax_paper.job_spec_for(setting, jax_paper.ExperimentConfig(**kw), seed=2)
        assert spec == ref
        assert job_spec_hash(validate_job_spec(spec)) == R.job_spec_hash(R.validate_job_spec(ref))


BAD_SPECS = [
    ["not", "a", "dict"],
    {"mode": "asink"},
    {"mode": "sync", "recrutment": "all"},
    {"mode": "sync", "model": {"hiden_dim": 4}},
    {"mode": "sync", "model": {"use_pallas": "false"}},
    {"mode": "sync", "recruitment": "nu-greedee"},
    {"mode": "async", "latency": "lognormel:0.5"},
    {"mode": "async", "dropout": "bernouli:0.1"},
    {"mode": "sync", "aggregator": "fedbuff:4"},
    {"mode": "async", "aggregator": "fedavg"},
    {"mode": "async", "selection": "uniform"},
    {"mode": "sync", "latency": "constant"},
    {"mode": "sync", "checkpoint_every": 0},
    {"mode": "sync", "mesh": "ring"},
    {"mode": "sync", "data": {"scale": 0}},
    {"mode": "sync", "data": "big"},
    {"mode": "sync", "engine": "warp"},
    {"mode": "sync", "staging": "cached"},
    {"mode": "sync", "selection": "uniform:1.5"},
    {"mode": "async", "rounds": 0},
    {"mode": "async", "concurrency": 0},
    {"mode": "sync", "privacy": {"clip_norm": "0.1"}},
    {"mode": "sync", "privacy": {"noise_multiplier": True}},
    {"mode": "sync", "privacy": {"clip_norm": -1.0}},
    {"mode": "sync", "privacy": {"clipnorm": 1.0}},
    {"mode": "sync", "privacy": "dp"},
    {"mode": "sync", "privacy": {"clip_norm": None, "noise_multiplier": 1.0}},
    {"mode": "sync", "observability": {"trace": 1}},
    {"mode": "sync", "observability": {"tracee": True}},
    {"mode": "sync", "observability": {"trace_capacity": 0}},
]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=lambda s: json.dumps(s, sort_keys=True))
def test_rejections_equal_the_references(spec):
    with pytest.raises(Exception) as ours:
        validate_job_spec(copy.deepcopy(spec))
    with pytest.raises(Exception) as ref:
        R.validate_job_spec(copy.deepcopy(spec))
    assert type(ours.value) is type(ref.value)
    assert str(ours.value) == str(ref.value)


def test_registry_table_equals_the_references():
    assert registry_table() == R.registry_table()


def test_privacy_flows_into_facade_configs():
    sync = validate_job_spec({"mode": "sync", "privacy": {"clip_norm": 2.0}})
    assert federation_config_from_spec(sync).privacy == {
        "clip_norm": 2.0, "noise_multiplier": 1.0, "delta": 1e-5}
    legacy = dict(validate_job_spec({"mode": "sync"}))
    legacy.pop("privacy")
    assert federation_config_from_spec(legacy).privacy is None


# --------------------------------------------------------------------------
# record streaming
# --------------------------------------------------------------------------


def _record(i: int, virtual: bool) -> RoundRecord:
    return RoundRecord(
        round_index=i,
        participant_ids=[1, 4, 7],
        mean_local_loss=1.0 / (i + 1),
        local_steps=5 * (i + 1),
        params_down=12,
        params_up=12,
        bytes_transferred=4096,
        wall_time_s=0.25,
        virtual_time=float(i) if virtual else None,
        staleness=0.5 if virtual else None,
    )


@pytest.mark.parametrize("virtual", [False, True])
def test_record_stream_jsonl_round_trip(tmp_path, virtual):
    path = str(tmp_path / "records.jsonl")
    seen = []
    stream = RecordStream(path, subscribers=[seen.append])
    records = [_record(i, virtual) for i in range(3)]
    for r in records:
        stream.emit(r)
    assert seen == records and stream.count == 3
    assert read_records(path) == records
    # the reference reads the port's stream line for line
    assert [r.__dict__ for r in R.read_records(path)] == [r.__dict__ for r in records]
    RecordStream(path)
    assert read_records(path) == []


# --------------------------------------------------------------------------
# kill-and-resume parity
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def async_runs(tmp_path_factory):
    """One uninterrupted async run + one preempted-at-flush-2 run dir."""
    root = tmp_path_factory.mktemp("svc_async")
    full = str(root / "full")
    cut = str(root / "cut")
    result = submit(ASYNC_SPEC, full)
    with pytest.raises(JobPreempted):
        submit(ASYNC_SPEC, cut, preempt_after=2)
    return full, cut, result


def states(path):
    out = []
    for r in read_records(os.path.join(path, "records.jsonl")):
        state = r.to_state()
        state.pop("round_time_s")
        out.append(state)
    return out


def test_async_preempted_run_dir_state(async_runs):
    full, cut, _ = async_runs
    status = status_job(cut)
    assert status["status"] == "preempted"
    assert status["checkpoint_round"] == 2
    assert status["rounds_recorded"] == 2
    assert states(cut) == states(full)[:2]
    with open(os.path.join(cut, "metrics.jsonl")) as f:
        assert [json.loads(line)["round_index"] for line in f] == [0, 1]


def test_async_kill_and_resume_parity(async_runs):
    full, cut, full_result = async_runs
    resumed = resume_job(cut, device=CPU)
    assert resumed["status"] == "completed"
    assert resumed["resumed_from"] == 2
    assert diff_runs(cut, full) == []
    full_recs = read_records(os.path.join(full, "records.jsonl"))
    cut_recs = read_records(os.path.join(cut, "records.jsonl"))
    assert [r.virtual_time for r in cut_recs] == [r.virtual_time for r in full_recs]
    assert [r.staleness for r in cut_recs] == [r.staleness for r in full_recs]
    assert states(cut) == states(full)
    assert resumed["summary"]["virtual_time"] == full_result["summary"]["virtual_time"]
    assert status_job(cut)["status"] == "completed"
    a, b = final_params(full), final_params(cut)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)  # bit for bit on one device


def test_resume_rejects_mismatched_spec(async_runs, tmp_path):
    _, cut, _ = async_runs
    other = copy.deepcopy(ASYNC_SPEC)
    other["seed"] = 99
    with pytest.raises(ValueError, match="must run the exact spec"):
        resume_job(cut, spec=other, device=CPU)
    tampered = tmp_path / "tampered"
    tampered.mkdir()
    for name in ("job.json", "records.jsonl"):
        (tampered / name).write_bytes((Path(cut) / name).read_bytes())
    import shutil

    shutil.copytree(Path(cut) / "checkpoint", tampered / "checkpoint")
    job = json.loads((tampered / "job.json").read_text())
    job["spec"]["seed"] = 99
    job["spec_hash"] = job_spec_hash(job["spec"])
    (tampered / "job.json").write_text(json.dumps(job))
    with pytest.raises(ValueError, match="refusing to resume"):
        resume_job(str(tampered), device=CPU)
    job["spec_hash"] = "0" * 64
    (tampered / "job.json").write_text(json.dumps(job))
    with pytest.raises(ValueError, match="corrupt"):
        resume_job(str(tampered), device=CPU)


def test_resume_requires_a_snapshot(tmp_path):
    run_dir = tmp_path / "no_snap"
    run_dir.mkdir()
    spec = validate_job_spec(copy.deepcopy(SYNC_SPEC))
    (run_dir / "job.json").write_text(
        json.dumps({"spec": spec, "spec_hash": job_spec_hash(spec)})
    )
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        resume_job(str(run_dir), device=CPU)
    assert status_job(str(tmp_path / "nowhere"))["status"] == "missing"
    assert status_job(str(run_dir))["status"] == "submitted"


# --------------------------------------------------------------------------
# CLI (sync job end to end: submit, preempt, status, resume, diff)
# --------------------------------------------------------------------------


def test_cli_sync_kill_resume_flow(tmp_path, capsys):
    spec_path = tmp_path / "job.json"
    spec_path.write_text(json.dumps(SYNC_SPEC))
    full = str(tmp_path / "full")
    cut = str(tmp_path / "cut")
    dev = ["--device", CPU]
    assert main(["submit", "--spec", str(spec_path), "--run-dir", full, "--quiet", *dev]) == 0
    assert main(["submit", "--spec", str(spec_path), "--run-dir", cut,
                 "--preempt-after", "1", "--quiet", *dev]) == EX_TEMPFAIL
    capsys.readouterr()
    assert main(["status", "--run-dir", cut]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "preempted"
    assert main(["resume", "--run-dir", cut, "--spec", str(spec_path), *dev]) == 0
    assert "round   2" in capsys.readouterr().out
    assert main(["diff", cut, full]) == 0
    other_spec = dict(SYNC_SPEC, seed=11)
    other_path = tmp_path / "other.json"
    other_path.write_text(json.dumps(other_spec))
    other = str(tmp_path / "other")
    assert main(["submit", "--spec", str(other_path), "--run-dir", other, "--quiet", *dev]) == 0
    capsys.readouterr()
    assert main(["diff", other, full]) == 1
    with pytest.raises(SystemExit):
        main(["submit", "--spec", str(spec_path), "--run-dir", full, "--device", "tpu"])


def test_cli_sync_resume_matches_uninterrupted_params(tmp_path):
    full = str(tmp_path / "full")
    cut = str(tmp_path / "cut")
    submit(SYNC_SPEC, full)
    with pytest.raises(JobPreempted):
        submit(SYNC_SPEC, cut, preempt_after=2)
    resume_job(cut, device=CPU)
    assert diff_runs(cut, full) == []
    a, b = final_params(full), final_params(cut)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], atol=TOL, rtol=0)


# --------------------------------------------------------------------------
# registry table drift
# --------------------------------------------------------------------------


def test_registry_table_lists_every_registered_spec():
    table = registry_table()
    for name in ("nu-greedy", "fedbuff", "hierarchical-async", "lognormal",
                 "bernoulli", "loss-weighted", "krum", "secagg-fedavg"):
        assert f"`{name}`" in table


def test_api_spec_registry_table_is_current():
    assert check_registry_table(str(REPO_ROOT / "docs" / "API_SPEC.md")) == []


def test_registry_drift_detected(tmp_path):
    stale = tmp_path / "doc.md"
    stale.write_text(
        "<!-- registry-table:begin -->\n| old |\n<!-- registry-table:end -->\n"
    )
    assert any("stale" in p for p in check_registry_table(str(stale)))
    no_markers = tmp_path / "plain.md"
    no_markers.write_text("nothing here\n")
    assert any("no" in p for p in check_registry_table(str(no_markers)))
    assert main(["registries", "--check", str(stale)]) == 1
    assert main(["registries", "--write", str(stale)]) == 0
    assert check_registry_table(str(stale)) == []


# --------------------------------------------------------------------------
# against the JAX package at the job level
# --------------------------------------------------------------------------


def reference_init(seed):
    """A stand-in for the port's ``init_gru``: the reference's init at the
    job seed, carried across bit for bit."""

    def init(generator, cfg, device=None):
        jcfg = jax_gru.GRUConfig(input_dim=cfg.input_dim, hidden_dim=cfg.hidden_dim,
                                 num_layers=cfg.num_layers, dropout=cfg.dropout)
        return gru.params_from_jax(
            jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(seed), jcfg)), device)

    return init


@pytest.mark.parametrize("base,eps,params_tol", [
    (SYNC_SPEC, None, ADAMW_EPS_DRIFT_TOL), (SYNC_SPEC, 1e-4, PARAMS_TOL),
    (ASYNC_SPEC, None, PARAMS_TOL),
], ids=["sync", "sync-eps1e-4", "async"])
def test_job_matches_the_reference_from_the_same_init(base, eps, params_tol, tmp_path,
                                                      monkeypatch):
    """The port's job (resident staging, cut and resumed) against the
    reference's uninterrupted job (rebuild staging) from the reference's
    initial params, at model dropout 0."""
    spec = copy.deepcopy(base)
    spec["model"]["dropout"] = 0.0
    if eps is not None:
        spec["optimizer"] = {"eps": eps}
    monkeypatch.setattr(gru, "init_gru", reference_init(spec["seed"]))
    ours, cut, ref = (str(tmp_path / d) for d in ("ours", "cut", "ref"))
    submit(spec, ours)
    with pytest.raises(JobPreempted):
        submit(spec, cut, preempt_after=2)
    resume_job(cut, device=CPU)
    assert diff_runs(cut, ours) == []
    R.submit_job({**copy.deepcopy(spec), "staging": "rebuild"}, ref)
    got = read_records(os.path.join(ours, "records.jsonl"))
    want = R.read_records(os.path.join(ref, "records.jsonl"))
    assert len(got) == len(want) == spec["rounds"]
    for g, w in zip(got, want):
        assert (g.round_index, g.participant_ids, g.local_steps, g.virtual_time, g.staleness,
                g.params_down, g.bytes_transferred) == (
            w.round_index, w.participant_ids, w.local_steps, w.virtual_time, w.staleness,
            w.params_down, w.bytes_transferred)
        assert abs(g.mean_local_loss - w.mean_local_loss) <= TOL
    a, b = final_params(ours), final_params(ref)
    assert sorted(a) == sorted(b)
    assert max(float(np.max(np.abs(a[k] - b[k]))) for k in a) <= params_tol
    with open(os.path.join(ours, "final", "manifest.json")) as f1, open(
            os.path.join(ref, "final", "manifest.json")) as f2:
        assert json.load(f1)["keys"] == json.load(f2)["keys"]


def test_step_gradients_equal_the_references(monkeypatch):
    """The service's workload (cohort, model, loss) gives the reference's
    gradient at the reference's init, client by client: the parity under
    the sync job's AdamW drift."""
    spec = validate_job_spec(copy.deepcopy(SYNC_SPEC))
    spec["model"]["dropout"] = 0.0
    monkeypatch.setattr(gru, "init_gru", reference_init(spec["seed"]))
    ours = build_workload(spec, CPU)
    ref = R.build_workload(spec)
    worst = 0.0
    for client, ref_client in zip(ours.clients, ref.clients):
        x, y = client.train.x[:8], client.train.y[:8]
        assert x.tobytes() == ref_client.train.x[:8].tobytes()
        mask = np.ones(len(y), np.float32)
        params = {k: v for k, v in ours.init_params.items()}
        leaves = [t.requires_grad_(True) for t in jax.tree.leaves(params)]
        loss = ours.loss_fn(params, tuple(torch.from_numpy(a) for a in (x, y, mask)))
        grads = torch.autograd.grad(loss, leaves)
        want = jax.grad(lambda p: ref.loss_fn(p, (x, y, mask), None))(ref.init_params)
        for g, w in zip(grads, jax.tree.leaves(want)):
            worst = max(worst, float(np.max(np.abs(g.numpy() - np.asarray(w)))))
    assert worst <= GRAD_TOL


def test_dp_job_cut_and_resumed_gives_the_uninterrupted_epsilons(tmp_path):
    spec = {**copy.deepcopy(SYNC_SPEC), "selection": "uniform:0.5",
            "privacy": {"clip_norm": 1.0, "noise_multiplier": 1.0}}
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    submit(spec, full)
    with pytest.raises(JobPreempted):
        submit(spec, cut, preempt_after=1)
    resume_job(cut, device=CPU)
    assert diff_runs(cut, full) == []
    eps = [r.epsilon for r in read_records(os.path.join(full, "records.jsonl"))]
    assert [r.epsilon for r in read_records(os.path.join(cut, "records.jsonl"))] == eps
    assert all(e > 0 for e in eps) and eps == sorted(eps)
    from repro.privacy.accountant import RdpAccountant

    acc, ref = RdpAccountant(1.0, delta=1e-5), []
    for r in read_records(os.path.join(full, "records.jsonl")):
        acc.step(len(r.participant_ids) / 8)
        ref.append(acc.epsilon())
    assert ref == eps


def test_metrics_stream_follows_records_across_resume(async_runs, tmp_path):
    """One metrics line per record, in lockstep with records.jsonl, and a
    resumed run continues the series: its counters and gauges line for
    line equal the uninterrupted run's."""
    full, _, _ = async_runs
    for base, cut_at in ((SYNC_SPEC, 1), (ASYNC_SPEC, 2)):
        ref_dir = full if base is ASYNC_SPEC else str(tmp_path / "full")
        if base is SYNC_SPEC:
            submit(base, ref_dir)
        cut = str(tmp_path / f"cut-{base['name']}")
        with pytest.raises(JobPreempted):
            submit(base, cut, preempt_after=cut_at)
        resume_job(cut, device=CPU)
        lines = {}
        for d in (ref_dir, cut):
            with open(os.path.join(d, "metrics.jsonl")) as f:
                lines[d] = [json.loads(line) for line in f]
        recs = read_records(os.path.join(cut, "records.jsonl"))
        assert [m["round_index"] for m in lines[cut]] == [r.round_index for r in recs]
        for a, b in zip(lines[cut], lines[ref_dir]):
            assert (a["counters"], a["gauges"]) == (b["counters"], b["gauges"])
        last = lines[cut][-1]
        assert last["counters"]["rounds.completed"] == len(recs)
        assert last["histograms"]["round.time_s"]["count"] == len(recs)
        result = json.loads(Path(cut, "result.json").read_text())
        assert result["summary"]["metrics"]["counters"] == last["counters"]


def test_a_job_killed_in_a_subprocess_resumes_to_the_uninterrupted_run(tmp_path):
    """SIGKILL once the first snapshot has landed, then resume: the run dir
    equals an uninterrupted run's."""
    spec = dict(copy.deepcopy(SYNC_SPEC), rounds=40, selection="uniform:4")
    spec_path = tmp_path / "job.json"
    spec_path.write_text(json.dumps(spec))
    killed = tmp_path / "killed"
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.federation_service", "submit", "--spec",
         str(spec_path), "--run-dir", str(killed), "--device", CPU, "--quiet"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not (killed / "checkpoint" / "snapshot.json").exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline, "no snapshot within 120 s"
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
        proc.stderr.close()
    assert proc.returncode == -signal.SIGKILL
    assert status_job(str(killed))["status"] == "submitted"
    resumed = resume_job(str(killed), device=CPU)
    assert 1 <= resumed["resumed_from"] < spec["rounds"]
    full = str(tmp_path / "full")
    submit(spec, full)
    assert diff_runs(str(killed), full) == []
    assert states(str(killed)) == states(full)


# --------------------------------------------------------------------------
# what the port does not run yet, and where it runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("section", [{}, {"trace": True}, {"trace": False, "jax_profile_rounds": 2}])
def test_observability_that_asks_for_a_trace_or_a_profile_raises_at_submit(tmp_path, section):
    """The span trace and profiled rounds are ported: a section that asks
    for them runs, and the run dir holds ``trace.json`` (round spans equal
    to the records) and ``torch_profile/`` (the first N rounds) as asked."""
    spec = dict(copy.deepcopy(SYNC_SPEC), observability=section)
    run_dir = tmp_path / "obs"
    out = submit(spec, run_dir)
    assert out["status"] == "completed" and (run_dir / "metrics.jsonl").exists()
    records = read_records(str(run_dir / "records.jsonl"))
    if section.get("trace", True):
        with open(run_dir / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e["name"] == "round" and e["ph"] == "X"]
        assert [e["dur"] for e in spans] == [r.round_time_s * 1e6 for r in records]
    else:
        assert not (run_dir / "trace.json").exists()
    profiled = sorted(os.listdir(run_dir / "torch_profile")) if (
        run_dir / "torch_profile").exists() else []
    assert profiled == (["rounds_0.pt.trace.json"] if section.get("jax_profile_rounds") else [])


def test_metrics_only_observability_runs(tmp_path):
    spec = dict(copy.deepcopy(SYNC_SPEC), observability={"trace": False}, rounds=1)
    out = submit(spec, tmp_path / "obs")
    assert out["status"] == "completed" and (tmp_path / "obs" / "metrics.jsonl").exists()
    assert not (tmp_path / "obs" / "trace.json").exists()


def test_mesh_auto_raises_naming_its_item(tmp_path):
    """``mesh: "auto"`` is ported: both packages accept it, it reaches the
    facade config, and in one process the job is the ``null`` job bit for
    bit, its spec hash apart.  The name dates from when the spec was
    refused, and is kept so the test keeps its identity."""
    assert validate_job_spec({"mode": "sync", "mesh": "auto"})["mesh"] == \
        R.validate_job_spec({"mode": "sync", "mesh": "auto"})["mesh"] == "auto"
    spec = dict(copy.deepcopy(SYNC_SPEC), mesh="auto")
    assert federation_config_from_spec(validate_job_spec(copy.deepcopy(spec))).mesh == "auto"
    auto, null = submit(spec, tmp_path / "auto"), submit(SYNC_SPEC, tmp_path / "null")
    assert auto["status"] == null["status"] == "completed"
    assert auto["spec_hash"] != null["spec_hash"]
    assert diff_runs(str(tmp_path / "auto"), str(tmp_path / "null"), atol=0.0) == []
    got, ref = final_params(tmp_path / "auto"), final_params(tmp_path / "null")
    assert all(got[k].tobytes() == ref[k].tobytes() for k in ref)


def test_the_device_is_not_part_of_the_job(tmp_path):
    out = submit(SYNC_SPEC, tmp_path / "a")
    job = json.loads((tmp_path / "a" / "job.json").read_text())
    assert "device" not in json.dumps(job["spec"])
    assert out["spec_hash"] == job_spec_hash(validate_job_spec(copy.deepcopy(SYNC_SPEC)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            submit_job(copy.deepcopy(SYNC_SPEC), str(tmp_path / "b"))
        assert not (tmp_path / "b").exists()
