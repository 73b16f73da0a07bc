"""The port's observability tier against the JAX package's.

The port of ``tests/test_obs.py``, on the port (``device="cpu"``):

* the tracer, the Chrome export, the metrics registry, the
  ``observability`` section, ``CompileWatcher`` and the report, each
  reference class as one parametrised test, with the port's copies held to
  the reference's on the same calls (``to_chrome`` documents equal);
* ``CompileWatcher`` on the kernel backend's library events: a build and a
  first load each fold into ``jit.*``, a failed build still raises;
* traced sync, stacked-aggregate, grouped-aggregate and async federations:
  round and flush spans equal their records exactly (``==``), the phases,
  the virtual task spans, flows and flush instants;
* the staging and pool counters and spans (``stage``, ``prefetch_wait``,
  ``pool_upload``);
* the job service's traced run directory across preempt and resume, and
  the report CLI;
* ``RoundProfiler`` on the CPU: a non-empty trace, ``error`` None, and a
  failure kept on ``error`` without stopping the run;
* tracer on against tracer off: params bit for bit in both engines and both
  stagings, and on the async runtime;
* against the JAX package on one numpy workload at model dropout 0 from the
  reference's init: the span names, counts, tracks and args equal, the
  virtual-clock events (task spans, flows, flush and scheduler instants)
  exactly equal, and each package's report renders the other's run dir.
"""

import copy
import ctypes
import dataclasses
import io
import json
import math
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.federated import api as jax_api  # noqa: E402
from repro.federated import runtime as jax_runtime  # noqa: E402
from repro.launch import federation_service as R  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.obs import metrics as jax_metrics  # noqa: E402
from repro.obs import profile as jax_profile  # noqa: E402
from repro.obs import report as jax_report  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, ClientDataset  # noqa: E402
from repro_torch.federated import (  # noqa: E402
    AsyncFederation,
    AsyncFederationConfig,
    Federation,
    FederationConfig,
)
from repro_torch.federated.staging import StagingPipeline  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.launch import federation_service as S  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import metrics, profile, report, trace  # noqa: E402
from repro_torch.obs import __main__ as obs_main  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.profile import CompileWatcher, RoundProfiler  # noqa: E402
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _fake_events import FakeDevice  # noqa: E402

torch.set_num_threads(1)

SEQ_LEN, FEAT = 3, 5
PACKAGES = {"port": (trace, metrics, profile, report),
            "reference": (jax_trace, jax_metrics, jax_profile, jax_report)}


def make_clients(count, rng, lo=2, hi=18):
    """Matching client lists for both packages (the same arrays)."""
    ours, theirs = [], []
    for i, n in enumerate(rng.integers(lo, hi, count)):
        x = rng.normal(size=(int(n), SEQ_LEN, FEAT)).astype(np.float32)
        y = rng.uniform(0.5, 20.0, size=int(n)).astype(np.float32)
        ours.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
        ds = jax_pipeline.ArrayDataset(x, y)
        theirs.append(jax_pipeline.ClientDataset(client_id=i, train=ds, val=ds))
    return ours, theirs


@pytest.fixture(scope="module")
def setup():
    """The reference test's federation: 10 clients, GRU N=2 (dropout 0.05)."""
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=1)
    clients, _ = make_clients(10, np.random.default_rng(0))
    return clients, gru.make_loss_fn(cfg), gru.init_gru(torch.Generator().manual_seed(1), cfg,
                                                          "cpu")


@pytest.fixture(scope="module")
def pair():
    """Both packages at dropout 0, from the reference's initial params."""
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=1, dropout=0.0)
    jcfg = jax_gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=1, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(1), jcfg))
    ours, theirs = make_clients(10, np.random.default_rng(0))
    return (ours, gru.make_loss_fn(cfg), gru.params_from_jax(init, "cpu"),
            theirs, jax_gru.make_loss_fn(jcfg), init)


def opt():
    return AdamW(learning_rate=5e-3)


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# --------------------------------------------------------------------------
# the tracer, the export, the registry, the section, the watcher: both copies
# --------------------------------------------------------------------------


def _span_records_nested(T):
    tracer = T.Tracer()
    with tracer.span("outer", track="t", n=1):
        with tracer.span("inner", track="t"):
            pass
    spans = tracer.spans()
    assert [s.name for s in spans] == ["inner", "outer"]  # inner exits first
    inner, outer = spans
    assert outer.ts <= inner.ts and outer.ts + outer.dur >= inner.ts + inner.dur
    assert outer.args == {"n": 1}


def _ring_is_bounded_and_counts_drops(T):
    tracer = T.Tracer(capacity=4)
    for i in range(10):
        tracer.instant("tick", ts=float(i))
    assert [e.ts for e in tracer.events()] == [6.0, 7.0, 8.0, 9.0]
    assert tracer.dropped == 6


def _capacity_validation(T):
    with pytest.raises(ValueError, match="capacity"):
        T.Tracer(capacity=0)


def _wrap_decorator(T):
    tracer = T.Tracer()

    @tracer.wrap("work", track="w")
    def work(x):
        """doc"""
        return x + 1

    assert (work(2), work.__name__, work.__doc__) == (3, "work", "doc")
    assert [s.name for s in tracer.spans()] == ["work"]


def _null_tracer_is_inert(T):
    null = T.resolve_tracer(None)
    assert null is T.NULL_TRACER and isinstance(null, T.NullTracer) and not null.enabled
    with null.span("x", n=1):
        pass
    null.complete("x", start=0.0, dur=1.0)
    null.instant("x")
    null.flow_start("x", 0, ts=0.0)
    null.flow_end("x", 0, ts=0.0, track="t")
    assert null.events() == [] and null.wrap("x")(len) is len
    tracer = T.Tracer()
    assert T.resolve_tracer(tracer) is tracer


def _summary_totals(T):
    tracer = T.Tracer()
    tracer.complete("a", start=0.0, dur=1.0)
    tracer.complete("a", start=2.0, dur=3.0)
    tracer.complete("b", start=0.0, dur=5.0, clock="virtual")
    summary = tracer.summary()
    assert summary["host"]["a"] == {"count": 2, "total_s": 4.0}
    assert summary["virtual"]["b"]["total_s"] == 5.0


def _thread_safety_no_loss_under_capacity(T):
    tracer = T.Tracer(capacity=10_000)

    def push(tag):
        for i in range(1000):
            tracer.instant(tag, ts=float(i))

    threads = [threading.Thread(target=push, args=(f"t{k}",)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(tracer.events()) == 4000 and tracer.dropped == 0


TRACER_CASES = {f.__name__[1:]: f for f in (
    _span_records_nested, _ring_is_bounded_and_counts_drops, _capacity_validation,
    _wrap_decorator, _null_tracer_is_inert, _summary_totals,
    _thread_safety_no_loss_under_capacity)}


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(TRACER_CASES))
def test_tracer(case, package):
    TRACER_CASES[case](PACKAGES[package][0])


def record_sample(T):
    """One fixed sequence of explicit-time events (no host clock)."""
    tracer = T.Tracer()
    tracer.complete("round", start=0.5, dur=0.25, round=0)
    tracer.complete("task", start=1.0, dur=2.0, track="client:3", clock="virtual",
                    latency=np.float64(2.0), clients=np.array([3]))
    fid = tracer.new_flow_id()
    tracer.flow_start("task", fid, ts=1.0, track="server")
    tracer.flow_end("task", fid, ts=3.0, track="client:3")
    tracer.instant("flush", ts=3.0, clock="virtual", staleness=np.float32(0.5))
    tracer.instant("complete", ts=3.0, track="scheduler", clock="virtual", seq=7)
    return tracer


def test_chrome_export(tmp_path):
    tracer = record_sample(trace)
    path = tracer.export_chrome(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    procs = {e["pid"]: e["args"]["name"] for e in events if e["name"] == "process_name"}
    assert procs == {1: "host clock", 2: "virtual clock"}
    task = next(e for e in events if e["name"] == "task" and e["ph"] == "X")
    assert (task["pid"], task["ts"], task["dur"]) == (2, 1e6, 2e6)
    assert task["args"] == {"latency": 2.0, "clients": [3]}  # numpy args made JSON-safe
    threads = {(e["pid"], e["args"]["name"]) for e in events if e["name"] == "thread_name"}
    assert {(2, "client:3"), (2, "scheduler"), (1, "server")} <= threads
    flows = [e for e in events if e["ph"] in ("s", "f")]
    assert {e["ph"] for e in flows} == {"s", "f"} and len({e["id"] for e in flows}) == 1
    assert next(e for e in flows if e["ph"] == "f")["bp"] == "e"
    # The port's document is the reference's, event for event.
    assert doc == json.loads(json.dumps(record_sample(jax_trace).to_chrome()))
    assert [dataclasses.astuple(e) for e in tracer.events()] == [
        dataclasses.astuple(e) for e in record_sample(jax_trace).events()]


def _counter_monotone(M):
    c = M.Counter("c")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)


def _histogram_stats(M):
    h = M.Histogram("h")
    assert h.snapshot() == {"count": 0, "sum": 0.0, "last": 0.0}
    for v in (2.0, 8.0, 5.0):
        h.observe(v)
    snap = h.snapshot()
    assert (snap["count"], snap["min"], snap["max"], snap["last"]) == (3, 2.0, 8.0, 5.0)
    assert snap["mean"] == pytest.approx(5.0)


def _registry_get_or_create_and_type_conflict(M):
    reg = M.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")


def _snapshot_load_round_trip(M):
    reg = M.MetricsRegistry()
    reg.counter("a").inc(3)
    reg.gauge("b").set(1.5)
    reg.histogram("c").observe(2.0)
    reg.histogram("c").observe(4.0)
    snap = reg.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    restored = M.MetricsRegistry()
    restored.load_snapshot(snap)
    assert restored.snapshot() == snap
    restored.counter("a").inc()
    assert restored.snapshot()["counters"]["a"] == 4
    restored.histogram("c").observe(1.0)
    assert restored.snapshot()["histograms"]["c"]["min"] == 1.0
    M.MetricsRegistry().load_snapshot(None)


METRICS_CASES = {f.__name__[1:]: f for f in (
    _counter_monotone, _histogram_stats, _registry_get_or_create_and_type_conflict,
    _snapshot_load_round_trip)}


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(METRICS_CASES))
def test_metrics(case, package):
    METRICS_CASES[case](PACKAGES[package][1])


SECTIONS = [None, {}, {"trace": False}, {"trace_capacity": 8, "jax_profile_rounds": 2},
            {"trace_cap": 1}, {"trace": "yes"}, {"jax_profile_rounds": -1},
            {"trace_capacity": True}, {"trace_capacity": 0}, [1]]


@pytest.mark.parametrize("section", SECTIONS, ids=[json.dumps(s) for s in SECTIONS])
def test_observability_section(section):
    """The section's defaults and validation equal the reference's, message
    for message."""

    def outcome(P):
        try:
            cfg = P.resolve_observability(section)
        except ValueError as exc:
            return "raises", str(exc)
        return "config", None if cfg is None else dataclasses.astuple(cfg)

    assert outcome(profile) == outcome(jax_profile)
    if section == {}:
        cfg = profile.resolve_observability(section)
        assert cfg == profile.ObservabilityConfig() and cfg.trace
        assert cfg.trace_capacity == 65536 and cfg.jax_profile_rounds == 0


def _poll_folds_deltas(P):
    reg = (metrics if P is profile else jax_metrics).MetricsRegistry()
    with P.CompileWatcher(reg) as watcher:
        watcher.compiles += 3
        watcher.compile_time_s += 0.5
        assert watcher.poll() == 3
        assert watcher.poll() == 0  # steady state: no new events
    snap = reg.snapshot()
    assert snap["counters"]["jit.compiles"] == 3
    assert snap["counters"]["jit.compile_time_s"] == pytest.approx(0.5)
    assert snap["gauges"]["jit.round_compiles"] == 0


def _none_registry_is_fine(P):
    with P.CompileWatcher(None) as watcher:
        watcher.compiles += 1
        assert watcher.poll() == 1


WATCHER_CASES = {f.__name__[1:]: f for f in (_poll_folds_deltas, _none_registry_is_fine)}


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(WATCHER_CASES))
def test_compile_watcher(case, package):
    WATCHER_CASES[case](PACKAGES[package][2])


def fake_nvcc(tmp_path: Path, rc: int) -> str:
    """A stand-in compiler: writes an empty file at ``-o`` and exits ``rc``."""
    script = tmp_path / f"nvcc{rc}"
    script.write_text(
        "#!/bin/sh\n"
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done\n'
        f"exit {rc}\n")
    script.chmod(0o755)
    return str(script)


def test_library_builds_and_loads_are_the_jit_events(tmp_path, monkeypatch):
    """The port's compile events are its kernel libraries' builds and first
    loads: each reaches the live watchers (and only them) with its seconds;
    a cached build and a second load are no event; a failed build raises."""
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(backend, "_libs", {})
    monkeypatch.setattr(backend, "_nvcc", lambda: fake_nvcc(tmp_path, 0))
    outside = CompileWatcher(MetricsRegistry())
    before = dict(backend.LIBRARY_EVENTS)
    reg = MetricsRegistry()
    with CompileWatcher(reg) as watcher:
        lib = backend.build("gru_scan")
        assert backend.build("gru_scan") == lib  # cached: no event
        assert watcher.poll() == 1
        # A first load in the process: load a library of the system under
        # the kernel's name, through the real path.
        monkeypatch.setattr(backend, "build", lambda name: Path("libm.so.6"))
        backend.load_library("gru_scan", {"cos": ([ctypes.c_double], ctypes.c_double)})
        backend.load_library("gru_scan", {})  # loaded: no event
        assert watcher.poll() == 1
        assert watcher.poll() == 0
    assert backend.LIBRARY_EVENTS["count"] == before["count"] + 2
    assert backend.LIBRARY_EVENTS["seconds"] > before["seconds"]
    snap = reg.snapshot()
    assert snap["counters"]["jit.compiles"] == 2 and snap["counters"]["jit.compile_time_s"] > 0
    assert snap["gauges"]["jit.round_compiles"] == 0
    assert outside.compiles == 0  # never entered: never counted
    monkeypatch.undo()
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build2")
    monkeypatch.setattr(backend, "_nvcc", lambda: fake_nvcc(tmp_path, 1))
    count = backend.LIBRARY_EVENTS["count"]
    with pytest.raises(RuntimeError, match="failed"):
        backend.build("gru_scan")
    assert backend.LIBRARY_EVENTS["count"] == count


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_report_on_a_missing_dir(package, capsys):
    assert PACKAGES[package][3].render_report("/nonexistent/run-dir") == 2
    assert "run dir not found" in capsys.readouterr().out


def test_report_cli_and_module_entry_point(tmp_path, capsys):
    assert obs_main.main(["report", str(tmp_path / "missing")]) == 2
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    record_sample(trace).export_chrome(str(run_dir / "trace.json"))
    assert obs_main.main(["report", str(run_dir), "--top", "1"]) == 0
    out = capsys.readouterr().out
    assert "per-phase time breakdown (host clock)" in out
    assert "top-1 slowest clients" in out and "client:3" in out
    assert "(no records.jsonl)" in out and "(no metrics.jsonl)" in out


# --------------------------------------------------------------------------
# traced federations: span/record reconciliation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["vectorized", "sequential"])
def test_sync_round_spans_reconcile_exactly(setup, engine):
    clients, loss_fn, params0 = setup
    tracer = Tracer()
    fed = Federation(FederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0,
                                      engine=engine),
                     clients, loss_fn, opt(), device="cpu", tracer=tracer)
    out = fed.run(params0)
    rounds = tracer.spans("round")
    assert len(rounds) == len(out.history) == 3
    for span, record in zip(rounds, out.history):
        assert span.dur == record.round_time_s  # the record's own wall time: exact
        assert span.args == {"round": record.round_index,
                             "participants": len(record.participant_ids)}
    summary = tracer.summary()["host"]
    for phase in ("select", "train"):
        assert summary[phase]["count"] == 3
        assert summary[phase]["total_s"] <= summary["round"]["total_s"]
    # fedavg reduces inside the engine: no aggregate span; stage spans only
    # where the vectorized engine stages chunks.
    assert "aggregate" not in summary
    assert summary.get("stage", {}).get("count", 0) == (3 if engine == "vectorized" else 0)
    snap = out.metrics
    assert snap["counters"]["rounds.completed"] == 3
    assert snap["counters"]["train.local_steps"] == out.total_local_steps
    assert snap["counters"]["comms.bytes_down"] + snap["counters"]["comms.bytes_up"] == sum(
        r.bytes_transferred for r in out.history)
    assert snap["histograms"]["round.time_s"]["count"] == 3
    assert snap["gauges"]["jit.round_compiles"] == 0  # no library loads on the CPU
    assert out.summary()["metrics"] == snap


@pytest.mark.parametrize("aggregator,arg,value", [
    ("trimmed-mean:0.1", "clients", 10), ("hierarchical:3", "groups", 3)])
def test_stacked_and_grouped_aggregate_spans(setup, aggregator, arg, value):
    clients, loss_fn, params0 = setup
    tracer = Tracer()
    Federation(FederationConfig(rounds=2, local_epochs=1, batch_size=4, seed=0,
                                aggregator=aggregator),
               clients, loss_fn, opt(), device="cpu", tracer=tracer).run(params0)
    aggregates = tracer.spans("aggregate")
    assert len(aggregates) == 2 and all(s.args == {arg: value} for s in aggregates)
    assert all(s.track == "server" and s.clock == "host" for s in aggregates)


def test_async_flush_and_task_spans(setup):
    clients, loss_fn, params0 = setup
    tracer = Tracer()
    fed = AsyncFederation(
        AsyncFederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0,
                              aggregator="fedbuff:3", latency="lognormal:0.5",
                              dropout="bernoulli:0.2", concurrency=4),
        clients, loss_fn, opt(), device="cpu", tracer=tracer)
    out = fed.run(params0)
    assert fed.tracer is tracer and fed._fed.tracer is tracer
    flushes = tracer.spans("flush", clock="host")
    assert len(flushes) == len(out.history)
    for span, record in zip(flushes, out.history):
        assert span.dur == record.round_time_s
        assert span.args["virtual_time"] == record.virtual_time
        assert span.args["version"] == record.round_index
    tasks = tracer.spans("task", clock="virtual")
    stats = fed.last_run_stats
    assert len(tasks) == stats["tasks"] == len(tracer.spans("dispatch"))
    assert sum(t.args["dropped"] for t in tasks) == stats["dropped"] > 0
    for task in tasks:
        assert task.ts >= 0.0 and task.dur > 0.0
        assert task.track == f"client:{task.args['clients'][0]}"
    assert min(t.ts + t.dur for t in tasks) <= out.history[-1].virtual_time
    flow_phases = [e.phase for e in tracer.events() if e.flow_id is not None]
    assert flow_phases.count("s") == flow_phases.count("f") == len(tasks)
    marks = [e for e in tracer.events()
             if e.name == "flush" and e.clock == "virtual" and e.phase == "i"
             and e.track == "server"]
    assert [m.ts for m in marks] == [r.virtual_time for r in out.history]
    assert [m.args["staleness"] for m in marks] == [r.staleness for r in out.history]
    popped = [e for e in tracer.events() if e.track == "scheduler"]
    assert len(popped) == stats["events"] and all(e.clock == "virtual" for e in popped)
    assert [e.args["seq"] for e in popped] != [] and [e.ts for e in popped] == sorted(
        e.ts for e in popped)
    doc = tracer.to_chrome()
    json.dumps(doc)
    assert any(e.get("ph") == "X" and e["pid"] == 2 for e in doc["traceEvents"])


def test_async_off_run_records_nothing(setup):
    clients, loss_fn, params0 = setup
    fed = AsyncFederation(
        AsyncFederationConfig(rounds=2, local_epochs=1, batch_size=4, seed=0,
                              aggregator="fedbuff:3", latency="constant", dropout="never"),
        clients, loss_fn, opt(), device="cpu")
    out = fed.run(params0)
    assert fed.tracer is NULL_TRACER and isinstance(fed.tracer, NullTracer)
    assert fed.tracer.events() == [] and fed.profiler is None
    assert out.metrics["counters"]["async.tasks"] == fed.last_run_stats["tasks"]
    assert out.metrics["gauges"]["async.virtual_time"] == fed.last_run_stats["virtual_time"]


@pytest.mark.parametrize("engine,staging", [
    ("vectorized", "resident"), ("vectorized", "rebuild"),
    ("sequential", "resident"), ("sequential", "rebuild")])
def test_tracer_on_equals_tracer_off_bit_for_bit(setup, engine, staging):
    """Model dropout 0.05: the tracer draws from no stream and touches no
    tensor, so a traced run is the untraced run bit for bit."""
    clients, loss_fn, params0 = setup
    config = FederationConfig(rounds=2, local_epochs=2, batch_size=4, seed=0, engine=engine,
                              staging=staging, cohort_chunk=4, selection="uniform:6")
    tracer = Tracer()
    on = Federation(config, clients, loss_fn, opt(), device="cpu", tracer=tracer).run(params0)
    off = Federation(config, clients, loss_fn, opt(), device="cpu").run(params0)
    assert same_bits(on.params, off.params)
    assert [r.mean_local_loss for r in on.history] == [r.mean_local_loss for r in off.history]
    assert len(tracer.spans("round")) == 2


def test_async_tracer_on_equals_tracer_off_bit_for_bit(setup):
    clients, loss_fn, params0 = setup
    config = AsyncFederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0,
                                   aggregator="fedbuff:0.3", latency="pareto:1.5",
                                   dropout="bernoulli:0.1", cohort_chunk=2)
    on_fed = AsyncFederation(config, clients, loss_fn, opt(), device="cpu", tracer=Tracer())
    on = on_fed.run(params0)
    off_fed = AsyncFederation(config, clients, loss_fn, opt(), device="cpu")
    off = off_fed.run(params0)
    assert same_bits(on.params, off.params)
    assert on_fed.last_run_stats == off_fed.last_run_stats
    assert [r.virtual_time for r in on.history] == [r.virtual_time for r in off.history]


# --------------------------------------------------------------------------
# staging / pool counters and spans
# --------------------------------------------------------------------------


def test_pipeline_prefetch_counter_all_hits():
    pipeline = StagingPipeline(lambda start: start * 10, [0, 1, 2, 3], tracer=Tracer())
    it = iter(pipeline)
    for expected in (0, 10, 20, 30):
        deadline = time.time() + 5
        while pipeline._queue.qsize() == 0:
            assert time.time() < deadline, "staging producer stalled"
            time.sleep(0.001)
        assert next(it) == expected
    assert pipeline.prefetched == 4
    assert pipeline._tracer.spans("prefetch_wait") == []  # never blocked


def test_pipeline_prefetch_counter_all_misses_and_wait_spans():
    """Staging proceeds only once the consumer is inside the blocking
    ``prefetch_wait`` path (the tracer hook releases the producer), so no
    chunk counts as prefetched and every miss records a wait span."""
    gate = threading.Semaphore(0)

    class ReleasingTracer(Tracer):
        def span(self, name, track="server", **args):
            if name == "prefetch_wait":
                gate.release()
            return super().span(name, track=track, **args)

    tracer = ReleasingTracer()

    def stage_fn(start):
        assert gate.acquire(timeout=5)
        return start * 10

    pipeline = StagingPipeline(stage_fn, [0, 1, 2, 3], tracer=tracer)
    assert list(pipeline) == [0, 10, 20, 30]
    assert pipeline.prefetched == 0
    waits = tracer.spans("prefetch_wait")
    assert len(waits) == 4 and all(w.track == "staging" for w in waits)


@pytest.mark.parametrize("staging", ["resident", "rebuild"])
def test_round_counters_absorbed_exactly(setup, staging):
    clients, loss_fn, params0 = setup
    rounds = 3
    tracer = Tracer()
    fed = Federation(
        FederationConfig(rounds=rounds, local_epochs=1, batch_size=4, seed=0, staging=staging,
                         cohort_chunk=4, engine="vectorized", prefetch=False),
        clients, loss_fn, opt(), device="cpu", tracer=tracer)
    out = fed.run(params0)
    stats = fed.cohort_trainer.last_round_stats
    assert stats["chunks"] == math.ceil(len(clients) / 4)
    counters, gauges = out.metrics["counters"], out.metrics["gauges"]
    assert counters["staging.chunks"] == rounds * stats["chunks"]
    assert stats["bytes_staged"] > 0
    assert counters["staging.bytes_staged"] == rounds * stats["bytes_staged"]
    assert gauges["staging.bytes_resident"] == stats["bytes_resident"]
    assert counters["staging.plans_prefetched"] == 0
    stages = tracer.spans("stage")
    assert [s.args["chunk"] for s in stages] == [0, 4, 8] * rounds
    assert all(s.track == "staging" for s in stages)
    assert tracer.spans("prefetch_wait") == []
    if staging == "resident":
        assert stats["bytes_resident"] > 0


def test_prefetched_plans_counted_and_staged_on_the_producer(setup):
    clients, loss_fn, params0 = setup
    rounds = 2
    tracer = Tracer()
    fed = Federation(
        FederationConfig(rounds=rounds, local_epochs=1, batch_size=4, seed=0,
                         staging="resident", cohort_chunk=4, prefetch=True),
        clients, loss_fn, opt(), device="cpu", tracer=tracer)
    out = fed.run(params0)
    stats = fed.cohort_trainer.last_round_stats
    counters = out.metrics["counters"]
    assert 0 <= counters["staging.plans_prefetched"] <= rounds * stats["chunks"]
    assert counters["staging.plans_prefetched"] >= stats["plans_prefetched"]
    # every chunk's stage span, in order, whichever thread staged it
    assert [s.args["chunk"] for s in tracer.spans("stage")] == [0, 4, 8] * rounds
    # a wait is a miss: each miss blocks the consumer once
    waits = len(tracer.spans("prefetch_wait"))
    assert waits + counters["staging.plans_prefetched"] == rounds * stats["chunks"]


def test_pool_counters_absorbed_exactly(setup):
    clients, loss_fn, params0 = setup
    max_n = max(c.n_train for c in clients)
    row_bytes = (max_n + 1) * (SEQ_LEN * FEAT * 4 + 4)
    rounds = 4
    tracer = Tracer()
    fed = Federation(
        FederationConfig(rounds=rounds, local_epochs=1, batch_size=4, seed=0,
                         selection="uniform:4", resident_budget_bytes=5 * row_bytes,
                         cohort_chunk=4),
        clients, loss_fn, opt(), device="cpu", tracer=tracer)
    out = fed.run(params0)
    dcohort = fed.cohort_trainer.device_cohort
    assert dcohort.is_pooled and dcohort.pool_rows == 5 and dcohort.tracer is tracer
    counters = out.metrics["counters"]
    assert counters["pool.uploads"] == dcohort.uploads
    assert counters["pool.evictions"] == dcohort.evictions
    assert counters["pool.hits"] == dcohort.hits
    assert counters["pool.bytes_uploaded"] == dcohort.bytes_uploaded
    appearances = sum(len(r.participant_ids) for r in out.history)
    assert counters["pool.hits"] + counters["pool.uploads"] == appearances
    assert counters["pool.evictions"] > 0
    uploads = tracer.spans("pool_upload")
    assert sum(s.args["missing"] for s in uploads) == dcohort.uploads
    assert all(s.track == "pool" for s in uploads)


# --------------------------------------------------------------------------
# the round profiler
# --------------------------------------------------------------------------


def test_round_profiler_writes_a_trace_on_the_cpu(setup, tmp_path):
    clients, loss_fn, params0 = setup
    profiler = RoundProfiler(1, str(tmp_path / "torch_profile"), device="cpu")
    fed = Federation(FederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0),
                     clients, loss_fn, opt(), device="cpu", profiler=profiler)
    fed.run(params0)
    assert profiler.error is None and fed.profiler is profiler
    assert profiler.trace_path == str(tmp_path / "torch_profile" / "rounds_0.pt.trace.json")
    with open(profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("name", "").startswith("aten::") for e in events)
    assert os.listdir(tmp_path / "torch_profile") == ["rounds_0.pt.trace.json"]
    profiler.stop()  # idempotent


def test_a_profiler_failure_is_kept_and_training_goes_on(setup, tmp_path):
    clients, loss_fn, params0 = setup
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    profiler = RoundProfiler(2, str(blocker / "profile"), device="cpu")
    config = AsyncFederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0,
                                   aggregator="fedbuff:4", latency="constant")
    fed = AsyncFederation(config, clients, loss_fn, opt(), device="cpu", profiler=profiler)
    out = fed.run(params0)
    assert len(out.history) == 3 and fed.profiler is profiler
    assert isinstance(profiler.error, OSError) and profiler.trace_path is None
    plain = AsyncFederation(config, clients, loss_fn, opt(), device="cpu").run(params0)
    assert same_bits(out.params, plain.params)
    assert RoundProfiler(0, str(tmp_path), device="cpu").rounds == 0


# --------------------------------------------------------------------------
# the control plane: metrics.jsonl + trace.json + torch_profile/ in the run dir
# --------------------------------------------------------------------------


OBS_SPEC = {
    "name": "t-obs",
    "mode": "sync",
    "rounds": 4,
    "local_epochs": 1,
    "batch_size": 8,
    "seed": 3,
    "recruitment": "all",
    "selection": "uniform",
    "data": {"scale": 0.002, "num_hospitals": 6, "split_mode": "stratified"},
    "model": {"hidden_dim": 2, "num_layers": 1},
    "observability": {"trace": True, "trace_capacity": 4096},
}


def test_service_spec_validation():
    normalized = S.validate_job_spec(dict(OBS_SPEC))
    assert normalized["observability"]["trace"] is True
    assert normalized["observability"]["jax_profile_rounds"] == 0
    assert S.job_spec_hash(normalized) == R.job_spec_hash(R.validate_job_spec(dict(OBS_SPEC)))
    bare = S.validate_job_spec({k: v for k, v in OBS_SPEC.items() if k != "observability"})
    assert bare["observability"] is None
    with pytest.raises(ValueError, match="unknown key"):
        S.validate_job_spec({**OBS_SPEC, "observability": {"capactiy": 1}})
    with pytest.raises(ValueError, match="must be a bool"):
        S.validate_job_spec({**OBS_SPEC, "observability": {"trace": 1}})


def test_run_dir_artifacts_and_resume_continuity(tmp_path, capsys):
    spec = {**copy.deepcopy(OBS_SPEC),
            "observability": {"trace": True, "trace_capacity": 4096, "jax_profile_rounds": 1}}
    run_dir = str(tmp_path / "run")
    with pytest.raises(S.JobPreempted):
        S.submit_job(spec, run_dir, preempt_after=2, device="cpu")
    # The cut run already has a partial trace, a profile and a metrics prefix.
    cut = json.loads(open(os.path.join(run_dir, "trace.json")).read())
    assert [e["args"]["round"] for e in cut["traceEvents"]
            if e["name"] == "round" and e["ph"] == "X"] == [0, 1]
    assert any(e["name"] == "checkpoint" for e in cut["traceEvents"])
    assert os.listdir(os.path.join(run_dir, S.PROFILE_DIR)) == ["rounds_0.pt.trace.json"]
    cut_lines = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert cut_lines and all("counters" in line for line in cut_lines)

    out = S.resume_job(run_dir, device="cpu")
    assert out["status"] == "completed"
    records = S.read_records(os.path.join(run_dir, "records.jsonl"))
    lines = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [line["round_index"] for line in lines] == [r.round_index for r in records]
    assert [line["counters"]["rounds.completed"] for line in lines] == list(
        range(1, len(records) + 1))
    assert [line["counters"]["train.local_steps"] for line in lines] == list(
        np.cumsum([r.local_steps for r in records]))
    assert all(line["gauges"]["jit.round_compiles"] == 0 for line in lines)
    assert out["summary"]["metrics"]["counters"]["rounds.completed"] == len(records)
    # The completed run's trace covers the resumed rounds only, each span
    # equal to its record.
    doc = json.loads(open(os.path.join(run_dir, "trace.json")).read())
    round_spans = [e for e in doc["traceEvents"] if e["name"] == "round" and e["ph"] == "X"]
    assert [e["args"]["round"] for e in round_spans] == [2, 3]
    assert [e["dur"] for e in round_spans] == [r.round_time_s * 1e6 for r in records[2:]]
    # The resumed segment profiled its own first round.
    assert sorted(os.listdir(os.path.join(run_dir, S.PROFILE_DIR))) == [
        "rounds_0.pt.trace.json", "rounds_2.pt.trace.json"]

    assert report.render_report(run_dir) == 0
    rendered = capsys.readouterr().out
    assert "per-phase time" in rendered and "round" in rendered and "metrics" in rendered


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


def host_shape(tracer, names):
    """Host spans ``names`` as sorted ``(name, track, clock, args)``: what
    is deterministic of them (their times are the host's)."""
    return sorted(
        (e.name, e.phase, e.track, e.clock, json.dumps(e.args, sort_keys=True, default=float))
        for e in tracer.events() if e.clock == "host" and e.name in names)


def virtual_events(tracer):
    """Every virtual-clock event, in ring order, times included."""
    return [(e.name, e.phase, e.ts, e.dur, e.track,
             json.dumps(e.args, sort_keys=True, default=float), e.flow_id)
            for e in tracer.events() if e.clock == "virtual"]


def flow_starts(tracer):
    return [(e.name, e.phase, e.ts, e.track, e.flow_id)
            for e in tracer.events() if e.phase == "s"]


@pytest.mark.parametrize("config", [
    dict(rounds=3, staging="resident", cohort_chunk=4, prefetch=False, selection="uniform:6",
         resident_budget_bytes=7 * (18 * (SEQ_LEN * FEAT * 4 + 4))),
    dict(rounds=2, aggregator="trimmed-mean:0.1"),
    dict(rounds=2, aggregator="hierarchical:3", staging="rebuild"),
], ids=["resident-pooled", "stacked", "grouped"])
def test_sync_spans_equal_the_references(pair, config):
    ours, loss_fn, params0, theirs, jax_loss_fn, init = pair
    base = dict(local_epochs=1, batch_size=4, seed=0, **config)
    ours_tracer, ref_tracer = Tracer(), jax_trace.Tracer()
    got = Federation(FederationConfig(**base), ours, loss_fn, opt(), device="cpu",
                     tracer=ours_tracer).run(params0)
    ref = jax_api.Federation(jax_api.FederationConfig(**base), theirs, jax_loss_fn,
                             JaxAdamW(learning_rate=5e-3), tracer=ref_tracer).run(init)
    assert [r.participant_ids for r in got.history] == [r.participant_ids for r in ref.history]
    names = ("select", "train", "aggregate", "round", "stage", "pool_upload", "checkpoint")
    shape = host_shape(ours_tracer, names)
    assert shape == host_shape(ref_tracer, names)
    assert {s[0] for s in shape} >= {"select", "train", "round"}
    if "resident_budget_bytes" in config:
        assert any(s[0] == "pool_upload" for s in shape) and any(s[0] == "stage" for s in shape)
    for ours_span, record in zip(ours_tracer.spans("round"), got.history):
        assert ours_span.dur == record.round_time_s


@pytest.mark.parametrize("config", [
    dict(aggregator="fedbuff:3", latency="lognormal:0.5", dropout="bernoulli:0.2",
         concurrency=4),
    dict(aggregator="hierarchical-async:3", latency="pareto:1.5", dropout="never"),
], ids=["fedbuff", "hierarchical-async"])
def test_async_virtual_timeline_equals_the_references(pair, config):
    """The virtual-clock events come from the same numpy streams in both
    packages: task spans, flows, flush and scheduler instants equal exactly,
    times included; the host spans equal in names, counts, tracks and args.
    The reference runs rebuild staging (its resident path traces anew for
    every one-client task on the CPU)."""
    ours, loss_fn, params0, theirs, jax_loss_fn, init = pair
    base = dict(rounds=3, local_epochs=1, batch_size=4, seed=0, **config)
    ours_tracer, ref_tracer = Tracer(), jax_trace.Tracer()
    snaps = []
    fed = AsyncFederation(AsyncFederationConfig(**base), ours, loss_fn, opt(), device="cpu",
                          tracer=ours_tracer)
    got = fed.run(params0, snapshot_hook=snaps.append)
    ref_fed = jax_runtime.AsyncFederation(
        jax_runtime.AsyncFederationConfig(**base, staging="rebuild"), theirs, jax_loss_fn,
        JaxAdamW(learning_rate=5e-3), tracer=ref_tracer)
    ref_snaps = []
    ref = ref_fed.run(init, snapshot_hook=ref_snaps.append)
    assert [r.virtual_time for r in got.history] == [r.virtual_time for r in ref.history]
    timeline = virtual_events(ours_tracer)
    assert timeline == virtual_events(ref_tracer)
    assert {e[0] for e in timeline} >= {"task", "flush", "complete"}
    assert flow_starts(ours_tracer) == flow_starts(ref_tracer)
    names = ("dispatch", "flush", "checkpoint", "stage")
    assert host_shape(ours_tracer, names) == host_shape(ref_tracer, names)
    assert len(ours_tracer.spans("checkpoint")) == len(snaps) == len(ref_snaps) > 0
    for span, record in zip(ours_tracer.spans("flush", clock="host"), got.history):
        assert span.dur == record.round_time_s
    # exported, the virtual-clock processes are the same document
    ours_doc, ref_doc = ours_tracer.to_chrome(), ref_tracer.to_chrome()

    def virtual_doc(doc):
        return [e for e in doc["traceEvents"] if e["pid"] == 2]

    assert virtual_doc(ours_doc) == virtual_doc(ref_doc)


# The port's host spans that the reference does not record.
PORT_ONLY = ("generators", "readback", "cohort_step", "serve_step")


def test_each_packages_report_renders_the_others_run_dir(tmp_path):
    ours_dir, ref_dir = str(tmp_path / "ours"), str(tmp_path / "ref")
    S.submit_job(copy.deepcopy(OBS_SPEC), ours_dir, device="cpu")
    R.submit_job(copy.deepcopy(OBS_SPEC), ref_dir)
    outputs = {}
    for name, render, run_dir in (("ref_on_ours", jax_report.render_report, ours_dir),
                                  ("ours_on_ref", report.render_report, ref_dir),
                                  ("ours_on_ours", report.render_report, ours_dir)):
        buf = io.StringIO()
        assert render(run_dir, out=buf) == 0
        outputs[name] = buf.getvalue()
        assert "per-phase time breakdown (host clock)" in outputs[name]
        assert "final metrics snapshot (4 rounds streamed)" in outputs[name]
    assert outputs["ref_on_ours"] == outputs["ours_on_ours"]

    def phase_counts(run_dir, names=None):
        with open(os.path.join(run_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        return {clock: {name: row["count"] for name, row in phases.items()
                        if (name in PORT_ONLY) == (names is PORT_ONLY)}
                for clock, phases in report.phase_breakdown(events).items()}

    # Every phase of the reference, counted alike; beside them the port's
    # own: a round's generators and a chunk's loss readback (one chunk a
    # round here; the CPU runs the step eagerly, so no cohort_step).
    assert phase_counts(ours_dir) == phase_counts(ref_dir)
    assert phase_counts(ours_dir, PORT_ONLY) == {"host": {"generators": 4, "readback": 4}}
    assert phase_counts(ref_dir, PORT_ONLY) == {"host": {}}


# --------------------------------------------------------------------------
# the port's device clock and the clock it shares with torch.profiler
# --------------------------------------------------------------------------


def test_device_spans_from_event_pairs_on_the_anchored_clock(monkeypatch):
    """Fake event pairs: a span starts at the anchor's host time plus the
    device time from the anchor, lasts the device time between its events,
    and is recorded once its end event has completed (or the ring is read)."""
    device = FakeDevice(now=50.0).install(monkeypatch, trace)
    tracer = Tracer()
    device.now = 51.0                       # the device runs ahead of the anchor below
    first = tracer.device_start()           # anchors: a synchronize, an event at 51.0
    anchor_ts = tracer._device.anchor_ts
    assert device.synchronizes == 1 and tracer._device.anchor.t == 51.0
    device.now = 51.25
    tracer.device_end(first, "cohort_step", t=3)
    assert tracer._device.pending and device.done == 51.0   # not finished: nothing waits
    second = tracer.device_start()
    device.now = 51.75
    device.done = 51.25                     # the first pair's work has finished
    tracer.device_end(second, "cohort_step", track="stream", t=4)
    resolved = [e for e in tracer._events if e.clock == trace.DEVICE_CLOCK]
    assert [e.args for e in resolved] == [{"t": 3}]   # by query: the second still runs
    spans = tracer.spans("cohort_step", clock="device")   # reading waits for the rest
    assert [(s.track, s.args) for s in spans] == [("device", {"t": 3}), ("stream", {"t": 4})]
    assert spans[0].ts == pytest.approx(anchor_ts, abs=1e-12)
    assert spans[0].dur == pytest.approx(0.25)
    assert spans[1].ts == pytest.approx(anchor_ts + 0.25)
    assert spans[1].dur == pytest.approx(0.5)
    assert all(s.phase == "X" and s.clock == "device" for s in spans)
    # resolved events are reused: a steady loop creates no event
    created = device.created
    for _ in range(5):
        tracer.device_end(tracer.device_start(), "serve_step")
    assert device.created == created and device.synchronizes == 1
    assert list(tracer._device.streams) == [(0, 0)]   # one stream object, kept by handle
    assert tracer.summary()["device"] == {
        "cohort_step": {"count": 2, "total_s": pytest.approx(0.75)},
        "serve_step": {"count": 5, "total_s": 0.0}}


def test_the_null_tracer_times_nothing(monkeypatch):
    device = FakeDevice().install(monkeypatch, trace)
    assert NULL_TRACER.device_start() is None
    NULL_TRACER.device_end(None, "x", t=1)
    assert NULL_TRACER.events() == [] and device.created == device.synchronizes == 0


def test_chrome_export_with_device_spans(monkeypatch, tmp_path):
    """With device spans: the third process and ``baseTimeNanoseconds``, the
    tracer's birth on the wall clock (``test_chrome_export`` holds the
    document without them to the reference's)."""
    FakeDevice().install(monkeypatch, trace)
    before = time.time_ns()
    tracer = record_sample(trace)
    after = time.time_ns()
    tracer.device_end(tracer.device_start(), "serve_step", pos=7)
    doc = json.loads(open(tracer.export_chrome(str(tmp_path / "trace.json"))).read())
    assert before <= doc["baseTimeNanoseconds"] <= after
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "process_name"}
    assert procs == {1: "host clock", 2: "virtual clock", 3: "device (CUDA events)"}
    step = next(e for e in doc["traceEvents"] if e["name"] == "serve_step")
    assert (step["pid"], step["cat"], step["ph"], step["args"]) == (3, "device", "X", {"pos": 7})
    threads = {(e["pid"], e["args"]["name"]) for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    assert (3, "device") in threads
    # the rest of the document is the reference's
    ref = record_sample(jax_trace).to_chrome()
    ours = [e for e in doc["traceEvents"] if e.get("pid") != 3]
    assert ours == json.loads(json.dumps(ref["traceEvents"]))


def _profile_doc(base_ns, ops):
    """A ``torch.profiler`` export: kernels ``(start_us, dur_us)`` on its own
    clock, with a host runtime call the gaps must not be put down to."""
    events = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": ts, "dur": dur}
              for i, (ts, dur) in enumerate(ops)]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": ops[0][0], "dur": 1e6})
    return {"baseTimeNanoseconds": base_ns, "traceEvents": events}


def test_idle_gaps_are_put_down_to_the_innermost_open_span():
    """A hand-built pair: the profiler's clock starts 2.5 s after the
    tracer's; each gap goes to the innermost host span open at its start."""
    base = 1_700_000_000_000_000_000
    host = [
        {"ph": "X", "cat": "host", "name": "round", "ts": 0.0, "dur": 1_000_000.0},
        {"ph": "X", "cat": "host", "name": "train", "ts": 10.0, "dur": 900_000.0},
        {"ph": "X", "cat": "host", "name": "cohort_step", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "host", "name": "readback", "ts": 500.0, "dur": 300.0},
        {"ph": "X", "cat": "virtual", "name": "task", "ts": 0.0, "dur": 5e9},
        {"ph": "X", "cat": "host", "name": "stage", "ts": 0.0, "dur": 5e6, "tid": 2},
    ]
    shift = 2_500_000  # µs: the profiler's ts 0 is the tracer's 2.5 s
    ops = [(120.0 - shift, 10.0),      # gap 130..140 opens inside cohort_step (100..150)
           (140.0 - shift, 20.0),
           (150.0 - shift, 10.0),      # overlaps: no gap at 160
           (200.0 - shift, 300.0),     # gap 160..200 opens inside train, after cohort_step
           (600.0 - shift, 10.0),      # gap 500..600 opens at readback's start
           (1_000_005.0 - shift, 1.0)]  # gap 610..1,000,005 opens inside readback
    rows = report.idle_by_span({"baseTimeNanoseconds": base, "traceEvents": host},
                               _profile_doc(base + shift * 1000, ops))
    assert {k: v["gaps"] for k, v in rows.items()} == {"cohort_step": 1, "train": 1, "readback": 2}
    assert rows["cohort_step"]["idle_s"] == pytest.approx(10e-6)
    assert rows["train"]["idle_s"] == pytest.approx(40e-6)
    assert rows["readback"]["idle_s"] == pytest.approx(100e-6 + (1_000_005 - 610) * 1e-6)
    # outside every host span, and a document without the shared clock
    late = report.idle_by_span({"baseTimeNanoseconds": base, "traceEvents": host[:1]},
                               _profile_doc(base, [(2e6, 1.0), (3e6, 1.0)]))
    assert late == {report.NO_SPAN: {"gaps": 1, "idle_s": pytest.approx(1.0 - 1e-6)}}
    assert report.idle_by_span({"traceEvents": host}, _profile_doc(base, ops)) is None


def test_report_adds_the_idle_table_only_with_device_spans_and_a_profile(
        monkeypatch, tmp_path, capsys):
    FakeDevice().install(monkeypatch, trace)
    run_dir = tmp_path / "run"
    (run_dir / "torch_profile").mkdir(parents=True)
    tracer = Tracer()
    with tracer.span("cohort_step", t=0):
        time.sleep(0.002)
    base = tracer._birth_ns
    start = tracer.spans("cohort_step")[0].ts * 1e6
    profile_doc = _profile_doc(base, [(start + 100.0, 10.0), (start + 1500.0, 10.0)])
    (run_dir / "torch_profile" / "rounds_0.pt.trace.json").write_text(json.dumps(profile_doc))
    tracer.export_chrome(str(run_dir / "trace.json"))   # no device span: no shared clock
    assert report.render_report(str(run_dir)) == 0
    assert "device idle" not in capsys.readouterr().out
    tracer.device_end(tracer.device_start(), "cohort_step", t=0)
    tracer.export_chrome(str(run_dir / "trace.json"))
    assert report.render_report(str(run_dir)) == 0
    out = capsys.readouterr().out
    assert "device idle by host span (1 profiled segment(s))" in out
    assert "per-phase time breakdown (device clock)" in out
    table = out.split("device idle by host span")[1].splitlines()
    assert table[1].split() == ["span", "gaps", "idle_s", "share"]
    assert table[3].split() == ["cohort_step", "1", "0.0014", "100.0%"]
