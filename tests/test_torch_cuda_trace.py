"""The tracer's device clock on the card (``obs/trace.py``, ``capture.py``).

Every test here needs a CUDA device and skips without one; the file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_trace.py

* One clock with ``torch.profiler``: over a profiled segment (CPU and CUDA
  activities), each ``cohort_step`` and ``serve_step`` host span, put on
  the profiler's time line through the tracer's ``baseTimeNanoseconds``,
  holds its replay's ``cudaGraphLaunch`` runtime record within 50 µs on at
  least 99% of the steps, and each replay's device span starts no earlier
  than 50 µs before its host span (its start event is recorded inside it)
  and ends no earlier than 50 µs before that launch began.  A device span
  may start before the launch itself: the host queues the generators'
  fills of ``CUDAGraph.replay`` between the start event and the launch.
* A replay's device span, timed by its own pair of CUDA events, is within
  3% of the mean of 100 back-to-back replays of the same graph timed by one
  pair.
"""

import bisect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

SLACK_US = 50.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans time CUDA graphs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def profiled(work, tmp_path):
    """``work()`` under ``torch.profiler`` with CPU and CUDA activities; its
    Chrome export."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def graph_launches(doc, tracer):
    """The profile's ``cudaGraphLaunch`` records as ``(start, end)`` µs on
    the tracer's clock, sorted."""
    shift = (int(doc["baseTimeNanoseconds"]) - tracer._birth_ns) / 1e3
    return sorted((e["ts"] + shift, e["ts"] + shift + e["dur"]) for e in doc["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith("cudaGraphLaunch"))


def held_launches(host_spans, launches):
    """For each host span, the first launch that lies inside it (within
    ``SLACK_US``), or None."""
    starts = [s for s, _ in launches]
    out = []
    for span in host_spans:
        lo, hi = span.ts * 1e6 - SLACK_US, (span.ts + span.dur) * 1e6 + SLACK_US
        k = bisect.bisect_left(starts, lo)
        out.append(launches[k] if k < len(launches) and launches[k][1] <= hi else None)
    return out


def assert_on_one_clock(tracer, name, host_before, device_before, doc):
    """The spans ``name`` recorded since the counts given: each host span
    holds a graph launch, and its replay's device span starts after the
    host span does and ends after the launch began."""
    host = tracer.spans(name, clock="host")[host_before:]
    device = tracer.spans(name, clock="device")[device_before:]
    assert len(host) == len(device) >= 100
    held = held_launches(host, graph_launches(doc, tracer))
    assert sum(h is not None for h in held) >= 0.99 * len(held), (
        f"{sum(h is None for h in held)} of {len(held)} {name} spans hold no graph launch")
    early = [(d.ts - h.ts) * 1e6 for d, h in zip(device, host)]
    assert sum(x >= -SLACK_US for x in early) >= 0.99 * len(early), (
        f"device spans start before their host spans: {sorted(early)[:5]} µs")
    ends = [(d.ts + d.dur) * 1e6 - h[0] for d, h in zip(device, held) if h is not None]
    assert sum(x >= -SLACK_US for x in ends) >= 0.99 * len(ends), (
        f"device spans end before their launch: {sorted(ends)[:5]} µs")


def test_cohort_step_spans_hold_their_graph_launches(cuda, tmp_path):
    from repro_torch.data.pipeline import ArrayDataset, ClientDataset
    from repro_torch.federated.cohort import CohortTrainer, client_generators
    from repro_torch.models import gru
    from repro_torch.obs import Tracer
    from repro_torch.optim.adamw import AdamW

    rng = np.random.default_rng(0)
    clients = []
    for i, n in enumerate(1 + (97 * k) % 600 for k in range(35)):   # up to 38 batches
        x = rng.normal(size=(n, 24, 38)).astype(np.float32)
        y = rng.uniform(0.5, 20, size=n).astype(np.float32)
        clients.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
    tracer = Tracer(capacity=1 << 16)
    trainer = CohortTrainer(gru.make_loss_fn(gru.GRUConfig(dropout=0.05)), AdamW(), 16, 2,
                            staging="resident", tracer=tracer, device=cuda)
    params = gru.init_gru(torch.Generator().manual_seed(0), gru.GRUConfig(), cuda)
    np_rng, gen_rng = np.random.default_rng(1), np.random.default_rng([1, 2])

    def round_():
        nonlocal params
        gens = client_generators(gen_rng, len(clients), cuda)
        params, _, _ = trainer.train_cohort(params, clients, np_rng, gens)

    round_()   # captures
    before = (len(tracer.spans("cohort_step", clock="host")),
              len(tracer.spans("cohort_step", clock="device")))
    doc = profiled(lambda: [round_() for _ in range(2)], tmp_path)
    assert trainer.last_round_stats["replays"] == trainer.last_round_stats["cohort_steps"]
    assert_on_one_clock(tracer, "cohort_step", *before, doc)


def test_serve_step_spans_hold_their_graph_launches(cuda, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.zoo import Model
    from repro_torch.obs import Tracer

    cfg = get_config("mamba2-130m").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    steps = 160
    cache = model.init_cache(2, steps + 8, cuda)
    tracer = Tracer()
    serve = make_serve_step(model, tracer=tracer)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    pos = 0

    def step():
        nonlocal tok, pos
        logits, _ = serve(params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        tok.cpu()   # the served tokens read back, as a serving loop does
        pos += 1

    for _ in range(4):
        step()   # the first call captures
    before = (len(tracer.spans("serve_step", clock="host")),
              len(tracer.spans("serve_step", clock="device")))
    doc = profiled(lambda: [step() for _ in range(steps)], tmp_path)
    assert_on_one_clock(tracer, "serve_step", *before, doc)


def test_a_replays_device_span_is_the_graphs_time(cuda):
    from repro_torch.capture import GraphCache
    from repro_torch.obs import Tracer

    a = torch.randn(2048, 2048, device=cuda)
    b = torch.randn(2048, 2048, device=cuda)

    def body():
        out = a
        for _ in range(8):
            out = torch.tanh(out @ b)
        return out.sum()

    tracer = Tracer()
    step = GraphCache(cuda, tracer, "chain").capture(body)
    for _ in range(5):
        step.graph.replay()   # warm: clocks up, no span
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(100):
        step.graph.replay()
    end.record()
    end.synchronize()
    mean_s = start.elapsed_time(end) / 100 * 1e-3
    for _ in range(100):
        step.replay()
    spans = tracer.spans("chain", clock="device")
    assert len(spans) == 100
    durs = np.asarray([s.dur for s in spans])
    assert abs(np.median(durs) / mean_s - 1) < 0.03, (np.median(durs), mean_s)
    assert np.mean(np.abs(durs / mean_s - 1) < 0.03) >= 0.95, (durs.min(), durs.max(), mean_s)
