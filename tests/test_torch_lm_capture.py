"""The rest of the port's ``jax.jit`` on the CPU: the donated decode cache,
``AdamW.update_``, and the captured LM train step, serve step and the
paper's predict function.

On the card ``make_train_step``, ``make_serve_step`` and
``experiments/paper.py::_predict`` capture their step as a CUDA graph and
replay it; on the CPU they run eagerly.  Here the captured path is forced
on the CPU (``capture_enabled`` patched to true), where ``GraphCache.
capture`` returns a stand-in that reruns the body at each replay, so
everything but the graph itself runs: the static buffers, the copies and
fills before a replay, the first call as the capture's warm-up, the swap of
another tree's values, the output cloned out.

* (a) ``Model.decode_step(donate=True)`` equals ``donate=False`` bit for
  bit in logits and cache over 8 steps for every decode family (dense with
  GQA groups of 2 and a wrapping window, qwen3 with 2 KV heads, Mamba2,
  the hybrid with 2 groups and a tail, the VLM after its patches, DeepSeek
  with MLA and MoE, the encoder-decoder after ``encode_for_decode``); the
  donated cache is the given tree, every tensor at its data pointer, and
  the encoder's K/V untouched.
* (b) The captured serve step equals the eager one bit for bit (logits and
  cache, int and tensor positions, one capture and a replay a later step);
  for qwen3 in float32 it also matches the JAX package's
  ``jax.jit(make_serve_step(jmodel), donate_argnums=(2,))`` within 1e-5.
* (c) ``AdamW.update_`` equals ``update`` bit for bit (float32, bfloat16,
  ``clip_norm``, ``cosine_schedule``, host and device coefficients).
* (d) The captured train step equals the eager one bit for bit after 3
  steps (params, moments, metrics) for mamba2-130m and smollm-135m (and
  smollm in bfloat16); a call with a cloned tree updates that tree and
  leaves the capturing one untouched.
* (e) ``_predict`` through its static buffers equals eager bit for bit,
  with a ragged last batch: two captures, a replay a batch.
* (f) An MLA serve step given an int position past the cache raises
  ``IndexError`` before anything runs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch import capture  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, lm_token_batch  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.kernels.gru_scan import kernel as gru_kernel  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.models.zoo import Model, params_from_jax  # noqa: E402
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates, cosine_schedule  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
B, STEPS = 2, 8
ENC_FRAMES = 9

# name -> (arch, changes to its reduced config)
DECODE_FAMILIES = {
    "smollm-135m": ("smollm-135m", {}),
    "smollm-window5": ("smollm-135m", {"sliding_window": 5}),
    "qwen3-group2": ("qwen3-1.7b", {"num_kv_heads": 2}),
    "mamba2-130m": ("mamba2-130m", {}),
    "zamba2-5layers": ("zamba2-7b", {"num_layers": 5}),
    "internvl2-26b": ("internvl2-26b", {}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
}


@pytest.fixture
def forced(monkeypatch):
    """The captured path on the CPU: the steps take it, and capture builds
    the stand-in that reruns the body."""
    monkeypatch.setattr(steps, "capture_enabled", lambda device: True)
    monkeypatch.setattr(paper, "capture_enabled", lambda device: True)


def config(name: str, **more):
    arch, changes = DECODE_FAMILIES[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes, **more)


def init(cfg, seed: int = 0):
    return Model(cfg, remat=False).init(torch.Generator().manual_seed(seed), "cpu")


def tokens(cfg, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32))


def start_cache(model: Model, params, max_len: int, seed: int = 1):
    """A cache with the encoder's K/V (encoder-decoder) or the VLM's patches
    put in through the functional decode; returns it and the next position."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    cache = model.init_cache(B, max_len, "cpu")
    pos = 0
    with torch.inference_mode():
        if cfg.arch_type.value == "encdec":
            src = torch.from_numpy(rng.normal(size=(B, ENC_FRAMES, cfg.d_model)).astype(np.float32))
            cache = model.encode_for_decode(params, src, cache)
        if cfg.arch_type.value == "vlm":
            patches = torch.from_numpy(rng.normal(
                size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32))
            for i in range(cfg.num_frontend_tokens):
                _, cache = model.decode_step(params, None, cache, pos,
                                             token_embeds=patches[:, i:i + 1])
                pos += 1
    return cache, pos


def clone_tree(tree):
    return tree_map(torch.clone, tree)


def assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# (a) the donated decode cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DECODE_FAMILIES))
def test_donated_decode_equals_functional(name):
    cfg = config(name)
    model = Model(cfg, remat=False)
    params = init(cfg)
    cache, pos0 = start_cache(model, params, cfg.num_frontend_tokens + STEPS)
    donated = clone_tree(cache)
    pointers = [t.data_ptr() for t in tree_leaves(donated)]
    cross = ({k: donated["blocks"][k].clone() for k in ("cross_k", "cross_v")}
             if "cross_k" in donated.get("blocks", {}) else {})
    toks = tokens(cfg, STEPS, seed=2)
    with torch.inference_mode():
        for t in range(STEPS):
            want, cache = model.decode_step(params, toks[:, t:t + 1], cache, pos0 + t)
            got, out = model.decode_step(params, toks[:, t:t + 1], donated, pos0 + t,
                                         donate=True)
            assert out is donated
            assert torch.equal(got, want)
            assert_same(donated, cache)
    assert [t.data_ptr() for t in tree_leaves(donated)] == pointers
    for k, v in cross.items():
        assert torch.equal(donated["blocks"][k], v)


def test_donated_decode_takes_a_tensor_position():
    cfg = config("qwen3-group2")
    model = Model(cfg, remat=False)
    params = init(cfg)
    cache = model.init_cache(B, STEPS, "cpu")
    donated = clone_tree(cache)
    toks = tokens(cfg, 3, seed=3)
    with torch.inference_mode():
        for t in range(3):
            want, cache = model.decode_step(params, toks[:, t:t + 1], cache, t)
            got, _ = model.decode_step(params, toks[:, t:t + 1], donated,
                                       torch.tensor(t, dtype=torch.int64), donate=True)
            assert torch.equal(got, want)
    assert_same(donated, cache)


# ---------------------------------------------------------------------------
# (b) the captured serve step
# ---------------------------------------------------------------------------

def serve_run(model, params, toks, cache, pos0, positions=int):
    serve = steps.make_serve_step(model)
    logits = []
    for t in range(toks.shape[1]):
        lg, out = serve(params, toks[:, t:t + 1], cache, positions(pos0 + t))
        assert out is cache
        logits.append(lg)
    return serve, torch.stack(logits, dim=1)


@pytest.mark.parametrize("name", ["smollm-window5", "mamba2-130m", "zamba2-5layers",
                                  "deepseek-v3-671b", "seamless-m4t-large-v2"])
def test_captured_serve_step_equals_eager(name, monkeypatch):
    cfg = config(name)
    model = Model(cfg, remat=False)
    params = init(cfg)
    cache, pos0 = start_cache(model, params, cfg.num_frontend_tokens + STEPS)
    toks = tokens(cfg, STEPS, seed=4)
    eager_cache = clone_tree(cache)
    _, want = serve_run(model, params, toks, eager_cache, pos0)
    monkeypatch.setattr(steps, "capture_enabled", lambda device: True)
    pointers = [t.data_ptr() for t in tree_leaves(cache)]
    positions = (lambda p: torch.tensor(p)) if name == "mamba2-130m" else int
    serve, got = serve_run(model, params, toks, cache, pos0, positions)
    assert torch.equal(got, want)
    assert_same(cache, eager_cache)
    assert [t.data_ptr() for t in tree_leaves(cache)] == pointers
    graphs = serve.graphs(torch.device("cpu"))
    assert (graphs.captures, graphs.replays, len(graphs.entries)) == (1, STEPS - 1, 1)


def test_captured_serve_step_matches_jax(forced):
    """qwen3-1.7b reduced, float32, against the reference's jitted serve
    step with the cache donated, on params carried across."""
    jcfg, cfg = jax_get_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    jmodel = jax_zoo.Model(jcfg, remat=False)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.key(5)))
    params = params_from_jax(jparams, "cpu")
    model = Model(cfg, remat=False)
    toks = tokens(cfg, STEPS, seed=6).numpy()
    jstep = jax.jit(jax_steps.make_serve_step(jmodel), donate_argnums=(2,))
    jcache = jmodel.init_cache(B, STEPS)
    want = []
    for t in range(STEPS):
        lg, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        want.append(np.asarray(lg))
    want = np.stack(want, axis=1)
    cache = model.init_cache(B, STEPS, "cpu")
    _, got = serve_run(model, params, torch.from_numpy(toks), cache, 0)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * max(1.0, np.abs(want).max()), rtol=0)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jcache)]
    for got_leaf, want_leaf in zip(tree_leaves(cache), jleaves):
        np.testing.assert_allclose(got_leaf.float().numpy(), want_leaf.astype(np.float32),
                                   atol=TOL * max(1.0, np.abs(want_leaf).max()), rtol=0)


def test_serve_step_keys_and_cross_kv(forced):
    """A new cache is a new key; new cross K/V copied into the served
    cache keep its graph."""
    cfg = config("seamless-m4t-large-v2")
    model = Model(cfg, remat=False)
    params = init(cfg)
    cache, _ = start_cache(model, params, STEPS, seed=7)
    serve = steps.make_serve_step(model)
    toks = tokens(cfg, 3, seed=8)
    serve(params, toks[:, :1], cache, 0)
    other, _ = start_cache(model, params, STEPS, seed=9)
    with torch.inference_mode():   # encode_for_decode made them there
        for k in ("cross_k", "cross_v"):
            cache["blocks"][k].copy_(other["blocks"][k])
    lg, _ = serve(params, toks[:, 1:2], cache, 1)
    graphs = serve.graphs(torch.device("cpu"))
    assert (graphs.captures, graphs.replays) == (1, 1)
    serve(params, toks[:, :1], other, 0)
    assert (graphs.captures, len(graphs.entries)) == (2, 2)


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "forced"])
def test_a_traced_serve_loop_has_a_serve_step_span_a_call(captured, monkeypatch):
    """One ``serve_step`` host span a call, the capture's first call and the
    eager path included, each around the step's whole host work; the
    traced loop serves the untraced loop's logits bit for bit."""
    if captured:
        monkeypatch.setattr(steps, "capture_enabled", lambda device: True)
    cfg = config("mamba2-130m")
    model = Model(cfg, remat=False)
    params = init(cfg)
    toks = tokens(cfg, STEPS, seed=4)
    _, want = serve_run(model, params, toks, model.init_cache(B, STEPS, "cpu"), 0)
    tracer = Tracer()
    serve = steps.make_serve_step(model, tracer=tracer)
    cache = model.init_cache(B, STEPS, "cpu")
    got = []
    for t in range(STEPS):
        with tracer.span("loop"):
            got.append(serve(params, toks[:, t:t + 1], cache, t)[0])
    assert torch.equal(torch.stack(got, dim=1), want)
    spans, loops = tracer.spans("serve_step"), tracer.spans("loop")
    assert len(spans) == len(loops) == STEPS
    assert {(s.clock, s.track, s.args) for s in spans} == {("host", "server", None)}
    for span, loop in zip(spans, loops):
        assert loop.ts <= span.ts and span.ts + span.dur <= loop.ts + loop.dur
    graphs = serve.graphs(torch.device("cpu"))
    assert graphs.tracer is NULL_TRACER   # the CPU times no replay
    assert (graphs.captures, graphs.replays) == ((1, STEPS - 1) if captured else (0, 0))


# ---------------------------------------------------------------------------
# (c) AdamW.update_
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["plain", "clip", "schedule", "device_coefficients"])
def test_update_in_place_equals_update(dtype, variant, monkeypatch):
    monkeypatch.setattr(adamw, "_CHUNK", 5)   # device coefficients: products taken in chunks
    g = torch.Generator().manual_seed(10)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [torch.randn(s, generator=g).to(dtype) for s in shapes]
    opt = AdamW(learning_rate=3e-3, weight_decay=1e-2,
                clip_norm=0.5 if variant == "clip" else None,
                schedule=cosine_schedule(2, 6) if variant == "schedule" else None)
    state = opt.init(params)
    mine = AdamWState(state.step, clone_tree(state.mu), clone_tree(state.nu))
    ref_params, my_params = clone_tree(params), clone_tree(params)
    for k in range(4):
        grads = [torch.randn(s, generator=g).to(dtype) for s in shapes]
        coefs = (torch.tensor(opt.coefficients(k + 1)) if variant == "device_coefficients"
                 else None)
        updates, state = opt.update(grads, state, ref_params)
        apply_updates(ref_params, updates)
        mu, nu = mine.mu, mine.nu
        my_updates = opt.update_(grads, mine, my_params, coefs)
        apply_updates(my_params, my_updates)
        mine = AdamWState(mine.step + 1, mu, nu)
        assert all(a is b for a, b in zip(mine.mu, mu))
        assert_same(my_updates, updates)
        assert_same((my_params, mine.mu, mine.nu), (ref_params, state.mu, state.nu))


# ---------------------------------------------------------------------------
# (d) the captured train step
# ---------------------------------------------------------------------------

def lm_batches(cfg, n: int, seq: int = 12, seed: int = 11):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(v) for k, v in lm_token_batch(rng, B, seq, cfg.vocab_size).items()}
            for _ in range(n)]


def train_run(model, opt, params, batches):
    step = steps.make_train_step(model, opt)
    state = opt.init(params)
    metrics = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        metrics.append(m)
    return step, params, state, metrics


@pytest.mark.parametrize("arch,dtype", [("mamba2-130m", "float32"), ("smollm-135m", "float32"),
                                        ("smollm-135m", "bfloat16")])
def test_captured_train_step_equals_eager(arch, dtype, monkeypatch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    model = Model(cfg, remat=True, loss_chunk=5)
    opt = AdamW(learning_rate=1e-2, clip_norm=1.0, schedule=cosine_schedule(1, 4))
    params0 = init(cfg, seed=12)
    batches = lm_batches(cfg, 3)
    _, want_p, want_s, want_m = train_run(model, opt, clone_tree(params0), batches)

    monkeypatch.setattr(steps, "capture_enabled", lambda device: True)
    step, got_p, got_s, got_m = train_run(model, opt, clone_tree(params0), batches)
    assert got_s.step == want_s.step == 3
    assert_same((got_p, got_s.mu, got_s.nu), (want_p, want_s.mu, want_s.nu))
    assert [list(m) for m in got_m] == [list(m) for m in want_m]
    for g, w in zip(got_m, want_m):
        assert all(torch.equal(g[k], w[k]) for k in w)
    graphs = step.graphs(torch.device("cpu"))
    assert (graphs.captures, graphs.replays) == (1, 2)

    # Another tree of the same shapes: its own step, the capturing tree kept.
    held = clone_tree((got_p, got_s.mu, got_s.nu))
    other = clone_tree(params0)
    other_state = opt.init(other)
    other, other_state, m = step(other, other_state, batches[0])
    assert_same((got_p, got_s.mu, got_s.nu), held)
    _, one_p, one_s, one_m = train_run(model, opt, clone_tree(params0), batches[:1])
    assert_same((other, other_state.mu, other_state.nu), (one_p, one_s.mu, one_s.nu))
    assert torch.equal(m["loss"], one_m[0]["loss"])
    assert (graphs.captures, graphs.replays) == (1, 3)


def test_eager_train_step_writes_the_moments_in_place():
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, remat=False)
    opt = AdamW(learning_rate=1e-3)
    params = init(cfg)
    state = opt.init(params)
    pointers = [t.data_ptr() for t in tree_leaves((state.mu, state.nu))]
    step = steps.make_train_step(model, opt)
    out, new_state, metrics = step(params, state, lm_batches(cfg, 1)[0])
    assert out is params and new_state.step == 1
    assert [t.data_ptr() for t in tree_leaves((new_state.mu, new_state.nu))] == pointers
    assert set(metrics) == {"ce", "router_aux", "loss"}


def test_warmup_is_step_keeps_the_first_step():
    """A capture whose warm-up is the caller's first step keeps its launch
    counts and its output; a scratch warm-up puts the counts back."""
    graphs = capture.GraphCache(torch.device("cpu"))
    before = gru_kernel.gru_scan.launches

    def body():
        gru_kernel.gru_scan.launches += 1
        return torch.ones(2)

    step = graphs.capture(body, warmup_is_step=True)
    assert gru_kernel.gru_scan.launches == before + 1
    assert torch.equal(step.first, torch.ones(2))
    scratch = graphs.capture(body)
    assert gru_kernel.gru_scan.launches == before + 1 and scratch.first is None
    gru_kernel.gru_scan.launches = before


# ---------------------------------------------------------------------------
# (e) the paper's predict function
# ---------------------------------------------------------------------------

def test_captured_predict_equals_eager(monkeypatch):
    cfg = gru.GRUConfig(input_dim=6, hidden_dim=8, num_layers=2)
    params = gru.init_gru(torch.Generator().manual_seed(13), cfg, "cpu")
    rng = np.random.default_rng(14)
    data = ArrayDataset(rng.normal(size=(37, 5, 6)).astype(np.float32),
                        rng.uniform(1, 9, size=37).astype(np.float32))
    want = paper._predict(params, cfg, data, batch=16)
    made = []

    class Recorded(capture.GraphCache):
        def __init__(self, device):
            super().__init__(device)
            made.append(self)

    monkeypatch.setattr(paper, "GraphCache", Recorded)
    monkeypatch.setattr(paper, "capture_enabled", lambda device: True)
    got = paper._predict(params, cfg, data, batch=16)
    assert got.dtype == want.dtype and got.shape == (37,)
    assert np.array_equal(got, want)
    assert len(made) == 1
    assert (made[0].captures, made[0].replays, len(made[0].entries)) == (2, 3, 2)
    paper._predict(params, cfg, data, batch=16)
    assert len(made) == 2   # one cache a call


# ---------------------------------------------------------------------------
# (f) MLA positions past the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("captured", [False, True])
def test_mla_serve_step_position_past_the_cache_raises(captured, monkeypatch):
    if captured:
        monkeypatch.setattr(steps, "capture_enabled", lambda device: True)
    cfg = config("deepseek-v3-671b")
    model = Model(cfg, remat=False)
    params = init(cfg)
    cache = model.init_cache(B, 4, "cpu")
    serve = steps.make_serve_step(model)
    toks = tokens(cfg, 2, seed=15)
    serve(params, toks[:, :1], cache, 0)
    held = clone_tree(cache)
    with pytest.raises(IndexError):
        serve(params, toks[:, 1:2], cache, 4)
    assert_same(cache, held)
    graphs = serve.graphs(torch.device("cpu"))
    assert graphs.captures == int(captured) and graphs.replays == 0
