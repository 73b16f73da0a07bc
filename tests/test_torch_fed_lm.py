"""The federated LM round (``launch/steps.py::make_fed_round_step``) and
``examples/torch_federated_lm.py`` against the JAX package's.

``make_fed_round_step`` at ``smollm-135m.reduced()`` in float32, C=3 client
slots of K=2 local AdamW(1e-3) steps, one slot of weight 0; JAX params
carried across with ``params_from_jax``, each slot's batches made with
numpy from a seed.  Tolerances: the round's loss 1e-5 times max(1,
|ref|); its params and moments 1e-4, by ROADMAP's AdamW drift rule at lr
1e-3: where a weighted slot's first-step gradient (the reference's) is
below 1e-6, AdamW's lr g / (|g| + eps) turns a rounding difference of that
gradient into a visible fraction of lr, so those entries are held to
2 lr + 1e-4, the swing of a sign flip (on these batches 1 entry of w_q and
1 of w_up move 1.6e-4 and 1.3e-4 apart, each with one slot's gradient
near 3e-10).  A slot of weight 0 must not move the average at all: the
round with that slot's batches replaced gives the same params bit for bit.

The example's recruitment on token histograms is the JAX package's
``recruit`` on the reference example's corpora (its ``make_client_corpus``,
the same numpy stream) with the sample size the port discloses, the
number of tokens the histogram counts.
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.histogram import token_histogram as jax_token_histogram  # noqa: E402
from repro.core.recruitment import BALANCED as JAX_BALANCED  # noqa: E402
from repro.core.recruitment import ClientStats as JaxClientStats  # noqa: E402
from repro.core.recruitment import recruit as jax_recruit  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

PARAM_TOL = 1e-4
LOSS_TOL = 1e-5
LR = 1e-3
C, K, BATCH, SEQ = 3, 2, 2, 12
WEIGHTS = np.array([40.0, 0.0, 25.0], np.float32)   # slot 1: a client recruitment excluded
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def client_batches(vocab: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (C, K, BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jax_get_config("smollm-135m").reduced(), get_config("smollm-135m").reduced()
    jmodel = jax_zoo.Model(jcfg, remat=False)
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    stacked = jax.tree.map(lambda a: np.broadcast_to(a, (C, *a.shape)).copy(), jparams)
    return jmodel, zoo.Model(tcfg, remat=False), stacked, client_batches(tcfg.vocab_size, 1)


def torch_round(model, stacked, batches):
    opt = AdamW(LR)
    params_c = zoo.params_from_jax(stacked, "cpu")
    state = opt.init(params_c)
    batches = {k: torch.from_numpy(v) for k, v in batches.items()}
    return steps.make_fed_round_step(model, opt)(params_c, state, batches, WEIGHTS)


def test_fed_round_matches_jax(setup):
    jmodel, model, stacked, batches = setup
    opt = JaxAdamW(LR)
    jstate = opt.init(stacked)
    jstate = JaxAdamWState(jnp.zeros((C,), jnp.int32), jstate.mu, jstate.nu)
    want_params, want_state, want_loss = jax.jit(jax_steps.make_fed_round_step(jmodel, opt))(
        stacked, jstate, {k: jnp.asarray(v) for k, v in batches.items()}, jnp.asarray(WEIGHTS))
    params_c, state, loss = torch_round(model, stacked, batches)
    first_grad = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    grads = [jax.tree.leaves(first_grad(jax.tree.map(lambda a: a[c], stacked),
                                        {k: jnp.asarray(v[c, 0]) for k, v in batches.items()}))
             for c in range(C) if WEIGHTS[c] > 0]

    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * max(1.0, abs(float(want_loss)))
    assert np.array_equal(np.asarray(state.step), np.asarray(want_state.step)) \
        and list(state.step) == [K] * C
    settled = [np.all([np.abs(np.asarray(g[i])) >= 1e-6 for g in grads], axis=0)
               for i in range(len(grads[0]))]
    for got, want, ok in zip(tree_leaves(params_c), jax.tree.leaves(want_params), settled):
        got = got.numpy()
        gap = np.abs(got - np.asarray(want))
        assert np.all(np.isfinite(got))
        assert float(gap[:, ok].max(initial=0.0)) <= PARAM_TOL
        assert float(gap.max()) <= 2 * LR + PARAM_TOL
        assert all(np.array_equal(got[c], got[0]) for c in range(1, C))  # every slot equal
    for tree, jtree in ((state.mu, want_state.mu), (state.nu, want_state.nu)):
        for got, want in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= PARAM_TOL


def test_a_weight_zero_slot_does_not_move_the_average(setup):
    _, model, stacked, batches = setup
    other = client_batches(model.cfg.vocab_size, 2)
    swapped = {k: v.copy() for k, v in batches.items()}
    for k in swapped:
        swapped[k][1] = other[k][1]
    a, state_a, _ = torch_round(model, stacked, batches)
    b, state_b, _ = torch_round(model, stacked, swapped)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    # the excluded slot still trained on its own batches: only its moments differ
    mu_a, mu_b = tree_leaves(state_a.mu), tree_leaves(state_b.mu)
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[2], y[2]) for x, y in zip(mu_a, mu_b))
    assert not all(torch.equal(x[1], y[1]) for x, y in zip(mu_a, mu_b))


def test_fed_round_of_one_slot_is_the_train_step(setup):
    """C=1 of weight 1: the round is K train steps (its average is itself)."""
    _, model, stacked, batches = setup
    opt = AdamW(LR)
    one = tree_map(lambda a: a[:1].copy(), stacked)
    params_c = zoo.params_from_jax(one, "cpu")
    params_c, _, loss = steps.make_fed_round_step(model, opt)(
        params_c, opt.init(params_c), {k: torch.from_numpy(v[:1]) for k, v in batches.items()},
        [1.0])
    params = zoo.params_from_jax(tree_map(lambda a: a[0], one), "cpu")
    state, losses = opt.init(params), []
    step = steps.make_train_step(model, opt)
    for k in range(K):
        params, state, metrics = step(params, state, {n: torch.from_numpy(v[0, k])
                                                      for n, v in batches.items()})
        losses.append(metrics["loss"])
    assert all(torch.equal(a[0], b) for a, b in zip(tree_leaves(params_c), tree_leaves(params)))
    assert torch.equal(loss, torch.stack(losses).mean() * 1.0)


def test_example_runs_on_the_cpu_and_recruits_the_reference_set(capsys):
    example = load(EXAMPLES / "torch_federated_lm.py")
    out = example.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "federated LM fine-tuning done" in printed
    assert len(out["round_losses"]) == example.ROUNDS
    assert all(np.isfinite(out["round_losses"]))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(out["params"]))

    reference = load(EXAMPLES / "federated_lm.py")
    assert (reference.NUM_CLIENTS, reference.SEQ, reference.BATCH, reference.ROUNDS,
            reference.LOCAL_STEPS) == (example.NUM_CLIENTS, example.SEQ, example.BATCH,
                                       example.ROUNDS, example.LOCAL_STEPS)
    cfg = jax_get_config("smollm-135m").reduced()
    rng = np.random.default_rng(0)
    corpora = [reference.make_client_corpus(rng, cfg.vocab_size, skew=rng.uniform(0, 1))
               for _ in range(reference.NUM_CLIENTS)]
    stats = [JaxClientStats(client_id=i, counts=jax_token_histogram(c[:, 1:], cfg.vocab_size),
                            n=c[:, 1:].size) for i, c in enumerate(corpora)]
    res = jax_recruit(stats, dataclasses.replace(JAX_BALANCED, gamma_th=0.3))
    assert out["recruited"] == sorted(res.recruited_ids.tolist())
    assert 0 < len(out["recruited"]) < reference.NUM_CLIENTS
    assert f"recruited {len(out['recruited'])}/12 hospital text shards" in printed


def test_example_flags_are_the_reference_flags_and_device():
    flags = lambda path: set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', path.read_text()))
    assert flags(EXAMPLES / "torch_federated_lm.py") == \
        flags(EXAMPLES / "federated_lm.py") | {"--device"}
