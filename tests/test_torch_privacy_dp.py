"""The port's DP-SGD and accountant on the CPU, against the JAX package's.

* ``DPConfig`` / ``resolve_dp`` accept and reject what the reference does.
* ``per_example_clip_factors`` and ``dp_value_and_grad`` (from the
  reference's initial params, clip binding, noise 0, dropout 0) against
  JAX's, at 1e-6 and 1e-5.
* The client-axis per-example gradients against a loop of one-example
  ``autograd.grad`` calls, 1e-6.
* The RNG contract of ``privacy/dp.py``: with the generator replayed, the
  noise is ``sigma / denom`` times one draw a leaf in leaf order; with
  dropout on, every example of a participant sees one ``(1, T, N)`` mask
  and the generator advances by that one draw.
* Federations: degenerate DP = unprotected and sequential = vectorized
  under DP with noise and dropout (both 1e-5); a 4-client DP federation
  against the reference's (noise 0, dropout 0), params within 1e-4, with
  per-round epsilons equal to the reference's; seeded DP runs replay bit
  for bit; unprotected runs report no epsilon.
* The accountant's epsilons equal to the reference's on a grid.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.privacy import accountant as jax_accountant  # noqa: E402
from repro.privacy import dp as jax_dp  # noqa: E402
from repro_torch.data.pipeline import build_client_datasets  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.federated.client import LocalTrainer  # noqa: E402
from repro_torch.federated.cohort import CohortTrainer  # noqa: E402
from repro_torch.kernels.gru_scan.ops import gru_sequence  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.privacy import accountant, dp  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
PARAMS_TOL = 1e-4
T, F = 6, 38
COHORT = dict(num_hospitals=6, total_stays=240, min_hospital_size=10)
IMPLS = {"port": dp, "jax": jax_dp}


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def jax_init(hidden=8, layers=2, seed=0):
    jcfg = jax_gru.GRUConfig(hidden_dim=hidden, num_layers=layers, dropout=0.0)
    return jcfg, jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(seed), jcfg))


def batch_arrays(c, b, seed, t=T, f=F, pad=2):
    """``(x, y, mask)`` numpy arrays (C, B, ...), the last ``pad`` slots of
    every participant padding."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, b, t, f)).astype(np.float32)
    y = rng.uniform(0.5, 20.0, size=(c, b)).astype(np.float32)
    m = np.ones((c, b), np.float32)
    m[:, b - pad:] = 0.0
    x[:, b - pad:] = 0.0
    y[:, b - pad:] = 0.0
    return x, y, m


def stacked(params, c):
    return tree_map(lambda q: q.unsqueeze(0).expand(c, *q.shape).clone(), params)


def tensors(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# --------------------------------------------------------------------------
# DPConfig and resolve_dp, each case on the port and on the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kwargs", [
    {"clip_norm": "0.1"}, {"noise_multiplier": "1.0"}, {"noise_multiplier": True},
    {"delta": "1e-5"},
])
def test_dp_config_rejects_json_strings_and_bools(impl, kwargs):
    with pytest.raises(TypeError, match="number"):
        IMPLS[impl].DPConfig(**kwargs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kwargs", [
    {"clip_norm": -1.0}, {"clip_norm": 0.0}, {"noise_multiplier": -0.5}, {"delta": 0.0},
    {"delta": 1.0}, {"clip_norm": None, "noise_multiplier": 1.0},
])
def test_dp_config_rejects_bad_ranges(impl, kwargs):
    with pytest.raises(ValueError):
        IMPLS[impl].DPConfig(**kwargs)


@pytest.mark.parametrize("impl", IMPLS)
def test_resolve_dp_forms(impl):
    m = IMPLS[impl]
    assert m.resolve_dp(None) is None
    cfg = m.DPConfig(clip_norm=2.0, noise_multiplier=0.5)
    assert m.resolve_dp(cfg) is cfg
    assert m.resolve_dp({"clip_norm": 2.0, "noise_multiplier": 0.5}) == cfg
    with pytest.raises(ValueError, match="unknown"):
        m.resolve_dp({"clipnorm": 2.0})
    with pytest.raises(TypeError):
        m.resolve_dp({"clip_norm": "2.0"})
    with pytest.raises(TypeError):
        m.resolve_dp("dp")


@pytest.mark.parametrize("kwargs", [
    {}, {"clip_norm": 2.0, "noise_multiplier": 1.5}, {"clip_norm": None, "noise_multiplier": 0.0},
    {"clip_norm": 0.3, "noise_multiplier": 0, "delta": 1e-3},
])
def test_dp_config_properties_match_the_reference(kwargs):
    got, ref = dp.DPConfig(**kwargs), jax_dp.DPConfig(**kwargs)
    assert got.effective_clip == ref.effective_clip
    assert got.noise_sigma == ref.noise_sigma
    assert got.to_state() == ref.to_state()


# --------------------------------------------------------------------------
# the primitives against JAX's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [0.5, 3.0, float("inf")])
def test_per_example_clip_factors_match_jax(clip):
    rng = np.random.default_rng(4)
    grads = {"a": rng.normal(size=(9, 3, 4)).astype(np.float32),
             "b": rng.normal(size=(9, 5)).astype(np.float32) * 0.2}
    grads["a"][2] = 0.0
    got = dp.per_example_clip_factors(tree_map(torch.from_numpy, grads), clip)
    ref = jax_dp.per_example_clip_factors(jax.tree.map(jnp.asarray, grads), clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_add_gaussian_noise_zero_sigma_is_identity_and_draws_nothing():
    tree = {"a": torch.arange(4.0), "b": torch.ones(2, 2)}
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    assert dp.add_gaussian_noise(tree, g, 0.0) is tree
    assert torch.equal(g.get_state(), state)
    noised = dp.add_gaussian_noise(tree, g, 0.5)
    replay = torch.Generator().manual_seed(3)
    for leaf, out in zip(tree_leaves(tree), tree_leaves(noised)):
        assert torch.equal(out, leaf + 0.5 * torch.randn(leaf.shape, generator=replay))


@pytest.mark.parametrize("clip", [0.05, None])
def test_dp_value_and_grad_matches_jax(clip):
    """From the reference's initial params, noise 0, dropout 0: the port's
    step over a client axis of one against JAX's ``dp_value_and_grad``."""
    jcfg, init = jax_init()
    x, y, m = batch_arrays(1, 10, seed=1)
    cfg = jax_dp.DPConfig(clip_norm=clip, noise_multiplier=0.0)
    ref_loss, ref_grads = jax_dp.dp_value_and_grad(jax_gru.make_loss_fn(jcfg), cfg)(
        init, (x[0], y[0], m[0]), jax.random.key(1), jax.random.key(2))
    tcfg = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    step = dp.dp_value_and_grad(gru.make_loss_fn(tcfg), dp.DPConfig(clip, 0.0))
    loss, grads = step(stacked(gru.params_from_jax(init, "cpu"), 1), tensors(x, y, m), None)
    if clip is not None:
        # the clip binds: every example's norm is above it
        _, per = dp.per_example_value_and_grad(
            gru.make_loss_fn(tcfg), stacked(gru.params_from_jax(init, "cpu"), 1),
            tensors(x, y, m), None)
        assert float(dp.per_example_clip_factors(per, clip)[:8].max()) < 1.0
    assert abs(float(loss[0]) - float(ref_loss)) <= TOL
    for g, r in zip(tree_leaves(grads), jax.tree.leaves(ref_grads)):
        assert g.shape[1:] == r.shape
        assert float(np.max(np.abs(g[0].numpy() - np.asarray(r)))) <= TOL


def one_example_loss(params, cfg, x, y, m, mask=None):
    """The plain one-client model on a single example; ``mask`` is the
    dropout mask of the first layer's output (None: no dropout)."""
    h = x[None]
    for i, layer in enumerate(params["layers"]):
        h = gru_sequence(h, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"])
        if mask is not None and i < len(params["layers"]) - 1:
            h = torch.where(mask < 1.0 - cfg.dropout, h / (1.0 - cfg.dropout), 0.0)
    y_hat = torch.relu(h[:, -1, :] @ params["head"]["w"] + params["head"]["b"])[:, 0]
    return gru.msle_loss(y[None], y_hat, m[None])


def test_client_axis_gradients_match_a_loop_of_one_example_grads():
    cfg = gru.GRUConfig(input_dim=F, hidden_dim=8, num_layers=2, dropout=0.0)
    c, b = 3, 5
    params = [gru.init_gru(torch.Generator().manual_seed(i), cfg, "cpu") for i in range(c)]
    p = tree_map(lambda *leaves: torch.stack(leaves), *params)
    x, y, m = tensors(*batch_arrays(c, b, seed=2, pad=1))
    losses, grads = dp.per_example_value_and_grad(gru.make_loss_fn(cfg), p, (x, y, m), None)
    assert losses.shape == (c * b,) and all(g.shape[0] == c * b for g in grads)
    for ci in range(c):
        for i in range(b):
            q = tree_map(lambda t: t.detach().clone().requires_grad_(True), params[ci])
            loss = one_example_loss(q, cfg, x[ci, i], y[ci, i], m[ci, i])
            want = torch.autograd.grad(loss, tree_leaves(q))
            assert abs(float(loss.detach()) - float(losses[ci * b + i])) <= 1e-6
            for g, w in zip(grads, want):
                assert float((g[ci * b + i] - w).abs().max()) <= 1e-6


def test_noise_is_sigma_over_denom_times_the_replayed_draws():
    cfg = gru.GRUConfig(input_dim=F, hidden_dim=8, num_layers=2, dropout=0.0)
    p = stacked(gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu"), 3)
    batch = tensors(*batch_arrays(3, 6, seed=3, pad=2))
    loss_fn = gru.make_loss_fn(cfg)
    clean_loss, clean = dp.dp_value_and_grad(loss_fn, dp.DPConfig(0.5, 0.0))(
        p, batch, [torch.Generator().manual_seed(s) for s in (7, 8, 9)])
    gens = [torch.Generator().manual_seed(7), None, torch.Generator().manual_seed(9)]
    cfg_dp = dp.DPConfig(0.5, 1.3)
    loss, noised = dp.dp_value_and_grad(loss_fn, cfg_dp)(p, batch, gens)
    assert torch.equal(loss, clean_loss)
    sigma, denom = cfg_dp.noise_sigma, 4.0
    for ci, seed in ((0, 7), (2, 9)):
        replay = torch.Generator().manual_seed(seed)
        want = dp.add_gaussian_noise(
            [g[ci] * denom for g in tree_leaves(clean)], replay, sigma)
        for got, w in zip(tree_leaves(noised), want):
            torch.testing.assert_close(got[ci], w / denom, rtol=0, atol=1e-6)
        assert torch.equal(gens[ci].get_state(), replay.get_state())
    # a padding slot draws nothing and gets the noiseless gradient
    for got, c_ in zip(tree_leaves(noised), tree_leaves(clean)):
        assert torch.equal(got[1], c_[1])


def test_dropout_mask_is_shared_across_a_participants_examples():
    cfg = gru.GRUConfig(input_dim=F, hidden_dim=8, num_layers=2, dropout=0.5)
    c, b, clip = 2, 5, 0.3
    params = gru.init_gru(torch.Generator().manual_seed(5), cfg, "cpu")
    x, y, m = tensors(*batch_arrays(c, b, seed=4, pad=1))
    gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    loss, grads = dp.dp_value_and_grad(gru.make_loss_fn(cfg), dp.DPConfig(clip, 0.0))(
        stacked(params, c), (x, y, m), gens)
    for ci, seed in enumerate((11, 12)):
        replay = torch.Generator().manual_seed(seed)
        mask = torch.rand((1, T, cfg.hidden_dim), generator=replay)  # the one draw
        assert torch.equal(gens[ci].get_state(), replay.get_state())
        total, summed = 0.0, None
        for i in range(b):
            q = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
            li = one_example_loss(q, cfg, x[ci, i], y[ci, i], m[ci, i], mask)
            gi = torch.autograd.grad(li, tree_leaves(q))
            norm = torch.sqrt(sum((g * g).sum() for g in gi))
            f = torch.clamp(clip / (norm + 1e-12), max=1.0)
            clipped = [f * g for g in gi]
            summed = clipped if summed is None else [s + g for s, g in zip(summed, clipped)]
            total += float(li.detach())
        denom = float(m[ci].sum())
        assert abs(float(loss[ci]) - total / denom) <= 1e-6
        for g, s in zip(tree_leaves(grads), summed):
            assert float((g[ci] - s / denom).abs().max()) <= 1e-6


def test_sequential_dp_needs_a_generator_for_noise():
    cfg = gru.GRUConfig(input_dim=F, hidden_dim=8, num_layers=1, dropout=0.0)
    step = dp.dp_value_and_grad(gru.make_loss_fn(cfg), dp.DPConfig(1.0, 1.0))
    p = stacked(gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu"), 1)
    with pytest.raises(ValueError, match="generator"):
        step(p, tensors(*batch_arrays(1, 4, seed=0)), None)


# --------------------------------------------------------------------------
# the engines and the facade
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def port_clients():
    return build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3))


def run(privacy, engine="vectorized", dropout=0.0, seed=1, rounds=2, params0=None, **kw):
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=dropout)
    if params0 is None:
        params0 = gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    fed = Federation(
        FederationConfig(rounds=rounds, local_epochs=1, batch_size=8, seed=seed, engine=engine,
                         privacy=privacy, **kw),
        port_clients(), gru.make_loss_fn(cfg), AdamW(1e-2), device="cpu",
    )
    return fed.run(params0)


@pytest.mark.parametrize("engine", ["sequential", "vectorized"])
def test_degenerate_dp_matches_unprotected(engine):
    plain = run(None, engine)
    degenerate = run(dp.DPConfig(clip_norm=None, noise_multiplier=0.0), engine)
    for a, b in zip(plain.history, degenerate.history):
        assert abs(a.mean_local_loss - b.mean_local_loss) <= TOL
    assert max_diff(plain.params, degenerate.params) <= TOL


@pytest.mark.parametrize("selection", ["uniform", "uniform:0.5"])
def test_engines_agree_under_dp_with_noise_and_dropout(selection):
    privacy = dp.DPConfig(clip_norm=1.0, noise_multiplier=1.0)
    seq = run(privacy, "sequential", dropout=0.05, selection=selection)
    vec = run(privacy, "vectorized", dropout=0.05, selection=selection)
    for a, b in zip(seq.history, vec.history):
        assert a.participant_ids == b.participant_ids
        assert abs(a.mean_local_loss - b.mean_local_loss) <= TOL
        assert a.epsilon == b.epsilon
    assert max_diff(seq.params, vec.params) <= TOL


@pytest.mark.parametrize("engine", ["sequential", "vectorized"])
def test_seeded_dp_run_replays_bit_for_bit(engine):
    privacy = {"clip_norm": 1.0, "noise_multiplier": 1.0}
    a = run(privacy, engine, dropout=0.05)
    b = run(privacy, engine, dropout=0.05)
    assert [r.mean_local_loss for r in a.history] == [r.mean_local_loss for r in b.history]
    assert max_diff(a.params, b.params) == 0.0
    other = run(privacy, engine, dropout=0.05, seed=2)
    assert max_diff(a.params, other.params) > 0.0


def test_unprotected_run_reports_no_epsilon():
    result = run(None, rounds=1)
    assert [r.epsilon for r in result.history] == [None]
    assert result.summary()["epsilon"] is None


@functools.lru_cache(maxsize=1)
def jax_dp_federation():
    """The reference's 4-client DP federation (clip binding, noise 0 and
    dropout 0, half the clients a round) and its initial params."""
    jcfg, init = jax_init()
    config = dict(rounds=3, local_epochs=1, batch_size=8, seed=1,
                  recruitment="top-n-samples:4", selection="uniform:0.5")
    privacy = {"clip_norm": 0.5, "noise_multiplier": 0.0}
    ref = JaxFederation(
        JaxFederationConfig(**config, engine="vectorized", staging="rebuild", privacy=privacy),
        jax_clients(jax_generate(JaxCohortConfig(**COHORT), seed=3)),
        jax_gru.make_loss_fn(jcfg), JaxAdamW(learning_rate=1e-2),
    ).run(init)
    return init, config, privacy, ref


@pytest.mark.parametrize("engine", ["sequential", "vectorized"])
def test_dp_federation_matches_jax(engine):
    init, config, privacy, ref = jax_dp_federation()
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    got = Federation(
        FederationConfig(**config, engine=engine, privacy=privacy),
        port_clients(), gru.make_loss_fn(cfg), AdamW(1e-2), device="cpu",
    ).run(gru.params_from_jax(init, "cpu"))
    assert got.federation_ids.tolist() == ref.federation_ids.tolist()
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
        assert g.epsilon == r.epsilon
    assert got.summary()["epsilon"] == ref.summary()["epsilon"]
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= PARAMS_TOL


def test_dp_epsilon_is_non_decreasing_and_equals_the_reference_schedule():
    privacy = dp.DPConfig(clip_norm=1.0, noise_multiplier=1.1, delta=1e-4)
    result = run(privacy, rounds=3, selection="uniform:0.5")
    eps = [r.epsilon for r in result.history]
    assert all(b >= a for a, b in zip(eps, eps[1:])) and eps[0] > 0
    ref = jax_accountant.RdpAccountant(1.1, delta=1e-4)
    size = result.federation_ids.size
    for r, e in zip(result.history, eps):
        ref.step(len(r.participant_ids) / size)
        assert e == ref.epsilon()


def test_trainers_take_a_dp_config_or_a_dict():
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=1)
    loss_fn = gru.make_loss_fn(cfg)
    spec = {"clip_norm": 2.0, "noise_multiplier": 0.5}
    for trainer in (LocalTrainer(loss_fn, AdamW(), 8, 1, device="cpu", dp=spec),
                    CohortTrainer(loss_fn, AdamW(), 8, 1, device="cpu", dp=spec)):
        assert trainer.dp == dp.DPConfig(2.0, 0.5)
    with pytest.raises(ValueError, match="unknown"):
        CohortTrainer(loss_fn, AdamW(), 8, 1, device="cpu", dp={"clip": 1.0})
    # the mesh is ported: "auto" in one process is no mesh, and what is not
    # a mesh is refused
    assert CohortTrainer(loss_fn, AdamW(), 8, 1, device="cpu", dp=spec, mesh="auto").mesh is None
    with pytest.raises(TypeError, match="mesh"):
        CohortTrainer(loss_fn, AdamW(), 8, 1, device="cpu", mesh=object())
    # the tracer is ported: a DP trainer takes one beside its DP config
    traced = CohortTrainer(loss_fn, AdamW(), 8, 1, device="cpu", dp=spec, tracer=Tracer())
    assert traced.dp == dp.DPConfig(2.0, 0.5) and traced.tracer.enabled


# --------------------------------------------------------------------------
# the accountant
# --------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0.0, 0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 4.0])
def test_accountant_epsilons_equal_the_reference(q, sigma):
    for alpha in (2, 7, 64):
        assert accountant.rdp_subsampled_gaussian(q, sigma, alpha) == \
            jax_accountant.rdp_subsampled_gaussian(q, sigma, alpha)
    got = accountant.RdpAccountant(sigma, delta=1e-5)
    ref = jax_accountant.RdpAccountant(sigma, delta=1e-5)
    assert got.epsilon() == ref.epsilon() == 0.0
    for steps in (1, 3, 10):
        got.step(q, steps=steps)
        ref.step(q, steps=steps)
        assert got.epsilon() == ref.epsilon() and got.steps == ref.steps
    assert accountant.epsilon_after(15, q, sigma, steps_per_round=2) == \
        jax_accountant.epsilon_after(15, q, sigma, steps_per_round=2)


def test_accountant_rejects_what_the_reference_rejects():
    for bad in (dict(noise_multiplier=-1.0), dict(noise_multiplier=1.0, delta=0.0),
                dict(noise_multiplier=1.0, orders=())):
        for m in (accountant, jax_accountant):
            with pytest.raises(ValueError):
                m.RdpAccountant(**bad)
    for m in (accountant, jax_accountant):
        with pytest.raises(ValueError):
            m.rdp_subsampled_gaussian(1.5, 1.0, 2)
        with pytest.raises(ValueError):
            m.rdp_subsampled_gaussian(0.5, 1.0, 1)


def test_privacy_frontier_runs_on_the_cpu():
    from repro.experiments import paper as jax_paper
    from repro_torch.experiments import paper

    assert paper.ExperimentConfig().privacy is None
    assert {f.name for f in dataclasses.fields(jax_paper.ExperimentConfig)} - {
        f.name for f in dataclasses.fields(paper.ExperimentConfig)} == {"use_pallas"}
    exp = paper.ExperimentConfig(cohort_scale=0.005, rounds=1, local_epochs=1, batch_size=32,
                                 device="cpu")
    out = paper.run_privacy_frontier(
        exp, setting="federated-arc", noise_multipliers=(1.0,), attacks=("scaled-update",),
        attack_fractions=(0.2,), aggregators=("krum:1",), verbose=False)
    assert [u["privacy"] for u in out["utility"]] == [None, dp.DPConfig(1.0, 1.0).to_state()]
    assert out["utility"][0]["epsilon"] is None
    # every recruited client trains every round: q = 1
    assert out["utility"][1]["epsilon"] == jax_accountant.epsilon_after(1, 1.0, 1.0)
    assert [(r["aggregator"], r["attack"], r["engine"]) for r in out["robustness"]] == [
        ("krum:1", None, "sequential"), ("krum:1", "scaled-update", "sequential")]
    for row in out["utility"] + out["robustness"]:
        assert all(np.isfinite(v) for v in row["metrics"].values())
