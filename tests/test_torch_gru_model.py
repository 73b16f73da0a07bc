"""The port's GRU model (repro_torch.models.gru) against the JAX package.

Same params (carried across with ``params_from_jax``), same numpy inputs,
dropout 0: forward, masked MSLE and the loss gradients agree to 1e-5 in
float32 (gradients scaled by max(1, max|ref|), as sums over the batch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import gru as jax_gru  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
JCFG = jax_gru.GRUConfig(input_dim=5, hidden_dim=4, num_layers=2, dropout=0.0)
TCFG = gru.GRUConfig(input_dim=5, hidden_dim=4, num_layers=2, dropout=0.0)


def jax_params(seed=0):
    return jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(seed), JCFG))


def batch(b=6, t=7, f=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    y = rng.lognormal(1.0, 0.5, size=(b,)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0
    return x, y, mask


def close(got, ref, tol=TOL, scaled=False):
    got = got.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    bound = tol * max(1.0, float(np.max(np.abs(ref)))) if scaled else tol
    assert float(np.max(np.abs(got - ref))) <= bound


def test_params_round_trip_is_bitwise():
    ref = jax_params()
    back = gru.params_to_numpy(gru.params_from_jax(ref, "cpu"))
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert gru.count_params(gru.params_from_jax(ref, "cpu")) == jax_gru.count_params(ref)


def test_init_matches_layout_and_range():
    ref = jax_params()
    got = gru.init_gru(torch.Generator().manual_seed(0), TCFG, "cpu")
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(got)):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
        assert float(b.abs().max()) <= 1.0 / np.sqrt(TCFG.hidden_dim)
    again = gru.init_gru(torch.Generator().manual_seed(0), TCFG, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_matches_jax(use_pallas):
    # use_pallas=False is the JAX cell-by-cell scan path (gru_cell); the port
    # always runs gru_sequence.
    ref_params = jax_params(1)
    x, _, _ = batch(seed=1)
    cfg = jax_gru.GRUConfig(**{**JCFG.__dict__, "use_pallas": use_pallas})
    ref = jax_gru.gru_apply(ref_params, cfg, x)
    got = gru.gru_apply(gru.params_from_jax(ref_params, "cpu"), TCFG, torch.from_numpy(x))
    close(got, ref)


def test_cell_path_matches_sequence_path():
    params = gru.params_from_jax(jax_params(2), "cpu")
    x = torch.from_numpy(batch(seed=2)[0])
    layer = params["layers"][0]
    from repro_torch.kernels.gru_scan.ops import gru_sequence

    seq = gru_sequence(x, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"])
    close(gru._layer_scan(layer, x), seq.detach().numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_msle_matches_jax(masked):
    _, y, mask = batch(seed=3)
    y_hat = np.abs(np.random.default_rng(4).normal(size=y.shape)).astype(np.float32)
    m = mask if masked else None
    ref = jax_gru.msle_loss(y, y_hat, m)
    got = gru.msle_loss(
        torch.from_numpy(y), torch.from_numpy(y_hat), None if m is None else torch.from_numpy(m)
    )
    close(got, ref)


def test_loss_gradients_match_jax():
    ref_params = jax_params(5)
    x, y, mask = batch(seed=5)
    ref_loss, ref_grads = jax.value_and_grad(jax_gru.make_loss_fn(JCFG))(ref_params, (x, y, mask))
    params = gru.params_from_jax(ref_params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = gru.make_loss_fn(TCFG)(params, tuple(torch.from_numpy(a) for a in (x, y, mask)))
    grads = torch.autograd.grad(loss, leaves)
    close(loss, ref_loss)
    for g, r in zip(grads, jax.tree.leaves(ref_grads)):
        close(g, r, scaled=True)


def test_dropout_draws_from_the_generator():
    params = gru.params_from_jax(jax_params(6), "cpu")
    x = torch.from_numpy(batch(seed=6)[0])
    cfg = gru.GRUConfig(input_dim=5, hidden_dim=4, num_layers=2, dropout=0.5)

    def run(seed):
        return gru.gru_apply(params, cfg, x, train=True, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), gru.gru_apply(params, cfg, x))
    with pytest.raises(ValueError):
        gru.gru_apply(params, cfg, x, train=True)
