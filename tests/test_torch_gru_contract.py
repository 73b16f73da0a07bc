"""The GRU kernels' whole contract against the JAX package, on the CPU: any
hidden size, bfloat16 and float16, and more than 65,535 clients a chunk.

On the CPU the wrappers run their plain versions (``ref.py``); they are held
against the Pallas kernels in interpret mode and against ``gru_scan_op``
under ``jax.grad``, on the same numpy inputs from a seed.  The CUDA kernels
behind the same wrappers (the wide variants above N = 64, the bfloat16 and
float16 instantiations, clients in launches of at most 65,535) are held
against the plain versions on the card by ``tests/test_torch_cuda_kernels.py``
and phase 27 of ``chip_smoke.py``.

Tolerances: float32 1e-5, and dW_hh / db_hh 1e-5 times max(1, max|ref|)
(sums over B*T terms in another order); bfloat16 and float16 3e-2 of
max(1, max|ref|), the reference's own (``tests/test_kernels.py``).  One
federation round at hidden 72 against JAX's: round losses 1e-5, params 1e-4
(``tests/test_torch_federation.py`` says why).  A DP chunk of 65,664
per-example clients against the same clients in chunks of 64: losses 1e-5,
params 1e-4.
"""

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
from repro.kernels.gru_scan import kernel as jax_kernel  # noqa: E402
from repro.kernels.gru_scan.ops import gru_scan_op  # noqa: E402
from repro.kernels.gru_scan.ops import gru_sequence as jax_gru_sequence  # noqa: E402
from repro.kernels.gru_scan.ref import gru_scan_ref as jax_fwd_ref  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, ClientDataset  # noqa: E402
from repro_torch.data.pipeline import build_client_datasets  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ops import GRUScan, gru_sequence  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.privacy.dp import DPConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
LOW_TOL = 3e-2
PARAMS_TOL = 1e-4
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}


def inputs(b, t, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(*lead, b, t, 3 * n)).astype(np.float32)
    w = (rng.normal(size=(*lead, n, 3 * n)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(*lead, 3 * n)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(*lead, b, t, n)).astype(np.float32)
    return xg, w, bias, dy


def close(got, ref, tol=TOL, scaled=False):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    bound = tol * max(1.0, float(np.max(np.abs(ref)))) if scaled else tol
    assert float(np.max(np.abs(got - ref))) <= bound


@pytest.mark.parametrize("n", [65, 100, 128])
def test_wide_hidden_sizes_match_pallas(n):
    """Forward, residual backward and autograd above N = 64, where the card
    runs the wide kernels, against the Pallas kernels and ``jax.grad``."""
    xg, w, bias, dy = inputs(3, 5, n, seed=n)
    h = kernel.gru_scan(*map(torch.from_numpy, (xg, w, bias)))
    close(h, jax_kernel.gru_scan(xg, w, bias, interpret=True))
    h_np = h.numpy()
    got = kernel.gru_scan_bwd(*map(torch.from_numpy, (xg, w, bias, h_np, dy)))
    ref = jax_kernel.gru_scan_bwd(xg, w, bias, h_np, dy, interpret=True)
    close(got[0], ref[0])
    close(got[1], ref[1], scaled=True)
    close(got[2], ref[2], scaled=True)
    ref = jax.grad(lambda a, b_, c: jnp.sum(gru_scan_op(a, b_, c) * dy),
                   argnums=(0, 1, 2))(xg, w, bias)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xg, w, bias)]
    got = torch.autograd.grad((GRUScan.apply(*leaves) * torch.from_numpy(dy)).sum(), leaves)
    close(got[0], ref[0])
    close(got[1], ref[1], scaled=True)
    close(got[2], ref[2], scaled=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,t,n", [(3, 7, 16), (2, 13, 32)])
def test_low_precision_matches_jax(dtype, b, t, n):
    """bfloat16 and float16 activations and weights: the forward against the
    Pallas kernel, and every gradient of a loss through ``GRUScan`` against
    ``gru_scan_op`` under ``jax.grad``, each in the inputs' dtype."""
    tdt, jdt = DTYPES[dtype]
    xg, w, bias, _ = inputs(b, t, n, seed=7 + n)
    jargs = [jnp.asarray(a, jdt) for a in (xg, w, bias)]
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jargs]
    h = kernel.gru_scan(*targs)
    h_ref = jax_kernel.gru_scan(*jargs, interpret=True)
    assert h.dtype == tdt and h_ref.dtype == jdt
    close(h, h_ref, tol=LOW_TOL, scaled=True)

    def loss(fn):
        return lambda x, w_, b_: jnp.sum(fn(x, w_, b_).astype(jnp.float32) ** 2)

    ref = jax.grad(loss(gru_scan_op), argnums=(0, 1, 2))(*jargs)
    leaves = [a.clone().requires_grad_(True) for a in targs]
    got = torch.autograd.grad((GRUScan.apply(*leaves).float() ** 2).sum(), leaves)
    for g, r, a in zip(got, ref, targs):
        assert g.dtype == a.dtype == tdt and r.dtype == jdt
        close(g, np.asarray(r.astype(jnp.float32)), tol=LOW_TOL, scaled=True)
    # The residual backward alone, on the same h_seq.
    dy = jnp.asarray(np.random.default_rng(n).normal(size=h_ref.shape), jdt)
    h_j = jnp.asarray(h.float().numpy(), jdt)
    ref = jax_kernel.gru_scan_bwd(*jargs, h_j, dy, interpret=True)
    dy_t = torch.from_numpy(np.array(dy.astype(jnp.float32))).to(tdt)
    got = kernel.gru_scan_bwd(*targs, h, dy_t)
    for g, r in zip(got, ref):
        assert g.dtype == tdt
        close(g, np.asarray(r.astype(jnp.float32)), tol=LOW_TOL, scaled=True)


def test_gru_sequence_with_a_client_axis_at_hidden_96():
    """A client axis at N = 96 through ``gru_sequence`` (one batched input
    product, one recurrence call) against JAX's ``gru_sequence`` and its
    gradients, client by client."""
    rng = np.random.default_rng(11)
    c, b, t, f, n = 2, 3, 4, 5, 96
    x = rng.normal(size=(c, b, t, f)).astype(np.float32)
    w_ih = (rng.normal(size=(c, f, 3 * n)) * 0.3).astype(np.float32)
    b_ih = (rng.normal(size=(c, 3 * n)) * 0.1).astype(np.float32)
    _, w_hh, b_hh, cot = inputs(b, t, n, seed=12, lead=(c,))
    args = (x, w_ih, w_hh, b_ih, b_hh)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h = gru_sequence(*leaves)
    assert h.shape == (c, b, t, n)
    got = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), leaves)
    for i in range(c):
        one = tuple(a[i] for a in args)
        close(h[i], jax_gru_sequence(*one))
        close(h[i], jax_fwd_ref(one[0] @ one[1] + one[3], one[2], one[4]))
        ref = jax.grad(lambda *a: jnp.sum(jax_gru_sequence(*a) * cot[i]),
                       argnums=(0, 1, 2, 3, 4))(*one)
        for g, r in zip(got, ref):
            close(g[i], r, scaled=True)


def test_federation_round_at_hidden_72_matches_jax():
    """One federated round of a 2-layer GRU at hidden 72 (the wide kernels'
    path on the card): the port's default engine and staging against JAX's
    sequential engine, from the same params."""
    cohort = dict(num_hospitals=6, total_stays=120, min_hospital_size=10)
    jcfg = jax_gru.GRUConfig(hidden_dim=72, num_layers=2, dropout=0.0)
    tcfg = gru.GRUConfig(hidden_dim=72, num_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    base = dict(rounds=1, local_epochs=1, batch_size=16, seed=1)
    ref = JaxFederation(
        JaxFederationConfig(engine="sequential", **base),
        jax_clients(jax_generate(JaxCohortConfig(**cohort), seed=3)),
        jax_gru.make_loss_fn(jcfg), JaxAdamW(),
    ).run(init)
    got = Federation(
        FederationConfig(**base), build_client_datasets(generate_cohort(CohortConfig(**cohort), 3)),
        gru.make_loss_fn(tcfg), AdamW(), device="cpu",
    ).run(gru.params_from_jax(init, "cpu"))
    assert got.federation_ids.tolist() == ref.federation_ids.tolist()
    (g,), (r,) = got.history, ref.history
    assert g.participant_ids == r.participant_ids and g.local_steps == r.local_steps
    assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
    for a, b_ in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert a.shape == b_.shape
        assert float(np.max(np.abs(a.detach().numpy() - np.asarray(b_)))) <= PARAMS_TOL


def test_dp_round_above_65535_per_example_clients_matches_smaller_chunks():
    """A DP round through ``Federation`` whose one chunk holds 513 clients at
    batch 128 (65,664 per-example clients on the kernels' client axis, more
    than the card's grid y) against the same round in chunks of 64."""
    cfg = gru.GRUConfig(input_dim=3, hidden_dim=4, num_layers=1, dropout=0.0)
    rng = np.random.default_rng(5)
    clients = [ClientDataset(i, ds, ds) for i, ds in enumerate(
        ArrayDataset(rng.normal(size=(2, 5, 3)).astype(np.float32),
                     rng.uniform(0.5, 2.0, size=2).astype(np.float32))
        for _ in range(513))]
    init = gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    runs = []
    for chunk in (None, 64):
        fed = Federation(
            FederationConfig(rounds=1, local_epochs=1, batch_size=128, seed=2, cohort_chunk=chunk,
                             privacy=DPConfig(clip_norm=1.0, noise_multiplier=0.5)),
            clients, gru.make_loss_fn(cfg), AdamW(), device="cpu")
        runs.append((fed.run(init), fed.cohort_trainer.last_round_stats))
    (whole, stats), (chunked, _) = runs
    assert stats["per_example_clients"] == 513 * 128 > 65535
    assert abs(whole.history[0].mean_local_loss - chunked.history[0].mean_local_loss) <= TOL
    moved = 0.0
    for a, b_, p0 in zip(tree_leaves(whole.params), tree_leaves(chunked.params),
                         tree_leaves(init)):
        assert float((a - b_).abs().max()) <= PARAMS_TOL
        moved = max(moved, float((a - p0).abs().max()))
    assert moved > 0.0
