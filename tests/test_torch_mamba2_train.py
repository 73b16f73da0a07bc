"""The port's Mamba2 training path (``Model.loss``, ``make_train_step``,
``launch/train.py``) against the JAX package's zoo.

The reduced ``mamba2-130m`` config in float32 on both sides; JAX
``Model(cfg).init`` params carried across with ``params_from_jax``; the same
numpy tokens.  ``loss_chunk`` is smaller than S and does not divide it, so
the CE's padding and masking run.  On the CPU the SSD scan and its backward
are the plain versions (``SSDChunkScan``); the card's kernels are held
against them in tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: loss and every gradient leaf 1e-5 times max(1, max|ref|);
params after one AdamW step 1e-4 wherever the reference gradient is at
least 1e-6.  Below that, AdamW's first step lr * g / (|g| + eps) turns a
rounding difference of a few 1e-9 (another summation order) into a visible
fraction of lr, the drift tests/test_torch_federation.py documents: on this
batch 1,052 of 949,408 entries have |g| < 1e-6, and one in_proj entry with
g = 3.1e-9 in JAX and -3.5e-11 here moves 2.3e-4 apart.  Those entries are
held to 2 lr + 1e-4, the swing of a sign flip.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import lm_token_batch as jax_lm_token_batch  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import lm_token_batch  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
STEP_TOL = 1e-4
ARCH = "mamba2-130m"
B, S = 2, 37        # S ragged against the reduced SSD chunk of 16
LOSS_CHUNK = 16     # < S and not dividing it: the last CE chunk is padded with -1 labels


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    assert jcfg.dtype == tcfg.dtype == "float32"
    jparams = jax.tree.map(np.asarray, jax_zoo.Model(jcfg).init(jax.random.key(0)))
    batch = lm_token_batch(np.random.default_rng(1), B, S, tcfg.vocab_size)
    return jcfg, tcfg, jparams, batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def params(jparams):
    return zoo.params_from_jax(jparams, "cpu")


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= tol * max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_matches_jax(setup, use_pallas):
    jcfg, tcfg, jparams, batch = setup
    jmodel = jax_zoo.Model(jcfg, use_pallas=use_pallas, remat=False, loss_chunk=LOSS_CHUNK)
    want, want_m = jmodel.loss(jparams, batch)
    got, got_m = zoo.Model(tcfg, remat=False, loss_chunk=LOSS_CHUNK).loss(
        params(jparams), torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == ()
    close(got, want)
    assert set(got_m) == set(want_m) == {"ce", "router_aux", "loss"}
    for k in got_m:
        close(got_m[k], want_m[k])


def test_masked_labels_are_not_scored(setup):
    """-1 labels are the CE's padding: scoring fewer labels changes the mean."""
    _, tcfg, jparams, batch = setup
    model = zoo.Model(tcfg, remat=False, loss_chunk=LOSS_CHUNK)
    p = params(jparams)
    full, _ = model.loss(p, torch_batch(batch))
    masked = dict(batch, labels=batch["labels"].copy())
    masked["labels"][:, S // 2:] = -1
    half, _ = model.loss(p, torch_batch(masked))
    short = {k: v[:, : S // 2] for k, v in batch.items()}
    want, _ = model.loss(p, torch_batch(short))
    assert float(half) != float(full)
    close(half, want.numpy())


def test_every_gradient_leaf_matches_jax_grad(setup):
    jcfg, tcfg, jparams, batch = setup
    jmodel = jax_zoo.Model(jcfg, remat=False, loss_chunk=LOSS_CHUNK)
    want = jax.grad(lambda p: jmodel.loss(p, batch)[0])(jparams)
    p = params(jparams)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = zoo.Model(tcfg, remat=False, loss_chunk=LOSS_CHUNK).loss(p, torch_batch(batch))
    got = torch.autograd.grad(loss, leaves)
    want_leaves = jax.tree.leaves(want)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        close(g, w)


def test_train_step_matches_jax(setup):
    jcfg, tcfg, jparams, batch = setup
    jmodel = jax_zoo.Model(jcfg, remat=False, loss_chunk=LOSS_CHUNK)
    jopt = JaxAdamW(learning_rate=1e-3)
    want_params, _, want_m = jax.jit(jax_steps.make_train_step(jmodel, jopt))(
        jparams, jopt.init(jparams), batch)
    model = zoo.Model(tcfg, remat=False, loss_chunk=LOSS_CHUNK)
    opt = AdamW(learning_rate=1e-3)
    p = params(jparams)
    got_params, opt_state, got_m = steps.make_train_step(model, opt)(p, opt.init(p), torch_batch(batch))
    assert opt_state.step == 1
    assert all(not leaf.requires_grad for leaf in tree_leaves(got_params))
    close(got_m["loss"], want_m["loss"])
    grads = jax.grad(lambda p_: jmodel.loss(p_, batch)[0])(jparams)
    for g, w, dg in zip(tree_leaves(got_params), jax.tree.leaves(want_params),
                        jax.tree.leaves(grads)):
        gap = np.abs(g.numpy() - np.asarray(w))
        settled = np.abs(np.asarray(dg)) >= 1e-6
        assert np.all(np.isfinite(gap))
        assert float(gap[settled].max(initial=0.0)) <= STEP_TOL
        assert float(gap.max()) <= 2 * opt.learning_rate + STEP_TOL


def test_remat_gives_the_same_loss_and_gradients(setup):
    _, tcfg, jparams, batch = setup
    out = {}
    for remat in (False, True):
        p = params(jparams)
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = zoo.Model(tcfg, remat=remat, loss_chunk=LOSS_CHUNK).loss(p, torch_batch(batch))
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    close(out[True][0], out[False][0].detach().numpy())
    for g, w in zip(out[True][1], out[False][1]):
        close(g, w.numpy())


def test_loss_decreases_over_steps():
    """Five steps on a FIXED batch must reduce the loss (learnability), as
    tests/test_archs_smoke.py::test_loss_decreases_over_steps holds JAX's."""
    cfg = get_config(ARCH).reduced()
    model = zoo.Model(cfg, remat=False)
    optimizer = AdamW(learning_rate=3e-3)
    p = model.init(torch.Generator().manual_seed(2), "cpu")
    opt_state = optimizer.init(p)
    step = steps.make_train_step(model, optimizer)
    batch = torch_batch(lm_token_batch(np.random.default_rng(2), B, 16, cfg.vocab_size))
    losses = []
    for _ in range(5):
        p, opt_state, metrics = step(p, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_lm_token_batch_matches_jax_byte_for_byte():
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for shape in ((2, 37, 512), (4, 64, 50_280)):
        got, want = lm_token_batch(rng_t, *shape), jax_lm_token_batch(rng_j, *shape)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes()


def test_loss_refuses_the_router_and_mtp_losses(setup):
    _, tcfg, jparams, batch = setup
    model = zoo.Model(dataclasses.replace(tcfg, mtp=True), remat=False)
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        model.loss(params(jparams), torch_batch(batch))


def test_train_cli_runs_lm_mode_on_the_cpu(capsys):
    train.main(["--mode", "lm", "--arch", ARCH, "--steps", "2", "--device", "cpu",
                "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(lines) == 2 and lines[0].startswith("step 0: loss=")
    assert all(np.isfinite(float(line.split("loss=")[1])) for line in lines)
    assert "lm smoke training done" in out
