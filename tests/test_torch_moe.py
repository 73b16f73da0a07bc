"""The port's MoE feed-forward (``repro_torch.models.moe``) and ``moe_layout``
against the JAX package's.

The reduced ``deepseek-v3-671b`` (4 experts, top-2, one shared expert) and
``llama4-scout-17b-a16e`` (4 experts, top-1, one shared expert) configs in
float32; JAX ``moe_init`` params carried across with ``params_from_jax``;
the same numpy inputs.  B x S = 2 x 16 tokens, so ``ep_local`` dispatches
in 16 groups of 2 tokens, each with its own capacity.  Each case first
asserts that the routed expert ids equal JAX's ``top_k`` (a near tie of two
router probabilities would show here as what it is), then compares the
output, the aux loss and the gradients of every param leaf and of x, each
within 1e-5 times max(1, max|ref|).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.models.transformer import moe_layout  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
B, S = 2, 16
ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e")
APPLY = {"global": (moe.moe_apply_global, jax_moe.moe_apply_global),
         "local": (moe.moe_apply_local, jax_moe.moe_apply_local)}


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= tol * max(1.0, float(np.max(np.abs(want))))


def configs(arch: str, **moe_changes):
    out = []
    for cfg in (jax_get_config(arch).reduced(), get_config(arch).reduced()):
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes)))
    return out


def setup(arch: str, seed: int, **moe_changes):
    jcfg, tcfg = configs(arch, **moe_changes)
    jparams = jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.key(seed), jcfg, jnp.float32))
    x = np.random.default_rng(seed).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    r = np.random.default_rng(seed + 100).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, x, r


def jax_ids(jparams, jcfg, x, groups):
    """The expert ids JAX's ``top_k`` routes each token to, (G, T/G, k)."""
    flat = jnp.asarray(x).reshape(groups, -1, x.shape[-1])
    probs = jax.nn.softmax(flat @ jparams["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.moe.top_k)[1])


def groups_of(mode: str) -> int:
    return 16 if mode == "local" else 1


@pytest.mark.parametrize("capacity", [None, 0.5], ids=["published", "capacity0.5"])
@pytest.mark.parametrize("mode", list(APPLY))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, mode, capacity):
    """Routing ids, output, aux and every gradient; at capacity 0.5 pairs
    drop in the global dispatch (checked), so who is dropped must be JAX's
    too.  (``ep_local``'s groups of 2 tokens keep the capacity floor of
    top_k, which deepseek's 2 distinct experts a token never exceed.)"""
    changes = {} if capacity is None else {"capacity_factor": capacity}
    jcfg, tcfg, jparams, x, r = setup(arch, 1, **changes)
    ours, theirs = APPLY[mode]
    g = groups_of(mode)

    def jloss(p, xx):
        out, aux = theirs(p, jcfg, xx)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (want, want_aux)), (jg_p, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))

    params = params_from_jax(jparams, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    _, _, ids, _ = moe.route(params, tcfg, xt, g)
    assert np.array_equal(ids.numpy(), jax_ids(jparams, jcfg, x, g))
    out, aux = ours(params, tcfg, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum() + aux, [*leaves, xt])
    close(out, want)
    close(aux, want_aux)
    assert aux.dtype == torch.float32
    jleaves = jax.tree.leaves(jg_p)
    assert len(grads) == len(jleaves) + 1
    for got, ref in zip(grads, [*jleaves, jg_x]):
        close(got, ref)
    if capacity is not None and mode == "global":
        dest = moe._dispatch(tcfg, ids, moe._capacity(B * S // g, tcfg.moe))
        assert bool((dest == tcfg.moe.num_experts * moe._capacity(B * S // g, tcfg.moe)).any())


@pytest.mark.parametrize("mode", list(APPLY))
def test_capacity_001_gives_dropped_tokens_the_shared_expert_alone(mode):
    """At capacity 0.01 the capacity floor is top_k (2 pairs an expert a
    group); a token whose every pair is dropped gets exactly the shared
    expert's output (no NaN from the drop row), and the whole output still
    matches JAX's."""
    jcfg, tcfg, jparams, x, _ = setup("deepseek-v3-671b", 2, capacity_factor=0.01,
                                      expert_sharding="ep_local" if mode == "local" else "ep")
    ours, theirs = APPLY[mode]
    params = params_from_jax(jparams, "cpu")
    xt = torch.from_numpy(x)
    out, _ = ours(params, tcfg, xt)
    want, _ = theirs(jparams, jcfg, jnp.asarray(x))
    close(out, want)
    g = groups_of(mode)
    cap = moe._capacity(B * S // g, tcfg.moe)
    assert cap == tcfg.moe.top_k
    _, _, ids, _ = moe.route(params, tcfg, xt, g)
    dropped = moe._dispatch(tcfg, ids, cap) == tcfg.moe.num_experts * cap    # (G, T/G * k)
    all_dropped = dropped.reshape(B * S, tcfg.moe.top_k).all(dim=1)
    if mode == "global":
        assert int(all_dropped.sum()) >= B * S - tcfg.moe.num_experts * cap
    shared = mlp_apply(params["shared"], xt, tcfg.activation).reshape(B * S, -1)
    flat = out.reshape(B * S, -1)
    assert torch.equal(flat[all_dropped], shared[all_dropped])
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_local_matches_global_at_generous_capacity(arch):
    """As tests/test_moe_modes.py holds JAX's: with no drops, the grouped
    dispatch is the global one."""
    _, tcfg, jparams, x, _ = setup(arch, 3, capacity_factor=8.0)
    params = params_from_jax(jparams, "cpu")
    a, aux_a = moe.moe_apply_global(params, tcfg, torch.from_numpy(x))
    b, aux_b = moe.moe_apply_local(params, tcfg, torch.from_numpy(x))
    torch.testing.assert_close(b, a, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(aux_b, aux_a)


def test_moe_apply_routes_by_expert_sharding():
    """``ep`` and ``tp`` take the global path, ``ep_local`` the grouped one;
    fewer than 16 tokens (or a count 16 does not divide) make one group."""
    _, tcfg, jparams, x, _ = setup("deepseek-v3-671b", 4, capacity_factor=0.5)
    params = params_from_jax(jparams, "cpu")
    xt = torch.from_numpy(x)
    glob = moe.moe_apply_global(params, tcfg, xt)[0]
    loc = moe.moe_apply_local(params, tcfg, xt)[0]
    assert not torch.equal(glob, loc)             # the capacities differ: drops differ
    for mode, want in (("ep", glob), ("tp", glob), ("ep_local", loc)):
        cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, expert_sharding=mode))
        assert torch.equal(moe.moe_apply(params, cfg, xt)[0], want)
    odd = xt[:, :7]                                # 14 tokens: one group
    assert torch.equal(moe.moe_apply_local(params, tcfg, odd)[0],
                       moe.moe_apply_global(params, tcfg, odd)[0])


def test_repeated_forward_gives_the_same_bits():
    _, tcfg, jparams, x, _ = setup("deepseek-v3-671b", 5)
    params = params_from_jax(jparams, "cpu")
    xt = torch.from_numpy(x)
    a, b = (moe.moe_apply_global(params, tcfg, xt)[0] for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_matches_jax_shapes_and_dtypes(arch):
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in configs(arch))
    jparams = jax_moe.moe_init(jax.random.key(0), jcfg, jnp.bfloat16)
    ours = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    flat = lambda tree: {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype).split(".")[-1])
                         for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(ours) == flat(jparams)
    assert ours["router"].dtype == torch.float32          # the router stays float32


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_count_matches_jax(arch, active_only):
    for full in (False, True):
        jcfg, tcfg = (jax_get_config(arch), get_config(arch)) if full else configs(arch)
        assert moe.moe_param_count(tcfg, active_only) == jax_moe.moe_param_count(jcfg, active_only)
    _, tcfg = configs(arch)
    ours = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    if not active_only:
        assert moe.moe_param_count(tcfg) == sum(t.numel() for t in tree_leaves(ours))


@pytest.mark.parametrize("arch, changes, want", [
    ("deepseek-v3-671b", {}, (3, 58, 0)),
    ("deepseek-v3-671b", {"num_layers": 2}, (1, 1, 0)),            # the reduced layout
    ("llama4-scout-17b-a16e", {}, (0, 48, 0)),
    ("llama4-scout-17b-a16e", {"num_layers": 5, "moe_every": 2}, (0, 2, 3)),
    ("llama4-scout-17b-a16e", {"num_layers": 6, "moe_every": 2, "first_dense": 1}, (1, 2, 3)),
    ("llama4-scout-17b-a16e", {"num_layers": 7, "moe_every": 3}, (0, 2, 5)),
])
def test_moe_layout_matches_jax(arch, changes, want):
    layers = {k: v for k, v in changes.items() if k == "num_layers"}
    moe_changes = {k: v for k, v in changes.items() if k != "num_layers"}
    cfgs = [dataclasses.replace(c, **layers, moe=dataclasses.replace(c.moe, **moe_changes))
            for c in (jax_get_config(arch), get_config(arch))]
    if changes.get("num_layers") == 2:
        cfgs = [c.reduced() for c in cfgs]
    assert moe_layout(cfgs[1]) == jax_transformer.moe_layout(cfgs[0]) == want
