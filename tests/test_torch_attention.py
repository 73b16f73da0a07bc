"""The port's attention, RoPE and MLPs (``repro_torch.models.attention``,
``repro_torch.models.layers``) against the JAX package's.

The same inputs, made with numpy from a seed, go through both; params are
drawn by JAX and carried across with ``params_from_jax``.  Tolerances:

* float32: 1e-5 times max(1, max|ref|);
* bfloat16 inputs: 3e-2 times max(1, max|ref|), as the two frameworks
  round bfloat16 elementwise results at different places.

``blockwise_attention`` is plain PyTorch (the reference has no kernel for
attention), so the CPU and the card run the same code.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import Activation, get_config  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.zoo import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 3e-2


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= tol * max(1.0, float(np.max(np.abs(want))))


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# name, S (== T), H, Hkv, causal, window, kv_chunk
ATTENTION_CASES = [
    ("causal-group1", 16, 4, 4, True, None, 1024),
    ("causal-group2", 16, 4, 2, True, None, 1024),
    ("noncausal-group2", 16, 4, 2, False, None, 1024),
    ("ragged-chunks-group2", 13, 4, 2, True, None, 4),      # 13 = 3 chunks of 4 + 1, padded
    ("noncausal-ragged-group1", 13, 2, 2, False, None, 5),
    ("window-group2", 19, 6, 3, True, 5, 4),                # chunk 0 fully masked for q >= 8
    ("window-fully-masked-chunk", 12, 2, 1, True, 3, 2),    # most chunks fully masked
]


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=[c[0] for c in ATTENTION_CASES])
def test_blockwise_attention_matches_jax(case):
    _, s, h, hkv, causal, window, kv_chunk = case
    rng = np.random.default_rng(s * 100 + h)
    q, k, v = normal(rng, 2, s, h, 8), normal(rng, 2, s, hkv, 8), normal(rng, 2, s, hkv, 6)
    want = jax_attention.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window, kv_chunk=kv_chunk)
    got = attention.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal, window=window,
                                        kv_chunk=kv_chunk)
    assert got.shape == (2, s, h, 6) and got.dtype == torch.float32
    close(got, want)


def test_a_fully_masked_chunk_contributes_nothing():
    """With a window of 2 and chunks of 2, query 9 sees keys 8 and 9 only:
    chunks 0 to 3 are fully masked for it and must add exactly 0 (not the
    exp(0) = 1 of NEG_INF - NEG_INF), so its output is the attention over
    its one live chunk alone."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(normal(rng, 1, 10, 2, 4)) for _ in range(3))
    out = attention.blockwise_attention(q, k, v, causal=True, window=2, kv_chunk=2)
    alone = attention.blockwise_attention(q[:, 8:], k[:, 8:], v[:, 8:], causal=True, kv_chunk=2)
    torch.testing.assert_close(out[:, 9], alone[:, 1], rtol=0, atol=1e-6)


def test_blockwise_attention_bf16_stays_near_jax():
    rng = np.random.default_rng(4)
    q, k, v = normal(rng, 2, 24, 4, 16), normal(rng, 2, 24, 2, 16), normal(rng, 2, 24, 2, 16)
    want = jax_attention.blockwise_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), kv_chunk=8)
    got = attention.blockwise_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), kv_chunk=8)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), tol=BF16_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(5)
    x = normal(rng, 2, 7, 3, 16)
    positions = np.arange(7)[None, :] + np.array([[0], [40]])
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    close(got, want)
    close(layers.rope_frequencies(16, theta), jax_layers.rope_frequencies(16, theta))


def test_apply_rope_keeps_bf16():
    rng = np.random.default_rng(6)
    x = normal(rng, 1, 5, 2, 8)
    positions = np.arange(5)[None, :]
    want = jax_layers.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(positions), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(positions),
                            10_000.0)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), tol=BF16_TOL)


@pytest.mark.parametrize("activation", list(Activation), ids=[a.value for a in Activation])
def test_mlp_apply_matches_jax(activation):
    from repro.configs.base import Activation as JaxActivation

    jact = JaxActivation(activation.value)
    jparams = jax.tree.map(np.asarray, jax_layers.mlp_init(jax.random.key(1), 32, 48, jact,
                                                           jnp.float32))
    x = normal(np.random.default_rng(7), 2, 5, 32)
    want = jax_layers.mlp_apply(jparams, jnp.asarray(x), jact)
    got = layers.mlp_apply(params_from_jax(jparams, "cpu"), torch.from_numpy(x), activation)
    close(got, want)
    ours = layers.mlp_init(torch.Generator().manual_seed(0), 32, 48, activation, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in jparams.items()}
    assert layers.mlp_param_count(32, 48, activation) == jax_layers.mlp_param_count(32, 48, jact)


def attention_config(arch: str, **changes):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return jcfg, tcfg


# name, arch, config changes
GQA_CASES = [
    ("qknorm-group1", "qwen3-1.7b", {}),
    ("qknorm-group2", "qwen3-1.7b", {"num_kv_heads": 2}),
    ("group2", "smollm-135m", {}),
    ("window-group2", "smollm-135m", {"sliding_window": 5}),
]


@pytest.mark.parametrize("case", GQA_CASES, ids=[c[0] for c in GQA_CASES])
def test_gqa_apply_matches_jax(case):
    _, arch, changes = case
    jcfg, tcfg = attention_config(arch, **changes)
    jparams = jax.tree.map(np.asarray, jax_attention.gqa_init(jax.random.key(2), jcfg, jnp.float32))
    x = normal(np.random.default_rng(8), 2, 11, tcfg.d_model)
    want = jax_attention.gqa_apply(jparams, jcfg, jnp.asarray(x), kv_chunk=4)
    got = attention.gqa_apply(params_from_jax(jparams, "cpu"), tcfg, torch.from_numpy(x), kv_chunk=4)
    close(got, want)
    ours = attention.gqa_init(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    assert {k: tuple(t.shape) for k, t in _flat(ours).items()} == \
        {k: tuple(a.shape) for k, a in _flat(jparams).items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {q: v for k in sorted(tree) for q, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("case", GQA_CASES, ids=[c[0] for c in GQA_CASES])
def test_gqa_decode_sequence_and_cache_match_jax(case):
    """Ten tokens through ``gqa_decode`` on both sides: each step's output
    and the cache after it.  With the window of 5 the ring buffer wraps
    twice; without one, ``max_len`` 12 leaves two slots empty (-1)."""
    _, arch, changes = case
    jcfg, tcfg = attention_config(arch, **changes)
    jparams = jax.tree.map(np.asarray, jax_attention.gqa_init(jax.random.key(3), jcfg, jnp.float32))
    params = params_from_jax(jparams, "cpu")
    xs = normal(np.random.default_rng(9), 2, 10, tcfg.d_model)
    jcache = jax_attention.gqa_cache_init(jcfg, 2, 12, jnp.float32)
    cache = attention.gqa_cache_init(tcfg, 2, 12, torch.float32, "cpu")
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in cache.items()} == \
        {k: (tuple(a.shape), str(a.dtype)) for k, a in jcache.items()}
    jdecode = jax.jit(jax_attention.gqa_decode, static_argnums=(1,))
    for t in range(10):
        want, jcache = jdecode(jparams, jcfg, jnp.asarray(xs[:, t:t + 1]), jcache, jnp.int32(t))
        given = {k: v.clone() for k, v in cache.items()}
        got, cache = attention.gqa_decode(params, tcfg, torch.from_numpy(xs[:, t:t + 1]), cache, t)
        assert all(torch.equal(given[k], v) for k, v in zip(sorted(given), tree_leaves(given)))
        close(got, want)
        for k in ("k", "v"):
            close(cache[k], jcache[k])
        assert np.array_equal(cache["slot_pos"].numpy(), np.asarray(jcache["slot_pos"]))
    if tcfg.sliding_window:
        assert cache["k"].shape[1] == 5
        assert sorted(cache["slot_pos"].tolist()) == [5, 6, 7, 8, 9]
    else:
        assert cache["slot_pos"].tolist() == [*range(10), -1, -1]


def test_gqa_decode_takes_a_tensor_position():
    jcfg, tcfg = attention_config("smollm-135m", sliding_window=3)
    params = attention.gqa_init(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    x = torch.from_numpy(normal(np.random.default_rng(10), 2, 1, tcfg.d_model))
    cache = attention.gqa_cache_init(tcfg, 2, 8, torch.float32, "cpu")
    a, ca = attention.gqa_decode(params, tcfg, x, cache, 4)
    b, cb = attention.gqa_decode(params, tcfg, x, cache, torch.tensor(4))
    assert torch.equal(a, b) and all(torch.equal(ca[k], cb[k]) for k in ca)
