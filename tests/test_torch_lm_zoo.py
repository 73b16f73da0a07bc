"""The port's LM zoo for every family against the JAX package's: ``Model``
(forward, loss with the router aux and MTP terms, every gradient leaf,
decode and its cache, the VLM's patch prefill, the encoder-decoder's
``encode_for_decode``), the prefill and serve steps, the configs,
``count_params_config`` and ``launch/train.py --mode lm`` and
``launch/serve.py``.

Each config's ``.reduced()`` in float32 on both sides, plus variants that
the reduced configs do not reach on their own: qwen3 with GQA group 2 (its
reduced config has group 1; smollm's has group 2 without qk-norm), smollm
with a sliding window of 5 (the ring buffer wraps), zamba2 with 5 layers
(2 groups of 1 Mamba layer and 1 tail layer; its reduced config has 2
layers and no tail), llama4 with ``moe_every=2`` and 5 layers (2 pairs of
a dense and a MoE layer, and a dense tail layer), deepseek with
``expert_sharding="ep_local"`` on 2 x 16 tokens (16 dispatch groups), and
deepseek at capacity 0.5 (pairs drop).  JAX ``Model(cfg).init`` params are
carried across with ``params_from_jax``; the same numpy tokens (and
patches, or frame embeddings) go through both.  Tolerances:

* float32: 1e-5 times max(1, max|ref|) (logits, loss, ``router_aux``,
  ``mtp_ce``, every gradient leaf, decode logits and cache, prefill and
  serve steps);
* the port's own decode against its own forward: the reference's 2e-4 /
  1e-4 (tests/test_decode.py), the MoE families at capacity 8.0 as there
  (at the published capacity a decode step of B tokens drops pairs that
  the forward keeps);
* bfloat16 params: 3e-2 times max(1, max|ref|) of JAX's forward.

On the CPU the hybrid's SSD scan runs its plain version; the card's SSD
kernels are held against it in chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import lm_token_batch as jax_lm_token_batch  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch.configs import ARCH_IDS, UNPORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.transformer import hybrid_layout  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
DECODE_ATOL, DECODE_RTOL = 2e-4, 1e-4
BF16_TOL = 3e-2
B, S = 2, 11
LOSS_CHUNK = 4      # < S and not dividing it: the last CE chunk is padded with -1 labels
ENC_FRAMES = 9      # the encoder-decoder's source frames

FAMILIES = ("smollm-135m", "qwen3-1.7b", "yi-9b", "nemotron-4-15b", "internvl2-26b", "zamba2-7b",
            "deepseek-v3-671b", "llama4-scout-17b-a16e", "seamless-m4t-large-v2")
NEW_FAMILIES = ("deepseek-v3-671b", "llama4-scout-17b-a16e", "seamless-m4t-large-v2")
# name -> (arch, changes to its reduced config, changes to its MoE config, S)
VARIANTS = {
    **{arch: (arch, {}, {}, S) for arch in FAMILIES},
    "qwen3-group2": ("qwen3-1.7b", {"num_kv_heads": 2}, {}, S),
    "smollm-window5": ("smollm-135m", {"sliding_window": 5}, {}, S),
    "zamba2-5layers": ("zamba2-7b", {"num_layers": 5}, {}, S),
    "llama4-moe-every2": ("llama4-scout-17b-a16e", {"num_layers": 5}, {"moe_every": 2}, S),
    "deepseek-ep-local": ("deepseek-v3-671b", {}, {"expert_sharding": "ep_local"}, 16),
    "deepseek-capacity0.5": ("deepseek-v3-671b", {}, {"capacity_factor": 0.5}, S),
}


def configs(name: str, **more):
    arch, changes, moe_changes, _ = VARIANTS[name]
    changes = {**changes, **more}
    out = []
    for cfg in (jax_get_config(arch).reduced(), get_config(arch).reduced()):
        if moe_changes:
            changes["moe"] = dataclasses.replace(cfg.moe, **moe_changes)
        out.append(dataclasses.replace(cfg, **changes))
    return tuple(out)


def generous(cfg):
    """``cfg`` at capacity 8.0 when it has experts (no pair drops at decode)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def make_batch(cfg, seed: int, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    batch = jax_lm_token_batch(rng, B, s, cfg.vocab_size)
    batch["labels"][0, -3:] = -1  # a few masked labels
    if cfg.arch_type.value == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type.value == "encdec":
        batch["src_embeds"] = rng.normal(size=(B, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= tol * max(1.0, float(np.max(np.abs(want))))


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    """(name, JAX config, port config, JAX model, JAX params, S)."""
    jcfg, tcfg = configs(request.param)
    jmodel = jax_zoo.Model(jcfg, remat=False, loss_chunk=LOSS_CHUNK)
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    return request.param, jcfg, tcfg, jmodel, jparams, VARIANTS[request.param][3]


def torch_model(tcfg, remat=False):
    return zoo.Model(tcfg, remat=remat, loss_chunk=LOSS_CHUNK)


def test_params_carry_across_key_for_key(case):
    _, jcfg, tcfg, _, jparams, _ = case
    ours = torch_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(a.shape)
                         for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(ours) == flat(jparams)
    params = zoo.params_from_jax(jparams, "cpu")
    assert all(np.array_equal(t.numpy(), a) for t, a in
               zip(tree_leaves(params), jax.tree.leaves(jparams)))
    assert zoo.count_params_config(tcfg) == sum(t.numel() for t in tree_leaves(params)) \
        == jax_zoo.count_params_config(jcfg)


def test_forward_logits_match_jax(case):
    _, jcfg, tcfg, jmodel, jparams, s = case
    batch = make_batch(tcfg, seed=1, s=s)
    want = jax.jit(jmodel.forward_logits)(jparams, as_jax(batch))
    got = torch_model(tcfg).forward_logits(zoo.params_from_jax(jparams, "cpu"), as_torch(batch))
    assert got.shape == (B, s, tcfg.vocab_size) and got.dtype == torch.float32
    close(got, want)


def test_loss_and_every_gradient_leaf_match_jax(case):
    """The total loss and each of its terms: ``ce``, ``router_aux`` (0
    without experts) and DeepSeek's ``mtp_ce``."""
    _, jcfg, tcfg, jmodel, jparams, s = case
    batch = make_batch(tcfg, seed=2, s=s)
    (want, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, as_jax(batch))
    params = zoo.params_from_jax(jparams, "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = torch_model(tcfg).loss(params, as_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    close(loss, want)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        close(metrics[k], jmetrics[k])
    assert ("mtp_ce" in metrics) == tcfg.mtp
    assert (float(metrics["router_aux"].detach()) == 0.0) == (tcfg.moe is None)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, r in zip(grads, jleaves):
        close(g, r)


def test_remat_gives_the_same_loss_and_gradients(case):
    _, _, tcfg, _, jparams, s = case
    batch = as_torch(make_batch(tcfg, seed=3, s=s))
    out = []
    for remat in (False, True):
        params = zoo.params_from_jax(jparams, "cpu")
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = torch_model(tcfg, remat=remat).loss(params, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    close(l1, l0.detach().numpy())
    for a, b in zip(g1, g0):
        close(a, b.numpy())


def decode_all(decode, params, toks, cache, start):
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = decode(params, toks[:, t:t + 1], cache, start + t)
        outs.append(lg)
    return outs, cache


def prefill_patches_jax(jmodel, jparams, patches, cache):
    step = jax.jit(lambda p, e, c, pos: jmodel.decode_step(p, None, c, pos, token_embeds=e))
    for i in range(patches.shape[1]):
        _, cache = step(jparams, jnp.asarray(patches[:, i:i + 1]), cache, jnp.int32(i))
    return cache


def prefill_patches(model, params, patches, cache):
    for i in range(patches.shape[1]):
        _, cache = model.decode_step(params, None, cache, i,
                                     token_embeds=torch.from_numpy(patches[:, i:i + 1]))
    return cache


def test_decode_sequence_and_cache_match_jax(case):
    """The encoder-decoder's frames through ``encode_for_decode``, or the
    VLM's patches (through ``token_embeds``), first; then every token
    through ``decode_step`` on both sides: each step's logits and the whole
    cache after the last, leaf for leaf (the latent cache under MLA)."""
    _, jcfg, tcfg, jmodel, jparams, s = case
    batch = make_batch(tcfg, seed=4, s=s)
    toks = batch["tokens"]
    n_patch = tcfg.num_frontend_tokens if "patch_embeds" in batch else 0
    max_len = s + n_patch
    model, params = torch_model(tcfg), zoo.params_from_jax(jparams, "cpu")
    jcache, cache = jmodel.init_cache(B, max_len), model.init_cache(B, max_len, "cpu")
    if "src_embeds" in batch:
        src = batch["src_embeds"]
        jcache = jax.jit(jmodel.encode_for_decode)(jparams, jnp.asarray(src), jcache)
        cache = model.encode_for_decode(params, torch.from_numpy(batch["src_embeds"]), cache)
        assert cache["blocks"]["cross_k"].shape[2] == ENC_FRAMES != model.encoder_frames(max_len)
    if n_patch:
        jcache = prefill_patches_jax(jmodel, jparams, batch["patch_embeds"], jcache)
        cache = prefill_patches(model, params, batch["patch_embeds"], cache)
    jstep = jax.jit(jmodel.decode_step)
    want, jcache = decode_all(lambda p, t, c, pos: jstep(p, t, c, jnp.int32(pos)), jparams,
                              jnp.asarray(toks), jcache, n_patch)
    got, cache = decode_all(model.decode_step, params, torch.from_numpy(toks), cache, n_patch)
    for g, w in zip(got, want):
        assert g.shape == (B, tcfg.vocab_size) and g.dtype == torch.float32
        close(g, w)
    flat = lambda tree: [jax.tree_util.keystr(p) for p, _ in
                         jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert flat(cache) == flat(jcache)
    for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.int32:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            close(g, w)


def test_own_decode_matches_own_forward(case):
    """The port's decode path (patches, or the encoder's frames, included)
    against its own forward, at the reference's decode tolerance; the MoE
    families at capacity 8.0."""
    _, _, tcfg, _, jparams, s = case
    tcfg = generous(tcfg)
    batch = make_batch(tcfg, seed=5, s=s)
    model, params = torch_model(tcfg), zoo.params_from_jax(jparams, "cpu")
    full = model.forward_logits(params, as_torch(batch))
    n_patch = tcfg.num_frontend_tokens if "patch_embeds" in batch else 0
    cache = model.init_cache(B, s + n_patch, "cpu")
    if "src_embeds" in batch:
        cache = model.encode_for_decode(params, torch.from_numpy(batch["src_embeds"]), cache)
    if n_patch:
        cache = prefill_patches(model, params, batch["patch_embeds"], cache)
    got, _ = decode_all(model.decode_step, params, torch.from_numpy(batch["tokens"]), cache, n_patch)
    torch.testing.assert_close(torch.stack(got, dim=1), full, atol=DECODE_ATOL, rtol=DECODE_RTOL)


def test_prefill_and_serve_steps_match_jax(case):
    _, jcfg, tcfg, jmodel, jparams, s = case
    batch = make_batch(tcfg, seed=6, s=s)
    model, params = torch_model(tcfg), zoo.params_from_jax(jparams, "cpu")
    want = jax.jit(jax_steps.make_prefill_step(jmodel))(jparams, as_jax(batch))
    got = steps.make_prefill_step(model)(params, as_torch(batch))
    assert got.shape == (B, tcfg.vocab_size) and got.dtype == torch.float32
    close(got, want)
    tok = batch["tokens"][:, :1]
    want, jcache = jax.jit(jax_steps.make_serve_step(jmodel))(
        jparams, jnp.asarray(tok), jmodel.init_cache(B, 4), jnp.int32(0))
    got, cache = steps.make_serve_step(model)(params, torch.from_numpy(tok),
                                              model.init_cache(B, 4, "cpu"), 0)
    close(got, want)
    assert len(tree_leaves(cache)) == len(jax.tree.leaves(jcache))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-26b", "zamba2-7b"])
def test_bf16_forward_stays_near_jax(arch):
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in configs(arch))
    jmodel = jax_zoo.Model(jcfg, remat=False)
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(7)))
    params = zoo.params_from_jax(jparams, "cpu")
    assert all(t.dtype == torch.bfloat16 or t.dtype == torch.float32 for t in tree_leaves(params))
    batch = make_batch(tcfg, seed=7)
    want = jax_steps.make_prefill_step(jmodel)(jparams, as_jax(batch))
    got = steps.make_prefill_step(zoo.Model(tcfg))(params, as_torch(batch))
    assert got.dtype == torch.float32
    close(got, want, tol=BF16_TOL)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_configs_and_full_param_counts_match_the_reference(arch):
    """All ten ids: the configs, and ``count_params_config`` with and without
    ``active_only`` (deepseek-v3-671b: 671.7 B params, 38.2 B active)."""
    full, jfull = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(full.reduced()) == dataclasses.asdict(jfull.reduced())
    assert zoo.count_params_config(full) == jax_zoo.count_params_config(jfull)
    assert zoo.count_params_config(full, active_only=True) == \
        jax_zoo.count_params_config(jfull, active_only=True)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert (full.active_param_count() < full.param_count()) == (full.moe is not None)


def test_the_registry_covers_every_reference_id():
    assert set(ARCH_IDS) | set(UNPORTED_ARCH_IDS) == set(JAX_ARCH_IDS)
    assert not set(ARCH_IDS) & set(UNPORTED_ARCH_IDS)
    assert set(FAMILIES) | {"mamba2-130m"} == set(ARCH_IDS)
    assert UNPORTED_ARCH_IDS == ()


@pytest.mark.parametrize("name, want", [
    ("zamba2-7b", (1, 1, 0)),               # reduced: 2 layers, attn_every 2
    ("zamba2-5layers", (2, 1, 1)),
])
def test_hybrid_layout(name, want):
    _, tcfg = configs(name)
    assert hybrid_layout(tcfg) == want
    assert hybrid_layout(get_config("zamba2-7b")) == (13, 5, 3)   # 68 Mamba layers


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-26b", "zamba2-7b", *NEW_FAMILIES])
def test_train_cli_runs_lm_mode_on_the_cpu(arch, capsys, monkeypatch):
    """``--mode lm`` on the CPU; its batches (the VLM's patches, or the
    encoder-decoder's max(seq // 4, 8) frames, drawn right after the tokens
    from one numpy stream) are the reference's byte for byte."""
    seen = []
    make = train.make_train_step

    def recording(model, optimizer):
        step = make(model, optimizer)

        def wrapped(params, opt_state, batch):
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
            return step(params, opt_state, batch)
        return wrapped

    monkeypatch.setattr(train, "make_train_step", recording)
    train.main(["--mode", "lm", "--arch", arch, "--steps", "2", "--device", "cpu",
                "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(lines) == 2 and all(np.isfinite(float(x.split("loss=")[1])) for x in lines)
    assert "lm smoke training done" in out
    cfg = jax_get_config(arch).reduced()
    rng = np.random.default_rng(0)
    for got in seen:
        want = jax_lm_token_batch(rng, 2, 16, cfg.vocab_size)
        if cfg.arch_type.value == "vlm":
            want["patch_embeds"] = rng.normal(
                size=(2, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
        if cfg.arch_type.value == "encdec":
            want["src_embeds"] = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
        assert sorted(got) == sorted(want)
        assert all(got[k].tobytes() == np.asarray(want[k]).tobytes() for k in want)
    assert len(seen) == 2 and ("patch_embeds" in seen[0]) == (cfg.arch_type.value == "vlm")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_cli_runs_on_the_cpu(arch, capsys, monkeypatch):
    """``launch/serve.py`` on the CPU: the encoder-decoder's
    max(prompt_len, 8) frames and then the prompt come from the numpy
    stream in the reference's order, and the greedy decode finishes."""
    seen = {"prompt": []}
    encode = zoo.Model.encode_for_decode
    make = serve.make_serve_step

    def recording_encode(self, params, src, cache):
        seen["src"] = src.numpy().copy()
        return encode(self, params, src, cache)

    def recording_step(model):
        step = make(model)

        def wrapped(params, tokens, cache, pos):
            if len(seen["prompt"]) < 4:
                seen["prompt"].append(tokens.numpy().copy())
            return step(params, tokens, cache, pos)
        return wrapped

    monkeypatch.setattr(zoo.Model, "encode_for_decode", recording_encode)
    monkeypatch.setattr(serve, "make_serve_step", recording_step)
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 device=cpu" in out and "decode : 3 steps" in out
    cfg = jax_get_config(arch).reduced()
    rng = np.random.default_rng(0)
    if cfg.arch_type.value == "encdec":
        want = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
        assert seen["src"].tobytes() == want.tobytes()
    else:
        assert "src" not in seen
    prompt = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    assert np.array_equal(np.concatenate(seen["prompt"], axis=1), prompt)


def test_the_moe_and_encdec_families_still_raise():
    """Once refused, the MoE and encoder-decoder families made from a dense
    config now build: the params count what ``count_params_config`` says,
    and a forward is finite."""
    from repro_torch.configs import ArchType, MoEConfig

    dense = get_config("smollm-135m").reduced()
    for family in (
        dataclasses.replace(dense, arch_type=ArchType.MOE, moe=MoEConfig(4, 2, 64)),
        dataclasses.replace(dense, arch_type=ArchType.ENCDEC, encoder_layers=2, frontend="audio"),
    ):
        model = zoo.Model(family, remat=False)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        assert zoo.count_params_config(family) == sum(t.numel() for t in tree_leaves(params))
        batch = as_torch(make_batch(family, seed=8))
        assert bool(torch.isfinite(model.forward_logits(params, batch)).all())
