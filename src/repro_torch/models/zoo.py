"""Model API of the port's LM zoo: every family of the JAX package's zoo.

``Model(cfg)`` exposes the functional surface the train and serving steps
consume::

    params = model.init(generator, device)
    loss, aux = model.loss(params, batch)                  # train
    h, aux = model.hidden(params, batch)                   # prefill
    logits = model.forward_logits(params, batch)
    cache  = model.init_cache(batch_size, max_len, device)
    cache  = model.encode_for_decode(params, src_embeds, cache)  # enc-dec
    logits, cache = model.decode_step(params, tok, cache, pos)   # serve

Batches are dicts with ``tokens`` and, for ``loss``, ``labels`` (B, S)
int64 (or int32; a label of -1 is not scored); the VLM adds
``patch_embeds`` (B, P, D), the vision stub's patch embeddings, prepended
to the text, and the encoder-decoder ``src_embeds`` (B, T, D), the audio
stub's frame embeddings, which the encoder reads.  Params are nested dicts
of tensors with the JAX zoo's keys and stacked layouts (the hybrid's
``group_mamba`` a stack of stacks, its ``shared_attn`` one block; the MoE
decoders' ``first_blocks``, ``moe_blocks`` or ``pair_blocks`` and
``tail_blocks``; the encoder-decoder's ``enc_blocks`` and decoder
``blocks``; DeepSeek's ``mtp``), so ``params_from_jax`` carries a JAX param
tree across key for key.  On one card the JAX package's sharding
constraints are no-ops and are dropped.  ``remat`` and ``loss_chunk`` keep
the JAX defaults: each layer (the hybrid: each group), and each sequence
chunk's logits, is recomputed in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, ArchType
from repro_torch.device import resolve_device
from repro_torch.models.attention import check_latent_position
from repro_torch.models.layers import dense_init, embed_init, mlp_param_count, rmsnorm, rmsnorm_init
from repro_torch.models.mamba2 import mamba2_cache_init, mamba2_param_count
from repro_torch.models.moe import moe_param_count
from repro_torch.models.transformer import (
    _self_attn_cache_init,
    dec_block_apply,
    dec_block_decode,
    dec_block_init,
    dense_block_apply,
    dense_block_decode,
    dense_block_init,
    hybrid_layout,
    mamba_block_apply,
    mamba_block_decode,
    mamba_block_init,
    moe_layout,
    run_stack,
    run_stack_decode,
    stack_init,
)
from repro_torch.tree import PyTree, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of one sequence chunk; labels < 0 score 0."""
    logp = torch.log_softmax((h @ head).float(), dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(labels >= 0, -ll, 0.0).sum()


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, as JAX promotes: float32 stub
    embeddings times a bfloat16 projection compute in float32."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    remat: bool = True
    loss_chunk: int = 512  # sequence chunk for the memory-bounded CE

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> PyTree:
        """Random params drawn from ``generator`` on its own device, placed on
        ``device``; in the order embed, head, the layer stacks,
        frontend_proj, mtp."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _dtype(cfg)
        params: dict[str, Any] = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, dev),
            "ln_f": rmsnorm_init(cfg.d_model, dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dtype, dev)

        at = cfg.arch_type
        dense = lambda: dense_block_init(generator, cfg, dtype, dev, use_moe=False)
        moe = lambda: dense_block_init(generator, cfg, dtype, dev, use_moe=True)
        mamba = lambda: mamba_block_init(generator, cfg, dtype, dev)
        if at in (ArchType.DENSE, ArchType.VLM):
            params["blocks"] = stack_init(dense, cfg.num_layers)
        elif at == ArchType.MOE:
            first, n_moe, n_inter = moe_layout(cfg)
            if first:
                params["first_blocks"] = stack_init(dense, first)
            if cfg.moe.moe_every == 1:
                params["moe_blocks"] = stack_init(moe, n_moe)
            else:
                params["pair_blocks"] = stack_init(lambda: {"dense": dense(), "moe": moe()}, n_moe)
                if n_inter > n_moe:
                    params["tail_blocks"] = stack_init(dense, n_inter - n_moe)
        elif at == ArchType.SSM:
            params["blocks"] = stack_init(mamba, cfg.num_layers)
        elif at == ArchType.HYBRID:
            groups, per_group, tail = hybrid_layout(cfg)
            params["group_mamba"] = stack_init(lambda: stack_init(mamba, per_group), groups)
            params["shared_attn"] = dense()
            if tail:
                params["tail_blocks"] = stack_init(mamba, tail)
        elif at == ArchType.ENCDEC:
            params["enc_blocks"] = stack_init(dense, cfg.encoder_layers)
            params["enc_ln"] = rmsnorm_init(cfg.d_model, dtype, dev)
            params["blocks"] = stack_init(lambda: dec_block_init(generator, cfg, dtype, dev),
                                          cfg.num_layers)
        else:
            raise ValueError(f"unknown arch_type {at}")
        if cfg.frontend is not None:
            params["frontend_proj"] = dense_init(generator, cfg.d_model, cfg.d_model, dtype, dev)
        if cfg.mtp:
            params["mtp"] = {
                "proj": dense_init(generator, 2 * cfg.d_model, cfg.d_model, dtype, dev),
                "block": dense(),
                "ln": rmsnorm_init(cfg.d_model, dtype, dev),
            }
        return params

    # --------------------------------------------------------------- forward
    def _embed_inputs(self, params: PyTree, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        x = params["embed"][batch["tokens"].long()]
        if self.cfg.arch_type == ArchType.VLM:
            patches = _promoted_matmul(batch["patch_embeds"], params["frontend_proj"])
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def _backbone(self, params: PyTree, x: torch.Tensor,
                  enc: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | float]:
        """Run the layer stacks.  Returns (hidden, the summed router aux loss)."""
        cfg = self.cfg
        at = cfg.arch_type
        remat = self.remat
        dense = lambda p, h: dense_block_apply(p, cfg, h, use_moe=False)
        mamba = lambda p, h: (mamba_block_apply(p, cfg, h), 0.0)
        if at in (ArchType.DENSE, ArchType.VLM):
            return run_stack(params["blocks"], x, dense, remat=remat)
        if at == ArchType.SSM:
            return run_stack(params["blocks"], x, mamba, remat=remat)
        if at == ArchType.ENCDEC:
            return run_stack(params["blocks"], x,
                             lambda p, h: (dec_block_apply(p, cfg, h, enc), 0.0), remat=remat)
        aux = 0.0
        if at == ArchType.MOE:
            def pair(p: PyTree, h: torch.Tensor):
                h, a1 = dense_block_apply(p["dense"], cfg, h, use_moe=False)
                h, a2 = dense_block_apply(p["moe"], cfg, h, use_moe=True)
                return h, a1 + a2

            bodies = {"first_blocks": dense,
                      "moe_blocks": lambda p, h: dense_block_apply(p, cfg, h, use_moe=True),
                      "pair_blocks": pair, "tail_blocks": dense}
            for key, body in bodies.items():
                if key in params:
                    x, a = run_stack(params[key], x, body, remat=remat)
                    aux = aux + a
            return x, aux
        shared = params["shared_attn"]  # HYBRID

        def group_body(p: PyTree, h: torch.Tensor):
            h, _ = run_stack(p, h, mamba)
            h, _ = dense_block_apply(shared, cfg, h, use_moe=False)
            return h, 0.0

        x, _ = run_stack(params["group_mamba"], x, group_body, remat=remat)
        if "tail_blocks" in params:
            x, _ = run_stack(params["tail_blocks"], x, mamba, remat=remat)
        return x, aux

    def _encode(self, params: PyTree, src_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over the audio stub's frame embeddings (B, T, D).  The
        frames are projected in the promoted dtype, as JAX does, and the
        encoder runs in the params' dtype (given float32 frames and bfloat16
        params, JAX would carry float32 activations through the encoder; in
        a float32 model the two are the same computation)."""
        cfg = self.cfg
        proj = params["frontend_proj"]
        x = _promoted_matmul(src_embeds, proj).to(proj.dtype)
        x, _ = run_stack(params["enc_blocks"], x,
                         lambda p, h: dense_block_apply(p, cfg, h, use_moe=False, causal=False),
                         remat=self.remat)
        return rmsnorm(params["enc_ln"], x, cfg.norm_eps)

    def hidden(self, params: PyTree, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states (B, S, D) of the text positions and the
        summed router aux loss (a float32 scalar, 0 without experts)."""
        cfg = self.cfg
        enc = None
        if cfg.arch_type == ArchType.ENCDEC:
            enc = self._encode(params, batch["src_embeds"])
        x, aux = self._backbone(params, self._embed_inputs(params, batch), enc)
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        if cfg.arch_type == ArchType.VLM:
            # drop the patch positions: loss and logits apply to text only
            x = x[:, batch["patch_embeds"].shape[1]:, :]
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def _head_matrix(self, params: PyTree) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def forward_logits(self, params: PyTree, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        x, _ = self.hidden(params, batch)
        return (x @ self._head_matrix(params)).float()

    # ------------------------------------------------------------------ loss
    def _chunked_ce(self, h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Memory-bounded CE: sequence chunks of ``loss_chunk``, each chunk's
        float32 logits recomputed in the backward."""
        b, s, _ = h.shape
        chunk = min(self.loss_chunk, s)
        nc = -(-s // chunk)
        pad = nc * chunk - s
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.int64, device=h.device)
        for k in range(nc):
            h_k, y_k = h[:, k * chunk:(k + 1) * chunk], labels[:, k * chunk:(k + 1) * chunk]
            total = total + torch.utils.checkpoint.checkpoint(
                _chunk_nll, h_k, y_k, head, use_reentrant=False)
            count = count + (y_k >= 0).sum()
        return total / torch.clamp(count, min=1).float()

    def loss(self, params: PyTree, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Mean next-token CE over the labels >= 0, plus ``router_aux_weight``
        times the router aux loss with experts, plus 0.3 times DeepSeek's MTP
        CE (predict token t+2 from h_t and the embedding of token t+1) with
        ``mtp``: ``(total, {"ce", "router_aux", ["mtp_ce",] "loss"})``."""
        cfg = self.cfg
        h, aux = self.hidden(params, batch)
        head = self._head_matrix(params)
        ce = self._chunked_ce(h, head, batch["labels"])
        total = ce
        metrics = {"ce": ce, "router_aux": aux}
        if cfg.moe is not None:
            total = total + cfg.moe.router_aux_weight * aux
        if cfg.mtp and "mtp" in params:
            mtp = params["mtp"]
            emb_next = params["embed"][batch["tokens"].long()][:, 1:, :]
            mtp_in = torch.cat([rmsnorm(mtp["ln"], h[:, :-1, :], cfg.norm_eps), emb_next], dim=-1)
            mtp_h, _ = dense_block_apply(mtp["block"], cfg, mtp_in @ mtp["proj"], use_moe=False)
            mtp_ce = self._chunked_ce(mtp_h, head, batch["labels"][:, 1:])
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device: str | torch.device | None = None) -> PyTree:
        """Zero decode cache.  GQA layers hold a ring buffer of ``max_len``
        slots (the window with a sliding window), MLA layers the latent cache
        of ``max_len`` positions; the SSM state does not grow.  The hybrid's
        ``group_mamba`` cache is (groups, per_group, ...) and its
        ``shared_attn`` cache one buffer a group.  The encoder-decoder's
        ``cross_k``/``cross_v`` (layers, B, ``encoder_frames(max_len)``, Hkv,
        hd) are zeros until ``encode_for_decode`` fills them."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _dtype(cfg)

        def stack_cache(one: PyTree, *lead: int) -> PyTree:
            return tree_map(
                lambda t: t[(None,) * len(lead)].expand(*lead, *t.shape).clone(), one)

        attn = lambda: _self_attn_cache_init(cfg, batch, max_len, dtype, dev)
        mamba = lambda: mamba2_cache_init(cfg, batch, dtype, dev)
        at = cfg.arch_type
        if at in (ArchType.DENSE, ArchType.VLM):
            return {"blocks": stack_cache(attn(), cfg.num_layers)}
        if at == ArchType.SSM:
            return {"blocks": stack_cache(mamba(), cfg.num_layers)}
        if at == ArchType.MOE:
            first, n_moe, n_inter = moe_layout(cfg)
            cache: dict[str, Any] = {}
            if first:
                cache["first_blocks"] = stack_cache(attn(), first)
            if cfg.moe.moe_every == 1:
                cache["moe_blocks"] = stack_cache(attn(), n_moe)
            else:
                cache["pair_blocks"] = {"dense": stack_cache(attn(), n_moe),
                                        "moe": stack_cache(attn(), n_moe)}
                if n_inter > n_moe:
                    cache["tail_blocks"] = stack_cache(attn(), n_inter - n_moe)
            return cache
        if at == ArchType.ENCDEC:
            cross = (cfg.num_layers, batch, self.encoder_frames(max_len), cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            return {"blocks": {"self": stack_cache(attn(), cfg.num_layers),
                               "cross_k": torch.zeros(cross, dtype=dtype, device=dev),
                               "cross_v": torch.zeros(cross, dtype=dtype, device=dev)}}
        groups, per_group, tail = hybrid_layout(cfg)  # HYBRID
        cache = {"group_mamba": stack_cache(mamba(), groups, per_group),
                 "shared_attn": stack_cache(attn(), groups)}
        if tail:
            cache["tail_blocks"] = stack_cache(mamba(), tail)
        return cache

    @staticmethod
    def encoder_frames(seq_len: int) -> int:
        """Audio frontend stub: 4x temporal downsampling of the frame track."""
        return max(seq_len // 4, 8)

    # ---------------------------------------------------------------- decode
    def decode_step(
        self,
        params: PyTree,
        tokens: torch.Tensor | None,
        cache: PyTree,
        pos,
        *,
        token_embeds: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, PyTree]:
        """One new token for every sequence.  tokens: (B, 1); pos: the new
        token's absolute position (int or 0-d tensor; with MLA an int past
        the latent cache raises ``IndexError``).  ``token_embeds`` (B, 1, D)
        bypasses the embedding table: the VLM's patches are prefilled
        through the decode path that way.  Returns (logits (B, vocab)
        float32, new cache)."""
        cfg = self.cfg
        at = cfg.arch_type
        if token_embeds is not None:
            x = token_embeds.to(params["embed"].dtype)
            if cfg.frontend == "vision":
                x = x @ params["frontend_proj"]
        else:
            x = params["embed"][tokens.long()]
        if not isinstance(pos, torch.Tensor):
            if cfg.mla is not None:
                check_latent_position(pos, _latent_slots(cache))
            # the position on the device once for every layer, filled by a
            # kernel: a copy from host memory would wait for the stream
            pos = torch.full((), pos, dtype=torch.int64, device=x.device)
        dense = lambda p, h, c: dense_block_decode(p, cfg, h, c, pos, use_moe=False)
        mamba = lambda p, h, c: mamba_block_decode(p, cfg, h, c, pos)

        new_cache: dict[str, Any] = {}
        if at in (ArchType.DENSE, ArchType.VLM):
            x, new_cache["blocks"] = run_stack_decode(params["blocks"], cache["blocks"], x, dense)
        elif at == ArchType.SSM:
            x, new_cache["blocks"] = run_stack_decode(params["blocks"], cache["blocks"], x, mamba)
        elif at == ArchType.MOE:
            def pair(p: PyTree, h: torch.Tensor, c: PyTree) -> tuple[torch.Tensor, PyTree]:
                h, cd = dense_block_decode(p["dense"], cfg, h, c["dense"], pos, use_moe=False)
                h, cm = dense_block_decode(p["moe"], cfg, h, c["moe"], pos, use_moe=True)
                return h, {"dense": cd, "moe": cm}

            moe = lambda p, h, c: dense_block_decode(p, cfg, h, c, pos, use_moe=True)
            bodies = {"first_blocks": dense, "moe_blocks": moe, "pair_blocks": pair,
                      "tail_blocks": dense}
            for key, body in bodies.items():
                if key in params:
                    x, new_cache[key] = run_stack_decode(params[key], cache[key], x, body)
        elif at == ArchType.ENCDEC:
            blocks = cache["blocks"]

            def dec(p: PyTree, h: torch.Tensor, c: PyTree) -> tuple[torch.Tensor, PyTree]:
                h, c_new = dec_block_decode(p["block"], cfg, h, {"self": c, "cross_k": p["cross_k"],
                                                                 "cross_v": p["cross_v"]}, pos)
                return h, c_new["self"]

            # the encoder's K/V ride with the layer params: only the self
            # caches are restacked, the cross caches come back as they are
            layers = {"block": params["blocks"], "cross_k": blocks["cross_k"],
                      "cross_v": blocks["cross_v"]}
            x, self_cache = run_stack_decode(layers, blocks["self"], x, dec)
            new_cache["blocks"] = {**blocks, "self": self_cache}
        else:  # HYBRID
            shared = params["shared_attn"]

            def group_body(p: PyTree, h: torch.Tensor, c: PyTree) -> tuple[torch.Tensor, PyTree]:
                h, c_group = run_stack_decode(p, c["group_mamba"], h, mamba)
                h, c_attn = dense(shared, h, c["shared_attn"])
                return h, {"group_mamba": c_group, "shared_attn": c_attn}

            x, groups = run_stack_decode(
                params["group_mamba"],
                {"group_mamba": cache["group_mamba"], "shared_attn": cache["shared_attn"]},
                x, group_body)
            new_cache.update(groups)
            if "tail_blocks" in params:
                x, new_cache["tail_blocks"] = run_stack_decode(
                    params["tail_blocks"], cache["tail_blocks"], x, mamba)

        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = (x[:, 0, :] @ self._head_matrix(params)).float()
        return logits, new_cache

    def encode_for_decode(self, params: PyTree, src_embeds: torch.Tensor, cache: PyTree) -> PyTree:
        """Run the encoder over ``src_embeds`` (B, T, D) and put every decoder
        layer's cross K/V, (layers, B, T, Hkv, hd) in the cache's dtype, in a
        new cache; the other entries are the given cache's."""
        cfg = self.cfg
        enc = self._encode(params, src_embeds)
        b, t, _ = enc.shape
        shape = (-1, b, t, cfg.num_kv_heads, cfg.resolved_head_dim)
        cross = params["blocks"]["cross"]
        blocks = dict(cache["blocks"])
        for name, w in (("cross_k", cross["w_k"]), ("cross_v", cross["w_v"])):
            blocks[name] = (enc[None] @ w[:, None]).reshape(shape).to(blocks[name].dtype)
        return {**cache, "blocks": blocks}


def _latent_slots(cache: PyTree) -> int:
    """The positions of an MLA model's latent cache: the length of the first
    ``c_kv`` found, (..., B, max_len, rank); every layer's is the same."""
    nodes = [cache]
    while nodes:
        node = nodes.pop()
        if "c_kv" in node:
            return node["c_kv"].shape[-2]
        nodes.extend(v for v in node.values() if isinstance(v, dict))
    raise ValueError("the cache holds no latent (c_kv) cache")


# ==========================================================================
# params across frameworks
# ==========================================================================

def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, which torch.from_numpy refuses
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: PyTree, device: str | torch.device | None = None) -> PyTree:
    """The JAX zoo's param tree (numpy or JAX arrays) -> the same tree of
    tensors, bit for bit, bfloat16 included."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def params_to_numpy(params: PyTree) -> PyTree:
    """Tensors -> numpy arrays.  bfloat16 leaves come back as float32, which
    holds every bfloat16 value exactly (numpy has no bfloat16 of its own)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, params)


# ==========================================================================
# analytic parameter counting (roofline MODEL_FLOPS = 6 N D)
# ==========================================================================

def _attn_params(cfg: ArchConfig) -> int:
    if cfg.mla is not None:
        m = cfg.mla
        h = cfg.num_heads
        return (
            cfg.d_model * m.q_lora_rank
            + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            + cfg.d_model * m.kv_lora_rank
            + cfg.d_model * m.qk_rope_head_dim
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            + h * m.v_head_dim * cfg.d_model
            + m.q_lora_rank + m.kv_lora_rank
        )
    hd = cfg.resolved_head_dim
    base = cfg.d_model * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * hd * cfg.d_model
    if cfg.qk_norm:
        base += 2 * hd
    return base


def _dense_block_params(cfg: ArchConfig) -> int:
    return _attn_params(cfg) + mlp_param_count(cfg.d_model, cfg.d_ff, cfg.activation) + 2 * cfg.d_model


def _moe_block_params(cfg: ArchConfig, active_only: bool) -> int:
    return _attn_params(cfg) + moe_param_count(cfg, active_only) + 2 * cfg.d_model


def count_params_config(cfg: ArchConfig, active_only: bool = False) -> int:
    """The params of ``cfg``'s model, counted from the config alone.
    ``active_only`` counts the ``top_k`` experts a token reaches, not all."""
    at = cfg.arch_type
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    total += cfg.d_model  # ln_f
    if at in (ArchType.DENSE, ArchType.VLM):
        total += cfg.num_layers * _dense_block_params(cfg)
    elif at == ArchType.MOE:
        first, n_moe, n_inter = moe_layout(cfg)
        total += first * _dense_block_params(cfg)
        total += n_moe * _moe_block_params(cfg, active_only)
        if cfg.moe.moe_every != 1:
            total += n_inter * _dense_block_params(cfg)
    elif at == ArchType.SSM:
        total += cfg.num_layers * (mamba2_param_count(cfg) + cfg.d_model)
    elif at == ArchType.HYBRID:
        groups, per_group, tail = hybrid_layout(cfg)
        total += (groups * per_group + tail) * (mamba2_param_count(cfg) + cfg.d_model)
        total += _dense_block_params(cfg)  # the shared attention block, once
    elif at == ArchType.ENCDEC:
        total += cfg.encoder_layers * _dense_block_params(cfg) + cfg.d_model
        # decoder blocks: self-attn + cross-attn + mlp
        total += cfg.num_layers * (
            2 * _attn_params(cfg)
            + mlp_param_count(cfg.d_model, cfg.d_ff, cfg.activation)
            + 3 * cfg.d_model
        )
        total += cfg.d_model * cfg.d_model  # frontend proj
    if cfg.frontend == "vision":
        total += cfg.d_model * cfg.d_model
    if cfg.mtp:
        total += 2 * cfg.d_model * cfg.d_model + _dense_block_params(cfg) + cfg.d_model
    return int(total)
