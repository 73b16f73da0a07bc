"""Model API of the port's LM zoo: the dense, VLM, SSM and hybrid families.

``Model(cfg)`` exposes the functional surface the train and serving steps
consume::

    params = model.init(generator, device)
    loss, aux = model.loss(params, batch)                  # train
    h, aux = model.hidden(params, batch)                   # prefill
    logits = model.forward_logits(params, batch)
    cache  = model.init_cache(batch_size, max_len, device)
    logits, cache = model.decode_step(params, tok, cache, pos)   # serve

Batches are dicts with ``tokens`` and, for ``loss``, ``labels`` (B, S)
int64 (or int32; a label of -1 is not scored); the VLM adds
``patch_embeds`` (B, P, D), the vision stub's patch embeddings, prepended
to the text.  Params are nested dicts of tensors with the JAX zoo's keys
and stacked layouts (the hybrid's ``group_mamba`` a stack of stacks, its
``shared_attn`` one block), so ``params_from_jax`` carries a JAX param tree
across key for key.  On one card the JAX package's sharding constraints
are no-ops and are dropped.  ``remat`` and ``loss_chunk`` keep the JAX
defaults: each layer (the hybrid: each group), and each sequence chunk's
logits, is recomputed in the backward.  The MoE families raise
``NotImplementedError`` (ROADMAP Queue 1 item 15b), and so does the
encoder-decoder family (item 15c).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, ArchType
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, embed_init, mlp_param_count, rmsnorm, rmsnorm_init
from repro_torch.models.mamba2 import mamba2_cache_init, mamba2_param_count
from repro_torch.models.transformer import (
    _self_attn_cache_init,
    dense_block_apply,
    dense_block_decode,
    dense_block_init,
    hybrid_layout,
    mamba_block_apply,
    mamba_block_decode,
    mamba_block_init,
    run_stack,
    run_stack_decode,
    stack_init,
)
from repro_torch.tree import PyTree, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PORTED = (ArchType.DENSE, ArchType.VLM, ArchType.SSM, ArchType.HYBRID)
_QUEUE_ITEM = {ArchType.MOE: "15b", ArchType.ENCDEC: "15c"}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type.value} family is not ported to PyTorch yet "
            f"(ROADMAP Queue 1 item {_QUEUE_ITEM[cfg.arch_type]}); the port runs the "
            f"{', '.join(a.value for a in _PORTED)} families"
        )


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of one sequence chunk; labels < 0 score 0."""
    logp = torch.log_softmax((h @ head).float(), dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(labels >= 0, -ll, 0.0).sum()


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    remat: bool = True
    loss_chunk: int = 512  # sequence chunk for the memory-bounded CE

    def __post_init__(self) -> None:
        _require_ported(self.cfg)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> PyTree:
        """Random params drawn from ``generator`` on its own device, placed on
        ``device``; in the order embed, head, the layer stacks, frontend_proj."""
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
        mamba = lambda: mamba_block_init(generator, cfg, dtype, dev)
        if at in (ArchType.DENSE, ArchType.VLM):
            params["blocks"] = stack_init(dense, cfg.num_layers)
        elif at == ArchType.SSM:
            params["blocks"] = stack_init(mamba, cfg.num_layers)
        else:  # HYBRID
            groups, per_group, tail = hybrid_layout(cfg)
            params["group_mamba"] = stack_init(lambda: stack_init(mamba, per_group), groups)
            params["shared_attn"] = dense()
            if tail:
                params["tail_blocks"] = stack_init(mamba, tail)
        if cfg.frontend is not None:
            params["frontend_proj"] = dense_init(generator, cfg.d_model, cfg.d_model, dtype, dev)
        return params

    # --------------------------------------------------------------- forward
    def _embed_inputs(self, params: PyTree, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        x = params["embed"][batch["tokens"].long()]
        if self.cfg.arch_type == ArchType.VLM:
            # in the promoted dtype, as JAX promotes: float32 patches times a
            # bfloat16 projection compute in float32
            proj = params["frontend_proj"]
            dtype = torch.promote_types(batch["patch_embeds"].dtype, proj.dtype)
            patches = batch["patch_embeds"].to(dtype) @ proj.to(dtype)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def _backbone(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        at = cfg.arch_type
        mamba = lambda p, h: mamba_block_apply(p, cfg, h)
        if at in (ArchType.DENSE, ArchType.VLM):
            return run_stack(params["blocks"], x,
                             lambda p, h: dense_block_apply(p, cfg, h, use_moe=False),
                             remat=self.remat)
        if at == ArchType.SSM:
            return run_stack(params["blocks"], x, mamba, remat=self.remat)
        shared = params["shared_attn"]  # HYBRID

        def group_body(p: PyTree, h: torch.Tensor) -> torch.Tensor:
            h = run_stack(p, h, mamba)
            return dense_block_apply(shared, cfg, h, use_moe=False)

        x = run_stack(params["group_mamba"], x, group_body, remat=self.remat)
        if "tail_blocks" in params:
            x = run_stack(params["tail_blocks"], x, mamba, remat=self.remat)
        return x

    def hidden(self, params: PyTree, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states (B, S, D) of the text positions and the
        aux loss (0 in every family the port runs)."""
        cfg = self.cfg
        x = self._backbone(params, self._embed_inputs(params, batch))
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        if cfg.arch_type == ArchType.VLM:
            # drop the patch positions: loss and logits apply to text only
            x = x[:, batch["patch_embeds"].shape[1]:, :]
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

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
        """Mean next-token CE over the labels >= 0: ``(total, {"ce",
        "router_aux", "loss"})``."""
        cfg = self.cfg
        if cfg.moe is not None or cfg.mtp:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.arch_type.value} family's router and MTP losses are "
                "not ported to PyTorch yet (ROADMAP Queue 1 item 15b)"
            )
        h, aux = self.hidden(params, batch)
        ce = self._chunked_ce(h, self._head_matrix(params), batch["labels"])
        return ce, {"ce": ce, "router_aux": aux, "loss": ce}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device: str | torch.device | None = None) -> PyTree:
        """Zero decode cache.  Attention layers hold a ring buffer of
        ``max_len`` slots (the window with a sliding window); the SSM state
        does not grow.  The hybrid's ``group_mamba`` cache is (groups,
        per_group, ...) and its ``shared_attn`` cache one buffer a group."""
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
        groups, per_group, tail = hybrid_layout(cfg)  # HYBRID
        cache = {"group_mamba": stack_cache(mamba(), groups, per_group),
                 "shared_attn": stack_cache(attn(), groups)}
        if tail:
            cache["tail_blocks"] = stack_cache(mamba(), tail)
        return cache

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
        token's absolute position (int or 0-d tensor).  ``token_embeds`` (B,
        1, D) bypasses the embedding table: the VLM's patches are prefilled
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
    hd = cfg.resolved_head_dim
    base = cfg.d_model * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * hd * cfg.d_model
    if cfg.qk_norm:
        base += 2 * hd
    return base


def _dense_block_params(cfg: ArchConfig) -> int:
    return _attn_params(cfg) + mlp_param_count(cfg.d_model, cfg.d_ff, cfg.activation) + 2 * cfg.d_model


def count_params_config(cfg: ArchConfig, active_only: bool = False) -> int:
    """The params of ``cfg``'s model, counted from the config alone.
    ``active_only`` counts the experts a token reaches; no family the port
    runs has experts, so it changes nothing here."""
    _require_ported(cfg)
    at = cfg.arch_type
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    total += cfg.d_model  # ln_f
    if at in (ArchType.DENSE, ArchType.VLM):
        total += cfg.num_layers * _dense_block_params(cfg)
    elif at == ArchType.SSM:
        total += cfg.num_layers * (mamba2_param_count(cfg) + cfg.d_model)
    else:  # HYBRID
        groups, per_group, tail = hybrid_layout(cfg)
        total += (groups * per_group + tail) * (mamba2_param_count(cfg) + cfg.d_model)
        total += _dense_block_params(cfg)  # the shared attention block, once
    if cfg.frontend == "vision":
        total += cfg.d_model * cfg.d_model
    return int(total)
