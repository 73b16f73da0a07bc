"""Model API of the port's LM zoo: the SSM family (Mamba2).

``Model(cfg)`` exposes the functional surface the train and serving steps
consume::

    params = model.init(generator, device)
    loss, aux = model.loss(params, batch)                  # train
    h, aux = model.hidden(params, batch)                   # prefill
    logits = model.forward_logits(params, batch)
    cache  = model.init_cache(batch_size, max_len, device)
    logits, cache = model.decode_step(params, tok, cache, pos)   # serve

Batches are dicts with ``tokens`` and, for ``loss``, ``labels`` (B, S)
int64 (or int32; a label of -1 is not scored).  Params are nested dicts of
tensors with the JAX zoo's keys and stacked layouts, so ``params_from_jax``
carries a JAX param tree across key for key.  On one card the JAX package's
sharding constraints are no-ops and are dropped.  ``remat`` and
``loss_chunk`` keep the JAX defaults: each layer, and each sequence chunk's
logits, is recomputed in the backward.  The other families raise
``NotImplementedError`` (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, ArchType
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, embed_init, rmsnorm, rmsnorm_init
from repro_torch.models.mamba2 import mamba2_cache_init, mamba2_param_count
from repro_torch.models.transformer import (
    mamba_block_apply,
    mamba_block_decode,
    mamba_block_init,
    run_stack,
    run_stack_decode,
    stack_init,
)
from repro_torch.tree import PyTree, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type != ArchType.SSM:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type.value} family is not ported to PyTorch yet "
            "(ROADMAP Queue 1 item 15); the port runs the ssm family"
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
        """Random params drawn from ``generator`` on the CPU, placed on ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _dtype(cfg)
        params: dict[str, Any] = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, dev),
            "ln_f": rmsnorm_init(cfg.d_model, dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dtype, dev)
        params["blocks"] = stack_init(
            lambda: mamba_block_init(generator, cfg, dtype, dev), cfg.num_layers
        )
        return params

    # --------------------------------------------------------------- forward
    def hidden(self, params: PyTree, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states (B, S, D) and the aux loss (0 for SSM)."""
        cfg = self.cfg
        x = params["embed"][batch["tokens"].long()]
        x = run_stack(params["blocks"], x, lambda p, h: mamba_block_apply(p, cfg, h),
                      remat=self.remat)
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
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
                "not ported to PyTorch yet (ROADMAP Queue 1 item 15)"
            )
        h, aux = self.hidden(params, batch)
        ce = self._chunked_ce(h, self._head_matrix(params), batch["labels"])
        return ce, {"ce": ce, "router_aux": aux, "loss": ce}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device: str | torch.device | None = None) -> PyTree:
        """Zero decode cache; the SSM state does not grow, so ``max_len`` is unused."""
        cfg = self.cfg
        dev = resolve_device(device)
        one = mamba2_cache_init(cfg, batch, _dtype(cfg), dev)
        return {"blocks": tree_map(
            lambda t: t[None].expand(cfg.num_layers, *t.shape).clone(), one)}

    # ---------------------------------------------------------------- decode
    def decode_step(
        self, params: PyTree, tokens: torch.Tensor, cache: PyTree, pos
    ) -> tuple[torch.Tensor, PyTree]:
        """One new token for every sequence.  tokens: (B, 1); returns
        (logits (B, vocab) float32, new cache)."""
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        x, blocks = run_stack_decode(
            params["blocks"], cache["blocks"], x,
            lambda p, h, c: mamba_block_decode(p, cfg, h, c, pos),
        )
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = (x[:, 0, :] @ self._head_matrix(params)).float()
        return logits, {"blocks": blocks}


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
# analytic parameter counting
# ==========================================================================

def count_params_config(cfg: ArchConfig) -> int:
    _require_ported(cfg)
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    total += cfg.d_model  # ln_f
    total += cfg.num_layers * (mamba2_param_count(cfg) + cfg.d_model)
    return int(total)
