"""Transformer and Mamba2 blocks, and the layer stacks that run them.

Per-layer parameters are stacked on a leading layer dimension, as in the
JAX package, so param trees carry across key for key.  JAX scans a layer
body over that dimension; here ``run_stack`` and ``run_stack_decode`` are
Python loops over the layer index.  ``run_stack(..., remat=True)`` is the
port of ``jax.checkpoint(body)``: each layer keeps only its input for the
backward and runs its forward again there.  ``run_stack`` returns ``x``
alone: the router aux loss is 0 in every family the port runs.

Block kinds:
  * ``dense`` — GQA attention + [swiglu | relu2 | gelu | relu] MLP;
  * ``mamba`` — the Mamba2 SSD block.
The hybrid (Zamba2) runs groups of mamba blocks with one weight-*shared*
dense block applied after each group (``hybrid_layout``).  MLA and the MoE
blocks come with the MoE families (ROADMAP Queue 1 item 15b); the
cross-attention and decoder blocks with the encoder-decoder family (item
15c).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import gqa_apply, gqa_cache_init, gqa_decode, gqa_init
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init
from repro_torch.models.mamba2 import mamba2_apply, mamba2_decode, mamba2_init
from repro_torch.tree import PyTree, tree_map


def stack_init(init_fn: Callable[[], PyTree], n: int) -> PyTree:
    """``n`` draws of ``init_fn()`` stacked leafwise on a leading layer dim."""
    layers = [init_fn() for _ in range(n)]
    return tree_map(lambda *leaves: torch.stack(leaves), *layers)


def layer(stack: PyTree, i: int) -> PyTree:
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], stack)


# ==========================================================================
# block init / apply
# ==========================================================================

def _require_gqa(cfg: ArchConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention (MLA) is not ported to PyTorch yet "
            "(ROADMAP Queue 1 item 15b)"
        )


def _require_dense(use_moe: bool) -> None:
    if use_moe:
        raise NotImplementedError(
            "the MoE block is not ported to PyTorch yet (ROADMAP Queue 1 item 15b)"
        )


def _self_attn_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    _require_gqa(cfg)
    return gqa_init(generator, cfg, dtype, device)


def _self_attn_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    _require_gqa(cfg)
    return gqa_apply(params, cfg, x)


def _self_attn_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree, pos):
    _require_gqa(cfg)
    return gqa_decode(params, cfg, x, cache, pos)


def _self_attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> PyTree:
    _require_gqa(cfg)
    return gqa_cache_init(cfg, batch, max_len, dtype, device)


def dense_block_init(generator: torch.Generator, cfg: ArchConfig, dtype, device, *,
                     use_moe: bool) -> PyTree:
    """Drawn in a fixed order: the attention's weights, then the MLP's."""
    _require_dense(use_moe)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": _self_attn_init(generator, cfg, dtype, device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dtype, device),
    }


def dense_block_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor, *,
                      use_moe: bool) -> torch.Tensor:
    """Causal self-attention and the MLP, each on the pre-normed residual."""
    _require_dense(use_moe)
    h = x + _self_attn_apply(params["attn"], cfg, rmsnorm(params["ln1"], x, cfg.norm_eps))
    return h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps), cfg.activation)


def dense_block_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree, pos, *,
                       use_moe: bool) -> tuple[torch.Tensor, PyTree]:
    _require_dense(use_moe)
    attn_out, new_cache = _self_attn_decode(
        params["attn"], cfg, rmsnorm(params["ln1"], x, cfg.norm_eps), cache, pos)
    h = x + attn_out
    h = h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps), cfg.activation)
    return h, new_cache


def mamba_block_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    return {"ln": rmsnorm_init(cfg.d_model, dtype, device),
            "mamba": mamba2_init(generator, cfg, dtype, device)}


def mamba_block_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mamba2_apply(params["mamba"], cfg, rmsnorm(params["ln"], x, cfg.norm_eps))


def mamba_block_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree, _pos):
    out, new_cache = mamba2_decode(params["mamba"], cfg, rmsnorm(params["ln"], x, cfg.norm_eps), cache)
    return x + out, new_cache


def run_stack(
    stack_params: PyTree,
    x: torch.Tensor,
    body: Callable[[PyTree, torch.Tensor], torch.Tensor],
    *,
    remat: bool = False,
) -> torch.Tensor:
    """``x = body(layer_params, x)`` over the stacked layers, in order.

    With ``remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``); only while grad is enabled, so a step
    under ``inference_mode`` runs each layer once."""
    remat = remat and torch.is_grad_enabled()
    for i in range(_depth(stack_params)):
        p = layer(stack_params, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(body, p, x, use_reentrant=False)
        else:
            x = body(p, x)
    return x


def run_stack_decode(
    stack_params: PyTree,
    caches: PyTree,
    x: torch.Tensor,
    body: Callable[[PyTree, torch.Tensor, PyTree], tuple[torch.Tensor, PyTree]],
) -> tuple[torch.Tensor, PyTree]:
    """One decode step through the stack; returns x and the new stacked caches."""
    new_caches = []
    for i in range(_depth(stack_params)):
        x, c = body(layer(stack_params, i), x, layer(caches, i))
        new_caches.append(c)
    return x, tree_map(lambda *leaves: torch.stack(leaves), *new_caches)


def _depth(stack: PyTree) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


# ==========================================================================
# layer layout
# ==========================================================================

def hybrid_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(num groups, mamba per group, trailing mamba layers)."""
    period = cfg.hybrid.attn_every
    groups = cfg.num_layers // period
    return groups, period - 1, cfg.num_layers - groups * period
