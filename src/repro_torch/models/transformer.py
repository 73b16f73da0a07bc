"""Blocks and layer stacks of the SSM family (Mamba2).

Per-layer parameters are stacked on a leading layer dimension, as in the
JAX package, so param trees carry across key for key.  JAX scans a layer
body over that dimension; here ``run_stack`` and ``run_stack_decode`` are
Python loops over the layer index.  ``run_stack(..., remat=True)`` is the
port of ``jax.checkpoint(body)``: each layer keeps only its input for the
backward and runs its forward again there.  The attention, MoE and encoder-decoder
blocks come with their families (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_init
from repro_torch.models.mamba2 import mamba2_apply, mamba2_decode, mamba2_init
from repro_torch.tree import PyTree, tree_map


def stack_init(init_fn: Callable[[], PyTree], n: int) -> PyTree:
    """``n`` draws of ``init_fn()`` stacked leafwise on a leading layer dim."""
    layers = [init_fn() for _ in range(n)]
    return tree_map(lambda *leaves: torch.stack(leaves), *layers)


def layer(stack: PyTree, i: int) -> PyTree:
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], stack)


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
