"""Step functions: train, prefill, serve (decode).

The train step takes the gradient of ``Model.loss`` over every param leaf
and applies the port's AdamW, the same step as the JAX package's jitted
``train_step``; on the card each layer runs the SSD kernel forward with
its entry states and, in the backward, the SSD backward kernel.  Prefill
and decode run under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates
from repro_torch.tree import PyTree, tree_leaves, tree_map


def make_train_step(model: Model, optimizer: AdamW) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` are updated in place and returned; the AdamW moments keep the
    params' dtype (bfloat16 for the published model), as in the reference.
    ``metrics`` holds detached scalars: ``ce``, ``router_aux``, ``loss``."""

    def train_step(params: PyTree, opt_state: AdamWState, batch: dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        flags = [leaf.requires_grad for leaf in leaves]
        with torch.enable_grad():
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, metrics = model.loss(params, batch)
            grads_flat = torch.autograd.grad(loss, leaves)
        for leaf, flag in zip(leaves, flags):
            leaf.requires_grad_(flag)
        grads_iter = iter(grads_flat)
        grads = tree_map(lambda _: next(grads_iter), params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_prefill_step(model: Model) -> Callable:
    """Serving prefill: hidden states for the whole prompt, logits for the
    LAST position only (materializing (B, S, V) float32 logits is never what
    a serving system does).  Runs the SSD kernel once per layer on the card."""

    @torch.inference_mode()
    def prefill_step(params: PyTree, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = model.hidden(params, batch)
        last = h[:, -1, :]
        return (last @ model._head_matrix(params)).float()

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode step: a new token for every sequence against the cache."""

    @torch.inference_mode()
    def serve_step(params: PyTree, tokens: torch.Tensor, cache: PyTree, pos):
        return model.decode_step(params, tokens, cache, pos)

    return serve_step
