"""Step functions: train, federated round, prefill, serve (decode).

The train step takes the gradient of ``Model.loss`` over every param leaf
and applies the port's AdamW, the same step as the JAX package's jitted
``train_step``; on the card each Mamba2 layer (the SSM and hybrid
families) runs the SSD kernel forward with its entry states and, in the
backward, the SSD backward kernel, while attention and the MLPs are plain
PyTorch under autograd.  The federated round is the paper's FedAvg over a
client-stacked tree.  Prefill and decode run under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


def make_fed_round_step(model: Model, optimizer: AdamW) -> Callable:
    """``fed_round_step(params_c, opt_state_c, batches, weights) ->
    (params_c, opt_state_c, loss)``: one FedAvg round over client slots.

    ``params_c`` and the moments of ``opt_state_c`` carry a leading client
    axis C; its ``step`` is an int or a (C,) array of each slot's steps.
    ``batches`` leaves are (C, K, b, ...) and ``weights`` (C,) is
    ``n_c * recruited_c``.  Each slot takes its K AdamW steps on its own
    replica (slot by slot: no cross-client traffic), then every leaf
    becomes the weighted average ``sum_c w_c x_c`` with ``w = weights /
    max(sum, 1e-9)`` in float32, written back to every slot.  A slot of
    weight 0 is a client that recruitment excluded: it trains, but does not
    move the average.  ``loss`` is ``sum_c w_c * mean_k loss_ck``.  Both
    trees are updated in place and returned."""
    train_step = make_train_step(model, optimizer)

    def fed_round_step(params_c: PyTree, opt_state_c: AdamWState, batches: PyTree, weights):
        leaves = tree_leaves(params_c)
        n_clients = leaves[0].shape[0]
        steps = np.broadcast_to(np.asarray(opt_state_c.step, dtype=np.int64), (n_clients,))
        k_steps = tree_leaves(batches)[0].shape[1]
        losses = []
        for c in range(n_clients):
            slot = lambda tree: tree_map(lambda t: t[c].clone(), tree)
            params = slot(params_c)
            state = AdamWState(int(steps[c]), slot(opt_state_c.mu), slot(opt_state_c.nu))
            slot_losses = []
            for k in range(k_steps):
                batch = tree_map(lambda t: t[c, k], batches)
                params, state, metrics = train_step(params, state, batch)
                slot_losses.append(metrics["loss"])
            with torch.no_grad():
                for stacked, new in ((params_c, params), (opt_state_c.mu, state.mu),
                                     (opt_state_c.nu, state.nu)):
                    for s_leaf, n_leaf in zip(tree_leaves(stacked), tree_leaves(new)):
                        s_leaf[c].copy_(n_leaf)
            losses.append(torch.stack(slot_losses).mean())

        w = torch.as_tensor(weights, dtype=torch.float32, device=leaves[0].device)
        w = w / torch.clamp(w.sum(), min=1e-9)
        with torch.no_grad():
            for leaf in leaves:
                avg = torch.tensordot(w.to(leaf.dtype), leaf, dims=1)   # reduce over C
                leaf.copy_(avg.expand_as(leaf))                         # redistribute
        loss = (torch.stack(losses) * w).sum()
        return params_c, AdamWState(steps + k_steps, opt_state_c.mu, opt_state_c.nu), loss

    return fed_round_step


def make_prefill_step(model: Model) -> Callable:
    """Serving prefill: hidden states for the whole prompt, logits for the
    LAST position only (materializing (B, S, V) float32 logits is never what
    a serving system does).  Runs the SSD kernel once per Mamba2 layer on
    the card."""

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
