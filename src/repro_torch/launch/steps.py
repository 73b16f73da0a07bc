"""Step functions: train, federated round, prefill, serve (decode).

The train step takes the gradient of ``Model.loss`` over every param leaf
and applies the port's AdamW, the same step as the JAX package's jitted
``train_step``; on the card each Mamba2 layer (the SSM and hybrid
families) runs the SSD kernel forward with its entry states and, in the
backward, the SSD backward kernel, while attention and the MLPs are plain
PyTorch under autograd.  The federated round is the paper's FedAvg over a
client-stacked tree.  Prefill and decode run under ``torch.inference_mode()``.

The train and serve steps are the reference's jitted ones (``launch/
train.py``, ``launch/serve.py``'s ``donate_argnums=(2,)``): on the card each
is captured as a CUDA graph the first time it meets a key and replayed
after that (``capture.py``); on the CPU, and inside
``capture.disable_capture()``, they run eagerly.  A key's first call is
the capture's warm-up, run eagerly on the caller's own tensors (they are
the graph's static buffers, so there is no second copy of the params,
moments or cache); later calls copy their inputs into static buffers and
replay.  The federated round and prefill stay eager, as in the reference,
which jits them only in its dry run.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.capture import GraphCache, capture_enabled
from repro_torch.models.attention import check_latent_position
from repro_torch.models.zoo import Model, _latent_slots
from repro_torch.obs.trace import Tracer, resolve_tracer
from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates
from repro_torch.tree import PyTree, tree_leaves, tree_map


def _spec(tree: PyTree) -> tuple:
    """The shapes and dtypes of ``tree``'s leaves, in order."""
    return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(tree))


def _pointers(tree: PyTree) -> tuple[int, ...]:
    return tuple(t.data_ptr() for t in tree_leaves(tree))


class _Graphs:
    """One :class:`GraphCache` a device, made at its first use; ``cuda``
    without an index is the current card.  ``tracer`` and ``name`` are the
    caches' (their replays' device spans)."""

    def __init__(self, tracer: Tracer | None = None, name: str = "replay"):
        self.by_device: dict[torch.device, GraphCache] = {}
        self.tracer = tracer
        self.name = name

    def __call__(self, device: torch.device | str) -> GraphCache:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self.by_device:
            self.by_device[device] = GraphCache(device, self.tracer, self.name)
        return self.by_device[device]


def make_train_step(model: Model, optimizer: AdamW) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` and the AdamW moments are updated in place (``AdamW.
    update_``) and returned; the moments keep the params' dtype (bfloat16
    for the published model), as in the reference.  ``metrics`` holds
    detached float32 scalars: ``ce``, ``router_aux``, ``loss`` (and
    ``mtp_ce`` with DeepSeek's MTP head).

    On the card the step is captured at the first call of each key (the
    shapes and dtypes of the params, the moments and the batch) and
    replayed after that; ``train_step.graphs(device)`` is its
    :class:`GraphCache`.  The graph updates in place the params and moments
    of the call that captured it (its static trees), reads the batch and
    the step's AdamW coefficients (a ``(3,)`` tensor) from static buffers
    filled before each replay, and gives its metrics as one stacked
    tensor.  A call with other trees of the same shapes swaps their values
    with the static trees' before the replay and back after it, so every
    tree keeps its own values and no extra copy is held."""

    def eager(params: PyTree, opt_state: AdamWState, batch: dict[str, torch.Tensor],
              coefficients: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
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
        apply_updates(params, optimizer.update_(grads, opt_state, params, coefficients))
        return {k: v.detach() for k, v in metrics.items()}

    graphs = _Graphs()

    def train_step(params: PyTree, opt_state: AdamWState, batch: dict[str, torch.Tensor]):
        device = tree_leaves(params)[0].device
        if capture_enabled(device):
            key = (_spec(params), _spec(opt_state.mu), _spec(opt_state.nu),
                   tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())))
            step = graphs(device).lookup(key, lambda: _TrainGraph(
                graphs(device), eager, optimizer, params, opt_state, batch))
            metrics = step(params, opt_state, batch)
        else:
            metrics = eager(params, opt_state, batch)
        return params, AdamWState(opt_state.step + 1, opt_state.mu, opt_state.nu), metrics

    train_step.graphs = graphs
    return train_step


class _TrainGraph:
    """``make_train_step``'s step captured for one key (see there)."""

    def __init__(self, graphs: GraphCache, eager: Callable, optimizer: AdamW, params: PyTree,
                 opt_state: AdamWState, batch: dict[str, torch.Tensor]):
        dev = graphs.device
        self.optimizer = optimizer
        # The static trees: the capturing call's tensors, in trees of our own.
        params, mu, nu = (tree_map(lambda t: t, tree) for tree in
                          (params, opt_state.mu, opt_state.nu))
        self.leaves = tree_leaves((params, mu, nu))
        self.batch = {k: v.to(dev, copy=True) for k, v in batch.items()}
        self.coefficients = torch.empty(3, dtype=torch.float32, device=dev)
        self.names: list[str] = []
        self._fill(opt_state.step)

        def body() -> torch.Tensor:
            metrics = eager(params, AdamWState(0, mu, nu), self.batch, self.coefficients)
            self.names = list(metrics)
            return torch.stack([metrics[k] for k in self.names])

        self.graph = graphs.capture(body, warmup_is_step=True)

    def _fill(self, step) -> None:
        """The AdamW coefficients of step ``step + 1`` into the static buffer
        (fills, not a host copy: nothing waits for the stream)."""
        for i, c in enumerate(self.optimizer.coefficients(int(step) + 1)):
            self.coefficients[i].fill_(c)

    def __call__(self, params: PyTree, opt_state: AdamWState,
                 batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        out, self.graph.first = self.graph.first, None
        if out is None:  # a replay (the capturing call's step was the warm-up)
            for k, v in batch.items():
                self.batch[k].copy_(v)
            self._fill(opt_state.step)
            pairs = [(s, x) for s, x in zip(self.leaves, tree_leaves((params, opt_state.mu,
                                                                      opt_state.nu)))
                     if s.data_ptr() != x.data_ptr()]
            _swap(pairs)
            out = self.graph.replay()
            _swap(pairs)
        return dict(zip(self.names, out.unbind()))


@torch.no_grad()
def _swap(pairs: list[tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Exchange the values of each pair of same-shaped tensors."""
    for a, b in pairs:
        held = a.clone()
        a.copy_(b)
        b.copy_(held)


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


def make_serve_step(model: Model, tracer: Tracer | None = None) -> Callable:
    """``serve_step(params, tokens, cache, pos) -> (logits, cache)``: one
    decode step, a new token for every sequence against the cache, with
    the cache donated (``Model.decode_step(..., donate=True)``): it is
    written in place and the given tree comes back.

    On the card the step is captured at the first call of each key (the
    params', tokens' and cache's shapes and dtypes, and the params' and
    cache's data pointers: the graph reads both in place) and replayed
    after that; ``serve_step.graphs(device)`` is its :class:`GraphCache`,
    whose entries keep the tensors they read alive.  The tokens go through
    a static ``(B, 1)`` buffer and ``pos`` through a static 0-d int64 one,
    so one graph serves every position (the reference's traced
    ``jnp.int32(pos)``); with MLA an int position is checked against the
    latent cache on the host first (``IndexError``), as ``decode_step``
    does.  New ``cross_k``/``cross_v`` from ``encode_for_decode`` are new
    tensors, so a new key: copy them into the served cache's to keep its
    graph.

    ``tracer`` (a ``repro_torch.obs.Tracer``; None is the null tracer)
    records a ``serve_step`` span of each call's host work (the key, the
    lookup, the fills, the replay and the output's clone) and, on the card,
    a ``serve_step`` span of each replay on its device clock."""
    cfg = model.cfg
    tracer = resolve_tracer(tracer)
    graphs = _Graphs(tracer, "serve_step")

    @torch.inference_mode()
    def serve_step(params: PyTree, tokens: torch.Tensor, cache: PyTree, pos):
        with tracer.span("serve_step"):
            device = tokens.device
            if not capture_enabled(device):
                return model.decode_step(params, tokens, cache, pos, donate=True)
            if cfg.mla is not None and not isinstance(pos, torch.Tensor):
                check_latent_position(pos, _latent_slots(cache))
            key = (_spec(params), _pointers(params), tuple(tokens.shape), tokens.dtype,
                   _spec(cache), _pointers(cache))
            step = graphs(device).lookup(key, lambda: _ServeGraph(
                graphs(device), model, params, tokens, cache, pos))
            return step(tokens, pos), cache

    serve_step.graphs = graphs
    return serve_step


class _ServeGraph:
    """``make_serve_step``'s step captured for one key (see there)."""

    def __init__(self, graphs: GraphCache, model: Model, params: PyTree, tokens: torch.Tensor,
                 cache: PyTree, pos):
        self.tokens = tokens.to(graphs.device, copy=True)
        self.pos = torch.empty((), dtype=torch.int64, device=graphs.device)
        self._fill(pos)
        self.reads = (params, cache)   # kept alive: the graph reads them in place

        def body() -> torch.Tensor:
            logits, _ = model.decode_step(params, self.tokens, cache, self.pos, donate=True)
            return logits

        self.graph = graphs.capture(body, warmup_is_step=True)

    def _fill(self, pos) -> None:
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(pos)   # a fill, not a host copy: nothing waits for the stream

    def __call__(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        out, self.graph.first = self.graph.first, None
        if out is None:
            self.tokens.copy_(tokens)
            self._fill(pos)
            out = self.graph.replay()
        return out
