"""Client-side local training for one round of FedAvg (the sequential engine).

Each client receives the global parameters, trains for ``local_epochs`` on
its own data with a *locally initialized* AdamW (FedML-style: the optimizer
state never leaves the client and is reset each round), and returns only the
updated parameters plus its sample count.

On the card a client's step is captured as a CUDA graph the first time the
trainer meets its shapes and replayed after that (``capture.py``, the port
of the reference's ``jax.jit`` of its step): :class:`CapturedStep` holds
the static params, moments, batch and AdamW coefficients the graph reads
and writes, and gives the eager step's bits.  On the CPU, and inside
``capture.disable_capture()``, :class:`EagerStep` runs ``train_step``
eagerly.  Both take AdamW's coefficients from a device table
(:class:`StepCoefficients`), so neither bakes in a step count.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.capture import GraphCache, capture_enabled, position, set_position
from repro_torch.data.pipeline import ClientDataset, local_round_steps
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates
from repro_torch.privacy.dp import DPConfig, dp_value_and_grad, resolve_dp
from repro_torch.tree import PyTree, tree_leaves, tree_map

LossFn = Callable[..., Any]  # loss(params, batch, generator) -> scalar tensor


def to_device(batch: tuple[np.ndarray, ...], device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)


def train_step(
    loss_fn: LossFn,
    optimizer: AdamW,
    params: PyTree,
    opt_state: AdamWState,
    batch: tuple[torch.Tensor, ...],
    generator: torch.Generator | None,
    coefficients: torch.Tensor | None = None,
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """One AdamW step; ``params`` are leaf tensors that require grad, updated
    in place.  ``coefficients`` is the step's ``(3,)`` AdamW coefficients on
    the device, or None for the host's (``AdamW.update``)."""
    loss = loss_fn(params, batch, generator)
    leaves = tree_leaves(params)
    grads_flat = torch.autograd.grad(loss, leaves)
    grads_iter = iter(grads_flat)
    grads = tree_map(lambda _: next(grads_iter), params)
    updates, opt_state = optimizer.update(grads, opt_state, params, coefficients)
    return apply_updates(params, updates), opt_state, loss.detach()


def dp_train_step(
    dp_grad: Callable[..., Any],
    optimizer: AdamW,
    params: PyTree,
    opt_state: AdamWState,
    batch: tuple[torch.Tensor, ...],
    generator: torch.Generator | None,
    coefficients: torch.Tensor | None = None,
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """One DP-SGD AdamW step: ``dp_grad`` (``privacy/dp.py::dp_value_and_grad``)
    over a client axis of one."""
    loss, grads = dp_grad(
        tree_map(lambda p: p.unsqueeze(0), params),
        tuple(a.unsqueeze(0) for a in batch),
        None if generator is None else [generator],
    )
    updates, opt_state = optimizer.update(
        tree_map(lambda g: g[0], grads), opt_state, params, coefficients
    )
    return apply_updates(params, updates), opt_state, loss[0]


def trainable_copy(params: PyTree) -> PyTree:
    """A private copy of ``params`` whose leaves require grad."""
    return tree_map(lambda p: p.detach().clone().requires_grad_(True), params)


class StepCoefficients:
    """AdamW's coefficients by step on the training device (row ``k - 1``
    for step ``k``): one upload for as many steps as the longest run yet."""

    def __init__(self, optimizer: AdamW, device: torch.device):
        self.optimizer = optimizer
        self.device = device
        self.table: torch.Tensor | None = None

    def upto(self, steps: int) -> torch.Tensor:
        if self.table is None or len(self.table) < steps:
            self.table = torch.from_numpy(self.optimizer.coefficient_table(steps)).to(self.device)
        return self.table


StepFn = Callable[..., Any]  # (params, opt_state, batch, generator, coefficients) -> ...


class EagerStep:
    """A run of ``step_fn`` steps from a private copy of the params."""

    def __init__(self, step_fn: StepFn, optimizer: AdamW, device: torch.device):
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.device = device

    def start(self, params: PyTree) -> None:
        self.params = trainable_copy(params)
        self.state = self.optimizer.init(self.params)

    def step(self, batch, coefficients: torch.Tensor, generator) -> torch.Tensor:
        self.params, self.state, loss = self.step_fn(
            self.params, self.state, to_device(batch, self.device), generator, coefficients
        )
        return loss

    def result(self) -> PyTree:
        return tree_map(lambda p: p.detach(), self.params)


class CapturedStep:
    """``step_fn`` over static buffers, captured into a graph of ``graphs``.

    The params and AdamW moments are updated in place by the graph; a run
    copies the params in (``start``), the batch, coefficients and the
    generator's position in before each replay (``step``), and the params
    out at its end (``result``)."""

    def __init__(self, graphs: GraphCache, step_fn: StepFn, params: PyTree,
                 batch_like: Sequence[tuple[tuple[int, ...], torch.dtype]], with_generator: bool):
        dev = graphs.device
        self.params = tree_map(
            lambda p: torch.zeros(p.shape, dtype=p.dtype, device=dev).requires_grad_(True), params
        )
        self.mu = tree_map(torch.zeros_like, self.params)
        self.nu = tree_map(torch.zeros_like, self.params)
        self.batch = tuple(torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype in batch_like)
        self.coefficients = torch.tensor([1.0, 1.0, 0.0], device=dev)
        self.slots = [torch.Generator(device=dev)] if with_generator else []
        slot = self.slots[0] if with_generator else None

        def body() -> torch.Tensor:
            _, state, loss = step_fn(self.params, AdamWState(0, self.mu, self.nu), self.batch,
                                     slot, self.coefficients)
            with torch.no_grad():
                for old, new in zip(tree_leaves((self.mu, self.nu)),
                                    tree_leaves((state.mu, state.nu))):
                    old.copy_(new)
            return loss

        self.graph = graphs.capture(body, self.slots)

    def start(self, params: PyTree) -> None:
        with torch.no_grad():
            for s, p in zip(tree_leaves(self.params), tree_leaves(params)):
                s.copy_(p)
            for m in tree_leaves((self.mu, self.nu)):
                m.zero_()

    def step(self, batch, coefficients: torch.Tensor, generator) -> torch.Tensor:
        for s, a in zip(self.batch, batch):
            s.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        self.coefficients.copy_(coefficients)
        if self.slots:
            set_position(self.slots[0], position(generator))
        loss = self.graph.replay()
        if self.slots:
            set_position(generator, position(self.slots[0]))
        return loss

    def result(self) -> PyTree:
        return tree_map(lambda p: p.detach().clone(), self.params)


def step_runner(graphs: GraphCache, step_fn: StepFn, optimizer: AdamW, params: PyTree,
                x: np.ndarray, y: np.ndarray, batch_size: int, generator) -> EagerStep | CapturedStep:
    """The runner of a client's (or the central) steps over batches of
    ``batch_size`` rows like ``x`` and ``y``: captured on the card (one graph
    a key of ``graphs``), eager on the CPU or inside ``disable_capture``."""
    if not capture_enabled(graphs.device):
        return EagerStep(step_fn, optimizer, graphs.device)
    batch_like = (
        ((batch_size, *x.shape[1:]), torch.from_numpy(x[:0]).dtype),
        ((batch_size,), torch.from_numpy(y[:0]).dtype),
        ((batch_size,), torch.float32),
    )
    key = (batch_like, tuple((tuple(p.shape), p.dtype) for p in tree_leaves(params)),
           generator is not None)
    return graphs.lookup(key, lambda: CapturedStep(
        graphs, step_fn, params, batch_like, generator is not None))


@dataclasses.dataclass
class LocalTrainer:
    """Shared local-training machinery reused across all clients."""

    loss_fn: LossFn
    optimizer: AdamW
    batch_size: int
    local_epochs: int
    device: str | torch.device | None = None
    # DP-SGD (privacy/dp.py): a DPConfig, a job-spec dict, or None, which
    # keeps the unprotected step untouched.
    dp: DPConfig | dict | None = None

    def __post_init__(self) -> None:
        self.dp = resolve_dp(self.dp)
        self._dp_grad = None if self.dp is None else dp_value_and_grad(self.loss_fn, self.dp)
        self.device = resolve_device(self.device)
        if self._dp_grad is None:
            self._step_fn = functools.partial(train_step, self.loss_fn, self.optimizer)
        else:
            self._step_fn = functools.partial(dp_train_step, self._dp_grad, self.optimizer)
        self._coefficients = StepCoefficients(self.optimizer, self.device)
        # The captured steps (on the card), one a batch shape.
        self.graphs = GraphCache(self.device)

    def train_client(
        self,
        params: PyTree,
        client: ClientDataset,
        rng: np.random.Generator,
        generator: torch.Generator | None,
    ) -> tuple[PyTree, float, int]:
        """Run local_epochs over the client's train split.

        Returns (updated params, mean train loss of last epoch, n_c).  The
        global ``params`` are not modified.  ``generator`` draws the dropout
        masks, and under DP the noise (None trains without dropout, and
        without noise only).
        """
        coefficients = self._coefficients.upto(self.steps_per_round(client))
        run = step_runner(self.graphs, self._step_fn, self.optimizer, params,
                          client.train.x, client.train.y, self.batch_size, generator)
        run.start(params)
        last_losses: list[torch.Tensor] = []
        k = 0
        for _ in range(self.local_epochs):
            losses = []
            for batch in client.train.padded_batches(self.batch_size, rng):
                losses.append(run.step(batch, coefficients[k], generator))
                k += 1
            last_losses = losses
        # One readback per client: it also waits for the client's last step.
        mean_loss = (
            float(torch.stack(last_losses).double().mean()) if last_losses else float("nan")
        )
        return run.result(), mean_loss, client.n_train

    def steps_per_round(self, client: ClientDataset) -> int:
        return local_round_steps(client.n_train, self.batch_size, self.local_epochs)
