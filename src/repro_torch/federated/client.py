"""Client-side local training for one round of FedAvg (the sequential engine).

Each client receives the global parameters, trains for ``local_epochs`` on
its own data with a *locally initialized* AdamW (FedML-style: the optimizer
state never leaves the client and is reset each round), and returns only the
updated parameters plus its sample count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

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
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """One AdamW step; ``params`` are leaf tensors that require grad, updated in place."""
    loss = loss_fn(params, batch, generator)
    leaves = tree_leaves(params)
    grads_flat = torch.autograd.grad(loss, leaves)
    grads_iter = iter(grads_flat)
    grads = tree_map(lambda _: next(grads_iter), params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


def dp_train_step(
    dp_grad: Callable[..., Any],
    optimizer: AdamW,
    params: PyTree,
    opt_state: AdamWState,
    batch: tuple[torch.Tensor, ...],
    generator: torch.Generator | None,
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """One DP-SGD AdamW step: ``dp_grad`` (``privacy/dp.py::dp_value_and_grad``)
    over a client axis of one."""
    loss, grads = dp_grad(
        tree_map(lambda p: p.unsqueeze(0), params),
        tuple(a.unsqueeze(0) for a in batch),
        None if generator is None else [generator],
    )
    updates, opt_state = optimizer.update(tree_map(lambda g: g[0], grads), opt_state, params)
    return apply_updates(params, updates), opt_state, loss[0]


def trainable_copy(params: PyTree) -> PyTree:
    """A private copy of ``params`` whose leaves require grad."""
    return tree_map(lambda p: p.detach().clone().requires_grad_(True), params)


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
        params = trainable_copy(params)
        opt_state = self.optimizer.init(params)
        last_losses: list[torch.Tensor] = []
        for _ in range(self.local_epochs):
            losses = []
            for batch in client.train.padded_batches(self.batch_size, rng):
                batch = to_device(batch, self.device)
                if self._dp_grad is None:
                    params, opt_state, loss = train_step(
                        self.loss_fn, self.optimizer, params, opt_state, batch, generator
                    )
                else:
                    params, opt_state, loss = dp_train_step(
                        self._dp_grad, self.optimizer, params, opt_state, batch, generator
                    )
                losses.append(loss)
            last_losses = losses
        # One readback per client: it also waits for the client's last step.
        mean_loss = (
            float(torch.stack(last_losses).double().mean()) if last_losses else float("nan")
        )
        return tree_map(lambda p: p.detach(), params), mean_loss, client.n_train

    def steps_per_round(self, client: ClientDataset) -> int:
        return local_round_steps(client.n_train, self.batch_size, self.local_epochs)
