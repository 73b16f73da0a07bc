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
    # In-jit DP-SGD has not been ported: only None is accepted.
    dp: Any = None

    def __post_init__(self) -> None:
        if self.dp is not None:
            raise NotImplementedError(
                "DP-SGD (repro.privacy.dp) is not ported yet; it comes with the "
                "privacy slice of the port"
            )
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
        masks (None trains without dropout).
        """
        params = trainable_copy(params)
        opt_state = self.optimizer.init(params)
        last_losses: list[torch.Tensor] = []
        for _ in range(self.local_epochs):
            losses = []
            for batch in client.train.padded_batches(self.batch_size, rng):
                params, opt_state, loss = train_step(
                    self.loss_fn, self.optimizer, params, opt_state,
                    to_device(batch, self.device), generator,
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
