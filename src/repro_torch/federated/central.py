"""Centralized training baseline (paper section 4.3).

Trains the same architecture on the pooled global train split — the upper
bound that federated training tries to approach without centralizing data.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.pipeline import ArrayDataset
from repro_torch.device import resolve_device
from repro_torch.federated.client import to_device, train_step, trainable_copy
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import PyTree, tree_map


@dataclasses.dataclass(frozen=True)
class CentralConfig:
    epochs: int = 15
    batch_size: int = 128
    seed: int = 0


@dataclasses.dataclass
class CentralRunResult:
    params: PyTree
    epoch_losses: list[float]
    total_wall_time_s: float
    total_steps: int


def train_central(
    config: CentralConfig,
    dataset: ArrayDataset,
    init_params: PyTree,
    loss_fn: Callable[..., Any],
    optimizer: AdamW,
    progress: Callable[[int, float], None] | None = None,
    device: str | torch.device | None = None,
) -> CentralRunResult:
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    generator = torch.Generator(device=dev)
    generator.manual_seed(config.seed)

    params = trainable_copy(tree_map(lambda p: p.to(dev), init_params))
    opt_state = optimizer.init(params)
    epoch_losses: list[float] = []
    steps = 0
    t0 = time.perf_counter()
    for epoch in range(config.epochs):
        losses = []
        for batch in dataset.padded_batches(config.batch_size, rng):
            params, opt_state, loss = train_step(
                loss_fn, optimizer, params, opt_state, to_device(batch, dev), generator
            )
            losses.append(loss)
            steps += 1
        mean = float(torch.stack(losses).double().mean())
        epoch_losses.append(mean)
        if progress is not None:
            progress(epoch, mean)
    return CentralRunResult(
        params=tree_map(lambda p: p.detach(), params),
        epoch_losses=epoch_losses,
        total_wall_time_s=time.perf_counter() - t0,
        total_steps=steps,
    )
