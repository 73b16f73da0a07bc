"""Centralized training baseline (paper section 4.3).

Trains the same architecture on the pooled global train split — the upper
bound that federated training tries to approach without centralizing data.
On the card the step is captured as a CUDA graph at the first batch and
replayed after that, as the reference jits it (``federated/client.py::
CapturedStep``); on the CPU, and inside ``capture.disable_capture()``, it
runs eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.capture import GraphCache
from repro_torch.data.pipeline import ArrayDataset, local_round_steps
from repro_torch.device import resolve_device
from repro_torch.federated.client import StepCoefficients, step_runner, train_step
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
    # The call's captures and replays of its step, and the captures'
    # seconds (0 when eager).
    captures: int = 0
    replays: int = 0
    capture_seconds: float = 0.0


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
    graphs = GraphCache(dev)
    rng = np.random.default_rng(config.seed)
    generator = torch.Generator(device=dev)
    generator.manual_seed(config.seed)

    params = tree_map(lambda p: p.to(dev), init_params)
    coefficients = StepCoefficients(optimizer, dev).upto(
        local_round_steps(len(dataset), config.batch_size, config.epochs)
    )
    run = step_runner(graphs, functools.partial(train_step, loss_fn, optimizer), optimizer,
                      params, dataset.x, dataset.y, config.batch_size, generator)
    run.start(params)
    epoch_losses: list[float] = []
    steps = 0
    t0 = time.perf_counter()
    for epoch in range(config.epochs):
        losses = []
        for batch in dataset.padded_batches(config.batch_size, rng):
            losses.append(run.step(batch, coefficients[steps], generator))
            steps += 1
        mean = float(torch.stack(losses).double().mean())
        epoch_losses.append(mean)
        if progress is not None:
            progress(epoch, mean)
    captures, replays, capture_seconds = graphs.counts()
    return CentralRunResult(
        params=run.result(),
        epoch_losses=epoch_losses,
        total_wall_time_s=time.perf_counter() - t0,
        total_steps=steps,
        captures=captures,
        replays=replays,
        capture_seconds=capture_seconds,
    )
