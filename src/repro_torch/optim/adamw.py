"""AdamW (Loshchilov & Hutter), the paper's optimizer, as a functional pair.

The JAX package's ``AdamW.init`` / ``update`` written over trees of tensors,
with the reference's order of operations (``torch.optim.AdamW`` orders them
differently): the update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``,
with bias corrections computed in float32 and optional global-norm clipping.
``update`` returns new moment tensors; ``apply_updates`` adds the updates to
the params **in place** and returns the same tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import PyTree, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: int      # steps taken
    mu: PyTree     # first moment
    nu: PyTree     # second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 5e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 5e-3
    clip_norm: float | None = None
    # Optional schedule: callable step -> lr multiplier.
    schedule: Callable[[int], Any] | None = None

    def init(self, params: PyTree) -> AdamWState:
        return AdamWState(
            step=0,
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    @torch.no_grad()
    def update(
        self, grads: PyTree, state: AdamWState, params: PyTree
    ) -> tuple[PyTree, AdamWState]:
        """Returns (updates, new_state); apply with ``apply_updates``."""
        step = state.step + 1
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (global_norm(grads) + 1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)

        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g), state.nu, grads)
        f32 = np.float32
        b1c = float(f32(1) - f32(b1) ** f32(step))
        b2c = float(f32(1) - f32(b2) ** f32(step))
        lr = f32(self.learning_rate)
        if self.schedule is not None:
            lr = lr * f32(self.schedule(step))
        neg_lr = -float(lr)

        def _update(m, v, p):
            adam = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            return (neg_lr * (adam + self.weight_decay * p)).to(p.dtype)

        updates = tree_map(_update, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``params += updates`` leafwise, in place; returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u)
    return params


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def cosine_schedule(warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    """lr multiplier: linear warmup then cosine decay to ``min_ratio`` (float32)."""
    f32 = np.float32

    def schedule(step: int) -> np.float32:
        s = f32(step)
        if s < warmup_steps:
            return s / f32(max(1.0, float(warmup_steps)))
        progress = (s - f32(warmup_steps)) / f32(max(1.0, float(total_steps - warmup_steps)))
        progress = min(max(progress, f32(0.0)), f32(1.0))
        return f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (f32(1) + f32(math.cos(math.pi * progress)))

    return schedule
