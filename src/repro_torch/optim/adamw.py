"""AdamW (Loshchilov & Hutter), the paper's optimizer, as a functional pair.

The JAX package's ``AdamW.init`` / ``update`` written over trees of tensors,
with the reference's order of operations (``torch.optim.AdamW`` orders them
differently): the update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``,
with bias corrections computed in float32 on the host and optional
global-norm clipping.  ``update`` returns new moment tensors;
``update_`` writes them into the state's own tensors (a step then holds
one set of moments, not two, and a captured step updates its static
buffers) with the same operations, so the same bits; ``apply_updates``
adds the updates to the params **in place** and returns the same tree.

``update_stacked`` is the same step for a client-stacked tree (every leaf
with a leading client axis), where each client has its own step count: the
host computes each client's coefficients with ``coefficients`` and hands
them over as a ``(3, C)`` tensor (``cohort_coefficients`` lays them out for
a whole round).  ``update`` takes the same as a ``(3,)`` tensor when the
caller passes one (``coefficient_table`` lays them out by step).  Both
forms apply a bias correction as a product with its
float32 reciprocal, ``m * (1 / b1c)``: CUDA divides a tensor by a host
scalar that way but divides by a tensor exactly, so a division would round
differently in the two forms.  With a product, each client of a stacked
step gets the same bits as the one-client step; a bfloat16 leaf takes each
product with a coefficient tensor in float32, as it does with a host float
(``_times``), so a step that reads its coefficients from the device gives
the host form's bits in bfloat16 too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import PyTree, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: Any      # steps taken: an int, or a (C,) int array for a client-stacked tree
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

    def coefficients(self, step: int) -> tuple[float, float, float]:
        """``(1 / b1c, 1 / b2c, -lr)`` of step ``step`` (counted from 1), in float32."""
        f32 = np.float32
        b1c = f32(1) - f32(self.b1) ** f32(step)
        b2c = f32(1) - f32(self.b2) ** f32(step)
        lr = f32(self.learning_rate)
        if self.schedule is not None:
            lr = lr * f32(self.schedule(step))
        return float(f32(1) / b1c), float(f32(1) / b2c), -float(lr)

    def cohort_coefficients(self, step_valid: np.ndarray) -> np.ndarray:
        """``(C, T)`` step validity -> ``(T, 3, C)`` float32 coefficients.

        Slot ``(t, :, c)`` holds ``coefficients(k)`` for client ``c``'s k-th
        valid step; a slot that is not valid holds ``(1, 1, 0)``.
        """
        counts = np.cumsum(step_valid, axis=1)
        top = int(counts.max(initial=0))
        table = np.array(
            [(1.0, 1.0, 0.0)] + [self.coefficients(k) for k in range(1, top + 1)],
            dtype=np.float32,
        )
        index = np.where(step_valid, counts, 0)
        return np.ascontiguousarray(table[index].transpose(1, 2, 0))

    def coefficient_table(self, steps: int) -> np.ndarray:
        """``(steps, 3)`` float32: row ``k - 1`` holds ``coefficients(k)``."""
        return np.asarray([self.coefficients(k) for k in range(1, steps + 1)],
                          dtype=np.float32).reshape(steps, 3)

    @torch.no_grad()
    def update(
        self, grads: PyTree, state: AdamWState, params: PyTree,
        coefficients: torch.Tensor | None = None,
    ) -> tuple[PyTree, AdamWState]:
        """Returns (updates, new_state); apply with ``apply_updates``.

        ``coefficients``, a ``(3,)`` tensor on the params' device holding
        ``coefficients(state.step + 1)`` (a row of ``coefficient_table``),
        takes the place of the host floats: a step that reads them from the
        device can be captured once and replayed at any step count.  The
        same bits either way."""
        step = state.step + 1
        grads, coefs = self._clipped(grads, step, coefficients)
        mu, nu, updates = self._step(grads, state, params, coefs)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    @torch.no_grad()
    def update_(
        self, grads: PyTree, state: AdamWState, params: PyTree,
        coefficients: torch.Tensor | None = None,
    ) -> PyTree:
        """``update`` with the new moments written into ``state.mu`` and
        ``state.nu`` in place; returns the updates.  The caller's new state
        is ``AdamWState(state.step + 1, state.mu, state.nu)``.

        Leaf by leaf, each moment takes ``update``'s operations in
        ``update``'s order, the first of them in place (``b1 * m`` as
        ``m.mul_(b1)``, then ``+ (1 - b1) * g`` as an ``add_``: the same
        kernels, so the same bits in float32 and bfloat16, with clipping and
        a schedule), and the update is computed from the new moments; a
        leaf's step holds one or two temporaries of its size, not a new
        moment and its parts.  ``coefficients`` as in ``update``; without it
        the step count comes from ``state.step``."""
        grads, coefs = self._clipped(grads, state.step + 1, coefficients)
        updates = []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            updates.append(self._update(m, v, p, coefs))
        it = iter(updates)
        return tree_map(lambda _: next(it), params)

    def _clipped(self, grads: PyTree, step, coefficients: torch.Tensor | None):
        """The grads after global-norm clipping (when set) and the step's
        coefficients: the host floats of ``step``, or ``coefficients``'
        three 0-dim tensors."""
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (global_norm(grads) + 1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        coefs = self.coefficients(step) if coefficients is None else tuple(coefficients)
        return grads, coefs

    @torch.no_grad()
    def update_stacked(
        self, grads: PyTree, state: AdamWState, params: PyTree, coefficients: torch.Tensor
    ) -> tuple[PyTree, AdamWState]:
        """``update`` for a client-stacked tree; ``coefficients`` is ``(3, C)``
        on the params' device, each client's ``coefficients(step)``.

        Clipping, when set, is per client.  The returned step is
        ``state.step + 1`` for every client; the caller keeps the old state of
        a client whose step does not count.
        """
        if self.clip_norm is not None:
            c = coefficients.shape[-1]
            norms = torch.sqrt(sum(
                torch.sum(torch.square(g.float()).reshape(c, -1), dim=1)
                for g in tree_leaves(grads)
            ))
            scale = torch.clamp(self.clip_norm / (norms + 1e-12), max=1.0)
            grads = tree_map(lambda g: g * _per_client(scale, g), grads)
        mu, nu, updates = self._step(grads, state, params, tuple(coefficients))
        return updates, AdamWState(step=state.step + 1, mu=mu, nu=nu)

    def _step(self, grads, state, params, coefs):
        """New moments and the updates.  ``coefs`` is ``(1/b1c, 1/b2c, -lr)``,
        each a float, a 0-dim tensor, or a ``(C,)`` tensor of one value per
        client."""
        mu = tree_map(self._mu, state.mu, grads)
        nu = tree_map(self._nu, state.nu, grads)
        return mu, nu, tree_map(lambda m, v, p: self._update(m, v, p, coefs), mu, nu, params)

    def _mu(self, m, g):
        return self.b1 * m + (1 - self.b1) * g

    def _nu(self, v, g):
        return self.b2 * v + (1 - self.b2) * (g * g)

    def _update(self, m, v, p, coefs):
        """``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``; each operation
        after the first of a temporary is taken in place on it (the same
        kernels: the same bits), so a leaf holds at most two temporaries."""
        inv_b1c, inv_b2c, neg_lr = (_per_client(k, p) for k in coefs)
        denom = _times(v, inv_b2c).sqrt_().add_(self.eps)
        adam = _times(m, inv_b1c).div_(denom)
        return _times(adam.add_(self.weight_decay * p), neg_lr).to(p.dtype)


def _per_client(k, like: torch.Tensor):
    """A float or a 0-dim tensor as is; a ``(C,)`` tensor shaped to
    broadcast over ``like``'s non-client axes."""
    if isinstance(k, float) or k.dim() == 0:
        return k
    return k.view(k.shape[0], *([1] * (like.dim() - 1)))


_CHUNK = 1 << 24   # elements a float32 temporary of ``_times`` holds


def _times(x: torch.Tensor, k) -> torch.Tensor:
    """``x * k``, the same bits for ``k`` a host float and ``k`` a float32
    tensor of its value.  A bfloat16 ``x`` times a host float multiplies in
    float32 and rounds once; CUDA would first round a float32 tensor ``k``
    to bfloat16, so that product is taken in float32 explicitly, a chunk of
    ``_CHUNK`` elements at a time for a 0-dim ``k`` (a float32 copy of a
    whole multi-GB leaf would not fit beside a large model's step)."""
    if not isinstance(k, torch.Tensor) or k.dtype == x.dtype:
        return x * k
    if k.dim():   # one value a client, shaped to broadcast
        return (x.to(k.dtype) * k).to(x.dtype)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    k = k.reshape(1)   # a 1-dim operand promotes the product to its float32
    for part, dest in zip(x.reshape(-1).split(_CHUNK), out.view(-1).split(_CHUNK)):
        dest.copy_(part * k)
    return out


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
