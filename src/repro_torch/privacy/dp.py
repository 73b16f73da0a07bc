"""DP-SGD: per-example clipping and calibrated Gaussian noise, in both engines.

The privacy unit is one *local step*: every example's gradient is clipped
to ``clip_norm`` in L2, the clipped gradients are summed, Gaussian noise
with standard deviation ``noise_multiplier * clip_norm`` is added to the
sum, and the noised sum is normalized by the batch's real example count —
the classic DP-SGD estimator (Abadi et al. 2016), as the JAX package's
``privacy/dp.py`` computes it.

Per-example gradients go through the GRU kernels' client axis.
``torch.func.vmap`` cannot trace the ctypes kernels, so :func:`dp_value_and_grad`
gives each example its own copy of its participant's params: a batch of
C participants × B examples becomes C·B "clients" of batch 1, the model
runs once over that axis (``models/gru.py``: one batched product per
layer, ``gru_scan`` and ``gru_scan_bwd`` at ``(C·B, 1, T, 3N)``), and one
``torch.autograd.grad`` with respect to the copies returns every example's
gradient: W_ih, b_ih and the head's from the batched products, W_hh and
b_hh from ``gru_scan_bwd``'s dW stage.  The per-example loss is the
training loss on a singleton batch, which with a 0/1 mask is the example's
unnormalized contribution, so with no clip and no noise the estimator is
the batch gradient (``DPConfig(clip_norm=None, noise_multiplier=0)``
matches the unprotected step to float-association tolerance).  The
sequential engine runs the same function with C = 1.

The RNG contract.  JAX key streams cannot be reproduced in torch, so the
port's DP step is defined on its own generators:

* each participant draws from its one ``torch.Generator`` of
  ``federated/cohort.py::client_generators``, and only on its valid steps
  (a padding step is an exact no-op and draws nothing);
* on a valid step it first draws its dropout masks, then the noise: one
  standard normal draw per leaf, in ``tree_leaves`` order, float32, in the
  leaf's shape (with ``noise_sigma == 0`` no noise is drawn at all);
* the dropout mask is shared across the participant's batch, as in the
  reference, whose per-example ``vmap`` passes one key to every example:
  one ``(1, T, N)`` mask per dropout layer per participant, broadcast over
  its B examples (``gru_apply`` with one generator per B-example group),
  never C·B masks.

Both engines follow it, so they remain each other's parity oracle under DP
with noise and dropout on, and a seeded DP run replays bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.tree import PyTree, tree_leaves, tree_map

LossFn = Callable[..., Any]  # loss(params, batch, generators) -> per-"client" losses

_DP_KEYS = ("clip_norm", "noise_multiplier", "delta")


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Per-step DP-SGD parameters, threaded as ``FederationConfig.privacy``.

    ``clip_norm`` is the per-example L2 clipping bound (``None`` = no
    clipping); ``noise_multiplier`` scales the Gaussian noise relative to
    the clip (sigma = ``noise_multiplier * clip_norm`` on the summed
    clipped gradients); ``delta`` is the accountant's target failure
    probability.  Values are validated strictly — JSON job specs must
    carry real numbers, never strings or booleans (truthy coercion of
    ``"0.1"`` would silently change the privacy guarantee).
    """

    clip_norm: float | None = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5

    def __post_init__(self) -> None:
        _require_number("clip_norm", self.clip_norm, allow_none=True)
        _require_number("noise_multiplier", self.noise_multiplier)
        _require_number("delta", self.delta)
        if self.clip_norm is not None and not (float(self.clip_norm) > 0):
            raise ValueError(
                f"privacy.clip_norm must be > 0 (or null for no clipping), "
                f"got {self.clip_norm}"
            )
        if float(self.noise_multiplier) < 0:
            raise ValueError(
                f"privacy.noise_multiplier must be >= 0, got {self.noise_multiplier}"
            )
        if self.noise_multiplier > 0 and (
            self.clip_norm is None or math.isinf(float(self.clip_norm))
        ):
            raise ValueError(
                "privacy.noise_multiplier > 0 needs a finite clip_norm: the "
                "noise is calibrated to noise_multiplier * clip_norm"
            )
        if not (0.0 < float(self.delta) < 1.0):
            raise ValueError(f"privacy.delta must be in (0, 1), got {self.delta}")

    @property
    def effective_clip(self) -> float:
        """The clipping bound as a float (``inf`` when clipping is off)."""
        return math.inf if self.clip_norm is None else float(self.clip_norm)

    @property
    def noise_sigma(self) -> float:
        """Noise std on the *summed* clipped gradients (0 when noiseless)."""
        if float(self.noise_multiplier) == 0.0:
            return 0.0
        return float(self.noise_multiplier) * float(self.clip_norm)

    def to_state(self) -> dict:
        """JSON form — the job spec's ``privacy`` section."""
        return {
            "clip_norm": None if self.clip_norm is None else float(self.clip_norm),
            "noise_multiplier": float(self.noise_multiplier),
            "delta": float(self.delta),
        }


def _require_number(name: str, value, allow_none: bool = False) -> None:
    if value is None and allow_none:
        return
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(
            f"privacy.{name} must be a number, got {value!r} "
            f"({type(value).__name__}) — JSON strings are rejected, never coerced"
        )


def resolve_dp(spec) -> DPConfig | None:
    """``None`` / :class:`DPConfig` / job-spec dict -> validated config.

    The dict form is the JSON job spec's ``privacy`` section; unknown keys
    fail fast with the allowed set.
    """
    if spec is None:
        return None
    if isinstance(spec, DPConfig):
        return spec
    if isinstance(spec, dict):
        unknown = sorted(set(spec) - set(_DP_KEYS))
        if unknown:
            raise ValueError(
                f"unknown privacy key(s) {unknown} (allowed: {sorted(_DP_KEYS)})"
            )
        return DPConfig(**spec)
    raise TypeError(
        f"privacy must be None, a DPConfig, or a dict, got {type(spec).__name__}"
    )


def per_example_clip_factors(grads: PyTree, clip_norm: float) -> torch.Tensor:
    """(E,) scale factors bounding each example's gradient L2 norm.

    ``grads`` carries a leading example axis on every leaf.  With
    ``clip_norm = inf`` every factor is exactly 1 — the clipped sum is the
    plain per-example sum.
    """
    sq = sum(
        torch.sum(torch.square(g.to(torch.float32).reshape(g.shape[0], -1)), dim=1)
        for g in tree_leaves(grads)
    )
    norms = torch.sqrt(sq)
    return torch.clamp(clip_norm / (norms + 1e-12), max=1.0)


def add_gaussian_noise(
    tree: PyTree, generator: torch.Generator | None, sigma: float
) -> PyTree:
    """Add independent N(0, sigma^2) noise to every leaf, drawn from
    ``generator`` leaf by leaf in ``tree_leaves`` order, float32, in each
    leaf's shape.  ``sigma == 0`` is the identity and draws nothing."""
    if sigma == 0.0:
        return tree
    if generator is None:
        raise ValueError("DP noise needs a generator")
    return tree_map(
        lambda leaf: leaf + sigma * torch.randn(
            leaf.shape, generator=generator, dtype=torch.float32, device=leaf.device
        ),
        tree,
    )


def per_example_value_and_grad(
    loss_fn: LossFn, params: PyTree, batch, generators: Sequence | None
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Every example's loss ``(C·B,)`` and gradient (``tree_leaves`` order,
    each ``(C·B, *leaf)``), example ``c·B + i`` being participant c's i-th.

    ``params`` carry a leading axis of C participants and ``batch`` is
    ``(x (C, B, ...), y (C, B), mask (C, B))``.  One copy of its
    participant's params per example makes C·B "clients" of batch 1 on the
    kernels' client axis; one backward gives each copy its own gradient.
    The masked-mean loss on a singleton batch is ``m_i · loss_i``, the
    example's unnormalized contribution.  ``generators`` (one per
    participant, or None) each draw one dropout mask for their group of B
    examples.
    """
    x, y, m = batch
    c, b = m.shape
    copies = tree_map(
        lambda q: q.detach().repeat_interleave(b, dim=0).requires_grad_(True), params
    )
    example_batch = (
        x.reshape(c * b, 1, *x.shape[2:]), y.reshape(c * b, 1), m.reshape(c * b, 1)
    )
    losses = loss_fn(copies, example_batch, generators)
    grads = torch.autograd.grad(losses.sum(), tree_leaves(copies))
    return losses.detach(), list(grads)


def dp_value_and_grad(loss_fn: LossFn, dp: DPConfig):
    """DP-SGD for a step over a client axis.

    Returns ``f(params, batch, generators) -> (losses, grads)``: every leaf
    of ``params`` carries a leading axis of C participants, ``batch =
    (x, y, mask)`` is ``(C, B, ...)``, ``(C, B)``, ``(C, B)``, and
    ``generators`` holds one generator per participant (a None entry is a
    padding slot: it draws nothing, and its result is discarded by the
    caller) or is None (no dropout, and only without noise).  ``losses`` is
    each participant's exact masked-mean batch loss, ``(C,)``; ``grads``
    each participant's clipped, summed, noised and normalized gradient, with
    ``params``' shapes.  ``loss_fn(params, batch, generators)`` is the
    training loss over a client axis (``models/gru.py::make_loss_fn``).
    """
    clip = dp.effective_clip
    sigma = dp.noise_sigma

    def value_and_grad(params: PyTree, batch, generators: Sequence | None):
        m = batch[2]
        c, b = m.shape
        if sigma != 0.0 and generators is None:
            raise ValueError("DP noise needs a generator per participant")
        losses, grads = per_example_value_and_grad(loss_fn, params, batch, generators)
        factors = per_example_clip_factors(grads, clip).view(c, 1, b)
        # Each participant's clipped sum: its factors against its examples'
        # gradients, one batched product per leaf.
        summed = [
            torch.bmm(factors, g.to(torch.float32).reshape(c, b, -1)).view(c, *g.shape[1:])
            for g in grads
        ]
        if sigma != 0.0:
            # add_gaussian_noise per participant, one stacked buffer a leaf:
            # each generator still draws its leaves in leaf order.
            drawing = [(i, g) for i, g in enumerate(generators) if g is not None]
            for s in summed:
                noise = torch.zeros_like(s)
                for i, g in drawing:
                    noise[i].normal_(generator=g)
                s += sigma * noise
        denom = torch.clamp(m.sum(dim=1), min=1.0)
        out = iter(summed)
        grads_out = tree_map(
            lambda ref: (next(out) / denom.view(c, *([1] * (ref.dim() - 1)))).to(ref.dtype),
            params,
        )
        return losses.view(c, b).sum(dim=1) / denom, grads_out

    return value_and_grad
