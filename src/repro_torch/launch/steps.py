"""Serving step functions: prefill and decode.

Both run under ``torch.inference_mode()``.  The train step comes with the
training slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.zoo import Model
from repro_torch.tree import PyTree


def make_prefill_step(model: Model) -> Callable:
    """Serving prefill: hidden states for the whole prompt, logits for the
    LAST position only (materializing (B, S, V) float32 logits is never what
    a serving system does).  Runs the SSD kernel once per layer on the card."""

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
