"""A full GRU layer: input projection as one matmul, then the recurrence kernel.

``GRUScan`` is the port of the JAX ``gru_scan_op`` ``custom_vjp``: its
forward saves ``(x_gates, w_hh, b_hh, h_seq)`` and its backward is the
single reverse pass of ``gru_scan_bwd`` (the CUDA kernel on the card, the
plain reverse loop on the CPU) with no forward recompute.  ``gru_sequence``
also takes a leading client axis, which the kernels take as it is.

``gru_scan_oracle`` is the pre-residual pairing, kept as a baseline for
``kernels/analysis.py`` only: the same forward, and a backward that reruns
the plain forward (``ref.py``) under autograd and transposes it.  Nothing on
the main path calls it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.analysis import recompute_vjp
from repro_torch.kernels.gru_scan.kernel import gru_scan, gru_scan_bwd
from repro_torch.kernels.gru_scan.ref import gru_scan_ref


class GRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_gates, w_hh, b_hh):
        h_seq = gru_scan(x_gates, w_hh, b_hh)
        ctx.save_for_backward(x_gates, w_hh, b_hh, h_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dy):
        x_gates, w_hh, b_hh, h_seq = ctx.saved_tensors
        return gru_scan_bwd(x_gates, w_hh, b_hh, h_seq, dy.contiguous())


class GRUScanOracle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_gates, w_hh, b_hh):
        ctx.save_for_backward(x_gates, w_hh, b_hh)
        return gru_scan(x_gates, w_hh, b_hh)

    @staticmethod
    def backward(ctx, dy):
        return recompute_vjp(gru_scan_ref, ctx.saved_tensors, dy, "gru_scan_oracle")


def gru_scan_oracle(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The kernel's forward; a backward that recomputes it (analysis baseline only)."""
    return GRUScanOracle.apply(x_gates, w_hh, b_hh)


def gru_sequence(
    x: torch.Tensor,       # (B, T, F), or (C, B, T, F) with a client axis
    w_ih: torch.Tensor,    # (F, 3N), or (C, F, 3N)
    w_hh: torch.Tensor,    # (N, 3N), or (C, N, 3N)
    b_ih: torch.Tensor,    # (3N,), or (C, 3N)
    b_hh: torch.Tensor,    # (3N,), or (C, 3N)
) -> torch.Tensor:
    """Hidden sequence (B, T, N) for one GRU layer, or (C, B, T, N) for C
    clients with their own weights."""
    if x.dim() == 4:
        c, b, t, f = x.shape
        # one batched product over every client's timesteps
        x_gates = torch.bmm(x.reshape(c, b * t, f), w_ih) + b_ih.unsqueeze(1)
        return GRUScan.apply(x_gates.reshape(c, b, t, -1), w_hh, b_hh)
    x_gates = x @ w_ih + b_ih  # one large matmul over all timesteps
    return GRUScan.apply(x_gates, w_hh, b_hh)
