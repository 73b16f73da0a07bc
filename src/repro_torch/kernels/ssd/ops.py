"""Public entry points of the SSD scan, routed by the tensors' device.

``ssd_chunk_scan`` takes the chunked layout that ``models/mamba2.py``
produces; ``ssd_full`` takes an unchunked sequence and pads, chunks and
forms the within-chunk cumulative decay first (the tests sweep shapes
through it against ``ssd_ref``).

Both go through ``SSDChunkScan``, the port of the JAX ``custom_vjp``: when
an input needs a gradient its forward also returns the chunk-entry states
and saves them, and its backward is the single reverse pass of
``ssd_chunk_scan_bwd`` from those states, with no forward recompute.  On
CUDA tensors both are the hand-written kernels; on CPU tensors both are the
plain versions in ``ref.py``, as the JAX package runs its jnp backward off
the TPU.  ``cum`` gets a cotangent of its own, which autograd carries
through ``ssd_full``'s cumsum to ``dt`` and ``A``.

``ssd_chunk_scan_oracle`` is the pre-residual pairing, kept as a baseline
for ``kernels/analysis.py`` only: the same forward, and a backward that
reruns the plain forward (``ssd_chunk_scan_ref``) under autograd and
transposes it.  Nothing on the main path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.analysis import recompute_vjp
from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref


class SSDChunkScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, dtc, cum, bc, cc):
        if not any(ctx.needs_input_grad):
            return kernel.ssd_chunk_scan(xc, dtc, cum, bc, cc)
        y, states = kernel.ssd_chunk_scan(xc, dtc, cum, bc, cc, return_states=True)
        ctx.save_for_backward(xc, dtc, cum, bc, cc, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        return kernel.ssd_chunk_scan_bwd(*ctx.saved_tensors, dy.contiguous())


def ssd_chunk_scan(xc, dtc, cum, bc, cc) -> torch.Tensor:
    """Chunked inputs (B, NC, L, ...) -> y (B, NC, L, H, P)."""
    return SSDChunkScan.apply(xc, dtc, cum, bc, cc)


class SSDChunkScanOracle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, dtc, cum, bc, cc):
        ctx.save_for_backward(xc, dtc, cum, bc, cc)
        return kernel.ssd_chunk_scan(xc, dtc, cum, bc, cc)

    @staticmethod
    def backward(ctx, dy):
        return recompute_vjp(ssd_chunk_scan_ref, ctx.saved_tensors, dy, "ssd_chunk_scan_oracle")


def ssd_chunk_scan_oracle(xc, dtc, cum, bc, cc) -> torch.Tensor:
    """The kernel's forward; a backward that recomputes it (analysis baseline only)."""
    return SSDChunkScanOracle.apply(xc, dtc, cum, bc, cc)


def ssd_full(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)
    a: torch.Tensor,      # (H,)
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    chunk: int = 64,
) -> torch.Tensor:
    """Unchunked wrapper: pads to whole chunks, chunks, runs the scan."""
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = b_mat.reshape(b, nc, chunk, n)
    cc = c_mat.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtc * a[None, None, None, :], dim=2)
    y = ssd_chunk_scan(xc.contiguous(), dtc.contiguous(), cum, bc.contiguous(), cc.contiguous())
    return y.reshape(b, nc * chunk, h, p)[:, :s]
