"""Public entry points of the SSD scan, routed by the tensors' device.

``ssd_chunk_scan`` takes the chunked layout that ``models/mamba2.py``
produces; ``ssd_full`` takes an unchunked sequence and pads, chunks and
forms the within-chunk cumulative decay first (the tests sweep shapes
through it against ``ssd_ref``).

Only the forward is ported: the backward kernel (the JAX package's
``ssd_chunk_scan_bwd``) comes with the training slice.  CPU tensors run the
plain version, which autograd differentiates as it is; CUDA tensors that
require grad raise, because a gradient on the card would have to run the
plain version there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import kernel


def ssd_chunk_scan(xc, dtc, cum, bc, cc) -> torch.Tensor:
    """Chunked inputs (B, NC, L, ...) -> y (B, NC, L, H, P)."""
    tensors = (xc, dtc, cum, bc, cc)
    if torch.is_grad_enabled() and any(t.is_cuda and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the SSD backward kernel is not ported yet (the training slice, ROADMAP "
            "Queue 2 item 4): run the card's SSD path under torch.inference_mode()"
        )
    return kernel.ssd_chunk_scan(*tensors)


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
