"""Wrappers of the Hopper SSD chunked-scan kernels (``csrc/ssd.cu``).

``ssd_chunk_scan`` replaces the JAX package's Pallas ``ssd_chunk_scan``:
chunked inputs ``x (B, NC, L, H, P)``, ``dt`` and ``cum (B, NC, L, H)``,
``b_mat`` and ``c_mat (B, NC, L, N)`` shared across heads, to
``y (B, NC, L, H, P)``; with ``return_states`` also the float32 chunk-entry
states ``(B, NC, H, P, N)``.  ``ssd_chunk_scan_bwd`` replaces the Pallas
``ssd_chunk_scan_bwd``: from those states and the cotangent ``dy`` to
``(dx, ddt, dcum, db, dc)`` in the inputs' shapes.

On CUDA tensors a wrapper checks dtype (float32), shape, the kernel's
limits (L <= 256, P <= 64, N <= 128) and contiguity, allocates its outputs
(and the backward's per-head scratch) with ``torch.empty``, launches the
kernel on PyTorch's current stream and adds one to its ``launches`` count.
On CPU tensors it returns the plain versions from ``ref.py`` and counts
nothing.  Padding a ragged sequence to whole chunks is the caller's
(``ops.ssd_full``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ssd.ref import (
    ssd_chunk_scan_bwd_ref,
    ssd_chunk_scan_ref,
    ssd_chunk_states_ref,
)

MAX_CHUNK = 256
MAX_HEAD_DIM = 64
MAX_STATE = 128
_P = ctypes.c_void_p
_I = ctypes.c_int
# Pointers and the stream as c_void_p: a bare Python int would pass as 32 bits.
_SIGNATURES = {
    "ssd_chunk_scan_fwd": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "ssd_chunk_scan_bwd": ([_P] * 14 + [_I] * 6 + [_P], _I),
}


def _library() -> ctypes.CDLL:
    return backend.load_library("ssd", _SIGNATURES)


def _check_shapes(xc, dtc, cum, bc, cc) -> tuple[int, ...]:
    """-> (B, NC, L, H, P, N) after checking the five shapes agree."""
    if xc.dim() != 5:
        raise ValueError(f"x must be (B, NC, L, H, P), got {tuple(xc.shape)}")
    b, nc, l_len, h, p = xc.shape
    n = bc.shape[-1] if bc.dim() == 4 else -1
    want = {"dt": (b, nc, l_len, h), "cum": (b, nc, l_len, h),
            "b_mat": (b, nc, l_len, n), "c_mat": (b, nc, l_len, n)}
    got = {"dt": dtc, "cum": cum, "b_mat": bc, "c_mat": cc}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} is {tuple(t.shape)}, expected {want[name]} for x {tuple(xc.shape)}"
            )
    return b, nc, l_len, h, p, n


def _check_cuda_inputs(l_len: int, p: int, n: int, *tensors: torch.Tensor,
                       what: str = "ssd_chunk_scan") -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the {what} kernel takes float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"the {what} kernel takes tensors on one device")
    if l_len > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(
            f"chunk {l_len}, head_dim {p}, d_state {n} above the kernel's limits "
            f"({MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE})"
        )


def ssd_chunk_scan(
    xc: torch.Tensor,    # (B, NC, L, H, P)
    dtc: torch.Tensor,   # (B, NC, L, H)
    cum: torch.Tensor,   # (B, NC, L, H)  within-chunk cumulative log-decay
    bc: torch.Tensor,    # (B, NC, L, N)
    cc: torch.Tensor,    # (B, NC, L, N)
    *,
    return_states: bool = False,
):
    """y (B, NC, L, H, P); with ``return_states`` also the float32
    chunk-entry states (B, NC, H, P, N)."""
    b, nc, l_len, h, p, n = _check_shapes(xc, dtc, cum, bc, cc)
    if backend.route(xc, dtc, cum, bc, cc) == "cpu":
        y = ssd_chunk_scan_ref(xc, dtc, cum, bc, cc)
        if return_states:
            return y, ssd_chunk_states_ref(xc, dtc, cum, bc, cc)
        return y
    _check_cuda_inputs(l_len, p, n, xc, dtc, cum, bc, cc)
    dev = xc.device
    y = torch.empty_like(xc)
    states = (torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
              if return_states else None)
    if xc.numel():
        err = _library().ssd_chunk_scan_fwd(
            xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(), cc.data_ptr(),
            y.data_ptr(), None if states is None else states.data_ptr(),
            b, nc, l_len, h, p, n, backend.stream_handle(dev),
        )
        backend.check(err, "ssd_chunk_scan")
        ssd_chunk_scan.launches += 1
    elif states is not None:
        states.zero_()  # an empty sequence leaves every entry state at S_0 = 0
    return (y, states) if return_states else y


ssd_chunk_scan.launches = 0


def ssd_chunk_scan_bwd(
    xc: torch.Tensor,      # (B, NC, L, H, P)
    dtc: torch.Tensor,     # (B, NC, L, H)
    cum: torch.Tensor,     # (B, NC, L, H)
    bc: torch.Tensor,      # (B, NC, L, N)
    cc: torch.Tensor,      # (B, NC, L, N)
    states: torch.Tensor,  # (B, NC, H, P, N) float32 chunk-entry states
    dy: torch.Tensor,      # (B, NC, L, H, P)
) -> tuple[torch.Tensor, ...]:
    """``(dx, ddt, dcum, db, dc)`` in the shapes of ``(xc, dtc, cum, bc, cc)``.

    ``cum`` is treated as an independent input: its cotangent is returned,
    not folded into ``ddt``."""
    b, nc, l_len, h, p, n = _check_shapes(xc, dtc, cum, bc, cc)
    for name, t, want in (("states", states, (b, nc, h, p, n)), ("dy", dy, tuple(xc.shape))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want} for x {tuple(xc.shape)}")
    tensors = (xc, dtc, cum, bc, cc, states, dy)
    if backend.route(*tensors) == "cpu":
        return ssd_chunk_scan_bwd_ref(*tensors)
    _check_cuda_inputs(l_len, p, n, *tensors, what="ssd_chunk_scan_bwd")
    grads = tuple(torch.empty_like(t) for t in (xc, dtc, cum, bc, cc))
    if not xc.numel():
        return tuple(g.zero_() for g in grads)
    # Each (batch, head) block writes its head's share of dB and dC here; a
    # second kernel sums the shares in head order.
    share = torch.empty((2, b, nc, h, l_len, n), dtype=torch.float32, device=xc.device)
    err = _library().ssd_chunk_scan_bwd(
        *(t.data_ptr() for t in tensors), *(g.data_ptr() for g in grads),
        share[0].data_ptr(), share[1].data_ptr(),
        b, nc, l_len, h, p, n, backend.stream_handle(xc.device),
    )
    backend.check(err, "ssd_chunk_scan_bwd")
    ssd_chunk_scan_bwd.launches += 1
    return grads


ssd_chunk_scan_bwd.launches = 0
