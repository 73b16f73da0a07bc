"""Wrappers of the Hopper GRU recurrence kernels (``csrc/gru_scan.cu``).

``gru_scan`` replaces the JAX package's Pallas ``gru_scan`` and
``gru_scan_bwd`` replaces its ``gru_scan_bwd``.  Each takes either one
client, ``x_gates (B, T, 3N)`` with ``w_hh (N, 3N)``, or a client axis,
``x_gates (C, B, T, 3N)`` with per-client ``w_hh (C, N, 3N)``.

On CUDA tensors a wrapper checks dtype (float32), shape and contiguity,
allocates its outputs and scratch with ``torch.empty``, launches the
kernel on PyTorch's current stream and adds one to its ``launches`` count.
On CPU tensors it returns the plain version from ``ref.py`` and counts
nothing.

``gru_scan_bwd`` runs in two stages on the card: the reverse recurrence
(``dx_gates`` and ``dgn``, the n-part of ``d_gh``), then ``dW_hh`` and
``db_hh`` summed over slices of the B*T rows.  ``stage_recur`` and
``stage_dw`` launch one stage each, so that the card's checks can hold each
against its plain twin in ``ref.py``; they count nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.gru_scan.ref import (
    gru_bwd_dw_ref,
    gru_bwd_recur_ref,
    gru_scan_bwd_ref,
    gru_scan_ref,
)

MAX_HIDDEN = 64
_P = ctypes.c_void_p
_I = ctypes.c_int
# Pointers and the stream as c_void_p: a bare Python int would pass as 32 bits.
_SIGNATURES = {
    "gru_scan_fwd": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "gru_scan_bwd": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "gru_bwd_recur": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "gru_bwd_dw": ([_P] * 6 + [_I] * 5 + [_P], _I),
}


def slice_rows(n: int) -> int:
    """Rows (b, t) per block of the backward's dW/db stage (34 KB of shared memory)."""
    return 64 if n <= 32 else 32


def _library() -> ctypes.CDLL:
    return backend.load_library("gru_scan", _SIGNATURES)


def _check_shapes(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor):
    """-> (C, B, T, N) after validating the two accepted layouts."""
    if x_gates.dim() == 3 and w_hh.dim() == 2 and b_hh.dim() == 1:
        c = 1
        b, t, three_n = x_gates.shape
    elif x_gates.dim() == 4 and w_hh.dim() == 3 and b_hh.dim() == 2:
        c, b, t, three_n = x_gates.shape
        if w_hh.shape[0] != c or b_hh.shape[0] != c:
            raise ValueError(
                f"client axis mismatch: x_gates {tuple(x_gates.shape)}, "
                f"w_hh {tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)}"
            )
    else:
        raise ValueError(
            "expected x_gates (B,T,3N) with w_hh (N,3N), b_hh (3N,), or "
            f"(C,B,T,3N) with (C,N,3N), (C,3N); got {tuple(x_gates.shape)}, "
            f"{tuple(w_hh.shape)}, {tuple(b_hh.shape)}"
        )
    n = three_n // 3
    if three_n != 3 * n or n < 1 or tuple(w_hh.shape[-2:]) != (n, three_n) \
            or b_hh.shape[-1] != three_n:
        raise ValueError(
            f"inconsistent GRU shapes: x_gates {tuple(x_gates.shape)}, "
            f"w_hh {tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)}"
        )
    return c, b, t, n


def _check_bwd_shapes(x_gates, w_hh, b_hh, h_seq, dy):
    """-> (C, B, T, N), also requiring h_seq and dy of shape (..., B, T, N)."""
    c, b, t, n = _check_shapes(x_gates, w_hh, b_hh)
    want = (*x_gates.shape[:-1], n)
    if tuple(h_seq.shape) != want or tuple(dy.shape) != want:
        raise ValueError(
            f"h_seq {tuple(h_seq.shape)} and dy {tuple(dy.shape)} must be {want}"
        )
    return c, b, t, n


def _check_cuda_inputs(n: int, *tensors: torch.Tensor) -> None:
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"the gru_scan kernels take float32 tensors, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the gru_scan kernels take contiguous tensors")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("the gru_scan kernels take tensors on one device")
    if n > MAX_HIDDEN:
        raise ValueError(f"hidden size {n} above the largest supported, {MAX_HIDDEN}")


def gru_scan(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Hidden-state sequence ``(…, B, T, N)`` of the GRU recurrence."""
    c, b, t, n = _check_shapes(x_gates, w_hh, b_hh)
    if backend.route(x_gates, w_hh, b_hh) == "cpu":
        return gru_scan_ref(x_gates, w_hh, b_hh)
    _check_cuda_inputs(n, x_gates, w_hh, b_hh)
    h_seq = torch.empty((*x_gates.shape[:-1], n), dtype=x_gates.dtype, device=x_gates.device)
    if h_seq.numel() == 0:
        return h_seq
    err = _library().gru_scan_fwd(
        x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h_seq.data_ptr(),
        c, b, t, n, backend.stream_handle(x_gates.device),
    )
    backend.check(err, "gru_scan")
    gru_scan.launches += 1
    return h_seq


def gru_scan_bwd(
    x_gates: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    h_seq: torch.Tensor,
    dy: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual backward: ``(dx_gates, dw_hh, db_hh)`` from the forward's ``h_seq``."""
    c, b, t, n = _check_bwd_shapes(x_gates, w_hh, b_hh, h_seq, dy)
    if backend.route(x_gates, w_hh, b_hh, h_seq, dy) == "cpu":
        return gru_scan_bwd_ref(x_gates, w_hh, b_hh, h_seq, dy)
    _check_cuda_inputs(n, x_gates, w_hh, b_hh, h_seq, dy)
    dxg = torch.empty_like(x_gates)
    dw = torch.empty_like(w_hh)
    db = torch.empty_like(b_hh)
    if x_gates.numel() == 0:
        return dxg, dw.zero_(), db.zero_()
    dgn, partial = _scratch(h_seq, c, b, t, n)
    _stage("gru_scan_bwd", (c, b, t, n, slice_rows(n)),
           (x_gates, w_hh, b_hh, h_seq, dy), (dxg, dgn, partial, dw, db))
    gru_scan_bwd.launches += 1
    return dxg, dw, db


# ---------------------------------------------------------------------------
# The backward's stages, one launch each (not on the main path; no count).
# ---------------------------------------------------------------------------


def _stage(name: str, dims: tuple[int, ...], tensors, outs) -> None:
    """Launch C entry point ``name`` on ``tensors`` (inputs, then outputs ``outs``)."""
    err = getattr(_library(), name)(
        *(x.data_ptr() for x in (*tensors, *outs)), *dims,
        backend.stream_handle(tensors[0].device))
    backend.check(err, name)


def _scratch(h_seq: torch.Tensor, c: int, b: int, t: int, n: int):
    """``dgn`` (h_seq's shape) and the dW/db stage's per-slice partials."""
    slices = -(-(b * t) // slice_rows(n))
    return (torch.empty_like(h_seq),
            torch.empty((c, slices, n + 1, 3 * n), dtype=torch.float32, device=h_seq.device))


def stage_recur(x_gates, w_hh, b_hh, h_seq, dy) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse recurrence alone: ``(dx_gates, dgn)``."""
    c, b, t, n = _check_bwd_shapes(x_gates, w_hh, b_hh, h_seq, dy)
    if backend.route(x_gates, w_hh, b_hh, h_seq, dy) == "cpu":
        return gru_bwd_recur_ref(x_gates, w_hh, b_hh, h_seq, dy)
    _check_cuda_inputs(n, x_gates, w_hh, b_hh, h_seq, dy)
    dxg, dgn = torch.empty_like(x_gates), torch.empty_like(h_seq)
    _stage("gru_bwd_recur", (c, b, t, n),
           (x_gates, w_hh, b_hh, h_seq, dy), (dxg, dgn))
    return dxg, dgn


def stage_dw(h_seq, dx_gates, dgn) -> tuple[torch.Tensor, torch.Tensor]:
    """dW/db over the recurrence's outputs alone: ``(dw_hh, db_hh)``."""
    *lead, b, t, n = h_seq.shape
    if len(lead) > 1 or tuple(dx_gates.shape) != (*h_seq.shape[:-1], 3 * n) \
            or dgn.shape != h_seq.shape:
        raise ValueError(
            f"expected h_seq ([C,] B, T, N) with dx_gates (..., 3N) and dgn like h_seq; got "
            f"{tuple(h_seq.shape)}, {tuple(dx_gates.shape)}, {tuple(dgn.shape)}"
        )
    if backend.route(h_seq, dx_gates, dgn) == "cpu":
        return gru_bwd_dw_ref(h_seq, dx_gates, dgn)
    c = lead[0] if lead else 1
    _check_cuda_inputs(n, h_seq, dx_gates, dgn)
    dw = torch.empty((*lead, n, 3 * n), dtype=torch.float32, device=h_seq.device)
    db = torch.empty((*lead, 3 * n), dtype=torch.float32, device=h_seq.device)
    _, partial = _scratch(h_seq, c, b, t, n)
    _stage("gru_bwd_dw", (c, b, t, n, slice_rows(n)), (h_seq, dx_gates, dgn),
           (partial, dw, db))
    return dw, db


gru_scan.launches = 0
gru_scan_bwd.launches = 0
