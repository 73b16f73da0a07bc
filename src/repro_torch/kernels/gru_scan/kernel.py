"""Wrappers of the Hopper GRU recurrence kernels (``csrc/gru_scan.cu``).

``gru_scan`` replaces the JAX package's Pallas ``gru_scan`` and
``gru_scan_bwd`` replaces its ``gru_scan_bwd``.  Each takes either one
client, ``x_gates (B, T, 3N)`` with ``w_hh (N, 3N)``, or a client axis,
``x_gates (C, B, T, 3N)`` with per-client ``w_hh (C, N, 3N)``, at any hidden
size N >= 1 and any number of clients.

On CUDA tensors a wrapper checks dtypes, shape and contiguity, allocates
its outputs and scratch with ``torch.empty``, launches the kernels on
PyTorch's current stream and adds one to its ``launches`` count.  The
activations (``x_gates``, ``h_seq``, ``dy``) are float32, bfloat16 or
float16, one type for all; ``w_hh`` and ``b_hh`` are any of the three and
reach the kernels as float32.  The kernels compute in float32 and store
``h_seq`` and ``dx_gates`` in the activations' type; ``dw_hh`` and ``db_hh``
are float32 sums returned in ``w_hh``'s and ``b_hh``'s types, as the
reference does.  Other dtypes raise ``TypeError``.  On CPU tensors a wrapper
returns the plain version from ``ref.py`` and counts nothing.  On meta
tensors it returns empty meta outputs of those shapes and dtypes, records
the call's work for the dry run (``kernels/work.py``) and counts nothing.

``gru_scan_bwd`` runs in two stages on the card: the reverse recurrence
(``dx_gates``, and float32 ``dgn``, the n-part of ``d_gh``, or all of
``d_gh`` below float32), then ``dW_hh`` and ``db_hh`` summed over slices of
the B*T rows.  ``stage_recur`` and ``stage_dw`` launch one stage each on
float32 tensors, so that the card's checks can hold each against its plain
twin in ``ref.py``; they count nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, work
from repro_torch.kernels.gru_scan.ref import (
    gru_bwd_dw_ref,
    gru_bwd_recur_ref,
    gru_scan_bwd_ref,
    gru_scan_ref,
)

# The activation types the kernels take, by the code their entry points read.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NARROW = 64   # up to this hidden size the warp-per-row kernels run; above, the wide ones
_P = ctypes.c_void_p
_I = ctypes.c_int
# Pointers and the stream as c_void_p: a bare Python int would pass as 32 bits.
_SIGNATURES = {
    "gru_scan_fwd": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "gru_scan_bwd": ([_P] * 11 + [_I] * 6 + [_P], _I),
    "gru_wide_scratch": ([_I] * 4 + [_P], _I),
    "gru_bwd_recur": ([_P] * 8 + [_I] * 4 + [_P], _I),
    "gru_bwd_dw": ([_P] * 6 + [_I] * 5 + [_P], _I),
}


def slice_rows(n: int, rows: int) -> int:
    """Rows (b, t) a slice of the backward's dW/db stage, of ``rows`` = B*T.

    Up to N = 64 a block sums its whole slice in one chunk of 34 KB of shared
    memory or less; above, it stages 64 rows at a time for one tile of the
    product, and slices grow so that there are at most 8 of them (each writes
    an (N+1, 3N) float32 partial)."""
    if n <= 32:
        return 64
    if n <= NARROW:
        return 32
    return 64 * max(1, -(-rows // (64 * 8)))


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


def _check_cuda_inputs(acts, params=()) -> int:
    """The kernels' code for the activations' dtype, after checking every tensor."""
    code = DTYPES.get(acts[0].dtype)
    if code is None or any(x.dtype != acts[0].dtype for x in acts):
        raise TypeError("the gru_scan kernels take float32, bfloat16 or float16 activations "
                        f"of one dtype, got {sorted({str(x.dtype) for x in acts})}")
    for x in params:
        if x.dtype not in DTYPES:
            raise TypeError(f"the gru_scan kernels take float32, bfloat16 or float16 weights, "
                            f"got {x.dtype}")
    tensors = (*acts, *params)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the gru_scan kernels take contiguous tensors")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("the gru_scan kernels take tensors on one device")
    return code


def _wide_scratch(c: int, b: int, n: int, bwd: bool, device) -> torch.Tensor | None:
    """Device memory for a wide recurrence's row tiles where they do not fit
    in shared memory (very large N), else None."""
    if n <= NARROW:
        return None
    floats = ctypes.c_longlong()
    backend.check(_library().gru_wide_scratch(c, b, n, int(bwd), ctypes.addressof(floats)),
                  "gru_wide_scratch")
    return torch.empty(floats.value, dtype=torch.float32, device=device) if floats.value else None


def gru_scan(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Hidden-state sequence ``(…, B, T, N)`` of the GRU recurrence."""
    c, b, t, n = _check_shapes(x_gates, w_hh, b_hh)
    where = backend.route(x_gates, w_hh, b_hh)
    if where == "cpu":
        return gru_scan_ref(x_gates, w_hh, b_hh)
    if where == "meta":
        work.record_gru("gru_scan", c, b, t, n, x_gates.element_size())
        return torch.empty((*x_gates.shape[:-1], n), dtype=x_gates.dtype, device="meta")
    code = _check_cuda_inputs((x_gates,), (w_hh, b_hh))
    h_seq = torch.empty((*x_gates.shape[:-1], n), dtype=x_gates.dtype, device=x_gates.device)
    if h_seq.numel() == 0:
        return h_seq
    w32, b32 = w_hh.float(), b_hh.float()
    scratch = _wide_scratch(c, b, n, False, x_gates.device)
    err = _library().gru_scan_fwd(
        x_gates.data_ptr(), w32.data_ptr(), b32.data_ptr(), h_seq.data_ptr(),
        None if scratch is None else scratch.data_ptr(), c, b, t, n, code,
        backend.stream_handle(x_gates.device),
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
    where = backend.route(x_gates, w_hh, b_hh, h_seq, dy)
    if where == "cpu":
        return gru_scan_bwd_ref(x_gates, w_hh, b_hh, h_seq, dy)
    if where == "meta":
        work.record_gru("gru_scan_bwd", c, b, t, n, x_gates.element_size())
        return (torch.empty_like(x_gates), torch.empty_like(w_hh), torch.empty_like(b_hh))
    code = _check_cuda_inputs((x_gates, h_seq, dy), (w_hh, b_hh))
    dxg = torch.empty_like(x_gates)
    dw = torch.empty(w_hh.shape, dtype=torch.float32, device=w_hh.device)
    db = torch.empty(b_hh.shape, dtype=torch.float32, device=b_hh.device)
    if x_gates.numel() == 0:
        return dxg, dw.zero_().to(w_hh.dtype), db.zero_().to(b_hh.dtype)
    dgo, partial = _scratch(h_seq, c, b, t, n)
    _stage("gru_scan_bwd", (c, b, t, n, slice_rows(n, b * t), code),
           (x_gates, w_hh.float(), b_hh.float(), h_seq, dy),
           (dxg, dgo, partial, dw, db, _wide_scratch(c, b, n, True, x_gates.device)))
    gru_scan_bwd.launches += 1
    return dxg, dw.to(w_hh.dtype), db.to(b_hh.dtype)


# ---------------------------------------------------------------------------
# The backward's stages, one launch each (not on the main path; no count).
# ---------------------------------------------------------------------------


def _stage(name: str, dims: tuple[int, ...], tensors, outs) -> None:
    """Launch C entry point ``name`` on ``tensors`` (inputs, then outputs and
    scratch ``outs``; None passes a null pointer)."""
    err = getattr(_library(), name)(
        *(None if x is None else x.data_ptr() for x in (*tensors, *outs)), *dims,
        backend.stream_handle(tensors[0].device))
    backend.check(err, name)


def _scratch(h_seq: torch.Tensor, c: int, b: int, t: int, n: int):
    """The recurrence's float32 ``d_gh`` output (``dgn``, h_seq's shape, for
    float32 activations; all of ``d_gh``, ``(..., B, T, 3N)``, below) and the
    dW/db stage's per-slice partials."""
    slices = -(-(b * t) // slice_rows(n, b * t))
    width = n if h_seq.dtype == torch.float32 else 3 * n
    return (torch.empty((*h_seq.shape[:-1], width), dtype=torch.float32, device=h_seq.device),
            torch.empty((c, slices, n + 1, 3 * n), dtype=torch.float32, device=h_seq.device))


def _check_f32(*tensors: torch.Tensor) -> None:
    if _check_cuda_inputs(tensors) != DTYPES[torch.float32]:
        raise TypeError("the backward's stage wrappers take float32 tensors")


def stage_recur(x_gates, w_hh, b_hh, h_seq, dy) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse recurrence alone: ``(dx_gates, dgn)``."""
    c, b, t, n = _check_bwd_shapes(x_gates, w_hh, b_hh, h_seq, dy)
    if backend.route(x_gates, w_hh, b_hh, h_seq, dy) == "cpu":
        return gru_bwd_recur_ref(x_gates, w_hh, b_hh, h_seq, dy)
    _check_f32(x_gates, w_hh, b_hh, h_seq, dy)
    dxg, dgn = torch.empty_like(x_gates), torch.empty_like(h_seq)
    _stage("gru_bwd_recur", (c, b, t, n), (x_gates, w_hh, b_hh, h_seq, dy),
           (dxg, dgn, _wide_scratch(c, b, n, True, x_gates.device)))
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
    _check_f32(h_seq, dx_gates, dgn)
    dw = torch.empty((*lead, n, 3 * n), dtype=torch.float32, device=h_seq.device)
    db = torch.empty((*lead, 3 * n), dtype=torch.float32, device=h_seq.device)
    _, partial = _scratch(h_seq, c, b, t, n)
    _stage("gru_bwd_dw", (c, b, t, n, slice_rows(n, b * t)), (h_seq, dx_gates, dgn),
           (partial, dw, db))
    return dw, db


gru_scan.launches = 0
gru_scan_bwd.launches = 0
