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
and scratch with ``torch.empty``, launches the kernel's stages on PyTorch's
current stream (four launches forward, six backward, one C call each) and
adds one to its ``launches`` count.  Scratch: G = C B^T (B, NC, L, L),
which the backward reuses for the head-summed dG, and in the backward the
carries dS (B, NC, H, P, N); the forward's entry states are always formed,
in ``states``.  On CPU tensors a wrapper returns the plain versions from
``ref.py`` and counts nothing.  Padding a ragged sequence to whole chunks
is the caller's (``ops.ssd_full``).

The ``stage_*`` functions launch one stage each, so that the card's checks
can hold each stage against its plain version in ``ref.py``; they count
nothing and the main path does not call them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ssd import ref
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
    "ssd_chunk_scan_fwd": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "ssd_chunk_scan_bwd": ([_P] * 14 + [_I] * 6 + [_P], _I),
    "ssd_stage_cb": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "ssd_stage_local": ([_P] * 5 + [_I] * 7 + [_P], _I),
    "ssd_stage_pass": ([_P] * 2 + [_I] * 7 + [_P], _I),
    "ssd_stage_y": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "ssd_stage_head": ([_P] * 12 + [_I] * 6 + [_P], _I),
    "ssd_stage_dg": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "ssd_stage_dbc": ([_P] * 11 + [_I] * 6 + [_P], _I),
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
    # The entry states are formed either way (scratch when not returned).
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    if xc.numel():
        g = torch.empty((b, nc, l_len, l_len), dtype=torch.float32, device=dev)
        err = _library().ssd_chunk_scan_fwd(
            xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(), cc.data_ptr(),
            y.data_ptr(), states.data_ptr(), g.data_ptr(),
            b, nc, l_len, h, p, n, backend.stream_handle(dev),
        )
        backend.check(err, "ssd_chunk_scan")
        ssd_chunk_scan.launches += 1
    else:
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
    # G = C B^T, then the head-summed dG; the carries F, then dS.
    g = torch.empty((b, nc, l_len, l_len), dtype=torch.float32, device=xc.device)
    ds = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xc.device)
    err = _library().ssd_chunk_scan_bwd(
        *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in grads),
        g.data_ptr(), ds.data_ptr(),
        b, nc, l_len, h, p, n, backend.stream_handle(xc.device),
    )
    backend.check(err, "ssd_chunk_scan_bwd")
    ssd_chunk_scan_bwd.launches += 1
    return grads


ssd_chunk_scan_bwd.launches = 0


# ---------------------------------------------------------------------------
# The stages, one launch each (not on the main path; no count).
# ---------------------------------------------------------------------------


def _stage(name: str, dims: tuple[int, ...], tensors, outs) -> None:
    """Launch stage ``name`` on ``tensors`` (inputs, then outputs ``outs``)."""
    err = getattr(_library(), name)(
        *(t.data_ptr() for t in (*tensors, *outs)), *dims,
        backend.stream_handle(tensors[0].device))
    backend.check(err, name)


def _empty(like: torch.Tensor, *shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def stage_cb(bc, cc) -> torch.Tensor:
    """G = C B^T (B, NC, L, L); on the card only its causal 64 x 64 tiles are
    formed, the rest stays zero."""
    if backend.route(bc, cc) == "cpu":
        return ref.chunk_cb_ref(bc, cc)
    b, nc, l_len, n = bc.shape
    _check_cuda_inputs(l_len, 1, n, bc, cc)
    g = torch.zeros((b, nc, l_len, l_len), dtype=torch.float32, device=bc.device)
    _stage("ssd_stage_cb", (b, nc, l_len, n), (bc, cc), (g,))
    return g


def _local(xs, dtc, cum, ys, backward: bool) -> torch.Tensor:
    b, nc, l_len, h, p = xs.shape
    n = ys.shape[-1]
    _check_cuda_inputs(l_len, p, n, xs, dtc, cum, ys)
    out = _empty(xs, b, nc, h, p, n)
    _stage("ssd_stage_local", (b, nc, l_len, h, p, n, int(backward)), (xs, dtc, cum, ys), (out,))
    return out


def stage_local(xc, dtc, cum, bc) -> torch.Tensor:
    """Every chunk's sum_l indec_l x_l^T B_l (B, NC, H, P, N)."""
    if backend.route(xc, dtc, cum, bc) == "cpu":
        return ref.chunk_local_ref(xc, dtc, cum, bc)
    return _local(xc, dtc, cum, bc, backward=False)


def stage_carry(dy, cum, cc) -> torch.Tensor:
    """Every chunk's F_k = sum_l (e_l dy_l)^T C_l (B, NC, H, P, N)."""
    if backend.route(dy, cum, cc) == "cpu":
        return ref.chunk_carry_ref(dy, cum, cc)
    return _local(dy, cum, cum, cc, backward=True)  # dt is not read for the carry


def stage_pass(local, cum, reverse: bool = False) -> torch.Tensor:
    """The carry over the chunks, on a copy of ``local``."""
    if backend.route(local, cum) == "cpu":
        return ref.state_pass_ref(local, cum, reverse)
    b, nc, h, p, n = local.shape
    l_len = cum.shape[2]
    _check_cuda_inputs(l_len, p, n, local, cum)
    out = local.clone()
    _stage("ssd_stage_pass", (b, nc, l_len, h, p, n, int(reverse)), (out, cum), ())
    return out


def stage_y(xc, dtc, cum, cc, g, states) -> torch.Tensor:
    """y from G and the entry states."""
    if backend.route(xc, dtc, cum, cc, g, states) == "cpu":
        return ref.chunk_y_ref(xc, dtc, cum, cc, g, states)
    b, nc, l_len, h, p = xc.shape
    n = cc.shape[-1]
    _check_cuda_inputs(l_len, p, n, xc, dtc, cum, cc, g, states)
    y = torch.empty_like(xc)
    _stage("ssd_stage_y", (b, nc, l_len, h, p, n), (xc, dtc, cum, cc, g, states), (y,))
    return y


def stage_head(xc, dtc, cum, bc, cc, states, ds, g, dy) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, dcum) from G, the entry states and dS."""
    tensors = (xc, dtc, cum, bc, cc, states, ds, g, dy)
    if backend.route(*tensors) == "cpu":
        return ref.bwd_head_ref(*tensors)
    b, nc, l_len, h, p = xc.shape
    n = bc.shape[-1]
    _check_cuda_inputs(l_len, p, n, *tensors)
    outs = (torch.empty_like(xc), torch.empty_like(dtc), torch.empty_like(cum))
    _stage("ssd_stage_head", (b, nc, l_len, h, p, n), tensors, outs)
    return outs


def stage_dg(xc, dtc, cum, dy) -> torch.Tensor:
    """dG = sum_h dW_h decay_h dt_h (B, NC, L, L); on the card only its
    causal tiles are formed, the rest stays zero."""
    if backend.route(xc, dtc, cum, dy) == "cpu":
        return ref.bwd_dg_ref(xc, dtc, cum, dy)
    b, nc, l_len, h, p = xc.shape
    _check_cuda_inputs(l_len, p, 1, xc, dtc, cum, dy)
    dg = torch.zeros((b, nc, l_len, l_len), dtype=torch.float32, device=xc.device)
    _stage("ssd_stage_dg", (b, nc, l_len, h, p), (xc, dtc, cum, dy), (dg,))
    return dg


def stage_dbc(xc, dtc, cum, bc, cc, states, ds, dg, dy) -> tuple[torch.Tensor, torch.Tensor]:
    """(dB, dC) from dG, the entry states and dS."""
    tensors = (xc, dtc, cum, bc, cc, states, ds, dg, dy)
    if backend.route(*tensors) == "cpu":
        return ref.bwd_dbc_ref(*tensors)
    b, nc, l_len, h, p = xc.shape
    n = bc.shape[-1]
    _check_cuda_inputs(l_len, p, n, *tensors)
    outs = (torch.empty_like(bc), torch.empty_like(cc))
    _stage("ssd_stage_dbc", (b, nc, l_len, h, p, n), tensors, outs)
    return outs
