"""Wrappers of the Hopper SSD chunked-scan kernels (``csrc/ssd.cu``).

``ssd_chunk_scan`` replaces the JAX package's Pallas ``ssd_chunk_scan``:
chunked inputs ``x (B, NC, L, H, P)``, ``dt`` and ``cum (B, NC, L, H)``,
``b_mat`` and ``c_mat (B, NC, L, N)`` shared across heads, to
``y (B, NC, L, H, P)``; with ``return_states`` also the float32 chunk-entry
states ``(B, NC, H, P, N)``.  ``ssd_chunk_scan_bwd`` replaces the Pallas
``ssd_chunk_scan_bwd``: from those states and the cotangent ``dy`` to
``(dx, ddt, dcum, db, dc)`` in the inputs' shapes.

The kernels take what the reference takes.  Inputs (and ``dy``) of one of
float32, bfloat16 and float16 run in that dtype: loads widened to float32,
float32 arithmetic, each output rounded once to the dtype.  Inputs that mix
those three are cast to float32 (exact), run in float32, and each output
comes back in its own input's dtype, as the reference computes in float32
and stores in each output's dtype.  The states stay float32.  Any chunk
length up to the longest that the kernels' shared memory holds, any head
dim and state size, and any number of (batch, chunk) rows: the
kernels take P in 64-column tiles, N in any number of 64-column halves and
the rows in launches of at most 65,535.

On CUDA tensors a wrapper checks dtypes (another dtype raises
``TypeError``), contiguity, device and shape (``ValueError``; the library
says which shapes its kernels take, ``ssd_takes_shape``), allocates its
outputs and scratch with ``torch.empty``, launches the kernel's stages on
PyTorch's current stream (one C call) and adds one to its ``launches``
count.  Scratch: G = C B^T (B, NC, L, L), which the backward reuses for the
head-summed dG, in the backward the carries dS (B, NC, H, P, N) and, above
P = 64, the float32 partials of ddt and dcum (2, B, NC, L, H, ceil(P/64));
the forward's entry states are always formed, in ``states``.  On CPU
tensors a wrapper returns the plain versions from ``ref.py`` and counts
nothing.  On meta tensors a wrapper allocates what the card route
allocates (outputs and scratch) on the meta device, records the call's work
for the dry run (``kernels/work.py``) and counts nothing.  Padding a ragged
sequence to whole chunks is the caller's (``ops.ssd_full``).

The ``stage_*`` functions launch one stage each, so that the card's checks
can hold each stage against its plain version in ``ref.py``; they take one
storage dtype (G, the states, dS and dG in float32), count nothing, and the
main path does not call them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, work
from repro_torch.kernels.ssd import ref
from repro_torch.kernels.ssd.ref import (
    ssd_chunk_scan_bwd_ref,
    ssd_chunk_scan_ref,
    ssd_chunk_states_ref,
)

# The kernels' code for each storage dtype (csrc/ssd.cu's `with_dtype`).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
# Pointers and the stream as c_void_p: a bare Python int would pass as 32 bits.
_SIGNATURES = {
    "ssd_chunk_scan_fwd": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "ssd_chunk_scan_bwd": ([_P] * 15 + [_I] * 7 + [_P], _I),
    "ssd_stage_cb": ([_P] * 3 + [_I] * 5 + [_P], _I),
    "ssd_stage_local": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "ssd_stage_pass": ([_P] * 2 + [_I] * 8 + [_P], _I),
    "ssd_stage_y": ([_P] * 7 + [_I] * 7 + [_P], _I),
    "ssd_stage_head": ([_P] * 13 + [_I] * 7 + [_P], _I),
    "ssd_stage_dg": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "ssd_stage_dbc": ([_P] * 11 + [_I] * 7 + [_P], _I),
    "ssd_takes_shape": ([_I] * 6, _I),
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


def p_tiles(p: int) -> int:
    """The 64-column tiles the kernels take P in."""
    return -(-p // 64)


def _check_cuda_inputs(dims: tuple[int, ...], data, float32=(),
                       what: str = "ssd_chunk_scan") -> int | None:
    """Check the tensors a kernel is handed and its sizes ``dims`` (B, NC,
    L, H, P, N); -> the dtype code of ``data`` (the storage-typed tensors),
    or None when they mix float32, bfloat16 and float16.  ``float32`` are
    tensors the kernels take in float32 only."""
    for t in (*data, *float32):
        if t.dtype not in DTYPES:
            raise TypeError(f"the {what} kernel takes float32, bfloat16 or float16 tensors, "
                            f"got {t.dtype}")
    for t in float32:
        if t.dtype != torch.float32:
            raise TypeError(f"the {what} kernel takes its states and scratch in float32, "
                            f"got {t.dtype}")
    for t in (*data, *float32):
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors")
    if len({t.device for t in (*data, *float32)}) != 1:
        raise ValueError(f"the {what} kernel takes tensors on one device")
    if all(dims) and not _library().ssd_takes_shape(*dims):  # empty calls launch nothing
        raise ValueError(f"the {what} kernels do not take (B, NC, L, H, P, N) = {dims} "
                         "(csrc/ssd.cu's shapes_ok)")
    dtypes = {t.dtype for t in data}
    return DTYPES[dtypes.pop()] if len(dtypes) == 1 else None


def ssd_chunk_scan(
    xc: torch.Tensor,    # (B, NC, L, H, P)
    dtc: torch.Tensor,   # (B, NC, L, H)
    cum: torch.Tensor,   # (B, NC, L, H)  within-chunk cumulative log-decay
    bc: torch.Tensor,    # (B, NC, L, N)
    cc: torch.Tensor,    # (B, NC, L, N)
    *,
    return_states: bool = False,
):
    """y (B, NC, L, H, P) in x's dtype; with ``return_states`` also the
    float32 chunk-entry states (B, NC, H, P, N)."""
    b, nc, l_len, h, p, n = _check_shapes(xc, dtc, cum, bc, cc)
    where = backend.route(xc, dtc, cum, bc, cc)
    if where == "cpu":
        y = ssd_chunk_scan_ref(xc, dtc, cum, bc, cc)
        if return_states:
            return y, ssd_chunk_states_ref(xc, dtc, cum, bc, cc)
        return y
    if where == "meta":
        return _meta_forward((b, nc, l_len, h, p, n), (xc, dtc, cum, bc, cc), return_states)
    code = _check_cuda_inputs((b, nc, l_len, h, p, n), (xc, dtc, cum, bc, cc))
    if code is None:  # mixed dtypes: float32 inside, y in x's dtype
        y, states = ssd_chunk_scan(*(t.float() for t in (xc, dtc, cum, bc, cc)),
                                   return_states=True)
        y = y.to(xc.dtype)
        return (y, states) if return_states else y
    dev = xc.device
    y = torch.empty_like(xc)
    # The entry states are formed either way (scratch when not returned).
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    if xc.numel():
        g = torch.empty((b, nc, l_len, l_len), dtype=torch.float32, device=dev)
        err = _library().ssd_chunk_scan_fwd(
            xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(), cc.data_ptr(),
            y.data_ptr(), states.data_ptr(), g.data_ptr(),
            b, nc, l_len, h, p, n, code, backend.stream_handle(dev),
        )
        backend.check(err, "ssd_chunk_scan")
        ssd_chunk_scan.launches += 1
    else:
        states.zero_()  # an empty sequence leaves every entry state at S_0 = 0
    return (y, states) if return_states else y


ssd_chunk_scan.launches = 0


def _parts(b: int, nc: int, l_len: int, h: int, p: int, device) -> torch.Tensor | None:
    """Above P = 64, the float32 partials of ddt and dcum, one a p-tile."""
    if p_tiles(p) == 1:
        return None
    return torch.empty((2, b, nc, l_len, h, p_tiles(p)), dtype=torch.float32, device=device)


def ssd_chunk_scan_bwd(
    xc: torch.Tensor,      # (B, NC, L, H, P)
    dtc: torch.Tensor,     # (B, NC, L, H)
    cum: torch.Tensor,     # (B, NC, L, H)
    bc: torch.Tensor,      # (B, NC, L, N)
    cc: torch.Tensor,      # (B, NC, L, N)
    states: torch.Tensor,  # (B, NC, H, P, N) float32 chunk-entry states
    dy: torch.Tensor,      # (B, NC, L, H, P)
) -> tuple[torch.Tensor, ...]:
    """``(dx, ddt, dcum, db, dc)`` in the shapes and dtypes of ``(xc, dtc,
    cum, bc, cc)``.

    ``cum`` is treated as an independent input: its cotangent is returned,
    not folded into ``ddt``."""
    b, nc, l_len, h, p, n = _check_shapes(xc, dtc, cum, bc, cc)
    for name, t, want in (("states", states, (b, nc, h, p, n)), ("dy", dy, tuple(xc.shape))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want} for x {tuple(xc.shape)}")
    tensors = (xc, dtc, cum, bc, cc, states, dy)
    where = backend.route(*tensors)
    if where == "cpu":
        return ssd_chunk_scan_bwd_ref(*tensors)
    inputs = (xc, dtc, cum, bc, cc)
    if where == "meta":
        return _meta_backward((b, nc, l_len, h, p, n), (*inputs, dy))
    code = _check_cuda_inputs((b, nc, l_len, h, p, n), (*inputs, dy), (states,),
                              what="ssd_chunk_scan_bwd")
    if code is None:  # mixed dtypes: float32 inside, each cotangent in its input's dtype
        grads = ssd_chunk_scan_bwd(*(t.float() for t in inputs), states, dy.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))
    grads = tuple(torch.empty_like(t) for t in inputs)
    if not xc.numel():
        return tuple(g.zero_() for g in grads)
    # G = C B^T, then the head-summed dG; the carries F, then dS.
    g = torch.empty((b, nc, l_len, l_len), dtype=torch.float32, device=xc.device)
    ds = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xc.device)
    parts = _parts(b, nc, l_len, h, p, xc.device)
    err = _library().ssd_chunk_scan_bwd(
        *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in grads),
        g.data_ptr(), ds.data_ptr(), None if parts is None else parts.data_ptr(),
        b, nc, l_len, h, p, n, code, backend.stream_handle(xc.device),
    )
    backend.check(err, "ssd_chunk_scan_bwd")
    ssd_chunk_scan_bwd.launches += 1
    return grads


ssd_chunk_scan_bwd.launches = 0


# ---------------------------------------------------------------------------
# The meta route: what the card allocates, and the call's work, no launch.
# ---------------------------------------------------------------------------


def _elem(tensors) -> int:
    """Bytes an element the kernels run in: the inputs' one dtype, or
    float32 where they mix dtypes."""
    dtypes = {t.dtype for t in tensors}
    return tensors[0].element_size() if len(dtypes) == 1 else 4


def _meta_scratch(b: int, nc: int, l_len: int, *sizes: tuple[int, ...]) -> None:
    """Allocate and drop the card route's float32 scratch: G (B, NC, L, L)
    and ``sizes``, so that a live-memory count of the step sees it."""
    for shape in ((b, nc, l_len, l_len), *sizes):
        torch.empty(shape, dtype=torch.float32, device="meta")


def _meta_forward(shape: tuple[int, ...], inputs, return_states: bool):
    b, nc, l_len, h, p, n = shape
    work.record_ssd("ssd_chunk_scan", shape, _elem(inputs))
    y = torch.empty_like(inputs[0])
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device="meta")
    _meta_scratch(b, nc, l_len)
    return (y, states) if return_states else y


def _meta_backward(shape: tuple[int, ...], tensors):
    """``tensors``: x, dt, cum, B, C and dy; the grads take the first five's
    shapes and dtypes."""
    b, nc, l_len, h, p, n = shape
    work.record_ssd("ssd_chunk_scan_bwd", shape, _elem(tensors))
    grads = tuple(torch.empty_like(t) for t in tensors[:5])
    parts = (() if p_tiles(p) == 1 else ((2, b, nc, l_len, h, p_tiles(p)),))
    _meta_scratch(b, nc, l_len, (b, nc, h, p, n), *parts)
    return grads


# ---------------------------------------------------------------------------
# The stages, one launch each (not on the main path; no count).
# ---------------------------------------------------------------------------


def _stage(name: str, dims: tuple[int, ...], tensors, outs, code: int = 0) -> None:
    """Launch stage ``name`` on ``tensors`` (inputs, then outputs ``outs``; a
    None is a null pointer) with storage dtype ``code``."""
    err = getattr(_library(), name)(
        *(None if t is None else t.data_ptr() for t in (*tensors, *outs)), *dims, code,
        backend.stream_handle(tensors[0].device))
    backend.check(err, name)


def _stage_code(dims: tuple[int, ...], data, float32=()) -> int:
    """``_check_cuda_inputs`` for a stage, whose storage-typed tensors share
    one dtype."""
    code = _check_cuda_inputs(dims, data, float32, what="SSD stage")
    if code is None:
        raise TypeError("an SSD stage takes its x, dt, cum, B, C and dy in one dtype, got "
                        f"{sorted({str(t.dtype) for t in data})}")
    return code


def _empty(like: torch.Tensor, *shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def stage_cb(bc, cc) -> torch.Tensor:
    """G = C B^T (B, NC, L, L), float32; on the card only its causal 64 x 64
    tiles are formed, the rest stays zero."""
    if backend.route(bc, cc) == "cpu":
        return ref.chunk_cb_ref(bc, cc)
    b, nc, l_len, n = bc.shape
    code = _stage_code((b, nc, l_len, 1, 1, n), (bc, cc))
    g = torch.zeros((b, nc, l_len, l_len), dtype=torch.float32, device=bc.device)
    _stage("ssd_stage_cb", (b, nc, l_len, n), (bc, cc), (g,), code)
    return g


def _local(xs, dtc, cum, ys, backward: bool) -> torch.Tensor:
    b, nc, l_len, h, p = xs.shape
    n = ys.shape[-1]
    code = _stage_code((b, nc, l_len, h, p, n), (xs, dtc, cum, ys))
    out = _empty(xs, b, nc, h, p, n)
    _stage("ssd_stage_local", (b, nc, l_len, h, p, n, int(backward)), (xs, dtc, cum, ys), (out,),
           code)
    return out


def stage_local(xc, dtc, cum, bc) -> torch.Tensor:
    """Every chunk's sum_l indec_l x_l^T B_l (B, NC, H, P, N), float32."""
    if backend.route(xc, dtc, cum, bc) == "cpu":
        return ref.chunk_local_ref(xc, dtc, cum, bc)
    return _local(xc, dtc, cum, bc, backward=False)


def stage_carry(dy, cum, cc) -> torch.Tensor:
    """Every chunk's F_k = sum_l (e_l dy_l)^T C_l (B, NC, H, P, N), float32."""
    if backend.route(dy, cum, cc) == "cpu":
        return ref.chunk_carry_ref(dy, cum, cc)
    return _local(dy, cum, cum, cc, backward=True)  # dt is not read for the carry


def stage_pass(local, cum, reverse: bool = False) -> torch.Tensor:
    """The carry over the chunks, on a float32 copy of ``local``."""
    if backend.route(local, cum) == "cpu":
        return ref.state_pass_ref(local, cum, reverse)
    b, nc, h, p, n = local.shape
    l_len = cum.shape[2]
    code = _stage_code((b, nc, l_len, h, p, n), (cum,), (local,))
    out = local.clone()
    _stage("ssd_stage_pass", (b, nc, l_len, h, p, n, int(reverse)), (out, cum), (), code)
    return out


def stage_y(xc, dtc, cum, cc, g, states) -> torch.Tensor:
    """y from G and the entry states, in x's dtype."""
    if backend.route(xc, dtc, cum, cc, g, states) == "cpu":
        return ref.chunk_y_ref(xc, dtc, cum, cc, g, states)
    b, nc, l_len, h, p = xc.shape
    n = cc.shape[-1]
    code = _stage_code((b, nc, l_len, h, p, n), (xc, dtc, cum, cc), (g, states))
    y = torch.empty_like(xc)
    _stage("ssd_stage_y", (b, nc, l_len, h, p, n), (xc, dtc, cum, cc, g, states), (y,), code)
    return y


def stage_head(xc, dtc, cum, bc, cc, states, ds, g, dy) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, dcum) from G, the entry states and dS, in the inputs' dtype."""
    tensors = (xc, dtc, cum, bc, cc, states, ds, g, dy)
    if backend.route(*tensors) == "cpu":
        return ref.bwd_head_ref(*tensors)
    b, nc, l_len, h, p = xc.shape
    n = bc.shape[-1]
    code = _stage_code((b, nc, l_len, h, p, n), (xc, dtc, cum, bc, cc, dy), (states, ds, g))
    outs = (torch.empty_like(xc), torch.empty_like(dtc), torch.empty_like(cum))
    _stage("ssd_stage_head", (b, nc, l_len, h, p, n), tensors,
           (*outs, _parts(b, nc, l_len, h, p, xc.device)), code)
    return outs


def stage_dg(xc, dtc, cum, dy) -> torch.Tensor:
    """dG = sum_h dW_h decay_h dt_h (B, NC, L, L), float32; on the card only
    its causal tiles are formed, the rest stays zero."""
    if backend.route(xc, dtc, cum, dy) == "cpu":
        return ref.bwd_dg_ref(xc, dtc, cum, dy)
    b, nc, l_len, h, p = xc.shape
    code = _stage_code((b, nc, l_len, h, p, 1), (xc, dtc, cum, dy))
    dg = torch.zeros((b, nc, l_len, l_len), dtype=torch.float32, device=xc.device)
    _stage("ssd_stage_dg", (b, nc, l_len, h, p), (xc, dtc, cum, dy), (dg,), code)
    return dg


def stage_dbc(xc, dtc, cum, bc, cc, states, ds, dg, dy) -> tuple[torch.Tensor, torch.Tensor]:
    """(dB, dC) from dG, the entry states and dS, in the inputs' dtype."""
    tensors = (xc, dtc, cum, bc, cc, states, ds, dg, dy)
    if backend.route(*tensors) == "cpu":
        return ref.bwd_dbc_ref(*tensors)
    b, nc, l_len, h, p = xc.shape
    n = bc.shape[-1]
    code = _stage_code((b, nc, l_len, h, p, n), (xc, dtc, cum, bc, cc, dy), (states, ds, dg))
    outs = (torch.empty_like(bc), torch.empty_like(cc))
    _stage("ssd_stage_dbc", (b, nc, l_len, h, p, n), tensors, outs, code)
    return outs
