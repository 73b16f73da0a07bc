"""Plain PyTorch versions of the GRU recurrence kernels.

``gru_scan_ref`` and ``gru_scan_bwd_ref`` mirror the JAX package's
``kernels/gru_scan/ref.py``: a Python loop over time, float32 accumulation,
outputs in the input dtype.  Leading dimensions broadcast, so a client axis
``(C, B, T, 3N)`` with per-client weights ``(C, N, 3N)`` works as is.  The
CUDA kernel wrappers use them for CPU tensors, and tests and
``chip_smoke.py`` hold the kernels against them.  ``gru_bwd_recur_ref`` and
``gru_bwd_dw_ref`` are the plain twins of the backward's two stage kernels.
The forward and the backward each run inside a ``recurrence`` range.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import marks_recurrence


def _gates(gx: torch.Tensor, gh: torch.Tensor, n: int):
    xr, xz, xn = gx.split(n, dim=-1)
    hr, hz, hn = gh.split(n, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    cand = torch.tanh(xn + r * hn)
    return r, z, cand, hn


@marks_recurrence
def gru_scan_ref(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """x_gates: (..., B, T, 3N) precomputed input projections -> h_seq (..., B, T, N)."""
    n = x_gates.shape[-1] // 3
    w32 = w_hh.float()
    b32 = b_hh.float().unsqueeze(-2)
    x32 = x_gates.float()
    h = x32.new_zeros((*x32.shape[:-2], n))
    outs = []
    for t in range(x32.shape[-2]):
        gh = h @ w32 + b32
        _, z, cand, _ = _gates(x32[..., t, :], gh, n)
        h = (1.0 - z) * cand + z * h
        outs.append(h)
    return torch.stack(outs, dim=-2).to(x_gates.dtype)


@marks_recurrence
def gru_scan_bwd_ref(
    x_gates: torch.Tensor,  # (..., B, T, 3N) forward input
    w_hh: torch.Tensor,     # (..., N, 3N)
    b_hh: torch.Tensor,     # (..., 3N)
    h_seq: torch.Tensor,    # (..., B, T, N)  forward output (the residual)
    dy: torch.Tensor,       # (..., B, T, N)  output cotangent
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual backward: one reverse loop, no forward recompute.

    Gates are rebuilt per step from ``h_{t-1}`` read out of ``h_seq``.
    Returns ``(dx_gates, dw_hh, db_hh)``.
    """
    n = x_gates.shape[-1] // 3
    t_len = x_gates.shape[-2]
    w32 = w_hh.float()
    b32 = b_hh.float().unsqueeze(-2)
    x32, h32, dy32 = x_gates.float(), h_seq.float(), dy.float()
    dh = h32.new_zeros((*h32.shape[:-2], n))
    dw = torch.zeros_like(w32)
    db = torch.zeros_like(b32)
    d_gx_seq = [None] * t_len
    for t in reversed(range(t_len)):
        h_prev = h32[..., t - 1, :] if t > 0 else torch.zeros_like(dh)
        gh = h_prev @ w32 + b32
        r, z, cand, hn = _gates(x32[..., t, :], gh, n)

        dh_total = dy32[..., t, :] + dh
        dz = dh_total * (h_prev - cand)
        da_n = dh_total * (1.0 - z) * (1.0 - cand * cand)
        da_r = da_n * hn * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        d_gx_seq[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        d_gh = torch.cat([da_r, da_z, da_n * r], dim=-1)

        dh = dh_total * z + d_gh @ w32.transpose(-1, -2)
        dw = dw + h_prev.transpose(-1, -2) @ d_gh
        db = db + d_gh.sum(dim=-2, keepdim=True)
    dx_gates = torch.stack(d_gx_seq, dim=-2).to(x_gates.dtype)
    return dx_gates, dw.to(w_hh.dtype), db.squeeze(-2).to(b_hh.dtype)


# The two stages of the CUDA backward, as plain versions: the reverse
# recurrence, then the weight cotangents summed over every (row, step).
# gru_bwd_dw_ref(h_seq, *gru_bwd_recur_ref(...)) equals gru_scan_bwd_ref's
# dW and db; the recurrence's dx_gates equals its dx_gates.


def gru_bwd_recur_ref(
    x_gates: torch.Tensor,  # (..., B, T, 3N)
    w_hh: torch.Tensor,     # (..., N, 3N)
    b_hh: torch.Tensor,     # (..., 3N)
    h_seq: torch.Tensor,    # (..., B, T, N)
    dy: torch.Tensor,       # (..., B, T, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ``(dx_gates, dgn)``: the gate cotangents and ``r * da_n`` (..., B, T, N),
    the n-part of ``d_gh``; its r- and z-parts are those of ``dx_gates``."""
    n = x_gates.shape[-1] // 3
    w32 = w_hh.float()
    b32 = b_hh.float().unsqueeze(-2)
    x32, h32, dy32 = x_gates.float(), h_seq.float(), dy.float()
    dh = h32.new_zeros((*h32.shape[:-2], n))
    dx_seq, dgn_seq = [], []
    for t in reversed(range(x32.shape[-2])):
        h_prev = h32[..., t - 1, :] if t > 0 else torch.zeros_like(dh)
        r, z, cand, hn = _gates(x32[..., t, :], h_prev @ w32 + b32, n)
        dh_total = dy32[..., t, :] + dh
        da_n = dh_total * (1.0 - z) * (1.0 - cand * cand)
        da_r = da_n * hn * r * (1.0 - r)
        da_z = dh_total * (h_prev - cand) * z * (1.0 - z)
        d_gh = torch.cat([da_r, da_z, da_n * r], dim=-1)
        dh = dh_total * z + d_gh @ w32.transpose(-1, -2)
        dx_seq.append(torch.cat([da_r, da_z, da_n], dim=-1))
        dgn_seq.append(da_n * r)
    dx_gates = torch.stack(dx_seq[::-1], dim=-2).to(x_gates.dtype)
    return dx_gates, torch.stack(dgn_seq[::-1], dim=-2).to(x_gates.dtype)


def gru_bwd_dw_ref(
    h_seq: torch.Tensor,     # (..., B, T, N)
    dx_gates: torch.Tensor,  # (..., B, T, 3N)
    dgn: torch.Tensor,       # (..., B, T, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ``(dw_hh, db_hh)``: ``sum_{b,t} h_{t-1}^T d_gh`` and ``sum_{b,t} d_gh``,
    with ``h_{-1} = 0`` and ``d_gh = (dx_r, dx_z, dgn)``."""
    n = h_seq.shape[-1]
    h32 = h_seq.float()
    h_prev = torch.cat([torch.zeros_like(h32[..., :1, :]), h32[..., :-1, :]], dim=-2)
    d_gh = torch.cat([dx_gates[..., : 2 * n].float(), dgn.float()], dim=-1)
    h_rows = h_prev.flatten(-3, -2)
    g_rows = d_gh.flatten(-3, -2)
    dw = h_rows.transpose(-1, -2) @ g_rows
    return dw.to(h_seq.dtype), g_rows.sum(dim=-2).to(h_seq.dtype)
