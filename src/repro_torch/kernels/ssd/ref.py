"""Plain PyTorch versions of the SSD scan: the CPU path and the card's yardstick.

    S_t = exp(dt_t A) * S_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . S_t

``ssd_ref`` runs that recurrence step by step over the unchunked sequence —
slow but unambiguous.  ``ssd_chunk_scan_ref`` computes what the CUDA kernel
computes, in the chunked layout, chunk by chunk; ``ssd_chunk_states_ref``
gives the chunk-entry states the kernel writes with ``return_states``;
``ssd_chunk_scan_bwd_ref`` is the backward kernel's plain version, one
reverse pass over the chunks from those states.  All compute in float32.
"""

from __future__ import annotations

import torch


def ssd_ref(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)   post-softplus
    a: torch.Tensor,      # (H,)        negative decay rates
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
) -> torch.Tensor:
    batch, s, h, p = x.shape
    n = b_mat.shape[-1]
    x32, dt32, b32, c32 = (t.float() for t in (x, dt, b_mat, c_mat))
    a32 = a.float()
    state = x.new_zeros((batch, h, p, n), dtype=torch.float32)
    ys = []
    for t in range(s):
        decay = torch.exp(dt32[:, t] * a32[None, :])                     # (B, H)
        state = state * decay[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhpn", b32[:, t], dt32[:, t], x32[:, t]
        )
        ys.append(torch.einsum("bn,bhpn->bhp", c32[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)                            # (B, S, H, P)


def _causal(l_len: int, device) -> torch.Tensor:
    idx = torch.arange(l_len, device=device)
    return idx[:, None] >= idx[None, :]                                  # (L, L) causal


def _state_update(state, x_k, dt_k, cum_k, b_k):
    """S <- S * exp(cum_last) + sum_l B_l (exp(cum_last - cum_l) dt_l) x_l."""
    chunk_decay = torch.exp(cum_k[:, -1, :])                             # (B, H)
    in_decay = torch.exp(cum_k[:, -1:, :] - cum_k) * dt_k                # (B, L, H)
    return state * chunk_decay[:, :, None, None] + torch.einsum(
        "bln,blh,blhp->bhpn", b_k, in_decay, x_k
    )


def ssd_chunk_scan_ref(
    xc: torch.Tensor,     # (B, NC, L, H, P)
    dtc: torch.Tensor,    # (B, NC, L, H)
    cum: torch.Tensor,    # (B, NC, L, H)  within-chunk cumulative log-decay
    bc: torch.Tensor,     # (B, NC, L, N)
    cc: torch.Tensor,     # (B, NC, L, N)
) -> torch.Tensor:
    """y (B, NC, L, H, P): the chunked dual form, one chunk at a time."""
    b, nc, l_len, h, p = xc.shape
    causal = _causal(l_len, xc.device)
    x32, dt32, cum32, b32, c32 = (t.float() for t in (xc, dtc, cum, bc, cc))
    state = x32.new_zeros((b, h, p, bc.shape[-1]))
    ys = []
    for k in range(nc):
        x_k, dt_k, cum_k, b_k, c_k = x32[:, k], dt32[:, k], cum32[:, k], b32[:, k], c32[:, k]
        cb = torch.einsum("bln,bmn->blm", c_k, b_k)
        diff = cum_k[:, :, None, :] - cum_k[:, None, :, :]               # (B, L, L, H)
        # Mask inside the exponent: the l < m entries of cum_l - cum_m are
        # large and positive, and exp would overflow.
        decay = torch.exp(torch.where(causal[None, :, :, None], diff, -1e30))
        w = cb[:, :, :, None] * decay * dt_k[:, None, :, :]
        y_intra = torch.einsum("blmh,bmhp->blhp", w, x_k)
        y_inter = torch.einsum("bln,bhpn,blh->blhp", c_k, state, torch.exp(cum_k))
        state = _state_update(state, x_k, dt_k, cum_k, b_k)
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).to(xc.dtype)


def ssd_chunk_states_ref(
    xc: torch.Tensor,
    dtc: torch.Tensor,
    cum: torch.Tensor,
    bc: torch.Tensor,
    cc: torch.Tensor,
) -> torch.Tensor:
    """Chunk-entry states S_k (B, NC, H, P, N) in float32.  S_0 = 0;
    S_{k+1} = S_k * exp(cum_k[-1]) + sum_l B_l (indec_l x_l)."""
    b, nc, l_len, h, p = xc.shape
    x32, dt32, cum32, b32 = (t.float() for t in (xc, dtc, cum, bc))
    state = x32.new_zeros((b, h, p, bc.shape[-1]))
    entries = []
    for k in range(nc):
        entries.append(state)
        state = _state_update(state, x32[:, k], dt32[:, k], cum32[:, k], b32[:, k])
    return torch.stack(entries, dim=1)


def ssd_chunk_scan_bwd_ref(
    xc: torch.Tensor,      # (B, NC, L, H, P)
    dtc: torch.Tensor,     # (B, NC, L, H)
    cum: torch.Tensor,     # (B, NC, L, H)
    bc: torch.Tensor,      # (B, NC, L, N)
    cc: torch.Tensor,      # (B, NC, L, N)
    states: torch.Tensor,  # (B, NC, H, P, N) chunk-entry states
    dy: torch.Tensor,      # (B, NC, L, H, P) output cotangent
) -> tuple[torch.Tensor, ...]:
    """Residual backward: one reverse pass over the chunks, no forward recompute.

    ``cum`` is an independent input: its own cotangent is returned, and the
    caller's cumsum carries it on to dt and A.  Returns
    ``(dxc, ddtc, dcum, dbc, dcc)`` in the inputs' dtypes.
    """
    b, nc, l_len, h, p = xc.shape
    causal = _causal(l_len, xc.device)
    x32, dt32, cum32, b32, c32, s32, dy32 = (
        t.float() for t in (xc, dtc, cum, bc, cc, states, dy))
    ds = x32.new_zeros((b, h, p, bc.shape[-1]))  # cotangent of the state after the chunk
    outs = []
    for k in reversed(range(nc)):
        x_k, dt_k, cum_k, b_k, c_k = x32[:, k], dt32[:, k], cum32[:, k], b32[:, k], c32[:, k]
        s_k, dy_k = s32[:, k], dy32[:, k]
        cb = torch.einsum("bln,bmn->blm", c_k, b_k)
        diff = cum_k[:, :, None, :] - cum_k[:, None, :, :]
        decay = torch.exp(torch.where(causal[None, :, :, None], diff, -1e30))

        # intra-chunk quadratic form, transposed
        w = cb[:, :, :, None] * decay * dt_k[:, None, :, :]
        dw = torch.einsum("blhp,bmhp->blmh", dy_k, x_k)
        dx = torch.einsum("blmh,blhp->bmhp", w, dy_k)
        dcb = torch.einsum("blmh,blmh->blm", dw, decay * dt_k[:, None, :, :])
        ddt = torch.einsum("blmh->bmh", dw * cb[:, :, :, None] * decay)
        term = dw * cb[:, :, :, None] * dt_k[:, None, :, :] * decay
        dcum = term.sum(dim=2) - term.sum(dim=1)
        dc = torch.einsum("blm,bmn->bln", dcb, b_k)
        db = torch.einsum("blm,bln->bmn", dcb, c_k)

        # the carried state's term y_inter = exp(cum_l) C_l . S_k
        sd = torch.exp(cum_k)
        d_cs = dy_k * sd[:, :, :, None]
        dc = dc + torch.einsum("blhp,bhpn->bln", d_cs, s_k)
        ds_from_y = torch.einsum("blhp,bln->bhpn", d_cs, c_k)
        y_inter = torch.einsum("bln,bhpn->blhp", c_k, s_k) * sd[:, :, :, None]
        dcum = dcum + torch.einsum("blhp,blhp->blh", dy_k, y_inter)

        # the state update S_k+1 = S_k exp(cum_last) + sum_l B_l indec_l x_l, transposed
        cd = torch.exp(cum_k[:, -1, :])
        indec = torch.exp(cum_k[:, -1:, :] - cum_k) * dt_k
        ds_in = ds * cd[:, :, None, None] + ds_from_y
        g = torch.einsum("bhpn,bln,blhp->blh", ds, b_k, x_k)
        db = db + torch.einsum("bhpn,blh,blhp->bln", ds, indec, x_k)
        dx = dx + torch.einsum("bhpn,bln,blh->blhp", ds, b_k, indec)
        ddt = ddt + g * torch.exp(cum_k[:, -1:, :] - cum_k)
        dcum = dcum - g * indec
        last = torch.einsum("bhpn,bhpn->bh", ds, s_k) * cd + (g * indec).sum(dim=1)
        dcum[:, -1, :] += last
        outs.append((dx, ddt, dcum, db, dc))
        ds = ds_in
    outs.reverse()
    return tuple(
        torch.stack([o[i] for o in outs], dim=1).to(like.dtype)
        for i, like in enumerate((xc, dtc, cum, bc, cc))
    )
