"""Plain PyTorch versions of the SSD scan: the CPU path and the card's yardstick.

    S_t = exp(dt_t A) * S_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . S_t

``ssd_ref`` runs that recurrence step by step over the unchunked sequence —
slow but unambiguous.  ``ssd_chunk_scan_ref`` computes what the CUDA kernel
computes, in the chunked layout, chunk by chunk; ``ssd_chunk_states_ref``
gives the chunk-entry states the kernel writes with ``return_states``;
``ssd_chunk_scan_bwd_ref`` is the backward kernel's plain version, one
reverse pass over the chunks from those states.  All compute in float32
(float64 for float64 tensors, to measure the kernels' rounding);
those three each run inside a ``recurrence`` range.

The CUDA kernels compute the same functions in stages (``csrc/ssd.cu``):
per-chunk work in parallel, only the state carry in sequence.  Each stage
has its plain version below (``chunk_cb_ref`` ... ``bwd_dbc_ref``), and
``ssd_chunk_scan_stages_ref`` and ``ssd_chunk_scan_bwd_stages_ref`` compose
them.  The tests hold the compositions against the JAX package, and the card
holds each stage kernel against its plain stage.  Nothing on the main path
calls them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import marks_recurrence


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The arithmetic type: float32, as the kernels compute; float64 for
    float64 tensors (the card's checks of the kernels' rounding)."""
    return t if t.dtype == torch.float64 else t.float()


def ssd_ref(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)   post-softplus
    a: torch.Tensor,      # (H,)        negative decay rates
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
) -> torch.Tensor:
    batch, s, h, p = x.shape
    n = b_mat.shape[-1]
    x32, dt32, b32, c32 = (_wide(t) for t in (x, dt, b_mat, c_mat))
    a32 = _wide(a)
    state = x32.new_zeros((batch, h, p, n))
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


@marks_recurrence
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
    x32, dt32, cum32, b32, c32 = (_wide(t) for t in (xc, dtc, cum, bc, cc))
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


@marks_recurrence
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
    x32, dt32, cum32, b32 = (_wide(t) for t in (xc, dtc, cum, bc))
    state = x32.new_zeros((b, h, p, bc.shape[-1]))
    entries = []
    for k in range(nc):
        entries.append(state)
        state = _state_update(state, x32[:, k], dt32[:, k], cum32[:, k], b32[:, k])
    return torch.stack(entries, dim=1)


@marks_recurrence
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
        _wide(t) for t in (xc, dtc, cum, bc, cc, states, dy))
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


# ---------------------------------------------------------------------------
# The kernels' stages.  Layouts: G, dG (B, NC, L, L); states, local states,
# the backward's carries F and dS (B, NC, H, P, N).
# ---------------------------------------------------------------------------


def _decay(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_l - cum_m) for m <= l, else 0: (B, NC, L, L, H)."""
    causal = _causal(cum.shape[2], cum.device)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.exp(torch.where(causal[None, None, :, :, None], diff, -1e30))


def _indec(dtc: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_last - cum_l) dt_l: (B, NC, L, H)."""
    return torch.exp(cum[:, :, -1:, :] - cum) * dtc


def chunk_cb_ref(bc: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """G = C B^T of each (batch, chunk), shared by the heads: (B, NC, L, L)."""
    return torch.einsum("bkln,bkmn->bklm", _wide(cc), _wide(bc))


def chunk_local_ref(xc, dtc, cum, bc) -> torch.Tensor:
    """Each chunk's own contribution to the state, sum_l indec_l x_l^T B_l."""
    return torch.einsum("bklh,bklhp,bkln->bkhpn", _indec(_wide(dtc), _wide(cum)),
                        _wide(xc), _wide(bc))


def chunk_carry_ref(dy, cum, cc) -> torch.Tensor:
    """The backward's carry from each chunk's outputs, F_k = sum_l (e_l dy_l)^T C_l."""
    return torch.einsum("bklh,bklhp,bkln->bkhpn", torch.exp(_wide(cum)), _wide(dy),
                        _wide(cc))


def state_pass_ref(local: torch.Tensor, cum: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The carry, in chunk order (reversed for the backward):
    out[k] = s; s = s exp(cum_last of k) + local[k], from s = 0.

    Forward: chunk-local states to entry states S_k.  Reverse: F to dS_k, the
    cotangent of each chunk's exit state."""
    nc = local.shape[1]
    decay = torch.exp(_wide(cum)[:, :, -1, :])[..., None, None]     # (B, NC, H, 1, 1)
    s = torch.zeros_like(_wide(local[:, 0]))
    out = [None] * nc
    for k in (reversed(range(nc)) if reverse else range(nc)):
        out[k] = s
        s = s * decay[:, k] + _wide(local[:, k])
    return torch.stack(out, dim=1)


def chunk_y_ref(xc, dtc, cum, cc, g, states) -> torch.Tensor:
    """y from G and the entry states: (G decay dt_m) x + e_l C_l . S_k."""
    x32, dt32, cum32, c32 = (_wide(t) for t in (xc, dtc, cum, cc))
    w = _wide(g)[..., None] * _decay(cum32) * dt32[:, :, None, :, :]
    return (torch.einsum("bklmh,bkmhp->bklhp", w, x32)
            + torch.einsum("bkln,bkhpn,bklh->bklhp", c32, _wide(states), torch.exp(cum32)))


def bwd_head_ref(xc, dtc, cum, bc, cc, states, ds, g, dy) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, dcum) from G, the entry states S_k and dS_k; the last row's
    dcum term as <dS_k, S_k+1>."""
    x32, dt32, cum32, b32, c32, s32, ds32, dy32 = (
        _wide(t) for t in (xc, dtc, cum, bc, cc, states, ds, dy))
    decay = _decay(cum32)
    g5 = _wide(g)[..., None]
    dw = torch.einsum("bklhp,bkmhp->bklmh", dy32, x32)
    q = dw * g5 * decay
    v = torch.einsum("bkln,bkhpn->bklhp", b32, ds32)
    gl = (x32 * v).sum(-1)
    z = (dy32 * torch.einsum("bkln,bkhpn->bklhp", c32, s32)).sum(-1)
    in_decay = torch.exp(cum32[:, :, -1:, :] - cum32)
    indec = in_decay * dt32
    dx = (torch.einsum("bklmh,bklhp->bkmhp", g5 * decay * dt32[:, :, None], dy32)
          + indec[..., None] * v)
    col = q.sum(2)
    ddt = col + gl * in_decay
    dcum = ((q * dt32[:, :, None]).sum(3) - dt32 * col + torch.exp(cum32) * z - gl * indec)
    dcum[:, :-1, -1, :] += torch.einsum("bkhpn,bkhpn->bkh", ds32[:, :-1], s32[:, 1:])
    return dx, ddt, dcum


def bwd_dg_ref(xc, dtc, cum, dy) -> torch.Tensor:
    """dG = sum_h (dy_h x_h^T) decay_h dt_h[m]: (B, NC, L, L)."""
    dw = torch.einsum("bklhp,bkmhp->bklmh", _wide(dy), _wide(xc))
    return torch.einsum("bklmh,bklmh,bkmh->bklm", dw, _decay(_wide(cum)), _wide(dtc))


def bwd_dbc_ref(xc, dtc, cum, bc, cc, states, ds, dg, dy) -> tuple[torch.Tensor, torch.Tensor]:
    """(dB, dC): dG^T C + [indec x] [dS] and dG B + [e dy] [S], the heads summed."""
    x32, dt32, cum32, dy32 = (_wide(t) for t in (xc, dtc, cum, dy))
    dg32 = _wide(dg)
    db = (torch.einsum("bklm,bkln->bkmn", dg32, _wide(cc))
          + torch.einsum("bklh,bklhp,bkhpn->bkln", _indec(dt32, cum32), x32, _wide(ds)))
    dc = (torch.einsum("bklm,bkmn->bkln", dg32, _wide(bc))
          + torch.einsum("bklh,bklhp,bkhpn->bkln", torch.exp(cum32), dy32, _wide(states)))
    return db, dc


def ssd_chunk_scan_stages_ref(xc, dtc, cum, bc, cc) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, entry states) through the forward kernel's stages."""
    g = chunk_cb_ref(bc, cc)
    states = state_pass_ref(chunk_local_ref(xc, dtc, cum, bc), cum)
    return chunk_y_ref(xc, dtc, cum, cc, g, states), states


def ssd_chunk_scan_bwd_stages_ref(xc, dtc, cum, bc, cc, states, dy) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, dcum, db, dc) through the backward kernel's stages."""
    g = chunk_cb_ref(bc, cc)
    ds = state_pass_ref(chunk_carry_ref(dy, cum, cc), cum, reverse=True)
    dx, ddt, dcum = bwd_head_ref(xc, dtc, cum, bc, cc, states, ds, g, dy)
    db, dc = bwd_dbc_ref(xc, dtc, cum, bc, cc, states, ds, bwd_dg_ref(xc, dtc, cum, dy), dy)
    return dx, ddt, dcum, db, dc
