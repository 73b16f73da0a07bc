"""Mamba2 (state-space duality / SSD) block — arXiv:2405.21060.

The SSD layer computes, per head h with per-step decay ``a_t = exp(dt_t A)``::

    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T          (state:  (head_dim, N))
    y_t = C_t . S_t + D * x_t

Prefill uses the chunked dual form through ``kernels/ssd``: the CUDA kernel
on the card, its plain version on the CPU (the tensors' device decides;
there is no ``use_pallas`` switch).  Decode is the O(1) recurrence on a
cached state, in plain PyTorch; with ``donate=True`` it writes the new
state into the given cache (``copy_``) instead of returning new tensors.
A depthwise causal conv (width 4) precedes the SSM as in the reference
implementation; its decode cache holds the last (d_conv - 1) inputs.  The
casts are the JAX package's: x, dt, B and C go to float32 before the scan,
and y comes back to the block input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels.ssd.ops import ssd_full
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init
from repro_torch.tree import PyTree


def mamba2_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nheads = s.num_heads(d)
    conv_dim = d_in + 2 * s.d_state  # x, B, C all go through the conv
    # in_proj emits [z, x, B, C, dt]
    proj_out = 2 * d_in + 2 * s.d_state + nheads
    in_proj = dense_init(generator, d, proj_out, dtype, device)
    conv_w = torch.randn((s.d_conv, conv_dim), generator=generator, device=generator.device) * 0.1
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.zeros((nheads,), **f32),
        "norm": rmsnorm_init(d_in, dtype, device),
        "out_proj": dense_init(generator, d_in, d, dtype, device),
    }


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nheads = s.num_heads(cfg.d_model)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * s.d_state, nheads], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B, S, C), w: (K, C)."""
    k = w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i : i + s, :] * w[i]
    return F.silu(out + b)


def _ssd_chunk_scan(
    x: torch.Tensor,      # (B, S, H, P)  fp32
    dt: torch.Tensor,     # (B, S, H)     fp32, post-softplus
    A: torch.Tensor,      # (H,)          fp32, negative
    B_mat: torch.Tensor,  # (B, S, N)
    C_mat: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> torch.Tensor:
    """Pad to whole chunks, form the within-chunk cumulative decay, scan
    (``kernels/ssd/ops.py::ssd_full``: the kernel on the card)."""
    return ssd_full(x, dt, A, B_mat, C_mat, chunk=chunk)


def mamba2_apply(params: PyTree, cfg: ArchConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block.  u: (B, S, D) -> (B, S, D)."""
    s_cfg: SSMConfig = cfg.ssm
    b, s, d = u.shape
    d_in = s_cfg.d_inner(d)
    nheads = s_cfg.num_heads(d)

    proj = u @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    x_in, B_mat, C_mat = torch.split(xbc, [d_in, s_cfg.d_state, s_cfg.d_state], dim=-1)

    x_heads = x_in.reshape(b, s, nheads, s_cfg.head_dim).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y = _ssd_chunk_scan(x_heads, dt, A, B_mat.float(), C_mat.float(), s_cfg.chunk_size)
    y = y + x_heads * params["D"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return y @ params["out_proj"]


# --------------------------------------------------------------------------
# decode (O(1) state update)
# --------------------------------------------------------------------------

def mamba2_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> PyTree:
    s: SSMConfig = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nheads = s.num_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.d_state
    return {
        "ssm_state": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device),
        "conv_state": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba2_decode(
    params: PyTree, cfg: ArchConfig, u: torch.Tensor, cache: PyTree, donate: bool = False
) -> tuple[torch.Tensor, PyTree]:
    """One-token SSD step.  u: (B, 1, D).  With ``donate`` the new states
    are written into ``cache``, which is returned; else new tensors."""
    s_cfg: SSMConfig = cfg.ssm
    b, _, d = u.shape
    d_in = s_cfg.d_inner(d)
    nheads = s_cfg.num_heads(d)

    proj = u[:, 0, :] @ params["in_proj"]
    z, xbc_new, dt_raw = _split_proj(proj, cfg)

    # causal conv over [cached inputs, new input]
    conv_in = torch.cat(
        [cache["conv_state"], xbc_new[:, None, :].to(cache["conv_state"].dtype)], dim=1
    )  # (B, d_conv, C)
    conv_out = torch.einsum("bkc,kc->bc", conv_in, params["conv_w"]) + params["conv_b"]
    xbc = F.silu(conv_out)
    new_conv_state = conv_in[:, 1:, :]

    x_in, B_mat, C_mat = torch.split(xbc, [d_in, s_cfg.d_state, s_cfg.d_state], dim=-1)
    x_h = x_in.reshape(b, nheads, s_cfg.head_dim).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])                  # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])                                   # (B, H)

    state = cache["ssm_state"]
    state = state * decay[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhpn", B_mat.float(), dt, x_h
    )
    y = torch.einsum("bn,bhpn->bhp", C_mat.float(), state)
    y = y + x_h * params["D"][None, :, None]
    y = y.reshape(b, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y[:, None, :], cfg.norm_eps)[:, 0]
    out = y @ params["out_proj"]
    if donate:
        cache["ssm_state"].copy_(state)
        cache["conv_state"].copy_(new_conv_state)
        return out[:, None, :], cache
    return out[:, None, :], {"ssm_state": state, "conv_state": new_conv_state}


def mamba2_param_count(cfg: ArchConfig) -> int:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nheads = s.num_heads(d)
    conv_dim = d_in + 2 * s.d_state
    proj_out = 2 * d_in + 2 * s.d_state + nheads
    return (
        d * proj_out
        + s.d_conv * conv_dim + conv_dim
        + 3 * nheads
        + d_in            # norm
        + d_in * d        # out_proj
    )
