"""Attention layers: GQA (qk-norm, sliding window) and DeepSeek's MLA.

Train and prefill run ``blockwise_attention``: a Python loop over KV chunks
with an online softmax in float32, so the S x S score matrix is never
formed.  It is plain PyTorch on purpose: the JAX package has no Pallas
kernel for attention, and parity with it holds only if the summation is
the reference's (``scaled_dot_product_attention`` sums in another order).
GQA reshapes the H query heads into (Hkv, group) and never repeats K/V.

Decode runs against a ring-buffer cache (window-sized with a sliding
window); ``slot_pos`` holds each slot's absolute position, -1 when empty.
By default ``gqa_decode`` and ``mla_decode`` return new cache tensors and
leave the ones they were given untouched, the reference's functional
contract.  With ``donate=True`` (the port of ``jax.jit``'s
``donate_argnums``) they write the token's row into the given cache in
place (``index_copy_``) and return it: a decode step then copies no cache,
and a captured step reads and writes one set of buffers.  Both give the
same bits.

MLA (multi-head latent attention) trains and prefills with full-rank keys
and values through ``blockwise_attention``, the shared rope key broadcast
to every head.  It decodes against the compressed latent cache (``c_kv``
and the shared ``k_rope``: (kv_lora_rank + rope_dim) values a token) with
the weight-absorption trick, in float32 as the reference does.  The latent
cache is positional, not a ring: a token is written at its position and
attends to every position up to its own.  A position past the cache raises
(``IndexError``; an int position is checked before anything runs), where
JAX's ``dynamic_update_slice`` would clamp it silently.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    rmsnorm,
    rmsnorm_init,
    truncated_normal,
)
from repro_torch.tree import PyTree

NEG_INF = -1e30


# ==========================================================================
# blockwise (flash-style) attention core
# ==========================================================================

def blockwise_attention(
    q: torch.Tensor,         # (B, S, H, Dk)
    k: torch.Tensor,         # (B, T, Hkv, Dk)
    v: torch.Tensor,         # (B, T, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    kv_chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Memory-bounded attention with an online softmax.  Returns (B, S, H, Dv)."""
    b, s, h, dk = q.shape
    t = k.shape[1]                            # KV length (== s for self-attention)
    hkv = k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    scale = dk ** -0.5 if scale is None else scale

    kv_chunk = min(kv_chunk, t)
    num_chunks = -(-t // kv_chunk)
    pad = num_chunks * kv_chunk - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    qf = (q.float() * scale).reshape(b, s, hkv, group, dk)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(s, device=q.device)

    m = torch.full((b, s, hkv, group), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, hkv, group), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, hkv, group, dv), dtype=torch.float32, device=q.device)
    for c in range(num_chunks):
        k_c = kf[:, c * kv_chunk:(c + 1) * kv_chunk]          # (B, C, Hkv, Dk)
        v_c = vf[:, c * kv_chunk:(c + 1) * kv_chunk]          # (B, C, Hkv, Dv)
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
        #        b=batch s=q h=kv-heads g=group c=kv-chunk d=dk
        scores = torch.einsum("bshgd,bchd->bshgc", qf, k_c)
        mask = (kv_pos[None, :] < t).expand(s, kv_chunk)      # pad mask
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        mask_b = mask[None, :, None, None, :]
        scores = torch.where(mask_b, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        # explicit mask multiply: a fully masked chunk must contribute 0,
        # not exp(NEG_INF - NEG_INF) = 1
        p = torch.exp(scores - m_new[..., None]) * mask_b
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bshgc,bchd->bshgd", p, v_c)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, dv).to(q.dtype)


# ==========================================================================
# GQA attention layer
# ==========================================================================

def gqa_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    """Drawn in a fixed order: w_q, w_k, w_v, w_o."""
    hd = cfg.resolved_head_dim
    params = {
        "w_q": dense_init(generator, cfg.d_model, cfg.num_heads * hd, dtype, device),
        "w_k": dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "w_v": dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "w_o": dense_init(generator, cfg.num_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qk_norm:
        params["q_norm"] = rmsnorm_init(hd, dtype, device)
        params["k_norm"] = rmsnorm_init(hd, dtype, device)
    return params


def _project_qkv(params: PyTree, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """q, k, v of ``x`` (B, S, D): qk-norm, then RoPE at ``positions``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["w_q"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ params["w_k"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ params["w_v"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(
    params: PyTree, cfg: ArchConfig, x: torch.Tensor, *, causal: bool = True, kv_chunk: int = 1024
) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  x: (B, S, D)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = blockwise_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                              kv_chunk=kv_chunk)
    return out.reshape(b, s, -1) @ params["w_o"]


# --- decode cache ---------------------------------------------------------

def gqa_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> PyTree:
    """Ring-buffer cache.  With a sliding window the buffer is window-sized."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, size, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def gqa_decode(
    params: PyTree,
    cfg: ArchConfig,
    x: torch.Tensor,         # (B, 1, D): one new token
    cache: PyTree,
    pos,                     # int or 0-d tensor: the new token's absolute position
    donate: bool = False,    # write the new row into ``cache`` and return it
) -> tuple[torch.Tensor, PyTree]:
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=x.device).reshape(1)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos_t.expand(b, 1))

    size = cache["k"].shape[1]
    slot = pos_t % size
    k_cache = _put(cache["k"], 1, slot, k_new, donate)
    v_cache = _put(cache["v"], 1, slot, v_new, donate)
    slot_pos = _put(cache["slot_pos"], 0, slot, pos_t, donate)

    group = cfg.num_heads // cfg.num_kv_heads
    qf = (q.float() * hd ** -0.5).reshape(b, cfg.num_kv_heads, group, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos_t)
    if cfg.sliding_window is not None:
        valid = valid & (slot_pos > pos_t - cfg.sliding_window)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", attn, v_cache.float())
    out = out.reshape(b, 1, cfg.num_heads * hd).to(x.dtype)
    new_cache = cache if donate else {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}
    return out @ params["w_o"], new_cache


def _put(buf: torch.Tensor, dim: int, index: torch.Tensor, rows: torch.Tensor,
         donate: bool) -> torch.Tensor:
    """``buf`` with ``rows`` (cast to its dtype) at ``index`` along ``dim``:
    written into ``buf`` itself with ``donate``, else into a copy."""
    rows = rows.to(buf.dtype)
    if donate:
        return buf.index_copy_(dim, index, rows)
    return buf.index_copy(dim, index, rows)


# ==========================================================================
# MLA (DeepSeek-V3 multi-head latent attention)
# ==========================================================================

def mla_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    """Drawn in a fixed order: w_dq, w_uq, w_dkv, w_kr, w_uk, w_uv, w_o.
    ``w_uk`` and ``w_uv`` are stored (rank, H, head_dim) so decode can absorb
    them per head."""
    m: MLAConfig = cfg.mla
    h = cfg.num_heads

    def per_head(dim):
        w = truncated_normal(generator, (m.kv_lora_rank, h, dim), -2.0, 2.0)
        return (w * m.kv_lora_rank ** -0.5).to(device=device, dtype=dtype)

    return {
        "w_dq": dense_init(generator, cfg.d_model, m.q_lora_rank, dtype, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "w_uq": dense_init(generator, m.q_lora_rank,
                           h * (m.qk_nope_head_dim + m.qk_rope_head_dim), dtype, device),
        "w_dkv": dense_init(generator, cfg.d_model, m.kv_lora_rank, dtype, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "w_kr": dense_init(generator, cfg.d_model, m.qk_rope_head_dim, dtype, device),
        "w_uk": per_head(m.qk_nope_head_dim),
        "w_uv": per_head(m.v_head_dim),
        "w_o": dense_init(generator, h * m.v_head_dim, cfg.d_model, dtype, device),
    }


def _mla_queries(params: PyTree, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    c_q = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
    q = (c_q @ params["w_uq"]).reshape(b, s, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor, *,
              kv_chunk: int = 1024) -> torch.Tensor:
    """Train / prefill MLA with full-rank keys and values (the standard form)."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_queries(params, cfg, x, positions)

    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)      # (B, S, R)
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions, cfg.rope_theta)
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhd->bshd", c_kv, params["w_uv"])

    # fold the shared rope key into every head and run one blockwise attention
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    out = blockwise_attention(q, k, v, causal=True, kv_chunk=kv_chunk, scale=scale)
    return out.reshape(b, s, h * m.v_head_dim) @ params["w_o"]


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> PyTree:
    m: MLAConfig = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def check_latent_position(pos: int, max_len: int) -> None:
    """A decode position must lie in the latent cache: JAX would clamp it."""
    if not 0 <= pos < max_len:
        raise IndexError(f"decode position {pos} is outside the latent cache of {max_len} slots")


def mla_decode(
    params: PyTree,
    cfg: ArchConfig,
    x: torch.Tensor,         # (B, 1, D)
    cache: PyTree,
    pos,                     # int or 0-d tensor: the new token's absolute position
    donate: bool = False,    # write the new latent row into ``cache`` and return it
) -> tuple[torch.Tensor, PyTree]:
    """Weight-absorbed decode over the compressed latent cache.

    Scores  = q_nope W_uk . c_kv  +  q_rope . k_rope     (per head)
    Output  = (attn . c_kv) W_uv                          (per head)
    Only (kv_lora_rank + rope_dim) values per token are cached."""
    m: MLAConfig = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    max_len = cache["c_kv"].shape[1]
    if not isinstance(pos, torch.Tensor):
        check_latent_position(pos, max_len)
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=x.device).reshape(1)
    positions = pos_t.expand(b, 1)
    q_nope, q_rope = _mla_queries(params, cfg, x, positions)          # (B, 1, H, *)

    c_kv_new = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    k_rope_new = apply_rope((x @ params["w_kr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    c_kv = _put(cache["c_kv"], 1, pos_t, c_kv_new, donate)
    k_rope = _put(cache["k_rope"], 1, pos_t, k_rope_new, donate)

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    # absorb W_uk: the query in latent space (B, H, R)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), params["w_uk"].float())
    scores = torch.einsum("bhr,bsr->bhs", q_lat, c_kv.float())
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), k_rope.float())
    scores = scores * scale
    mask = torch.arange(max_len, device=x.device) <= pos_t
    scores = torch.where(mask[None, None, :], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhs,bsr->bhr", attn, c_kv.float())          # (B, H, R)
    out = torch.einsum("bhr,rhd->bhd", out_lat, params["w_uv"].float())
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return out @ params["w_o"], cache if donate else {"c_kv": c_kv, "k_rope": k_rope}
