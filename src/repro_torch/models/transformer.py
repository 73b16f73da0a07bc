"""Transformer and Mamba2 blocks, and the layer stacks that run them.

Per-layer parameters are stacked on a leading layer dimension, as in the
JAX package, so param trees carry across key for key.  JAX scans a layer
body over that dimension; here ``run_stack`` and ``run_stack_decode`` are
Python loops over the layer index.  A body returns ``(x, aux)``, and
``run_stack`` returns ``x`` and the sum of the layers' router aux losses;
a layer without experts returns an aux of ``0.0``, a float, so a stack
without experts runs no extra device operation.  ``run_stack(...,
remat=True)`` is the port of ``jax.checkpoint(body)``: each layer keeps
only its input for the backward and runs its forward again there.

Block kinds:
  * ``dense`` — [MLA | GQA] attention + [swiglu | relu2 | gelu | relu] MLP;
  * ``moe``   — the same attention + the sort-dispatch MoE (+ shared experts);
  * ``mamba`` — the Mamba2 SSD block;
  * ``enc``   — a ``dense`` block with bidirectional attention (the audio
    encoder);
  * ``dec``   — causal self-attention + cross-attention + MLP.
The hybrid (Zamba2) runs groups of mamba blocks with one weight-*shared*
dense block applied after each group (``hybrid_layout``); the MoE decoders
lay out their dense and MoE layers by ``moe_layout``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (
    blockwise_attention,
    gqa_apply,
    gqa_cache_init,
    gqa_decode,
    gqa_init,
    mla_apply,
    mla_cache_init,
    mla_decode,
    mla_init,
)
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init
from repro_torch.models.mamba2 import mamba2_apply, mamba2_decode, mamba2_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.tree import PyTree, tree_map


def stack_init(init_fn: Callable[[], PyTree], n: int) -> PyTree:
    """``n`` draws of ``init_fn()`` stacked leafwise on a leading layer dim.
    Each layer is copied into its place and dropped before the next is
    drawn, so building a stack holds it and one layer, not two stacks."""
    stack = None
    for i in range(n):
        one = init_fn()
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((n, *t.shape)), one)
        tree_map(lambda s, t: s[i].copy_(t), stack, one)
        del one
    return stack


def layer(stack: PyTree, i: int) -> PyTree:
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], stack)


# ==========================================================================
# block init / apply
# ==========================================================================

def _self_attn_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    if cfg.mla is not None:
        return mla_init(generator, cfg, dtype, device)
    return gqa_init(generator, cfg, dtype, device)


def _self_attn_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    if cfg.mla is not None:
        return mla_apply(params, cfg, x)
    return gqa_apply(params, cfg, x, causal=causal)


def _self_attn_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree, pos):
    if cfg.mla is not None:
        return mla_decode(params, cfg, x, cache, pos)
    return gqa_decode(params, cfg, x, cache, pos)


def _self_attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> PyTree:
    if cfg.mla is not None:
        return mla_cache_init(cfg, batch, max_len, dtype, device)
    return gqa_cache_init(cfg, batch, max_len, dtype, device)


def dense_block_init(generator: torch.Generator, cfg: ArchConfig, dtype, device, *,
                     use_moe: bool) -> PyTree:
    """Drawn in a fixed order: the attention's weights, then the MLP's (or
    the experts')."""
    params = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": _self_attn_init(generator, cfg, dtype, device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if use_moe:
        params["moe"] = moe_init(generator, cfg, dtype, device)
    else:
        params["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dtype, device)
    return params


def dense_block_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor, *, use_moe: bool,
                      causal: bool = True) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Self-attention and the MLP (or the MoE), each on the pre-normed
    residual.  Returns x and the router aux loss (``0.0`` without experts)."""
    h = x + _self_attn_apply(params["attn"], cfg, rmsnorm(params["ln1"], x, cfg.norm_eps),
                             causal=causal)
    ff_in = rmsnorm(params["ln2"], h, cfg.norm_eps)
    if use_moe:
        ff, aux = moe_apply(params["moe"], cfg, ff_in)
    else:
        ff, aux = mlp_apply(params["mlp"], ff_in, cfg.activation), 0.0
    return h + ff, aux


def dense_block_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree, pos, *,
                       use_moe: bool) -> tuple[torch.Tensor, PyTree]:
    attn_out, new_cache = _self_attn_decode(
        params["attn"], cfg, rmsnorm(params["ln1"], x, cfg.norm_eps), cache, pos)
    h = x + attn_out
    ff_in = rmsnorm(params["ln2"], h, cfg.norm_eps)
    if use_moe:
        ff, _ = moe_apply(params["moe"], cfg, ff_in)
    else:
        ff = mlp_apply(params["mlp"], ff_in, cfg.activation)
    return h + ff, new_cache


def mamba_block_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    return {"ln": rmsnorm_init(cfg.d_model, dtype, device),
            "mamba": mamba2_init(generator, cfg, dtype, device)}


def mamba_block_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mamba2_apply(params["mamba"], cfg, rmsnorm(params["ln"], x, cfg.norm_eps))


def mamba_block_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree, _pos):
    out, new_cache = mamba2_decode(params["mamba"], cfg, rmsnorm(params["ln"], x, cfg.norm_eps), cache)
    return x + out, new_cache


# --- cross attention (encoder-decoder) ------------------------------------

def cross_attn_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    return gqa_init(generator, cfg, dtype, device)


def cross_attn_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor,
                     enc: torch.Tensor) -> torch.Tensor:
    """Attention of the decoder positions ``x`` (B, S, D) over the encoder
    output ``enc`` (B, T, D): no mask, no RoPE."""
    b, s, _ = x.shape
    t = enc.shape[1]
    hd = cfg.resolved_head_dim
    q = (x @ params["w_q"]).reshape(b, s, cfg.num_heads, hd)
    k = (enc @ params["w_k"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = (enc @ params["w_v"]).reshape(b, t, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    out = blockwise_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ params["w_o"]


def cross_attn_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor) -> torch.Tensor:
    """Decode-time cross attention over the precomputed encoder K/V."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    group = cfg.num_heads // cfg.num_kv_heads
    q = (x @ params["w_q"]).reshape(b, cfg.num_kv_heads, group, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    qf = q.float() * hd ** -0.5
    scores = torch.einsum("bhgd,bthd->bhgt", qf, k_cache.float())
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", attn, v_cache.float())
    return out.reshape(b, 1, cfg.num_heads * hd).to(x.dtype) @ params["w_o"]


def dec_block_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    """Drawn in a fixed order: self-attention, cross-attention, MLP."""
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": _self_attn_init(generator, cfg, dtype, device),
        "ln_x": rmsnorm_init(cfg.d_model, dtype, device),
        "cross": cross_attn_init(generator, cfg, dtype, device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dtype, device),
    }


def dec_block_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
    h = x + _self_attn_apply(params["attn"], cfg, rmsnorm(params["ln1"], x, cfg.norm_eps))
    h = h + cross_attn_apply(params["cross"], cfg, rmsnorm(params["ln_x"], h, cfg.norm_eps), enc)
    return h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps), cfg.activation)


def dec_block_decode(params: PyTree, cfg: ArchConfig, x: torch.Tensor, cache: PyTree,
                     pos) -> tuple[torch.Tensor, PyTree]:
    """``cache`` holds ``self`` (the self-attention cache) and the layer's
    ``cross_k``/``cross_v``, which come back as they went in."""
    attn_out, self_cache = _self_attn_decode(
        params["attn"], cfg, rmsnorm(params["ln1"], x, cfg.norm_eps), cache["self"], pos)
    h = x + attn_out
    h = h + cross_attn_decode(params["cross"], cfg, rmsnorm(params["ln_x"], h, cfg.norm_eps),
                              cache["cross_k"], cache["cross_v"])
    h = h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h, cfg.norm_eps), cfg.activation)
    return h, {"self": self_cache, "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}


# ==========================================================================
# stacks
# ==========================================================================

def run_stack(
    stack_params: PyTree,
    x: torch.Tensor,
    body: Callable[[PyTree, torch.Tensor], tuple[torch.Tensor, torch.Tensor | float]],
    *,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | float]:
    """``x, a = body(layer_params, x)`` over the stacked layers, in order;
    returns x and the sum of the ``a``.

    With ``remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``); only while grad is enabled, so a step
    under ``inference_mode`` runs each layer once."""
    remat = remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(_depth(stack_params)):
        p = layer(stack_params, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(body, p, x, use_reentrant=False)
        else:
            x, a = body(p, x)
        aux = aux + a
    return x, aux


def run_stack_decode(
    stack_params: PyTree,
    caches: PyTree,
    x: torch.Tensor,
    body: Callable[[PyTree, torch.Tensor, PyTree], tuple[torch.Tensor, PyTree]],
) -> tuple[torch.Tensor, PyTree]:
    """One decode step through the stack; returns x and the new stacked caches."""
    new_caches = []
    for i in range(_depth(stack_params)):
        x, c = body(layer(stack_params, i), x, layer(caches, i))
        new_caches.append(c)
    return x, tree_map(lambda *leaves: torch.stack(leaves), *new_caches)


def _depth(stack: PyTree) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


# ==========================================================================
# layer layout per architecture
# ==========================================================================

def moe_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(num leading dense layers, num moe layers, num trailing dense layers
    interleaved) — as (first_dense, n_moe, n_inter_dense)."""
    m = cfg.moe
    rest = cfg.num_layers - m.first_dense
    if m.moe_every == 1:
        return m.first_dense, rest, 0
    n_pairs = rest // m.moe_every
    return m.first_dense, n_pairs, rest - n_pairs


def hybrid_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(num groups, mamba per group, trailing mamba layers)."""
    period = cfg.hybrid.attn_every
    groups = cfg.num_layers // period
    return groups, period - 1, cfg.num_layers - groups * period
