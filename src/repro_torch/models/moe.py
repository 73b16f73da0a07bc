"""Mixture-of-Experts feed-forward with sort-based capacity dispatch.

The port of the JAX package's ``models/moe.py``, step for step:

  1. top-k routing over float32 router logits (the router stays float32 in a
     bfloat16 model);
  2. the (token, slot) pairs flattened and sorted by expert id with a
     *stable* sort, so the pairs of one expert keep token order;
  3. each pair's position within its expert from ``searchsorted`` on the
     sorted ids;
  4. the kept pairs copied into a dense (E, C, D) expert buffer; a pair past
     its expert's capacity C lands in one drop row (row ``E*C``), which is
     cut off before the experts run, so no value or gradient passes through
     it;
  5. batched expert products ``(E, C, D) @ (E, D, F)``, plain ``torch.bmm``
     (the reference computes them as einsums outside any Pallas kernel);
  6. the combine: each pair's expert output gathered back in pair order,
     weighted and summed over the k slots of its token.

The combine is a gather and a sum, not the reference's scatter-add
(``.at[pair_token].add``): ``index_add_`` adds with atomics on CUDA, so a
repeated call could round differently; a gather and a sum over k give the
same bits every call.

``moe_apply_local`` dispatches in ``num_shards`` groups of tokens, each with
its own capacity (the reference's ``ep_local`` mode); ``moe_apply_global``
is the same computation in one group.  The ``"ep"`` and ``"tp"`` modes both
take the global path, as in the reference, where they differ only in how
XLA shards the expert buffer.  On one card the reference's sharding
constraints (``constrain``) are no-ops and are dropped.

Aux load-balance loss follows Switch/DeepSeek: E * sum_e f_e * p_e.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Activation, ArchConfig, MoEConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, truncated_normal
from repro_torch.tree import PyTree

_MAX_DRAW = 1 << 26   # values an expert draw holds (0.5 GB of float64 a temporary)


def moe_init(generator: torch.Generator, cfg: ArchConfig, dtype, device) -> PyTree:
    """Drawn in a fixed order: router (float32), w_gate, w_up, w_down, shared.
    An expert tensor is drawn a run of experts at a time, at most
    ``_MAX_DRAW`` values a draw, into its place: one draw of deepseek-v3's
    256 x 7168 x 2048 would hold ~30 GB of float64 temporaries on the card.
    A tensor under ``_MAX_DRAW`` values (every reduced config's) is one
    draw."""
    m: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts

    def experts(shape, scale):
        out = torch.empty((e, *shape), dtype=dtype, device=device)
        step = max(1, _MAX_DRAW // math.prod(shape))
        for i in range(0, e, step):
            w = truncated_normal(generator, (min(step, e - i), *shape), -2.0, 2.0) * scale
            out[i:i + step] = w.to(device=device, dtype=dtype)
        return out

    params = {
        "router": dense_init(generator, d, e, torch.float32, device),
        "w_gate": experts((d, f), d ** -0.5),
        "w_up": experts((d, f), d ** -0.5),
        "w_down": experts((f, d), f ** -0.5),
    }
    if m.num_shared_experts > 0:
        params["shared"] = mlp_init(generator, d, f * m.num_shared_experts, Activation.SWIGLU,
                                    dtype, device)
    return params


def _capacity(num_tokens: int, m: MoEConfig) -> int:
    cap = int(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(cap, m.top_k)


def route(params: PyTree, cfg: ArchConfig, x: torch.Tensor, groups: int = 1):
    """Top-k routing of ``x`` (B, S, D) in ``groups`` groups of tokens:
    float32 ``probs`` (G, T/G, E), the renormalised ``weights`` and expert
    ``ids`` (G, T/G, k), and the aux load-balance loss."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    flat = x.reshape(groups, b * s // groups, d)
    probs = torch.softmax(flat.float() @ params["router"], dim=-1)
    weights, ids = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    f_e = F.one_hot(ids, m.num_experts).float().sum(dim=2).mean(dim=(0, 1))   # frac routed
    p_e = probs.mean(dim=(0, 1))
    aux = m.num_experts * torch.sum(f_e * p_e)
    return probs, weights, ids, aux


def _dispatch(cfg: ArchConfig, ids: torch.Tensor, cap: int):
    """Each (token, slot) pair's row in its group's (E*C + 1)-row buffer, in
    pair order (G, T*k): ``e*C + position`` while the expert has room, the
    drop row ``E*C`` after.  Pairs claim room in the order of a stable sort
    by expert id, the reference's."""
    e = cfg.moe.num_experts
    g, t_loc, k = ids.shape
    flat_e = ids.reshape(g, t_loc * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=ids.device).expand(g, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")
    pos_in_e = torch.arange(t_loc * k, device=ids.device) - torch.gather(starts, 1, sorted_e)
    dest = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e, e * cap)
    # back to pair order: each sorted slot's row goes to the pair it came from
    return torch.empty_like(dest).scatter_(1, order, dest)


def _moe(params: PyTree, cfg: ArchConfig, x: torch.Tensor, groups: int):
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t_loc = b * s // groups
    e, k = m.num_experts, m.top_k
    _, weights, ids, aux = route(params, cfg, x, groups)
    cap = _capacity(t_loc, m)
    dest = _dispatch(cfg, ids, cap)                                   # (G, T_loc*k)
    rows = e * cap + 1
    # one buffer for all groups: group g's rows start at g * rows
    flat_dest = (dest + rows * torch.arange(groups, device=x.device)[:, None]).reshape(-1)
    pairs = x.reshape(groups * t_loc, 1, d).expand(-1, k, d).reshape(-1, d)
    buf = torch.zeros((groups * rows, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, flat_dest, pairs)                        # drops land in each drop row
    buf = buf.reshape(groups, rows, d)[:, :e * cap].reshape(groups, e, cap, d)
    buf = buf.transpose(0, 1).reshape(e, groups * cap, d)           # (E, G*C, D)

    gate = F.silu(torch.bmm(buf, params["w_gate"]))
    up = torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(gate * up, params["w_down"])                 # (E, G*C, D)

    out_buf = out_buf.reshape(e, groups, cap, d).transpose(0, 1).reshape(groups, e * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros(groups, 1, d)], dim=1).reshape(-1, d)
    gathered = out_buf[flat_dest].reshape(b * s, k, d)             # dropped pairs -> 0
    token_out = (gathered * weights.reshape(b * s, k, 1).to(x.dtype)).sum(dim=1)
    token_out = token_out.reshape(b, s, d)
    if "shared" in params:
        token_out = token_out + mlp_apply(params["shared"], x, Activation.SWIGLU)
    return token_out, aux


def moe_apply(params: PyTree, cfg: ArchConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.expert_sharding == "ep_local":
        return moe_apply_local(params, cfg, x)
    return moe_apply_global(params, cfg, x)


def moe_apply_global(params: PyTree, cfg: ArchConfig, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (output (B, S, D), aux load-balance loss, a float32 scalar)."""
    return _moe(params, cfg, x, groups=1)


def moe_apply_local(params: PyTree, cfg: ArchConfig, x: torch.Tensor,
                    num_shards: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch in ``num_shards`` groups of consecutive tokens, each with
    the capacity of its own token count; one group when the tokens do not
    split evenly (or are fewer than ``num_shards``), as in the reference."""
    t = x.shape[0] * x.shape[1]
    groups = num_shards if t % num_shards == 0 and t >= num_shards else 1
    return _moe(params, cfg, x, groups=groups)


def moe_param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Per-layer MoE parameter count (router + experts + shared)."""
    m: MoEConfig = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    per_expert = 3 * d * f
    num = m.top_k if active_only else m.num_experts
    total = cfg.d_model * m.num_experts + num * per_expert
    if m.num_shared_experts > 0:
        total += 3 * d * f * m.num_shared_experts
    return total
