"""Plain reference of mamba2-130m: embedding, 24 Mamba-2 blocks, final norm,
the tied head and next-token cross-entropy, in float32, and AdamW.

Written from arXiv:2405.21060 and the public ``mamba_ssm`` Mamba-2 block:
``in_proj`` to ``[z, x, B, C, dt]``, a depthwise causal conv of width
``d_conv`` over ``[x, B, C]`` and SiLU, ``dt = softplus(dt + dt_bias)``,
``A = -exp(A_log)``, the SSD scan (one group: B and C shared by the
heads) by the chunked dual form of the paper's minimal listing, the skip
``D x``, the gated RMSNorm ``norm(y * silu(z))``, ``out_proj``; each block
``x + mixer(rmsnorm(x))``.  No kernel of the program and nothing of it is
imported.  ``quantize`` (the control) computes each product in fp8: its operands
in e4m3 forward and its output's gradient in e5m2 backward, each with a
per-tensor scale; the SSD scan stays in float32, as the configuration
computes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dims(cfg: dict) -> dict:
    d_in = cfg["expand"] * cfg["d_model"]
    heads = d_in // cfg["headdim"]
    conv = d_in + 2 * cfg["ngroups"] * cfg["d_state"]
    return {"d_in": d_in, "heads": heads, "conv": conv, "proj": 2 * d_in + 2 * cfg["d_state"] + heads}


def init_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The benchmark's weights, drawn on ``device`` from ``seed`` a leaf at a
    time (every layer of a leaf in one call), in the program's layout."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1) + 7)
    d, L, V = cfg["d_model"], cfg["n_layer"], cfg["vocab_size"]
    k = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def normal(shape, std):
        return (torch.randn(shape, generator=g, **f32) * std).to(dtype)

    dt = torch.exp(torch.rand((L, k["heads"]), generator=g, **f32)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "embed": normal((V, d), 0.02),
        "ln_f": {"scale": torch.ones(d, dtype=dtype, device=device)},
        "blocks": {
            "ln": {"scale": torch.ones((L, d), dtype=dtype, device=device)},
            "mamba": {
                "in_proj": normal((L, d, k["proj"]), d ** -0.5),
                "conv_w": normal((L, cfg["d_conv"], k["conv"]), 0.1),
                "conv_b": torch.zeros((L, k["conv"]), dtype=dtype, device=device),
                "A_log": torch.log(torch.rand((L, k["heads"]), generator=g, **f32) * 15 + 1),
                "D": torch.ones((L, k["heads"]), **f32),
                "dt_bias": dt + torch.log(-torch.expm1(-dt)),
                "norm": {"scale": torch.ones((L, k["d_in"]), dtype=dtype, device=device)},
                "out_proj": normal((L, k["d_in"], d), k["d_in"] ** -0.5),
            },
        },
    }


def _q(t: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to an 8-bit float format with a per-tensor scale."""
    scale = top / t.abs().amax().clamp(min=1e-12)
    return (t * scale).to(fmt).to(t.dtype) / scale


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` in e4m3, its gradient passed straight through (the embedding)."""
    return t + (_q(t.detach(), torch.float8_e4m3fn, 448.0) - t.detach())


class _Fp8Mm(torch.autograd.Function):
    """A product in fp8: operands in e4m3 forward, the output's gradient in
    e5m2 backward, each with a per-tensor scale; float32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _q(a, torch.float8_e4m3fn, 448.0), _q(b, torch.float8_e4m3fn, 448.0)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _q(g, torch.float8_e5m2, 57344.0)
        ga = g @ b.transpose(-1, -2)
        gb = (a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])).reshape(b.shape)
        return ga, gb


def _mm(a, b, quantize: bool):
    return _Fp8Mm.apply(a, b) if quantize else a @ b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x[j+1..i] below the diagonal, 0 on
    it, -inf above."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~below, 0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), 0)
    return out.masked_fill(~keep, -torch.inf)


def ssd(x, dt, a, b_mat, c_mat, chunk: int) -> torch.Tensor:
    """y_t = C_t . S_t, S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T, from a zero
    state.  x (b, s, h, p), dt (b, s, h), a (h,), B and C (b, s, n)."""
    bsz, s, h, p = x.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        b_mat, c_mat = F.pad(b_mat, (0, 0, 0, pad)), F.pad(c_mat, (0, 0, 0, pad))
    xd = (x * dt[..., None]).reshape(bsz, nc, chunk, h, p)
    ad = (dt * a).reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)       # (b, h, c, l)
    bc = b_mat.reshape(bsz, nc, chunk, -1)
    cc = c_mat.reshape(bsz, nc, chunk, -1)
    a_cum = torch.cumsum(ad, dim=-1)
    decay = torch.exp(segsum(ad))                                       # (b, h, c, l, l)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, decay, xd)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :s]


def mixer(p: dict, u: torch.Tensor, cfg: dict, quantize: bool) -> torch.Tensor:
    k = dims(cfg)
    bsz, s, _ = u.shape
    n, heads = cfg["d_state"], k["heads"]
    proj = _mm(u, p["in_proj"], quantize)
    z, xbc, dt = torch.split(proj, [k["d_in"], k["conv"], heads], dim=-1)
    w = p["conv_w"]                                                     # (K, conv)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (w.shape[0] - 1, 0)),
                   w.t().unsqueeze(1), p["conv_b"], groups=k["conv"]).transpose(1, 2)
    xbc = F.silu(xbc)
    x, b_mat, c_mat = torch.split(xbc, [k["d_in"], n, n], dim=-1)
    xh = x.reshape(bsz, s, heads, cfg["headdim"])
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(xh, dt, -torch.exp(p["A_log"]), b_mat, c_mat, cfg["chunk_size"])
    y = (y + xh * p["D"][:, None]).reshape(bsz, s, k["d_in"])
    y = rmsnorm(y * F.silu(z), p["norm"]["scale"], cfg["norm_eps"])
    return _mm(y, p["out_proj"], quantize)


def _layer(params: dict, i: int) -> dict:
    def take(tree):
        return {k: take(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]
    return take(params["blocks"])


def _nll(h, head, labels, quantize):
    logits = _mm(h, head, quantize)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                           reduction="sum")


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict,
         quantize: bool = False, loss_chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy; each layer and each sequence chunk of
    the loss is recomputed in the backward (memory only)."""
    emb = params["embed"]
    x = (_fp8(emb) if quantize else emb)[tokens.long()]
    for i in range(cfg["n_layer"]):
        blk = _layer(params, i)

        def block(h, blk=blk):
            return h + mixer(blk["mamba"], rmsnorm(h, blk["ln"]["scale"], cfg["norm_eps"]), cfg,
                             quantize)

        x = checkpoint(block, x, use_reentrant=False)
    h = rmsnorm(x, params["ln_f"]["scale"], cfg["norm_eps"])
    total = h.new_zeros(())
    for s in range(0, h.shape[1], loss_chunk):
        total = total + checkpoint(_nll, h[:, s:s + loss_chunk], emb.t(),
                                   labels[:, s:s + loss_chunk], quantize, use_reentrant=False)
    return total / labels.numel()


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def train_steps(params: dict, batches: list, cfg: dict, opt: dict, quantize: bool = False,
                write_params: bool = True):
    """AdamW steps from ``params`` over ``batches`` (``(tokens, labels)``
    each).  Each step computes in float32 and stores every param and both
    moments in the param's own dtype, as the configuration holds them
    (bfloat16 but for ``A_log``, ``D`` and ``dt_bias``).  Returns each
    step's loss, the first step's gradient and the params after the last
    step, each as a flat dict.  ``write_params=False`` (a planted fault)
    updates the moments and leaves the params as they were."""
    store = {k: v.dtype for k, v in flat(params).items()}
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in flat(params).items()}
    tree = _unflat(p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        value = loss(tree, tokens, labels, cfg, quantize)
        grads = torch.autograd.grad(value, list(p.values()))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        with torch.no_grad():
            c1, c2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v2[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                if write_params:
                    w.sub_(opt["learning_rate"] * ((m[k] / c1) / ((v2[k] / c2).sqrt() + opt["eps"])
                                                  + opt["weight_decay"] * w))
                for t in (w, m[k], v2[k]):
                    t.copy_(t.to(store[k]))
    return losses, first, {k: w.detach() for k, w in p.items()}


def _unflat(flat_p: dict) -> dict:
    tree: dict = {}
    for k, v in flat_p.items():
        node = tree
        parts = k.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, cfg: dict, quantize: bool = False,
           chunk: int = 2048) -> torch.Tensor:
    """Float32 logits ``(S, V)`` of one sequence ``tokens (S,)`` from its start,
    layer by layer, the head in sequence chunks."""
    p = {k: v.float() for k, v in flat(params).items()}
    tree = _unflat(p)
    emb = tree["embed"]
    x = (_fp8(emb) if quantize else emb)[tokens.long()][None]
    for i in range(cfg["n_layer"]):
        blk = _layer(tree, i)
        x = x + mixer(blk["mamba"], rmsnorm(x, blk["ln"]["scale"], cfg["norm_eps"]), cfg, quantize)
    h = rmsnorm(x, tree["ln_f"]["scale"], cfg["norm_eps"])[0]
    return torch.cat([_mm(h[s:s + chunk], emb.t(), quantize) for s in range(0, h.shape[0], chunk)])
