"""Shared neural-net building blocks (free functions over dict params).

Initializers return dicts of tensors drawn from a ``torch.Generator`` on the
generator's own device and moved to ``device``: a CPU generator draws what
it always drew, and a ``torch.Generator(device="cuda")`` draws on the card,
which is what makes a multi-billion-parameter init take seconds.  Apply
functions are free functions, as in the JAX package's functional zoo.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Activation
from repro_torch.tree import PyTree

_SQRT2 = math.sqrt(2.0)


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / _SQRT2))


def truncated_normal(generator: torch.Generator, shape, lower: float, upper: float) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], by inverting the CDF (float32)."""
    lo, hi = _normal_cdf(lower), _normal_cdf(upper)
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device) * (hi - lo) + lo
    x = torch.erfinv(2.0 * u - 1.0) * _SQRT2
    return x.clamp_(lower, upper).to(torch.float32)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LLM practice)."""
    w = truncated_normal(generator, (in_dim, out_dim), -2.0, 2.0) * in_dim ** -0.5
    return w.to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=generator.device) * 0.02
    return w.to(device=device, dtype=dtype)


def rmsnorm_init(dim: int, dtype, device) -> PyTree:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32, returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).

    Computed in float32 on the two halves of D (not interleaved pairs) and
    cast back to ``x``'s dtype, as the reference does."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs                      # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                              # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# feed-forward variants
# --------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, activation: Activation,
             dtype, device) -> PyTree:
    """Drawn in a fixed order: w_gate (SwiGLU only), w_up, w_down."""
    if activation == Activation.SWIGLU:
        return {
            "w_gate": dense_init(generator, d_model, d_ff, dtype, device),
            "w_up": dense_init(generator, d_model, d_ff, dtype, device),
            "w_down": dense_init(generator, d_ff, d_model, dtype, device),
        }
    return {
        "w_up": dense_init(generator, d_model, d_ff, dtype, device),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device),
    }


def mlp_apply(params: PyTree, x: torch.Tensor, activation: Activation) -> torch.Tensor:
    if activation == Activation.SWIGLU:
        gate = F.silu(x @ params["w_gate"])
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    h = x @ params["w_up"]
    if activation == Activation.RELU2:
        h = torch.square(F.relu(h))        # Nemotron-4 squared ReLU
    elif activation == Activation.GELU:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        h = F.relu(h)
    return h @ params["w_down"]


def mlp_param_count(d_model: int, d_ff: int, activation: Activation) -> int:
    return d_model * d_ff * (3 if activation == Activation.SWIGLU else 2)
