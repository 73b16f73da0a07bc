"""Shared neural-net building blocks (free functions over dict params).

Initializers return dicts of tensors drawn from a ``torch.Generator`` on the
CPU and moved to ``device``; apply functions are free functions, as in the
JAX package's functional zoo.  RoPE and the MLPs come with the attention
families.
"""

from __future__ import annotations

import math

import torch

from repro_torch.tree import PyTree

_SQRT2 = math.sqrt(2.0)


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / _SQRT2))


def truncated_normal(generator: torch.Generator, shape, lower: float, upper: float) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], by inverting the CDF (float32)."""
    lo, hi = _normal_cdf(lower), _normal_cdf(upper)
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    x = torch.erfinv(2.0 * u - 1.0) * _SQRT2
    return x.clamp_(lower, upper).to(torch.float32)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LLM practice)."""
    w = truncated_normal(generator, (in_dim, out_dim), -2.0, 2.0) * in_dim ** -0.5
    return w.to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32) * 0.02
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
