"""The paper's model: stacked GRU + single ReLU-headed FCN for LoS regression.

Paper Table 1: L=2 layers, N=32 hidden, dropout r=0.05, batch 128,
AdamW(lr=5e-3, wd=5e-3), loss = MSLE.  Eq. (1)-(2) define the cell and the
strictly-positive output head (a patient cannot have negative LoS).

Params are nested dicts of tensors with the JAX pytree's keys and layouts:
``{"layers": [{"w_ih" (F,3N), "w_hh" (N,3N), "b_ih" (3N,), "b_hh" (3N,)}],
"head": {"w" (N,1), "b" (1,)}}``.  ``gru_apply`` always runs the
recurrence through ``gru_sequence``; the tensors' device decides between
the CUDA kernel and its plain version, so no switch runs the card without
the kernel.

The cohort engine trains C clients in one step: every leaf then carries a
leading client axis, ``x`` is ``(C, B, T, F)``, the loss is a ``(C,)``
vector of per-client masked means, and dropout draws each client's mask
from that client's own generator, as its one-client step would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gru_scan.ops import gru_sequence
from repro_torch.tree import PyTree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    input_dim: int = 38
    hidden_dim: int = 32
    num_layers: int = 2
    dropout: float = 0.05


def init_gru(
    generator: torch.Generator, cfg: GRUConfig, device: str | torch.device | None = None
) -> PyTree:
    """U(-1/sqrt(N), 1/sqrt(N)) init (torch.nn.GRU's default), drawn on the CPU."""
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(cfg.hidden_dim)
    n3 = 3 * cfg.hidden_dim

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * (2 * scale) - scale).to(dev)

    params: dict[str, Any] = {"layers": []}
    for layer in range(cfg.num_layers):
        in_dim = cfg.input_dim if layer == 0 else cfg.hidden_dim
        params["layers"].append(
            {
                "w_ih": uniform(in_dim, n3),
                "w_hh": uniform(cfg.hidden_dim, n3),
                "b_ih": uniform(n3),
                "b_hh": uniform(n3),
            }
        )
    params["head"] = {
        "w": uniform(cfg.hidden_dim, 1),
        "b": torch.zeros(1, dtype=torch.float32, device=dev),
    }
    return params


def params_from_jax(tree: PyTree, device: str | torch.device | None = None) -> PyTree:
    """A params pytree of numpy (or JAX) arrays -> the same tree of tensors, bit for bit."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(params: PyTree) -> PyTree:
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def gru_cell(layer: PyTree, x_t: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Paper eq. (1).  x_t: (B, F), h: (B, N) -> new h."""
    gates_x = x_t @ layer["w_ih"] + layer["b_ih"]          # (B, 3N)
    gates_h = h @ layer["w_hh"] + layer["b_hh"]            # (B, 3N)
    xr, xz, xn = gates_x.chunk(3, dim=-1)
    hr, hz, hn = gates_h.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _layer_scan(layer: PyTree, x: torch.Tensor) -> torch.Tensor:
    """One GRU layer over time, cell by cell.  x: (B, T, F) -> hidden seq (B, T, N)."""
    h = x.new_zeros((x.shape[0], layer["w_hh"].shape[0]))
    outs = []
    for t in range(x.shape[1]):
        h = gru_cell(layer, x[:, t], h)
        outs.append(h)
    return torch.stack(outs, dim=1)


def gru_apply(
    params: PyTree,
    cfg: GRUConfig,
    x: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """x: (B, T, F) -> predicted LoS (B,), strictly non-negative (eq. 2).

    In train mode, dropout between layers draws its masks from
    ``generator``, which must live on ``x``'s device.  With a client axis
    (``x`` of (C, B, T, F), every param leaf with a leading C) the result
    is (C, B) and ``generator`` is a sequence of C generators: client c's
    mask comes from ``generator[c]``.  A client whose entry is None (the
    cohort engine's padding step, whose result it discards) draws nothing
    and keeps every unit, scaled as a kept unit is.  With C = k·G clients
    and G generators, each generator draws one mask for its group of k
    consecutive clients: DP's per-example copies (``privacy/dp.py``), B
    clients of batch 1 a participant, share their participant's
    ``(1, T, N)`` mask.
    """
    if x.dim() == 4:
        return _gru_apply_cohort(params, cfg, x, train, generator)
    h = x
    for i, layer in enumerate(params["layers"]):
        h = gru_sequence(h, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"])
        if train and cfg.dropout > 0.0 and i < len(params["layers"]) - 1:
            if generator is None:
                raise ValueError("dropout requires a generator in train mode")
            u = torch.rand(h.shape, generator=generator, device=h.device, dtype=h.dtype)
            h = torch.where(u < 1.0 - cfg.dropout, h / (1.0 - cfg.dropout), 0.0)
    h_final = h[:, -1, :]  # prediction from the final hidden state (24th hour)
    y_hat = torch.relu(h_final @ params["head"]["w"] + params["head"]["b"])
    return y_hat[:, 0]


def _gru_apply_cohort(params, cfg: GRUConfig, x, train: bool, generators) -> torch.Tensor:
    """``gru_apply`` over a leading client axis: (C, B, T, F) -> (C, B)."""
    h = x
    for i, layer in enumerate(params["layers"]):
        h = gru_sequence(h, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"])
        if train and cfg.dropout > 0.0 and i < len(params["layers"]) - 1:
            if generators is None or not generators or h.shape[0] % len(generators):
                raise ValueError(
                    "dropout over a client axis requires one generator per client "
                    "or per equal group of clients"
                )
            # Each generator's draw has the shape and order of its one-client
            # step; a group of clients (DP's per-example copies) shares it.
            group = h.shape[0] // len(generators)
            u = torch.zeros((len(generators), *h.shape[1:]), device=h.device, dtype=h.dtype)
            for c, g in enumerate(generators):
                if g is not None:
                    u[c].uniform_(0.0, 1.0, generator=g)
            if group > 1:
                u = u.repeat_interleave(group, dim=0)
            h = torch.where(u < 1.0 - cfg.dropout, h / (1.0 - cfg.dropout), 0.0)
    h_final = h[:, :, -1, :]
    y_hat = torch.relu(torch.bmm(h_final, params["head"]["w"]) + params["head"]["b"].unsqueeze(1))
    return y_hat[..., 0]


def msle_loss(
    y: torch.Tensor, y_hat: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Paper eq. (6): mean squared logarithmic error.

    For (C, B) inputs (a client axis) it is a (C,) vector, each client's
    masked mean.
    """
    err = (torch.log1p(y) - torch.log1p(y_hat)) ** 2
    if y_hat.dim() == 2:
        if mask is None:
            return err.mean(dim=-1)
        return (err * mask).sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1.0)
    if mask is None:
        return err.mean()
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg: GRUConfig):
    """loss(params, batch=(x, y, mask), generator) for training loops.

    With a client axis in ``batch`` the loss is (C,) and ``generator`` a
    sequence of per-client generators (None entries draw nothing).
    """

    def loss_fn(params, batch, generator=None):
        x, y, mask = batch
        y_hat = gru_apply(params, cfg, x, train=generator is not None, generator=generator)
        return msle_loss(y, y_hat, mask)

    return loss_fn


def count_params(params: PyTree) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
