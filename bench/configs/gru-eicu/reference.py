"""Plain reference of gru-eicu's federated rounds: FedAvg over AdamW clients.

Written from the paper (2 stacked GRU layers, eq. (1); a ReLU head, eq.
(2); MSLE, eq. (6); AdamW; FedAvg weighted by n_c) and from the program's
documented contracts for what is drawn from which stream, so that a round
here is the program's round up to rounding:

* the batch plan: one ``numpy`` generator ``default_rng(seed)``, drawn
  client-major, one ``permutation(n_c)`` a client a local epoch, batches of
  B in that order, the last one short (its missing rows masked);
* each participant's generator: ``default_rng([seed, 2])`` draws one int64
  seed a participant a round, in participant order, for a
  ``torch.Generator`` on the device; on each of its real steps the client
  draws its dropout mask (a float32 uniform of ``(B, T, N)``, or under DP
  one ``(1, T, N)`` shared by its B examples) and then, under DP, one
  float32 standard normal a param leaf, in sorted-key leaf order;
* a round's reported loss: each client's mean of its last epoch's step
  losses, averaged over the clients.

Everything else is computed here in plain PyTorch in ``dtype`` (float64 for
the reference; float32 for the control, whose products round their
operands to TF32, forward and backward, as TF32 tensor cores do):
the recurrence cell by cell, autograd for the gradients, AdamW and FedAvg
by their formulas.  Clients run side by side on a leading client axis,
each with its own params; a client that has finished its steps drops off
the axis.  Nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def leaf_names(num_layers: int) -> list[tuple]:
    """The params' leaves in sorted-key order: ``head`` (b, w), then each
    layer's b_hh, b_ih, w_hh, w_ih."""
    names = [("head", "b"), ("head", "w")]
    for layer in range(num_layers):
        names += [("layers", layer, k) for k in ("b_hh", "b_ih", "w_hh", "w_ih")]
    return names


def get(tree, name):
    for k in name:
        tree = tree[k]
    return tree


def init_params(cfg: dict, seed: int, device) -> dict:
    """U(-1/sqrt(N), 1/sqrt(N)) for every weight and GRU bias, a zero head
    bias, float32, drawn on ``device`` from ``seed``."""
    n, f = cfg["hidden_dim"], cfg["input_dim"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1) + 1)
    scale = 1.0 / math.sqrt(n)

    def uniform(*shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return u * (2 * scale) - scale

    layers = []
    for layer in range(cfg["num_layers"]):
        fin = f if layer == 0 else n
        layers.append({"w_ih": uniform(fin, 3 * n), "w_hh": uniform(n, 3 * n),
                       "b_ih": uniform(3 * n), "b_hh": uniform(3 * n)})
    return {"layers": layers,
            "head": {"w": uniform(n, 1), "b": torch.zeros(1, dtype=torch.float32, device=device)}}


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to TF32's 10 stored mantissa bits (to nearest)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Bmm(torch.autograd.Function):
    """``bmm`` whose operands are rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a), _tf32(b)
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


def _bmm(a, b, tf32: bool):
    return _Tf32Bmm.apply(a, b) if tf32 else torch.bmm(a, b)


def _gru_layer(w_ih, w_hh, b_ih, b_hh, x, tf32=False):
    """x (A, R, T, Fin) with per-client weights (A, Fin, 3N) -> (A, R, T, N)."""
    a, r, t, fin = x.shape
    n = w_hh.shape[1]
    gx = _bmm(x.reshape(a, r * t, fin), w_ih, tf32).reshape(a, r, t, 3 * n) + b_ih[:, None, None, :]
    h = x.new_zeros((a, r, n))
    outs = []
    for step in range(t):
        gh = _bmm(h, w_hh, tf32) + b_hh[:, None, :]
        xr, xz, xn = gx[:, :, step].split(n, dim=-1)
        hr, hz, hn = gh.split(n, dim=-1)
        rg = torch.sigmoid(xr + hr)
        zg = torch.sigmoid(xz + hz)
        ng = torch.tanh(xn + rg * hn)
        h = (1.0 - zg) * ng + zg * h
        outs.append(h)
    return torch.stack(outs, dim=2)


def _predict(p: dict, x, keep, dropout: float, tf32: bool = False):
    """The model over a client axis; ``keep`` (A, R or 1, T, N) boolean
    masks the first layer's output (inverted dropout)."""
    h = x
    layers = p["layers"]
    for i, layer in enumerate(layers):
        h = _gru_layer(layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"], h, tf32)
        if i < len(layers) - 1 and dropout > 0.0:
            h = torch.where(keep, h / (1.0 - dropout), torch.zeros((), dtype=h.dtype, device=h.device))
    y_hat = torch.relu(_bmm(h[:, :, -1, :], p["head"]["w"], tf32) + p["head"]["b"][:, None, :])
    return y_hat[..., 0]


def _sq_log_err(y, y_hat):
    return (torch.log1p(y) - torch.log1p(y_hat)) ** 2


def train_round(params: dict, hospitals: list, rng: np.random.Generator,
                gen_rng: np.random.Generator, cfg: dict, train: dict, *,
                dtype=torch.float64, device="cuda", dp: dict | None = None,
                tf32: bool = False, fault: str | None = None) -> tuple[dict, np.ndarray]:
    """One FedAvg round over every hospital (all participate).

    ``params``: float32 or ``dtype`` tensors in the program's layout;
    ``hospitals``: each participant's train ``(x, y)`` numpy arrays, in
    participant order; ``rng`` and ``gen_rng`` the two streams (advanced).
    Returns the new params in ``dtype`` and each participant's mean local
    loss.  ``tf32`` rounds every product's operands to TF32 (the control).
    ``fault`` plants a known fault for the harness's tests: ``"half_batch"``
    trains every step on the first half of its batch."""
    b, epochs = train["batch_size"], train["local_epochs"]
    lr, wd = train["learning_rate"], train["weight_decay"]
    b1, b2, eps = train["b1"], train["b2"], train["eps"]
    drop = cfg["dropout"]
    n_hidden, t_len = cfg["hidden_dim"], None
    c_all = len(hospitals)
    seeds = gen_rng.integers(0, np.iinfo(np.int64).max, size=c_all, dtype=np.int64)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]

    sizes = np.array([len(y) for _, y in hospitals], dtype=np.int64)
    plans = []
    for n in sizes:
        batches = []
        for _ in range(epochs):
            perm = rng.permutation(int(n))
            batches += [perm[s:s + b] for s in range(0, int(n), b)]
        plans.append(batches)
    steps = np.array([len(p) for p in plans])
    spe = -(-sizes // b)
    # Longest first, so that the clients still training are a prefix.
    order = np.argsort(-steps, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    x_all = torch.from_numpy(np.concatenate([x for x, _ in hospitals])).to(device, dtype)
    y_all = torch.from_numpy(np.concatenate([y for _, y in hospitals])).to(device, dtype)
    t_len = x_all.shape[1]
    k_max = int(steps.max())
    index = np.full((k_max, c_all, b), -1, dtype=np.int64)
    for slot, c in enumerate(order):
        for k, rows in enumerate(plans[c]):
            index[k, slot, :len(rows)] = rows + offsets[c]
    index = torch.from_numpy(index).to(device)

    names = leaf_names(len(params["layers"]))
    stacked = {nm: get(params, nm).to(device, dtype).unsqueeze(0).repeat(
        c_all, *([1] * get(params, nm).dim())).contiguous() for nm in names}
    mom = {nm: torch.zeros_like(t) for nm, t in stacked.items()}
    vel = {nm: torch.zeros_like(t) for nm, t in stacked.items()}
    sigma = 0.0 if dp is None else dp["noise_multiplier"] * dp["clip_norm"]
    mshape = (b, t_len, n_hidden) if dp is None else (1, t_len, n_hidden)
    u = torch.empty((c_all, *mshape), dtype=torch.float32, device=device)
    noise = {nm: torch.empty((c_all, *get(params, nm).shape), dtype=torch.float32, device=device)
             for nm in names}
    step_losses = []

    for k in range(k_max):
        a = int((steps[order] > k).sum())
        rows = index[k, :a]
        if fault == "half_batch":
            rows = rows.clone()
            rows[:, b // 2:] = -1
        mask = (rows >= 0).to(dtype)
        safe = rows.clamp(min=0)
        xb = x_all[safe]                       # (A, B, T, F)
        yb = y_all[safe] * mask
        for slot in range(a):
            u[slot].uniform_(0.0, 1.0, generator=gens[order[slot]])
        keep = u[:a] < 1.0 - drop
        p = {nm: stacked[nm][:a].detach().requires_grad_(True) for nm in names}
        tree = {"layers": [{} for _ in params["layers"]], "head": {}}
        if dp is None:
            for nm in names:
                _place(tree, nm, p[nm])
            y_hat = _predict(tree, xb, keep, drop, tf32)
            per_client = (_sq_log_err(yb, y_hat) * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
            grads = torch.autograd.grad(per_client.sum(), [p[nm] for nm in names])
        else:
            copies = {nm: p[nm].detach().repeat_interleave(b, dim=0).requires_grad_(True)
                      for nm in names}
            for nm in names:
                _place(tree, nm, copies[nm])
            keep_e = keep.repeat_interleave(b, dim=0)      # (A·B, 1, T, N)
            y_hat = _predict(tree, xb.reshape(a * b, 1, *xb.shape[2:]), keep_e, drop, tf32)
            m_e = mask.reshape(a * b, 1)
            per_example = _sq_log_err(yb.reshape(a * b, 1), y_hat) * m_e
            g_e = torch.autograd.grad(per_example.sum(), [copies[nm] for nm in names])
            sq = sum(g.reshape(a * b, -1).square().sum(1) for g in g_e)
            factor = torch.clamp(dp["clip_norm"] / (sq.sqrt() + 1e-12), max=1.0)
            denom = mask.sum(-1).clamp(min=1.0)
            grads = []
            for nm, g in zip(names, g_e):
                s = (factor[:, None] * g.reshape(a * b, -1)).reshape(a, b, -1).sum(1)
                s = s.reshape(a, *g.shape[1:])
                if sigma:
                    z = noise[nm]
                    for slot in range(a):
                        z[slot].normal_(generator=gens[order[slot]])
                    s = s + sigma * z[:a].to(dtype)
                grads.append(s / denom.view(a, *([1] * (s.dim() - 1))))
            per_client = per_example.reshape(a, b).sum(-1) / denom
        with torch.no_grad():
            step = k + 1
            c1 = 1.0 - b1 ** step
            c2 = 1.0 - b2 ** step
            for nm, g in zip(names, grads):
                m_, v_, w_ = mom[nm][:a], vel[nm][:a], stacked[nm][:a]
                m_.mul_(b1).add_((1 - b1) * g)
                v_.mul_(b2).add_((1 - b2) * g * g)
                w_.sub_(lr * ((m_ / c1) / ((v_ / c2).sqrt() + eps) + wd * w_))
        step_losses.append(per_client.detach())
    weights = torch.from_numpy(sizes.astype(np.float64)).to(device, dtype)
    weights = weights[torch.from_numpy(order).to(device)]
    new = {"layers": [{} for _ in params["layers"]], "head": {}}
    for nm in names:
        w = weights.view(-1, *([1] * (stacked[nm].dim() - 1)))
        _place(new, nm, (stacked[nm] * w).sum(0) / weights.sum())
    loss_sum = np.zeros(c_all)
    loss_cnt = np.zeros(c_all)
    for k, losses in enumerate(step_losses):
        losses = losses.double().cpu().numpy()
        for slot, c in enumerate(order[:len(losses)]):
            if k >= steps[c] - spe[c]:
                loss_sum[c] += losses[slot]
                loss_cnt[c] += 1
    return new, loss_sum / np.maximum(loss_cnt, 1)


def _place(tree, name, value):
    if name[0] == "head":
        tree["head"][name[1]] = value
    else:
        tree["layers"][name[1]][name[2]] = value
