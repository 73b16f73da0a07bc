"""An LM's captured train step (``launch/steps.py::make_train_step``).

Set-up: the configuration's ``ArchConfig`` from its file, the benchmark's
weights on the card from the seed, AdamW's state, and the step.  The first
``check_steps`` steps (the first is the capture's warm-up, the second its
first replay) belong to set-up: each step's loss, the first gradient as
AdamW's first moment holds it after one step, and the params' change after
the last are kept for the reference.  The window then runs steps
back to back, a fresh batch of random tokens from the seed each, until
``--seconds`` have passed and the card is done; its rate is every token of
those steps over the window's seconds.  A traced run profiles
``profile_steps`` more steps.  Then the program's state is freed and the
reference trains the same batches from the same weights in float32.
"""

from __future__ import annotations

import time

from harness import common, lm, profile


def batches(cfg: dict, traffic: dict, seed: int, device):
    """An endless stream of ``(tokens, labels)`` of random tokens from the seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1) + 11)
    shape = (traffic["batch"], traffic["seq_len"] + 1)
    while True:
        t = torch.randint(0, cfg["vocab_size"], shape, generator=g, device=device,
                          dtype=torch.int64).to(torch.int32)
        yield t[:, :-1], t[:, 1:]


def optimizer_spec(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("learning_rate", "weight_decay", "b1", "b2", "eps")}


def leaf_norms(tree: dict) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def change_norms(after: dict, before: dict) -> dict:
    """Each leaf's norm of ``after - before`` (flat dicts), in float64."""
    import torch

    return {k: float(torch.linalg.vector_norm(after[k].double() - before[k].double()))
            for k in before}


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.zoo import Model
    from repro_torch.optim.adamw import AdamW

    cfg, traffic = cell["config"], cell["traffic"]
    ref = common.load_module(cell["config_dir"] / "reference.py", "lm_reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg["dtype"])
    params = ref.init_params(cfg, seed, device, dtype)
    spec = optimizer_spec(traffic)
    opt = AdamW(spec["learning_rate"], b1=spec["b1"], b2=spec["b2"], eps=spec["eps"],
                weight_decay=spec["weight_decay"])
    state = opt.init(params)
    step = make_train_step(Model(lm.arch_config(cfg), remat=traffic["remat"]), opt)
    feed = batches(cfg, traffic, seed, device)
    sync = (lambda: torch.cuda.synchronize()) if device != "cpu" else (lambda: None)

    def one():
        nonlocal params, state
        tokens, labels = next(feed)
        params, state, metrics = step(params, state, {"tokens": tokens, "labels": labels})
        return metrics

    losses, grad1 = [], None
    for k in range(traffic["check_steps"]):
        metrics = one()
        losses.append(float(metrics["ce"]))
        if k == 0:
            grad1 = leaf_norms({key: m.float() / (1 - spec["b1"])
                                for key, m in ref.flat(state.mu).items()})
    change = change_norms(ref.flat(params), ref.flat(ref.init_params(cfg, seed, device, dtype)))
    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        one()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            sync()
            break
    window_s = time.perf_counter() - t0
    traced = None
    if trace:
        traced = profile.profile(lambda: [one() for _ in range(traffic["profile_steps"])], device)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del params, state, step
    if device != "cpu":
        torch.cuda.empty_cache()

    checks = judge(cell, ref, seed, device, losses, grad1, change)
    tokens_a_step = traffic["batch"] * traffic["seq_len"]
    rate = tokens_a_step * n / window_s
    ctx = {"rate": rate, "window_s": window_s, "steps": n, "trace": traced,
           "units": traffic["profile_steps"], "params": cfg["params"], "tokens_a_step": tokens_a_step,
           "ssd_shape": ssd_shape(cfg, traffic)}
    return {"setup_s": t0 - t_start,
            "e2e": {"lm_train_tokens_per_s": rate, "peak_device_gib": peak / 2**30},
            "ctx": ctx, "attempted": n, "failed": 0, "peak_bytes": peak, "checks": checks}


def ssd_shape(cfg: dict, traffic: dict) -> dict:
    """One SSD call's shape (B, NC, L, H, P, N) and the calls a step needs:
    a forward and a backward a layer."""
    chunk = cfg["chunk_size"]
    nc = -(-traffic["seq_len"] // chunk)
    heads = cfg["expand"] * cfg["d_model"] // cfg["headdim"]
    return {"shape": (traffic["batch"], nc, chunk, heads, cfg["headdim"], cfg["d_state"]),
            "layers": cfg["n_layer"]}


def reference_batches(cell: dict, seed: int, device, half: bool = False) -> list:
    traffic = cell["traffic"]
    feed = batches(cell["config"], traffic, seed, device)
    out = []
    for _ in range(traffic["check_steps"]):
        tokens, labels = next(feed)
        if half:
            h = tokens.shape[0] // 2
            tokens, labels = tokens[:h], labels[:h]
        out.append((tokens, labels))
    return out


def judge(cell, ref, seed, device, losses, grad1, change, program=None) -> list:
    """The reference's first steps against the program's: the worst step's
    loss gap, relative to the reference's, the first gradient by its worst
    leaf and by its median leaf (``common.leaf_gap``, ``median_leaf_gap``:
    the fp8 control stands out in the bulk of the params, where no small
    float32 leaf's noise leads), and the params' change after the steps by
    its worst leaf (its leaves left out by the reference's first gradient).  ``program`` (``"control"``, or a fault:
    ``"half_batch"``, ``"params_unwritten"``) puts a second reference in the
    program's place."""
    import torch

    cfg, traffic = cell["config"], cell["traffic"]
    spec = optimizer_spec(traffic)
    p0 = ref.init_params(cfg, seed, device, getattr(torch, cfg["dtype"]))
    if program is not None:
        batches = reference_batches(cell, seed, device, program == "half_batch")
        losses, first, final = ref.train_steps(p0, batches, cfg, spec,
                                               quantize=program == "control",
                                               write_params=program != "params_unwritten")
        grad1, change = leaf_norms(first), change_norms(final, ref.flat(p0))
    r_losses, r_first, r_final = ref.train_steps(p0, reference_batches(cell, seed, device), cfg,
                                                 spec)
    r_grad = leaf_norms(r_first)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    limits = traffic["limits"]
    return [common.check_entry("loss_rel_gap", loss_gap, limits["loss_rel_gap"]),
            common.check_entry("grad1_norm_gap", common.leaf_gap(grad1, r_grad),
                               limits["grad1_norm_gap"]),
            common.check_entry("grad1_median_gap", common.median_leaf_gap(grad1, r_grad),
                               limits["grad1_median_gap"]),
            common.check_entry("change_norm_gap",
                               common.leaf_gap(change, change_norms(r_final, ref.flat(p0)),
                                               basis=r_grad),
                               limits["change_norm_gap"])]


def control(cell: dict, seed: int, device: str, mode: str) -> list:
    ref = common.load_module(cell["config_dir"] / "reference.py", "lm_reference")
    return judge(cell, ref, seed, device, None, None, None, program=mode)
