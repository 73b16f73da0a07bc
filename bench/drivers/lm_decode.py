"""An LM's captured greedy decode (``launch/steps.py::make_serve_step``).

Set-up: the configuration's ``ArchConfig``, the benchmark's weights on the
card from the seed, the cache, and B prompts of random tokens from the
seed, fed through the decode step one position at a time (the program's
way of filling its cache; the first call captures the step).  The window
then decodes greedily in a closed loop, one step after another, each
step's tokens read back on the host before the next is sent, until
``--seconds`` have passed: its rate is every token of those steps over the
window's seconds.  A traced run profiles ``profile_steps`` more steps.
Then the program's state is freed and the reference reads, for a sample of
the sequences drawn from the seed, the prompt and every served token in one
float32 forward, and finds the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import time

import numpy as np

from harness import common, lm, profile


def prompts(cfg: dict, traffic: dict, seed: int, device):
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1) + 13)
    return torch.randint(0, cfg["vocab_size"], (traffic["batch"], traffic["prompt_len"]),
                         generator=g, device=device, dtype=torch.int64).to(torch.int32)


def sample(traffic: dict, seed: int) -> list[int]:
    """The sequences the reference reads, drawn from the seed."""
    rng = np.random.default_rng([seed, 5])
    return sorted(rng.choice(traffic["batch"], traffic["check_sequences"], replace=False).tolist())


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.zoo import Model

    cfg, traffic = cell["config"], cell["traffic"]
    ref = common.load_module(cell["config_dir"] / "reference.py", "lm_reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = ref.init_params(cfg, seed, device, getattr(torch, cfg["dtype"]))
    model = Model(lm.arch_config(cfg))
    cache = model.init_cache(traffic["batch"], traffic["prompt_len"] + traffic["max_new"], device)
    serve = make_serve_step(model)
    prompt = prompts(cfg, traffic, seed, device)
    logits = None
    for t in range(traffic["prompt_len"]):
        logits, cache = serve(params, prompt[:, t:t + 1], cache, t)
    pos = traffic["prompt_len"]
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    served = [tok[:, 0].cpu().numpy()]
    t0 = time.perf_counter()

    def one():
        nonlocal logits, cache, tok, pos
        logits, cache = serve(params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        pos += 1
        served.append(tok[:, 0].cpu().numpy())

    n = 0
    while time.perf_counter() - t0 < seconds and pos < traffic["prompt_len"] + traffic["max_new"] - 1:
        one()
        n += 1
    window_s = time.perf_counter() - t0
    traced = None
    if trace:
        traced = profile.profile(lambda: [one() for _ in range(traffic["profile_steps"])], device)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del cache, serve, logits, params
    if device != "cpu":
        torch.cuda.empty_cache()

    tokens = np.stack(served, axis=1)             # (B, served)
    params = ref.init_params(cfg, seed, device, getattr(torch, cfg["dtype"]))
    checks = judge(cell, ref, params, prompt, tokens, seed)
    rate = traffic["batch"] * n / window_s
    ctx = {"rate": rate, "window_s": window_s, "steps": n, "trace": traced,
           "units": traffic["profile_steps"], "tokens": tokens}
    return {"setup_s": t0 - t_start,
            "e2e": {"decode_tokens_per_s": rate, "peak_device_gib": peak / 2**30},
            "ctx": ctx, "attempted": traffic["batch"] * n, "failed": 0, "peak_bytes": peak,
            "checks": checks}


def gaps(ref, params, cfg, prompt_row, served_row, quantize=False) -> np.ndarray:
    """At each served position, the reference's best logit less its logit of
    the served token (or, with ``quantize``, of the token that the lower
    precision puts first)."""
    import torch

    seq = torch.cat([prompt_row, torch.as_tensor(served_row, device=prompt_row.device,
                                                 dtype=prompt_row.dtype)])
    k = len(served_row)
    truth = ref.logits(params, seq[:-1], cfg)[-k:]
    if quantize:
        chosen = ref.logits(params, seq[:-1], cfg, quantize=True)[-k:].argmax(-1)
    else:
        chosen = torch.as_tensor(served_row, device=truth.device).long()
    best = truth.max(-1).values
    return (best - truth.gather(-1, chosen[:, None])[:, 0]).cpu().numpy()


def judge(cell, ref, params, prompt, tokens, seed, quantize=False) -> list:
    cfg, traffic = cell["config"], cell["traffic"]
    widest = max(float(gaps(ref, params, cfg, prompt[i], tokens[i], quantize).max())
                 for i in sample(traffic, seed))
    return [common.check_entry("served_logit_gap", widest, traffic["limits"]["served_logit_gap"])]


def control(cell: dict, seed: int, device: str, mode: str) -> list:
    """The served tokens' check with the reference in fp8 in the program's
    place, on the tokens that the program serves in a window of
    ``control_seconds``."""
    import torch

    if mode != "control":
        raise ValueError(f"no fault {mode!r} for a decode cell")
    out = run(cell, seed, cell["traffic"]["control_seconds"], False, device, time.perf_counter())
    ref = common.load_module(cell["config_dir"] / "reference.py", "lm_reference")
    params = ref.init_params(cell["config"], seed, device, getattr(torch, cell["config"]["dtype"]))
    return judge(cell, ref, params, prompts(cell["config"], cell["traffic"], seed, device),
                 out["ctx"]["tokens"], seed, quantize=True)
