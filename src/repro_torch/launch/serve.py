"""Decode driver: batched autoregressive *inference* with a state cache.

The port of ``repro.launch.serve``, with the same CLI and behaviour: a
*reduced* config; for the encoder-decoder, max(prompt_len, 8) frame
embeddings through the encoder into the cache (``encode_for_decode``);
the VLM's patch embeddings and then the prompt fed through the decode
path token by token; then batched greedy decode, with tokens/step timings.
The numpy draws come in the reference's order.  ``--device`` defaults to
the card, where each decode step is a replay of a captured CUDA graph that
writes the donated cache in place (``launch/steps.py::make_serve_step``,
the reference's ``jax.jit(..., donate_argnums=(2,))``).  The decode path
runs no kernel: the SSD kernel runs in the prefill step
(``launch/steps.py::make_prefill_step``).

    python -m repro_torch.launch.serve --arch mamba2-130m --batch 4 --prompt-len 16 --gen 32
    python -m repro_torch.launch.serve --arch internvl2-26b --device cpu
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, ArchType, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.zoo import Model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=ARCH_IDS[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)

    max_len = args.prompt_len + args.gen + cfg.num_frontend_tokens
    cache = model.init_cache(args.batch, max_len, dev)
    serve_step = make_serve_step(model)

    if cfg.arch_type == ArchType.ENCDEC:
        src = torch.from_numpy(rng.normal(
            size=(args.batch, max(args.prompt_len, 8), cfg.d_model)).astype(np.float32)).to(dev)
        with torch.inference_mode():
            cache = model.encode_for_decode(params, src, cache)

    pos = 0
    if cfg.arch_type == ArchType.VLM:
        patches = torch.from_numpy(rng.normal(
            size=(args.batch, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)).to(dev)
        with torch.inference_mode():
            for i in range(cfg.num_frontend_tokens):
                _, cache = model.decode_step(params, None, cache, pos,
                                             token_embeds=patches[:, i : i + 1])
                pos += 1

    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    prompt_t = torch.from_numpy(prompt).to(dev)
    logits = None
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        logits, cache = serve_step(params, prompt_t[:, t : t + 1], cache, pos)
        pos += 1
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(args.gen):
        generated.append(tok[:, 0])
        logits, cache = serve_step(params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1)[:, None]
        pos += 1
    _sync(dev)
    decode_s = time.perf_counter() - t0

    gen = torch.stack(generated, dim=1).cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} device={dev}")
    print(f"prefill: {args.prompt_len} steps in {prefill_s:.2f}s")
    print(
        f"decode : {args.gen} steps in {decode_s:.2f}s "
        f"({args.gen * args.batch / max(decode_s, 1e-9):.1f} tok/s batched)"
    )
    print("sample token ids:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
