"""Training entry point: the port of ``repro.launch.train``.

Two modes:

  * ``paper`` (default) — the paper's experiments on the synthetic eICU
    cohort: central / federated with and without client recruitment.
  * ``lm`` — single-process smoke training of any architecture's *reduced*
    variant on synthetic tokens; the VLM's patch embeddings, or the
    encoder-decoder's frame embeddings (max(seq // 4, 8) frames), are
    drawn from the same numpy stream right after each batch's tokens, as in
    the reference.

``--device`` defaults to the card and raises where there is none; ``cpu``
runs the plain versions of the kernels.  There is no ``--pallas``: the
device decides.  Paper results go to ``build/results/paper/`` of the
checkout.

    python -m repro_torch.launch.train --setting federated-src --scale 0.2 --seeds 0 1 2
    python -m repro_torch.launch.train --mode lm --arch mamba2-130m --steps 10
    python -m repro_torch.launch.train --mode lm --arch zamba2-7b --steps 10
    python -m repro_torch.launch.train --mode lm --arch deepseek-v3-671b --steps 10
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, ArchType, get_config
from repro_torch.data.pipeline import lm_token_batch
from repro_torch.device import resolve_device
from repro_torch.experiments.paper import MODEL_SETTINGS, ExperimentConfig, run_seeds
from repro_torch.launch.steps import make_train_step
from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import AdamW

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "results"


def run_paper(args) -> None:
    exp = ExperimentConfig(
        cohort_scale=args.scale,
        rounds=args.rounds,
        gamma_th=args.gamma_th,
        device=str(resolve_device(args.device)),
    )
    agg = run_seeds(args.setting, exp, seeds=args.seeds)
    print(json.dumps({k: v for k, v in agg.items() if k != "runs"}, indent=2))
    out = RESULTS_DIR / "paper" / f"{args.setting}_scale{args.scale}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(agg, indent=1))
    print(f"saved -> {out}")


def run_lm(args) -> None:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Model(cfg, remat=False)
    optimizer = AdamW(learning_rate=1e-3)
    params = model.init(torch.Generator().manual_seed(args.seed), dev)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer)
    rng = np.random.default_rng(args.seed)

    for i in range(args.steps):
        batch = lm_token_batch(rng, args.batch, args.seq, cfg.vocab_size)
        if cfg.arch_type == ArchType.VLM:
            batch["patch_embeds"] = rng.normal(
                size=(args.batch, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
        if cfg.arch_type == ArchType.ENCDEC:
            batch["src_embeds"] = rng.normal(
                size=(args.batch, Model.encoder_frames(args.seq), cfg.d_model)).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step(params, opt_state, batch)
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print("lm smoke training done")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["paper", "lm"], default="paper")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # paper mode
    ap.add_argument("--setting", choices=list(MODEL_SETTINGS), default="federated-src")
    ap.add_argument("--scale", type=float, default=1.0, help="cohort scale (1.0 = full)")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--gamma-th", type=float, default=0.1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    # lm mode
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=ARCH_IDS[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mode == "paper":
        run_paper(args)
    else:
        run_lm(args)


if __name__ == "__main__":
    main()
