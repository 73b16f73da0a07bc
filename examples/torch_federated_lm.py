"""Beyond-paper example on the PyTorch port: the recruitment technique is model-agnostic.

    PYTHONPATH=src python examples/torch_federated_lm.py [--device cpu]

The port of ``examples/federated_lm.py``, with its constants and numpy
streams.  Federated fine-tuning of a *reduced* smollm-135m across synthetic
hospital text shards: each client's disclosure is a TOKEN histogram (10
vocabulary buckets) + sample size — exactly the paper's (P_co, n_c) tuple,
applied to a language model instead of the LoS GRU.  Recruitment then
gates which hospitals join the federation, and FedAvg aggregates
transformer weights.

The disclosed sample size is the number of tokens the histogram counts.
The reference example discloses the number of sequences, which
``ClientStats`` refuses (a histogram may not count more than n), so it
stops before recruiting; a token is the LM's sample, and the FedAvg
weights stay the sequence counts, as in the reference.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.histogram import token_histogram
from repro_torch.core.recruitment import BALANCED, ClientStats, recruit
from repro_torch.device import resolve_device
from repro_torch.federated.fedavg import aggregate
from repro_torch.launch.steps import make_train_step
from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_map

NUM_CLIENTS = 12
SEQ, BATCH = 64, 4
ROUNDS, LOCAL_STEPS = 3, 5


def make_client_corpus(rng, vocab, skew: float):
    """Non-IID token distributions: each hospital's notes favor a band of the
    vocabulary (specialty jargon); skew controls divergence."""
    center = rng.uniform(0, vocab)
    width = vocab * (1.0 - 0.8 * skew)
    n_samples = int(rng.integers(40, 400))
    toks = (rng.normal(center, width, size=(n_samples, SEQ + 1)) % vocab).astype(np.int32)
    return toks


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, remat=False)
    optimizer = AdamW(learning_rate=1e-3)
    rng = np.random.default_rng(0)

    corpora = [make_client_corpus(rng, cfg.vocab_size, skew=rng.uniform(0, 1)) for _ in range(NUM_CLIENTS)]

    # recruitment on token histograms — the paper's disclosure, LM flavor
    stats = [
        ClientStats(client_id=i, counts=token_histogram(c[:, 1:], cfg.vocab_size), n=c[:, 1:].size)
        for i, c in enumerate(corpora)
    ]
    res = recruit(stats, dataclasses.replace(BALANCED, gamma_th=0.3))
    recruited = sorted(res.recruited_ids.tolist())
    print(f"recruited {res.num_recruited}/{NUM_CLIENTS} hospital text shards: {recruited}")

    params = model.init(torch.Generator().manual_seed(0), dev)
    step = make_train_step(model, optimizer)

    round_losses = []
    for rnd in range(ROUNDS):
        client_params, weights = [], []
        for cid in res.recruited_ids:
            corpus = corpora[int(cid)]
            p = tree_map(torch.clone, params)  # the step updates its params in place
            opt_state = optimizer.init(p)
            losses = []
            for k in range(LOCAL_STEPS):
                idx = rng.integers(0, len(corpus), BATCH)
                toks = torch.from_numpy(corpus[idx]).to(dev)
                batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
                p, opt_state, metrics = step(p, opt_state, batch)
                losses.append(float(metrics["loss"]))
            client_params.append(p)
            weights.append(len(corpus))
        params = aggregate(client_params, weights)
        round_losses.append(float(np.mean(losses)))
        print(f"round {rnd}: mean local loss {round_losses[-1]:.4f} "
              f"({len(client_params)} clients aggregated)")

    print("federated LM fine-tuning done — recruitment + FedAvg over a transformer.")
    return {"recruited": recruited, "round_losses": round_losses, "params": params}


if __name__ == "__main__":
    main()
