"""Quickstart on the PyTorch port: client recruitment + a small federation.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``: the same steps through
``repro_torch``, on the card unless ``--device cpu``.
"""

import argparse

import torch

from repro_torch.core import BALANCED, recruit
from repro_torch.data import CohortConfig, build_client_datasets, generate_cohort, global_dataset
from repro_torch.federated import Federation, FederationConfig
from repro_torch.metrics import evaluate_predictions
from repro_torch.models.gru import GRUConfig, gru_apply, init_gru, make_loss_fn
from repro_torch.optim import AdamW


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 1. a synthetic multi-hospital ICU cohort (5% of the paper's scale)
    cohort = generate_cohort(CohortConfig().scaled(0.05), seed=0)
    clients = build_client_datasets(cohort)
    print(f"cohort: {len(cohort.y):,} stays across {len(clients)} hospitals")

    # 2. recruitment: each hospital discloses ONLY (target histogram, n_c)
    stats = [c.stats() for c in clients]
    result = recruit(stats, BALANCED)
    print(
        f"recruited {result.num_recruited}/{len(clients)} clients "
        f"(gamma_dv={BALANCED.gamma_dv}, gamma_sa={BALANCED.gamma_sa}, "
        f"gamma_th={BALANCED.gamma_th}; threshold iota={result.iota:.2f})"
    )

    # 3. federated training as a policy combination (Federated-SRC setting):
    #    nu-greedy recruitment + 10% uniform per-round sampling + FedAvg.
    #    Swap any stage by spec string — recruitment="random-k:20",
    #    selection="round-robin:0.1", aggregator="trimmed-mean:0.1", ... —
    #    or pass your own policy instance (see examples/torch_custom_policy.py).
    #    The vectorized engine trains every round participant in batched
    #    steps (the GRU kernels on a client axis); client data is uploaded to
    #    the device once (staging="resident") and rounds stage int32 index plans.
    model_cfg = GRUConfig()
    fed_cfg = FederationConfig(
        rounds=5, local_epochs=2, seed=0, engine="vectorized",
        recruitment="nu-greedy", selection="uniform:0.1", aggregator="fedavg",
    )
    print(f"engine: {fed_cfg.engine}")
    federation = Federation(
        fed_cfg,
        clients,
        make_loss_fn(model_cfg),
        AdamW(learning_rate=5e-3, weight_decay=5e-3),
        device=args.device,
    )
    out = federation.run(
        init_gru(torch.Generator().manual_seed(0), model_cfg, args.device),
        progress=lambda r: print(
            f"  round {r.round_index}: {len(r.participant_ids)} clients, "
            f"local loss {r.mean_local_loss:.4f}"
        ),
    )

    # 4. evaluate on held-out patients from ALL hospitals (recruited or not)
    test = global_dataset(cohort, cohort.TEST)
    with torch.no_grad():
        x = torch.from_numpy(test.x).to(args.device)
        y_hat = gru_apply(out.params, model_cfg, x).cpu().numpy()
    print("test metrics:", {k: round(v, 4) for k, v in evaluate_predictions(test.y, y_hat).items()})
    print("total wall time:", f"{out.total_wall_time_s:.1f}s")


if __name__ == "__main__":
    main()
