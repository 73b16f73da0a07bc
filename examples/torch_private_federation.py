"""Private federation on the PyTorch port: DP-SGD, masked-sum secagg, one attack.

    PYTHONPATH=src python examples/torch_private_federation.py [--device cpu]

The port of ``examples/private_federation.py``.  Three runs on the same
small cohort: (1) DP-SGD — per-example clipping and Gaussian noise inside
the batched round, with the accountant's cumulative epsilon on every round
record; (2) the same round program aggregated through pairwise-masked
fixed-point sums, so the server never sees a plaintext update; (3) a
label-flip attack that plain FedAvg absorbs into the average but the Krum
aggregator discards.
"""

import argparse

import numpy as np
import torch

from repro_torch.data import CohortConfig, build_client_datasets, generate_cohort
from repro_torch.federated import Federation, FederationConfig
from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
from repro_torch.optim import AdamW
from repro_torch.privacy import DPConfig, ScenarioConfig, apply_scenario


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = args.device

    cohort = generate_cohort(CohortConfig().scaled(0.02), seed=0)
    clients = build_client_datasets(cohort)[:12]
    model_cfg = GRUConfig(dropout=0.0, hidden_dim=8, num_layers=1)
    loss_fn, optimizer = make_loss_fn(model_cfg), AdamW(learning_rate=5e-3)
    params0 = init_gru(torch.Generator().manual_seed(0), model_cfg, device)

    def run(fed_cfg, scenario=None, opt=optimizer):
        federation = Federation(fed_cfg, clients, loss_fn, opt, device=device)
        if scenario is not None:
            apply_scenario(federation, scenario)
        return federation.run(params0)

    # 1. DP-SGD rides the batched cohort step; epsilon accumulates per round.
    out = run(FederationConfig(
        rounds=3, local_epochs=2, batch_size=16, seed=0,
        privacy=DPConfig(clip_norm=1.0, noise_multiplier=1.1),
    ))
    for record in out.history:
        print(f"  round {record.round_index}: loss {record.mean_local_loss:.4f} "
              f"epsilon {record.epsilon:.2f}")
    print(f"DP-SGD final (epsilon, delta): ({out.summary()['epsilon']:.2f}, 1e-05)")

    # 2. Secure aggregation: the server sums masked fixed-point tensors;
    #    ":0.2" lets each client drop out with p=0.2 (mask recovery path).
    out = run(FederationConfig(
        rounds=3, local_epochs=2, batch_size=16, seed=0,
        aggregator="secagg-fedavg:0.2",
    ))
    print(f"secagg final loss: {out.history[-1].mean_local_loss:.4f}")

    # 3. Adversarial clients: 30% of clients flip their labels.  Krum
    #    scores updates by neighbor distance and discards the attackers.
    #    Evaluate on clean held-out data — reported local losses would be
    #    contaminated by what the attackers claim about their own data.
    val_x = torch.from_numpy(np.concatenate([c.val.x for c in clients])).to(device)
    val_y = torch.from_numpy(np.concatenate([c.val.y for c in clients])).to(device)
    val = (val_x, val_y, torch.ones(val_y.shape[0], dtype=torch.float32, device=device))
    attack = ScenarioConfig(attack="label-flip", fraction=0.3, seed=5)
    hot = AdamW(learning_rate=5e-2)  # enough rounds x lr for attacks to bite
    for aggregator in ("fedavg", "krum:4"):
        cfg = FederationConfig(rounds=6, local_epochs=3, batch_size=16,
                               seed=0, aggregator=aggregator)
        clean_params, bad_params = run(cfg, opt=hot).params, run(cfg, attack, opt=hot).params
        with torch.no_grad():
            clean, bad = float(loss_fn(clean_params, val)), float(loss_fn(bad_params, val))
        print(f"{aggregator}: clean val {clean:.4f} vs attacked {bad:.4f}")


if __name__ == "__main__":
    main()
