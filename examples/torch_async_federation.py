"""Async federation demo on the PyTorch port: stragglers, staleness, and the
recruitment claim.

    PYTHONPATH=src python examples/torch_async_federation.py [--scale 0.05] [--device cpu]

The port of ``examples/async_federation.py``.  It runs the event-driven
``AsyncFederation`` (``repro_torch.federated.runtime``) twice under a
heavy-tailed straggler latency model — once with every hospital in the
federation, once with only the nu-greedy recruited subset — and compares
the simulated virtual-clock time each needs to reach a shared target loss.

Things to try:

* ``--latency pareto:1.2`` (fatter straggler tail), ``--latency trace``
  (compute time tracks local data size — the big hospitals become the slow
  hospitals), ``--latency constant`` (no spread: fedbuff with a full
  buffer degenerates to synchronous FedAvg).
* ``--aggregator hierarchical-async:4`` — regional sub-federations whose
  cross-pod combines tolerate stale global params.
* ``--dropout 0.2`` — every dispatch fails with probability 0.2; dropped
  clients retry after their latency elapses.
"""

import argparse

import torch

from repro_torch.data.pipeline import build_client_datasets
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
from repro_torch.experiments.paper import shared_time_to_target
from repro_torch.federated.runtime import AsyncFederation, AsyncFederationConfig
from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
from repro_torch.optim.adamw import AdamW


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05, help="cohort scale (1.0 = 89k stays)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flushes", type=int, default=6, help="buffered-aggregation flush budget")
    ap.add_argument(
        "--latency", default="lognormal:0.6",
        help="latency model spec: constant[:t], lognormal[:sigma], "
        "pareto[:alpha], trace[:per_sample]",
    )
    ap.add_argument("--dropout", type=float, default=0.05, help="per-dispatch failure probability")
    ap.add_argument(
        "--aggregator", default="fedbuff:0.25",
        help="buffered aggregator spec ('fedbuff:K' with an int count or a "
        "fraction of the federation, 'hierarchical-async:R'); default "
        "flushes every quarter-federation",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cohort = generate_cohort(CohortConfig().scaled(args.scale), seed=args.seed)
    clients = build_client_datasets(cohort)
    model_cfg = GRUConfig(hidden_dim=8, num_layers=1)
    loss_fn = make_loss_fn(model_cfg)
    params0 = init_gru(torch.Generator().manual_seed(args.seed), model_cfg, args.device)
    print(f"cohort: {len(cohort.y):,} stays, {len(clients)} hospitals")
    print(f"latency={args.latency} dropout={args.dropout}")

    results = {}
    for name, recruitment in (("all-clients", "all"), ("recruited", "nu-greedy")):
        federation = AsyncFederation(
            AsyncFederationConfig(
                rounds=args.flushes,
                local_epochs=1,
                batch_size=16,
                recruitment=recruitment,
                aggregator=args.aggregator,
                latency=args.latency,
                dropout=args.dropout,
                seed=args.seed,
            ),
            clients,
            loss_fn,
            AdamW(learning_rate=5e-3, weight_decay=5e-3),
            device=args.device,
        )
        out = federation.run(params0)
        stats = federation.last_run_stats
        results[name] = out
        print(f"--- {name}: {out.federation_ids.size} clients ---")
        for r in out.history:
            print(
                f"  flush {r.round_index}: virtual_t={r.virtual_time:7.2f}s "
                f"loss={r.mean_local_loss:.4f} staleness={r.staleness:.2f} "
                f"({len(r.participant_ids)} updates)"
            )
        print(
            f"  {stats['tasks']} tasks, {stats['dropped']} dropped, "
            f"virtual time {stats['virtual_time']:.2f}s "
            f"(host {out.total_wall_time_s:.1f}s)"
        )

    target, times = shared_time_to_target(
        {name: out.history for name, out in results.items()}
    )
    t_all, t_rec = times["all-clients"], times["recruited"]
    if t_all is None or t_rec is None or t_rec == 0:
        print(f"\nno shared finite target reached (target={target}); "
              "try more --flushes or a lower --dropout")
        return
    sizes = {name: int(out.federation_ids.size) for name, out in results.items()}
    print(
        f"\nTime to loss<={target:.4f} on the simulated clock: "
        f"all-clients {t_all:.2f}s vs recruited {t_rec:.2f}s "
        f"({sizes['recruited']} of {sizes['all-clients']} hospitals, "
        f"{t_all / t_rec:.2f}x sooner)"
    )
    stale = [out.summary()["mean_staleness"] for out in results.values()]
    print(f"mean update staleness: {stale[0]:.2f} / {stale[1]:.2f} parameter versions")


if __name__ == "__main__":
    main()
