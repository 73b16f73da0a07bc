"""End-to-end example on the PyTorch port: the paper's full experiment —
federated training of the LoS GRU across 189 hospital clients, with and
without client recruitment, several hundred local steps per model.

    PYTHONPATH=src python examples/torch_federated_recruitment.py [--scale 0.3] [--device cpu]

The port of ``examples/federated_recruitment.py``, with its flags and
``--device`` (default ``cuda``).  It produces the SC-vs-SRC comparison that
is the paper's headline claim: recruited federations match or beat standard
FedAvg at a fraction of the training cost.

Every paper setting is a policy combination for the ``Federation`` facade
(``repro_torch.federated.available_policies()`` lists the registries);
``--selection`` / ``--aggregator`` override the per-setting defaults with
any spec.  ``--staging resident`` (the default) uploads the federation's
client data to the card once and stages int32 index plans each round, the
next chunk's plan built on a thread while one trains (``--no-prefetch``
builds them inline); ``--staging rebuild`` re-stages the whole schedule
every round.  ``--mesh auto`` (the client axis over several GPUs) is not
ported yet and raises.  The paper's tables are
``python -m repro_torch.experiments.run_full``.
"""

import argparse
import json

from repro_torch.experiments.paper import ExperimentConfig, build_cohort, run_setting


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.3, help="cohort scale (1.0 = 89k stays)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--engine", choices=["vectorized", "sequential"], default="vectorized",
        help="vectorized = a chunk of clients in one batched step",
    )
    ap.add_argument(
        "--cohort-chunk", type=int, default=None,
        help="vectorized engine: clients per batched step (bounds memory)",
    )
    ap.add_argument(
        "--mesh", choices=["auto"], default=None,
        help="vectorized engine: the client axis over several GPUs (not ported yet)",
    )
    ap.add_argument(
        "--no-donate", action="store_true",
        help="vectorized engine: keep round buffers alive (memory diffing)",
    )
    ap.add_argument(
        "--staging", choices=["resident", "rebuild"], default="resident",
        help="resident = client data uploaded once, rounds stage int32 index "
        "plans; rebuild = full schedule re-uploaded every round",
    )
    ap.add_argument(
        "--no-prefetch", action="store_true",
        help="resident staging: build chunk plans inline instead of on the "
        "double-buffering background thread",
    )
    ap.add_argument(
        "--selection", default=None,
        help="override the per-round selection policy spec (e.g. "
        "'round-robin:0.1', 'loss-weighted:0.1'); default derives the "
        "paper's uniform sampling from the setting",
    )
    ap.add_argument(
        "--aggregator", default="fedavg",
        help="aggregation policy spec ('fedavg', 'trimmed-mean:0.1', "
        "'hierarchical:4')",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh auto (the client axis over several GPUs) is not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )

    # paper-faithful settings, trained on the selected engine
    exp = ExperimentConfig(
        cohort_scale=args.scale,
        engine=args.engine,
        cohort_chunk=args.cohort_chunk,
        donate_buffers=not args.no_donate,
        staging=args.staging,
        prefetch=not args.no_prefetch,
        selection=args.selection,
        aggregator=args.aggregator,
        device=args.device,
    )
    print(f"engine: {args.engine}")
    cohort = build_cohort(exp, seed=args.seed)
    print(f"cohort: {len(cohort.y):,} stays, {cohort.num_hospitals} hospitals")

    results = {}
    for setting in ("federated-sc", "federated-src"):
        print(f"--- {setting} (15 rounds x 4 local epochs) ---")
        out = run_setting(setting, exp, cohort, seed=args.seed)
        results[setting] = out
        print(
            f"  federation={out['federation_size']} recruited={out['recruited']} "
            f"local_steps={out['local_steps']} tau={out['tau_s']:.1f}s"
        )
        print(f"  metrics: {json.dumps({k: round(v, 4) for k, v in out['metrics'].items()})}")

    sc, src = results["federated-sc"], results["federated-src"]
    speedup = sc["tau_s"] / src["tau_s"]
    print(
        f"\nRecruited federation (SRC): {src['recruited']} of {sc['federation_size']} clients, "
        f"{speedup:.2f}x faster than standard FedAvg (SC), "
        f"MSLE {src['metrics']['msle']:.4f} vs {sc['metrics']['msle']:.4f}"
    )


if __name__ == "__main__":
    main()
