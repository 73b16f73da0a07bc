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
every round.  The paper's tables are
``python -m repro_torch.experiments.run_full``.

``--mesh auto`` splits the vectorized engine's client axis over processes,
one GPU each:

    PYTHONPATH=src torchrun --nproc-per-node N examples/torch_federated_recruitment.py --mesh auto

Each rank sets its card from ``LOCAL_RANK`` and joins the NCCL group that
torchrun describes (gloo with ``--device cpu``); rank 0 prints.  In one
plain process ``--mesh auto`` is the run without a mesh.
"""

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch.experiments.paper import ExperimentConfig, build_cohort, run_setting


def join_process_group(device: str) -> bool:
    """Under torchrun (``WORLD_SIZE`` above 1): this rank's card from
    ``LOCAL_RANK`` and the process group torchrun describes.  Returns
    whether a group was created here."""
    if int(os.environ.get("WORLD_SIZE", "1")) < 2 or dist.is_initialized():
        return False
    if device == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return True


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
        help="vectorized engine: the client axis over the ranks of torchrun's "
        "process group (no mesh in one process)",
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
    joined = args.mesh is not None and join_process_group(args.device)
    try:
        run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def run(args: argparse.Namespace) -> None:
    # Under a mesh every rank computes the same results; rank 0 prints them.
    quiet = dist.is_initialized() and dist.get_rank() != 0
    say = (lambda *_: None) if quiet else print

    # paper-faithful settings, trained on the selected engine
    exp = ExperimentConfig(
        cohort_scale=args.scale,
        engine=args.engine,
        cohort_chunk=args.cohort_chunk,
        mesh=args.mesh,
        donate_buffers=not args.no_donate,
        staging=args.staging,
        prefetch=not args.no_prefetch,
        selection=args.selection,
        aggregator=args.aggregator,
        device=args.device,
    )
    say(f"engine: {args.engine}")
    cohort = build_cohort(exp, seed=args.seed)
    say(f"cohort: {len(cohort.y):,} stays, {cohort.num_hospitals} hospitals")

    results = {}
    for setting in ("federated-sc", "federated-src"):
        say(f"--- {setting} (15 rounds x 4 local epochs) ---")
        out = run_setting(setting, exp, cohort, seed=args.seed)
        results[setting] = out
        say(
            f"  federation={out['federation_size']} recruited={out['recruited']} "
            f"local_steps={out['local_steps']} tau={out['tau_s']:.1f}s"
        )
        say(f"  metrics: {json.dumps({k: round(v, 4) for k, v in out['metrics'].items()})}")

    sc, src = results["federated-sc"], results["federated-src"]
    speedup = sc["tau_s"] / src["tau_s"]
    say(
        f"\nRecruited federation (SRC): {src['recruited']} of {sc['federation_size']} clients, "
        f"{speedup:.2f}x faster than standard FedAvg (SC), "
        f"MSLE {src['metrics']['msle']:.4f} vs {sc['metrics']['msle']:.4f}"
    )


if __name__ == "__main__":
    main()
