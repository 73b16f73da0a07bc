"""Recruitment-parameter study (paper section 6.2 / Fig. 2) on the PyTorch port.

Sweeps gamma_th (number of recruited clients) and compares the balanced,
quality-greedy, and data-greedy strategies; ``--train`` also trains
Federated-SRC at several gamma_th, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_recruitment_sweep.py [--scale 0.1] [--device cpu]

The port of ``examples/recruitment_sweep.py``.
"""

import argparse
import dataclasses

from repro_torch.core import BALANCED, DATA_GREEDY, QUALITY_GREEDY, recruit, recruitment_curve
from repro_torch.data import CohortConfig, build_client_datasets, generate_cohort
from repro_torch.experiments.paper import ExperimentConfig, build_cohort, run_setting


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--train", action="store_true", help="also train at each gamma_th")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cohort = generate_cohort(CohortConfig().scaled(args.scale), seed=0)
    stats = [c.stats() for c in build_client_datasets(cohort)]

    print("gamma_th -> clients recruited (balanced strategy)")
    for gth, n in recruitment_curve(stats, BALANCED, [0.05, 0.1, 0.2, 0.4, 0.7, 1.0]):
        bar = "#" * max(1, n // 4)
        print(f"  {gth:4.2f}: {n:4d} {bar}")

    print("\nstrategy comparison at gamma_th=0.1:")
    for name, cfg in (("balanced", BALANCED), ("quality-greedy", QUALITY_GREEDY), ("data-greedy", DATA_GREEDY)):
        res = recruit(stats, cfg)
        sizes = [s.n for s in stats if res.is_recruited(s.client_id)]
        print(
            f"  {name:15s}: {res.num_recruited:3d} clients, "
            f"median local n={sorted(sizes)[len(sizes)//2]}"
        )

    if args.train:
        exp = ExperimentConfig(cohort_scale=args.scale, rounds=5, local_epochs=2,
                               device=args.device)
        cohort_t = build_cohort(exp, seed=0)
        print("\ntraining at each gamma_th (federated-src):")
        for gth in (0.05, 0.1, 0.3, 0.7):
            e = dataclasses.replace(exp, gamma_th=gth)
            out = run_setting("federated-src", e, cohort_t, seed=0)
            print(
                f"  gamma_th={gth:4.2f}: recruited={out['recruited']:3d} "
                f"msle={out['metrics']['msle']:.4f} mae={out['metrics']['mae']:.3f} "
                f"tau={out['tau_s']:.1f}s"
            )


if __name__ == "__main__":
    main()
