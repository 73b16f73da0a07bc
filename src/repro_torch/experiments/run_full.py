"""Full paper-faithful experiment run: Tables 4 and 5 and Fig. 2, written as
JSON under ``results/torch/paper/`` and printed as markdown.

    python -m repro_torch.experiments.run_full --scale 1.0 --seeds 0 1 2

The port of the JAX package's ``experiments/run_full.py``, with the same
flags, files and tables, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.experiments.paper import ExperimentConfig
from repro_torch.experiments.tables import (
    FIG2_GAMMA_THS,
    run_fig2,
    run_table4,
    run_table5,
    save,
    to_markdown_table4,
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--fig2-seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--skip-fig2", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    exp = ExperimentConfig(cohort_scale=args.scale, device=args.device)
    t0 = time.time()

    print(f"=== Table 4 (scale={args.scale}, seeds={args.seeds}) ===", flush=True)
    t4 = run_table4(exp, args.seeds)
    save(t4, f"table4_scale{args.scale}.json")
    print(to_markdown_table4(t4), flush=True)

    print("=== Table 5 (QG/DG ablations) ===", flush=True)
    t5 = run_table5(exp, args.seeds)
    save(t5, f"table5_scale{args.scale}.json")
    print(to_markdown_table4(t5), flush=True)

    if not args.skip_fig2:
        print("=== Fig 2 (gamma_th sweep) ===", flush=True)
        fig2 = run_fig2(exp, args.fig2_seeds, list(FIG2_GAMMA_THS))
        save(fig2, f"fig2_scale{args.scale}.json")

    print(f"total experiment time: {(time.time()-t0)/60:.1f} min", flush=True)


if __name__ == "__main__":
    main()
