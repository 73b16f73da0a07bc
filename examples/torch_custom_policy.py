"""A user-defined recruitment policy in under 30 lines, on the PyTorch port.

    PYTHONPATH=src python examples/torch_custom_policy.py [--device cpu]

The port of ``examples/custom_policy.py``.  The Federation facade treats
recruitment / selection / aggregation as pluggable stages.  This example
writes a new ``RecruitmentPolicy`` — "median-band": recruit only hospitals
whose sample size sits within a band around the cohort median, a crude
fairness rule that excludes both tiny, noisy sites and dominating academic
centers — registers it under a spec name, and trains a federation with it,
changing nothing else.
"""

import argparse

import numpy as np
import torch

from repro_torch.data import CohortConfig, build_client_datasets, generate_cohort
from repro_torch.federated import (
    Federation,
    FederationConfig,
    RecruitmentDecision,
    RecruitmentPolicy,
    register_recruitment,
)
from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
from repro_torch.optim import AdamW


# The whole policy: subclass, implement recruit(), return sorted ids.
# Policies see only the disclosure tuples (target histogram, n_c) — never
# raw features — so recruitment stays model-agnostic by construction.
@register_recruitment("median-band")
class MedianBandRecruitment(RecruitmentPolicy):
    """Recruit clients whose n_c lies within ``band``x of the median size."""

    def __init__(self, band: float = 2.0) -> None:
        self.band = float(band)

    def recruit(self, stats, rng):
        sizes = np.array([s.n for s in stats], dtype=np.float64)
        ids = np.array([s.client_id for s in stats], dtype=np.int64)
        median = np.median(sizes)
        keep = (sizes >= median / self.band) & (sizes <= median * self.band)
        if not keep.any():  # degenerate cohort: fall back to everyone
            keep[:] = True
        return RecruitmentDecision(federation_ids=np.sort(ids[keep]))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cohort = generate_cohort(CohortConfig().scaled(0.02), seed=0)
    clients = build_client_datasets(cohort)
    model_cfg = GRUConfig()

    # Registered policies compose by spec string like any built-in; an
    # instance (MedianBandRecruitment(1.5)) would work the same.
    fed_cfg = FederationConfig(
        rounds=2, local_epochs=1, seed=0,
        recruitment="median-band:2.0", selection="uniform:0.5", aggregator="fedavg",
    )
    federation = Federation(
        fed_cfg, clients, make_loss_fn(model_cfg),
        AdamW(learning_rate=5e-3, weight_decay=5e-3), device=args.device,
    )
    out = federation.run(init_gru(torch.Generator().manual_seed(0), model_cfg, args.device))
    sizes = {c.client_id: c.n_train for c in clients}
    picked = [sizes[int(i)] for i in out.federation_ids]
    print(
        f"median-band recruited {out.federation_ids.size}/{len(clients)} hospitals "
        f"(sizes {min(picked)}..{max(picked)}, cohort median "
        f"{int(np.median(list(sizes.values())))})"
    )
    for r in out.history:
        print(
            f"  round {r.round_index}: {len(r.participant_ids)} clients, "
            f"loss {r.mean_local_loss:.4f}, {r.bytes_transferred:,} bytes moved"
        )
    print("summary:", out.summary())


if __name__ == "__main__":
    main()
