from repro_torch.data.pipeline import (
    ArrayDataset,
    ClientDataset,
    build_client_datasets,
    global_dataset,
    local_round_steps,
)
from repro_torch.data.synth_eicu import Cohort, CohortConfig, generate_cohort

__all__ = [
    "ArrayDataset",
    "ClientDataset",
    "build_client_datasets",
    "global_dataset",
    "local_round_steps",
    "Cohort",
    "CohortConfig",
    "generate_cohort",
]
