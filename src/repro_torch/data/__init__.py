from repro_torch.data.device_cohort import (
    CohortPlan,
    DeviceCohort,
    build_cohort_plan,
    build_device_cohort,
    pad_cohort_plan,
)
from repro_torch.data.pipeline import (
    ArrayDataset,
    ClientDataset,
    CohortSchedule,
    build_client_datasets,
    build_cohort_schedule,
    cohort_steps_per_epoch,
    global_dataset,
    local_round_steps,
    pad_cohort_schedule,
)
from repro_torch.data.synth_eicu import Cohort, CohortConfig, generate_cohort

__all__ = [
    "ArrayDataset",
    "ClientDataset",
    "CohortPlan",
    "CohortSchedule",
    "DeviceCohort",
    "build_cohort_plan",
    "build_device_cohort",
    "pad_cohort_plan",
    "build_cohort_schedule",
    "cohort_steps_per_epoch",
    "pad_cohort_schedule",
    "build_client_datasets",
    "global_dataset",
    "local_round_steps",
    "Cohort",
    "CohortConfig",
    "generate_cohort",
]
