"""Entry points of the port: serving and training (``serve``, ``train``,
``steps``) and the federation control plane
(``federation_service``), whose public names are exported here.

The control plane's names load on first access, so importing this package
(or running ``python -m repro_torch.launch.federation_service``) does not
import the service module twice.
"""

_SERVICE_NAMES = (
    "EX_TEMPFAIL",
    "JobPreempted",
    "RecordStream",
    "Workload",
    "build_workload",
    "check_registry_table",
    "diff_runs",
    "federation_config_from_spec",
    "job_spec_hash",
    "read_records",
    "registry_table",
    "resume_job",
    "status_job",
    "submit_job",
    "validate_job_spec",
)

__all__ = list(_SERVICE_NAMES)


def __getattr__(name: str):
    if name in _SERVICE_NAMES:
        from repro_torch.launch import federation_service

        return getattr(federation_service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
