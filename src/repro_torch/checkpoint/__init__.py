from repro_torch.checkpoint.store import (
    federation_snapshot_state,
    has_federation_snapshot,
    load_federation_snapshot,
    load_pytree,
    restore_server_state,
    save_federation_snapshot,
    save_pytree,
    save_server_state,
)

__all__ = [
    "load_pytree",
    "save_pytree",
    "save_server_state",
    "restore_server_state",
    "save_federation_snapshot",
    "load_federation_snapshot",
    "federation_snapshot_state",
    "has_federation_snapshot",
]
