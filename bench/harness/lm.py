"""What the LM drivers share: the program's ``ArchConfig`` from a
configuration file."""

from __future__ import annotations

import dataclasses

from harness import common


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` with the file's sizes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig

    base = get_config(cfg["arch"])
    if cfg["ngroups"] != 1:
        raise common.RunFailed("the program's Mamba-2 block has one group")
    return dataclasses.replace(
        base, num_layers=cfg["n_layer"], d_model=cfg["d_model"], vocab_size=cfg["vocab_size"],
        norm_eps=cfg["norm_eps"], tie_embeddings=cfg["tie_embeddings"], dtype=cfg["dtype"],
        ssm=SSMConfig(d_state=cfg["d_state"], d_conv=cfg["d_conv"], expand=cfg["expand"],
                      head_dim=cfg["headdim"], chunk_size=cfg["chunk_size"]))
