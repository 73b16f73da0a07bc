"""Architecture registry of the port: ``get_config("<arch-id>")`` / ``--arch <id>``.

It holds the architectures the port runs.  The JAX package's other ids are
known by name and raise ``NotImplementedError``: their model families are
still to be ported (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from repro_torch.configs.base import (
    Activation,
    ArchConfig,
    ArchType,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
)

ARCH_IDS: tuple[str, ...] = ("mamba2-130m",)

# The reference's ids whose model families the port does not run yet.
UNPORTED_ARCH_IDS: tuple[str, ...] = (
    "qwen3-1.7b",
    "seamless-m4t-large-v2",
    "deepseek-v3-671b",
    "smollm-135m",
    "yi-9b",
    "internvl2-26b",
    "nemotron-4-15b",
    "llama4-scout-17b-a16e",
    "zamba2-7b",
)


def _registry() -> dict[str, ArchConfig]:
    from repro_torch.configs import mamba2_130m

    return {c.name: c for c in (mamba2_130m.CONFIG,)}


def get_config(name: str) -> ArchConfig:
    if name in UNPORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{name!r} is not ported to PyTorch yet (ROADMAP Queue 1 item 15); "
            f"ported: {list(ARCH_IDS)}"
        )
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(reg)}")
    return reg[name]


def all_configs() -> dict[str, ArchConfig]:
    return _registry()


__all__ = [
    "Activation",
    "ArchConfig",
    "ArchType",
    "HybridConfig",
    "MLAConfig",
    "MoEConfig",
    "SSMConfig",
    "ARCH_IDS",
    "UNPORTED_ARCH_IDS",
    "get_config",
    "all_configs",
]
