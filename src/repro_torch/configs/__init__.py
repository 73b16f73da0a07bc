"""Architecture registry of the port: ``get_config("<arch-id>")`` / ``--arch <id>``.

It holds the architectures the port runs: the dense decoders, the VLM, the
SSM and the hybrid.  The JAX package's other ids are known by name and
raise ``NotImplementedError``: the MoE decoders are ROADMAP Queue 1 item
15b and the encoder-decoder item 15c.
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

# The first id is the default ``--arch`` of the port's train and serve CLIs.
ARCH_IDS: tuple[str, ...] = (
    "mamba2-130m",
    "qwen3-1.7b",
    "smollm-135m",
    "yi-9b",
    "internvl2-26b",
    "nemotron-4-15b",
    "zamba2-7b",
)

# The reference's ids whose model families the port does not run yet, each
# with the ROADMAP Queue 1 item that ports it.
UNPORTED_ARCH_IDS: tuple[str, ...] = (
    "seamless-m4t-large-v2",
    "deepseek-v3-671b",
    "llama4-scout-17b-a16e",
)
_UNPORTED_ITEM = {
    "seamless-m4t-large-v2": "15c",
    "deepseek-v3-671b": "15b",
    "llama4-scout-17b-a16e": "15b",
}


def _registry() -> dict[str, ArchConfig]:
    from repro_torch.configs import (
        internvl2_26b,
        mamba2_130m,
        nemotron_4_15b,
        qwen3_1_7b,
        smollm_135m,
        yi_9b,
        zamba2_7b,
    )

    configs = (mamba2_130m, qwen3_1_7b, smollm_135m, yi_9b, internvl2_26b, nemotron_4_15b,
               zamba2_7b)
    return {c.CONFIG.name: c.CONFIG for c in configs}


def get_config(name: str) -> ArchConfig:
    if name in UNPORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{name!r} is not ported to PyTorch yet (ROADMAP Queue 1 item "
            f"{_UNPORTED_ITEM[name]}); ported: {list(ARCH_IDS)}"
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
