"""Architecture registry of the port: ``get_config("<arch-id>")`` / ``--arch <id>``.

It holds the JAX package's ten architectures: the dense decoders, the MoE
decoders, the VLM, the SSM, the hybrid and the encoder-decoder.
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
    "deepseek-v3-671b",
    "llama4-scout-17b-a16e",
    "seamless-m4t-large-v2",
)

# The reference's ids whose model families the port does not run: none.
UNPORTED_ARCH_IDS: tuple[str, ...] = ()


def _registry() -> dict[str, ArchConfig]:
    from repro_torch.configs import (
        deepseek_v3_671b,
        internvl2_26b,
        llama4_scout_17b_a16e,
        mamba2_130m,
        nemotron_4_15b,
        qwen3_1_7b,
        seamless_m4t_large_v2,
        smollm_135m,
        yi_9b,
        zamba2_7b,
    )

    configs = (mamba2_130m, qwen3_1_7b, smollm_135m, yi_9b, internvl2_26b, nemotron_4_15b,
               zamba2_7b, deepseek_v3_671b, llama4_scout_17b_a16e, seamless_m4t_large_v2)
    return {c.CONFIG.name: c.CONFIG for c in configs}


def get_config(name: str) -> ArchConfig:
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
