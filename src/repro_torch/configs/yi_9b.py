"""yi-9b — llama-arch dense, GQA kv=4  [arXiv:2403.04652]."""

from repro_torch.configs.base import Activation, ArchConfig, ArchType

CONFIG = ArchConfig(
    name="yi-9b",
    arch_type=ArchType.DENSE,
    source="arXiv:2403.04652 (Yi)",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    activation=Activation.SWIGLU,
)
