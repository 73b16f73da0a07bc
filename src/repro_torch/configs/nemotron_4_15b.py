"""nemotron-4-15b — dense, GQA kv=8, squared-ReLU MLP  [arXiv:2402.16819]."""

from repro_torch.configs.base import Activation, ArchConfig, ArchType

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    arch_type=ArchType.DENSE,
    source="arXiv:2402.16819 (Nemotron-4 15B)",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256_000,
    activation=Activation.RELU2,
)
