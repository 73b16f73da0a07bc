"""qwen3-1.7b — dense, GQA kv=8, qk-norm  [hf:Qwen/Qwen3-8B family]."""

from repro_torch.configs.base import Activation, ArchConfig, ArchType

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    arch_type=ArchType.DENSE,
    source="hf:Qwen/Qwen3-8B (1.7B sibling card)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    activation=Activation.SWIGLU,
    qk_norm=True,
    rope_theta=1_000_000.0,
    # long_500k decode runs through the sliding-window variant that the JAX
    # package's launch/specs.py::long_context_variant applies (window=8192);
    # the base config stays full-attention.
)
