"""zamba2-7b — hybrid: Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242]."""

from repro_torch.configs.base import Activation, ArchConfig, ArchType, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type=ArchType.HYBRID,
    source="arXiv:2411.15242 (Zamba2)",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,             # shared attention block's MLP width
    vocab_size=32_000,
    activation=Activation.SWIGLU,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    hybrid=HybridConfig(attn_every=6),
)
