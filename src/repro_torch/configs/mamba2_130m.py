"""mamba2-130m — attention-free SSM with SSD  [arXiv:2405.21060]."""

from repro_torch.configs.base import ArchConfig, ArchType, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    arch_type=ArchType.SSM,
    source="arXiv:2405.21060 (Mamba-2)",
    num_layers=24,
    d_model=768,
    num_heads=1,        # attention-free; SSD heads come from ssm config
    num_kv_heads=1,
    d_ff=0,             # no MLP blocks in Mamba2
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
)
