"""smollm-135m — llama-arch small dense, GQA kv=3  [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import Activation, ArchConfig, ArchType

CONFIG = ArchConfig(
    name="smollm-135m",
    arch_type=ArchType.DENSE,
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49_152,
    activation=Activation.SWIGLU,
    tie_embeddings=True,
)
