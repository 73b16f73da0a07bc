"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""

from repro_torch.configs.base import Activation, ArchConfig, ArchType, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    arch_type=ArchType.MOE,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,              # dense-path FFN (unused: every layer is MoE)
    vocab_size=202_048,
    activation=Activation.SWIGLU,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        first_dense=0,
        moe_every=1,
        capacity_factor=1.5,  # top-1 routing needs headroom against drops
        expert_sharding="ep",
    ),
)
