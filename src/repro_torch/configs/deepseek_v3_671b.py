"""deepseek-v3-671b — MoE 256e top-8 + MLA + MTP  [arXiv:2412.19437]."""

from repro_torch.configs.base import ArchConfig, ArchType, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    arch_type=ArchType.MOE,
    source="arXiv:2412.19437 (DeepSeek-V3)",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,       # MLA supersedes GQA; kept for bookkeeping
    d_ff=18432,             # dense-layer FFN width (first 3 layers)
    vocab_size=129_280,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_dense=3,
        moe_every=1,
        capacity_factor=1.25,
        expert_sharding="ep",
    ),
    mtp=True,
)
