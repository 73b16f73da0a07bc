"""internvl2-26b — VLM: InternViT (stub) + InternLM2 backbone  [arXiv:2404.16821].

The InternViT-6B vision tower + MLP projector is a STUB per the harness
carve-out: ``input_specs()`` provides 256 precomputed patch embeddings at
d_model which are prepended to the text sequence (early fusion).
"""

from repro_torch.configs.base import Activation, ArchConfig, ArchType

CONFIG = ArchConfig(
    name="internvl2-26b",
    arch_type=ArchType.VLM,
    source="arXiv:2404.16821 (InternVL2, InternLM2-20B LM)",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    activation=Activation.SWIGLU,
    frontend="vision",
    num_frontend_tokens=256,
)
