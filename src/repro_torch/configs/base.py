"""Architecture config system (the port's copy of the JAX package's dataclasses).

One ``ArchConfig`` dataclass describes every selectable architecture
(``--arch <id>``).  Families: dense decoder, MoE decoder, SSM (Mamba2),
hybrid (Mamba2 + shared attention), encoder-decoder (audio backbone), and
VLM (vision-stub + decoder).  Reduced variants for CPU smoke tests come from
``.reduced()``.  The dataclasses are copied whole, and the port's model
zoo runs every family.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ArchType(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"   # audio backbone (stub frontend feeds the encoder)
    VLM = "vlm"         # vision-stub embeddings prepended to the decoder


class Activation(str, enum.Enum):
    SWIGLU = "swiglu"
    RELU2 = "relu2"     # squared ReLU (Nemotron-4)
    GELU = "gelu"
    RELU = "relu"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # layers [0, first_dense) are dense; among the rest, every
    # ``moe_every``-th layer is MoE (1 = all MoE, 2 = alternating).
    first_dense: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # 'ep' shards the expert dim over the model axis (all-to-all dispatch);
    # 'tp' shards each expert's ffn dim (no all-to-all).  Baseline: 'ep'.
    expert_sharding: str = "ep"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style layout: runs of Mamba2 blocks with a weight-shared
    attention block applied every ``attn_every`` layers."""

    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: ArchType
    source: str                      # citation (paper / model card)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    activation: Activation = Activation.SWIGLU
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # encoder-decoder (audio): encoder depth/width may differ from decoder
    encoder_layers: int = 0
    # modality frontend stub: number of prepended embedding positions the
    # ``input_specs`` provide (vision patches / audio frames)
    frontend: Optional[str] = None   # None | 'audio' | 'vision'
    num_frontend_tokens: int = 0

    # sliding-window variant for sub-quadratic long-context decode; None
    # means full attention (long_500k then runs only if ssm/hybrid)
    sliding_window: Optional[int] = None
    # multi-token prediction extra block (DeepSeek-V3)
    mtp: bool = False

    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: num_heads must divide num_kv_heads")
        if self.arch_type in (ArchType.MOE,) and self.moe is None:
            raise ValueError(f"{self.name}: MoE arch needs moe config")
        if self.arch_type in (ArchType.SSM, ArchType.HYBRID) and self.ssm is None:
            raise ValueError(f"{self.name}: SSM/hybrid arch needs ssm config")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this config decode at 500k context?"""
        return self.arch_type in (ArchType.SSM, ArchType.HYBRID) or self.sliding_window is not None

    def reduced(self) -> "ArchConfig":
        """CPU-smoke-test variant of the same family: 2 layers, d_model<=512,
        <=4 experts — per the harness contract."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # keep the GQA ratio family: kv divides heads
        while num_heads % num_kv:
            num_kv -= 1
        changes: dict = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=d_model // num_heads,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                first_dense=min(self.moe.first_dense, 1),
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), head_dim=32, chunk_size=16
            )
        if self.hybrid is not None:
            changes["hybrid"] = HybridConfig(attn_every=2)
        if self.sliding_window is not None:
            changes["sliding_window"] = min(self.sliding_window, 64)
        return dataclasses.replace(self, **changes)

    # --- parameter counting (for MODEL_FLOPS = 6 N D roofline term) -------
    def param_count(self) -> int:
        from repro_torch.models.zoo import count_params_config  # lazy, avoids cycle

        return count_params_config(self)

    def active_param_count(self) -> int:
        from repro_torch.models.zoo import count_params_config

        return count_params_config(self, active_only=True)
