"""seamless-m4t-large-v2 — audio enc-dec backbone  [arXiv:2308.11596].

The mel-spectrogram + conformer feature frontend is a stub, as in the JAX
package: ``launch/specs.py::batch_specs`` and the train and serve drivers
feed precomputed frame embeddings (d_model wide, 4x temporal downsampling)
straight into the transformer encoder.
"""

from repro_torch.configs.base import Activation, ArchConfig, ArchType

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    arch_type=ArchType.ENCDEC,
    source="arXiv:2308.11596 (SeamlessM4T v2)",
    num_layers=24,          # decoder depth
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    activation=Activation.SWIGLU,
    frontend="audio",
)
