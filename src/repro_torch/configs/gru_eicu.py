"""gru-eicu — the paper's own model: 2-layer GRU(32) + ReLU head (Table 1).

Not in the architecture registry, as in the JAX package: ``get_config``
serves the LM zoo, and this model runs through ``experiments/paper.py``.
"""

from repro_torch.models.gru import GRUConfig

CONFIG = GRUConfig(
    input_dim=38,     # 20 temporal + 18 static (fused), paper Table 2
    hidden_dim=32,
    num_layers=2,
    dropout=0.05,
)

# Paper Table 1 training hyperparameters.
LEARNING_RATE = 5e-3
BATCH_SIZE = 128
WEIGHT_DECAY = 5e-3
