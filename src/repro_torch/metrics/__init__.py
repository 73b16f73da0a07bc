from repro_torch.metrics.regression import evaluate_predictions, mae, mape, mse, msle
from repro_torch.metrics.stats import significance_stars, welch_t_test

__all__ = [
    "evaluate_predictions",
    "mae",
    "mape",
    "mse",
    "msle",
    "welch_t_test",
    "significance_stars",
]
