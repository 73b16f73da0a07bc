from repro_torch.metrics.regression import evaluate_predictions, mae, mape, mse, msle

__all__ = ["evaluate_predictions", "mae", "mape", "mse", "msle"]
