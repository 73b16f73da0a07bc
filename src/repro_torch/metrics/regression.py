"""Paper section 4.5 evaluation metrics (eq. 6-7)."""

from __future__ import annotations

import numpy as np


def mae(y: np.ndarray, y_hat: np.ndarray) -> float:
    return float(np.mean(np.abs(y - y_hat)))


def mape(y: np.ndarray, y_hat: np.ndarray) -> float:
    return float(np.mean(np.abs((y - y_hat) / y)))


def mse(y: np.ndarray, y_hat: np.ndarray) -> float:
    return float(np.mean((y - y_hat) ** 2))


def msle(y: np.ndarray, y_hat: np.ndarray) -> float:
    return float(np.mean((np.log1p(y) - np.log1p(y_hat)) ** 2))


def evaluate_predictions(y: np.ndarray, y_hat: np.ndarray) -> dict[str, float]:
    y = np.asarray(y, dtype=np.float64)
    y_hat = np.asarray(y_hat, dtype=np.float64)
    return {
        "mae": mae(y, y_hat),
        "mape": mape(y, y_hat),
        "mse": mse(y, y_hat),
        "msle": msle(y, y_hat),
    }
