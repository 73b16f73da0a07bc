"""Rényi-DP (moments) accountant for subsampled Gaussian DP-SGD.

The port's copy of the JAX package's ``privacy/accountant.py`` (numpy
only): the same inputs give the same epsilons, bit for bit.

Tracks cumulative privacy loss across federation rounds.  Each round the
federation samples a fraction ``q`` of its clients (the recruitment/
selection stages), every sampled client runs noised local steps, and the
accountant composes the round's Rényi divergence bounds; ``epsilon()``
converts the running totals to an ``(epsilon, delta)`` guarantee.

The per-order bound is Mironov et al.'s integer-order formula for the
Poisson-subsampled Gaussian mechanism::

    RDP(alpha) = 1/(alpha-1) * log( sum_{k=0..alpha}
        C(alpha, k) * (1-q)^(alpha-k) * q^k * exp((k^2 - k) / (2 sigma^2)) )

composed linearly over rounds, then converted with the classic bound
``epsilon = min_alpha [ RDP_total(alpha) + log(1/delta) / (alpha - 1) ]``.
Binomial coefficients come from ``math.lgamma`` — no SciPy dependency —
and the log-sum-exp is stabilized, so small ``sigma`` / large ``alpha``
never overflow.

Accounting granularity is one federation *round* per client sample: the
round's local steps all touch the same sampled cohort, so we compose one
subsampled-Gaussian event per local step at the round's sampling rate
(``steps`` parameter).  ``sigma = 0`` (no noise) yields ``epsilon = inf``
— an honest report, never a silent 0.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_ORDERS: tuple[int, ...] = tuple(range(2, 65))


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _logsumexp(terms) -> float:
    arr = np.asarray(terms, dtype=np.float64)
    m = float(np.max(arr))
    if math.isinf(m):
        return m
    return m + math.log(float(np.sum(np.exp(arr - m))))


def rdp_subsampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """RDP of order ``alpha`` for one subsampled Gaussian release."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate must be in [0, 1], got {q}")
    if alpha < 2 or int(alpha) != alpha:
        raise ValueError(f"integer order >= 2 required, got {alpha}")
    if q == 0.0:
        return 0.0
    if sigma == 0.0:
        return math.inf
    if q == 1.0:
        return alpha / (2.0 * sigma * sigma)
    alpha = int(alpha)
    log_q, log_1q = math.log(q), math.log1p(-q)
    terms = [
        _log_binom(alpha, k)
        + (alpha - k) * log_1q
        + k * log_q
        + (k * k - k) / (2.0 * sigma * sigma)
        for k in range(alpha + 1)
    ]
    return _logsumexp(terms) / (alpha - 1)


class RdpAccountant:
    """Cumulative (epsilon, delta) over federation rounds.

    One accountant per run; ``step(q)`` after each round with that round's
    client sampling rate, ``epsilon()`` whenever a ``RoundRecord`` is cut.
    Epsilon is non-decreasing in the number of steps, so every record in a
    run carries a monotonically increasing cumulative budget.
    """

    def __init__(
        self,
        noise_multiplier: float,
        delta: float = 1e-5,
        orders: tuple[int, ...] = DEFAULT_ORDERS,
    ) -> None:
        if noise_multiplier < 0:
            raise ValueError(f"noise_multiplier must be >= 0, got {noise_multiplier}")
        if not (0.0 < delta < 1.0):
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        if not orders:
            raise ValueError("at least one RDP order is required")
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.orders = tuple(int(a) for a in orders)
        self._rdp = np.zeros(len(self.orders), dtype=np.float64)
        self._steps = 0

    def step(self, sampling_rate: float, steps: int = 1) -> None:
        """Compose ``steps`` subsampled-Gaussian events at ``sampling_rate``."""
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if steps == 0:
            return
        per_order = np.array(
            [
                rdp_subsampled_gaussian(sampling_rate, self.noise_multiplier, a)
                for a in self.orders
            ],
            dtype=np.float64,
        )
        self._rdp += steps * per_order
        self._steps += steps

    @property
    def steps(self) -> int:
        return self._steps

    def epsilon(self) -> float:
        """Current epsilon at the accountant's delta (0.0 before any step)."""
        if self._steps == 0:
            return 0.0
        log_inv_delta = math.log(1.0 / self.delta)
        candidates = [
            rdp + log_inv_delta / (alpha - 1)
            for rdp, alpha in zip(self._rdp, self.orders)
        ]
        return float(min(candidates))


def epsilon_after(
    rounds: int,
    sampling_rate: float,
    noise_multiplier: float,
    delta: float = 1e-5,
    steps_per_round: int = 1,
) -> float:
    """One-shot budget estimate — e.g. for sizing a run before launch."""
    acct = RdpAccountant(noise_multiplier, delta=delta)
    for _ in range(rounds):
        acct.step(sampling_rate, steps=steps_per_round)
    return acct.epsilon()
