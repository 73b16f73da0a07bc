"""Per-client latency and dropout models for the async federation runtime.

The port's copy of the JAX package's ``federated/runtime/latency.py``:
numpy only, the same draws from the same seeded streams.

The paper's training-time claim is about the wall-clock cost of *waiting
for hospitals*: a synchronous FedAvg round is as slow as its slowest
participant, and real eICU deployments see heavy-tailed straggler and
dropout behavior the repo's device timers cannot express.  These models put
that axis under experimental control: each one maps a client to the
virtual seconds its local-training task takes (and, for dropout, whether
the task fails), drawing from the scheduler's seeded stream so simulated
timelines replay deterministically.

Models resolve from the same string-spec grammar as the federation policies
(``latency="lognormal:0.5"``, ``dropout="bernoulli:0.1"``):

* ``constant[:seconds]`` — every task takes the same time; the zero-spread
  model the sync-parity gate runs under.
* ``lognormal[:sigma[,median]]`` — each client draws a persistent rate
  ``median * exp(sigma * z)`` at first dispatch: mild, realistic speed
  heterogeneity (slow ICUs stay slow).
* ``pareto[:alpha[,scale]]`` — persistent per-client rates
  ``scale * (1 + Pareto(alpha))``: the heavy-tailed straggler regime
  (smaller ``alpha`` = fatter tail).
* ``trace[:per_sample[,base]]`` — deterministic
  ``base + per_sample * n_c``: compute time tracks local dataset size, the
  "big hospitals are slow hospitals" trace the recruitment trade-off is
  really about.

Dropout specs: ``never`` and ``bernoulli:p`` (each dispatch independently
fails with probability ``p``; the runtime retries the client after its
latency elapses).  ``resolve_dropout`` also accepts a bare float as
shorthand for ``bernoulli:p``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.federated.api import _resolve


class LatencyModel:
    """Maps one client task to its virtual duration.

    ``sample(client_id, n_samples, rng)`` returns the virtual seconds the
    client's next local-training task takes; ``rng`` is the scheduler's
    seeded stream.  Implementations that draw persistent per-client rates
    must draw lazily from ``rng`` on first sight of a client so the whole
    timeline stays a pure function of the seed and the dispatch order.
    """

    def sample(self, client_id: int, n_samples: int, rng: np.random.Generator) -> float:
        raise NotImplementedError

    @property
    def zero_spread(self) -> bool:
        """True when every client always takes the identical time."""
        return False

    def state_dict(self) -> dict:
        """JSON-serializable model state for checkpoint/resume.

        Stateless models return ``{}``.  Models with lazily-drawn
        persistent per-client rates must round-trip them: a resumed run's
        fresh instance would otherwise redraw rates from the restored
        stream, changing both the rates and every later draw.
        """
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class DropoutModel:
    """Decides whether one dispatched task fails (no update reaches the server)."""

    def drops(self, client_id: int, rng: np.random.Generator) -> bool:
        raise NotImplementedError


_LATENCIES: dict[str, Callable[..., LatencyModel]] = {}
_DROPOUTS: dict[str, Callable[..., DropoutModel]] = {}


def register_latency(name: str):
    """Register a latency-model factory (``@register_latency("x")``)."""

    def deco(factory):
        _LATENCIES[name] = factory
        return factory

    return deco


def register_dropout(name: str):
    def deco(factory):
        _DROPOUTS[name] = factory
        return factory

    return deco


def resolve_latency(spec) -> LatencyModel:
    """``"constant"`` / ``"lognormal:0.5"`` / instance -> model."""
    return _resolve(_LATENCIES, spec, "latency", LatencyModel)


def resolve_dropout(spec) -> DropoutModel:
    """``"never"`` / ``"bernoulli:0.1"`` / bare probability / instance -> model."""
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return BernoulliDropout(float(spec))
    return _resolve(_DROPOUTS, spec, "dropout", DropoutModel)


def available_runtime_models() -> dict[str, tuple[str, ...]]:
    """Registered spec names — the discoverable runtime-model surface."""
    return {
        "latency": tuple(sorted(_LATENCIES)),
        "dropout": tuple(sorted(_DROPOUTS)),
    }


# ---------------------------------------------------------------------------
# latency models
# ---------------------------------------------------------------------------


@register_latency("constant")
class ConstantLatency(LatencyModel):
    """Every task takes exactly ``seconds`` — the zero-spread reference."""

    def __init__(self, seconds: float = 1.0) -> None:
        if not (float(seconds) > 0):
            raise ValueError(f"constant latency needs seconds > 0, got {seconds}")
        self.seconds = float(seconds)

    def sample(self, client_id, n_samples, rng) -> float:
        return self.seconds

    @property
    def zero_spread(self) -> bool:
        return True


class PersistentRateLatency(LatencyModel):
    """Base for models where a client's speed is a stable property.

    The per-client rate is drawn once, lazily, the first time the client is
    dispatched (so the draw order — and therefore the timeline — is fixed
    by the event order), and reused for every later dispatch: slow ICUs
    stay slow, which is what makes stragglers a *systematic* cost instead
    of noise that averages out.
    """

    def __init__(self) -> None:
        self._rate: dict[int, float] = {}

    def _draw(self, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def sample(self, client_id, n_samples, rng) -> float:
        cid = int(client_id)
        if cid not in self._rate:
            self._rate[cid] = float(self._draw(rng))
        return self._rate[cid]

    def state_dict(self) -> dict:
        return {"rate": {str(cid): rate for cid, rate in self._rate.items()}}

    def load_state_dict(self, state: dict) -> None:
        self._rate = {int(cid): float(r) for cid, r in state.get("rate", {}).items()}


@register_latency("lognormal")
class LognormalLatency(PersistentRateLatency):
    """Rates ``median * exp(sigma * z)`` — multiplicative speed spread."""

    def __init__(self, sigma: float = 0.5, median: float = 1.0) -> None:
        super().__init__()
        if float(sigma) < 0:
            raise ValueError(f"lognormal needs sigma >= 0, got {sigma}")
        if not (float(median) > 0):
            raise ValueError(f"lognormal needs median > 0, got {median}")
        self.sigma, self.median = float(sigma), float(median)

    def _draw(self, rng) -> float:
        return self.median * float(np.exp(self.sigma * rng.standard_normal()))

    @property
    def zero_spread(self) -> bool:
        return self.sigma == 0.0


@register_latency("pareto")
class ParetoLatency(PersistentRateLatency):
    """Rates ``scale * (1 + Pareto(alpha))`` — heavy-tailed stragglers.

    ``alpha <= 1`` has infinite mean: a federation will reliably contain a
    client an order of magnitude slower than the median, the regime where
    synchronous rounds collapse and buffered async aggregation earns its
    keep.
    """

    def __init__(self, alpha: float = 1.5, scale: float = 1.0) -> None:
        super().__init__()
        if not (float(alpha) > 0):
            raise ValueError(f"pareto needs alpha > 0, got {alpha}")
        if not (float(scale) > 0):
            raise ValueError(f"pareto needs scale > 0, got {scale}")
        self.alpha, self.scale = float(alpha), float(scale)

    def _draw(self, rng) -> float:
        return self.scale * (1.0 + float(rng.pareto(self.alpha)))


@register_latency("trace")
class TraceLatency(LatencyModel):
    """Deterministic ``base + per_sample * n_c`` — compute tracks data size.

    The latency twin of the recruitment trade-off: the clients that
    contribute the most samples are exactly the ones a synchronous barrier
    waits longest for.
    """

    def __init__(self, per_sample: float = 0.01, base: float = 0.1) -> None:
        if float(per_sample) < 0 or float(base) < 0:
            raise ValueError(
                f"trace latency needs per_sample >= 0 and base >= 0, "
                f"got {per_sample}, {base}"
            )
        if float(per_sample) == 0 and float(base) == 0:
            raise ValueError("trace latency needs per_sample or base > 0")
        self.per_sample, self.base = float(per_sample), float(base)

    def sample(self, client_id, n_samples, rng) -> float:
        return self.base + self.per_sample * int(n_samples)


# ---------------------------------------------------------------------------
# dropout models
# ---------------------------------------------------------------------------


@register_dropout("never")
class NeverDropout(DropoutModel):
    """No task ever fails — the default, and the parity-gate setting."""

    def drops(self, client_id, rng) -> bool:
        return False


@register_dropout("bernoulli")
class BernoulliDropout(DropoutModel):
    """Each dispatch independently fails with probability ``p``."""

    def __init__(self, p: float = 0.1) -> None:
        if not (0.0 <= float(p) <= 1.0):
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = float(p)

    def drops(self, client_id, rng) -> bool:
        return bool(rng.random() < self.p)
