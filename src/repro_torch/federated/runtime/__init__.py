"""Async federation runtime: virtual-clock scheduling, stragglers, staleness.

The port of the JAX package's ``federated/runtime/``.  Importing this
package registers the buffered aggregators (``"fedbuff:K"``,
``"hierarchical-async:R"``) into the shared aggregator registry (which
also loads them on its first use) and exposes the latency/dropout model
registries (``"constant"``, ``"lognormal:0.5"``, ``"pareto:1.5"``,
``"trace"``, ``"bernoulli:0.1"``).  The entry point is
:class:`AsyncFederation` driven by an :class:`AsyncFederationConfig`;
:class:`AsyncFederationSnapshot` is its checkpoint/resume image (the
control plane in :mod:`repro_torch.launch.federation_service` persists one at
every flush boundary).
"""

from repro_torch.federated.runtime.async_federation import (
    AsyncFederation,
    AsyncFederationConfig,
    AsyncFederationSnapshot,
    PendingEvent,
)
from repro_torch.federated.runtime.latency import (
    BernoulliDropout,
    ConstantLatency,
    DropoutModel,
    LatencyModel,
    LognormalLatency,
    NeverDropout,
    ParetoLatency,
    TraceLatency,
    available_runtime_models,
    register_dropout,
    register_latency,
    resolve_dropout,
    resolve_latency,
)
from repro_torch.federated.runtime.scheduler import Event, VirtualScheduler
from repro_torch.federated.runtime.staleness import (
    AsyncAggregator,
    AsyncUpdate,
    FedBuffAggregator,
    HierarchicalAsyncAggregator,
    polynomial_staleness_weight,
    staleness_weights,
)

__all__ = [
    "AsyncFederation",
    "AsyncFederationConfig",
    "AsyncFederationSnapshot",
    "PendingEvent",
    "AsyncAggregator",
    "AsyncUpdate",
    "FedBuffAggregator",
    "HierarchicalAsyncAggregator",
    "polynomial_staleness_weight",
    "staleness_weights",
    "Event",
    "VirtualScheduler",
    "LatencyModel",
    "DropoutModel",
    "ConstantLatency",
    "LognormalLatency",
    "ParetoLatency",
    "TraceLatency",
    "NeverDropout",
    "BernoulliDropout",
    "available_runtime_models",
    "register_latency",
    "register_dropout",
    "resolve_latency",
    "resolve_dropout",
]
