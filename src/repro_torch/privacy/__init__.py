"""Privacy & robustness tier: DP-SGD, masked-sum secagg, adversary scenarios.

The port of the JAX package's ``privacy/``, with its public names:

* :mod:`repro_torch.privacy.dp` — DP-SGD (per-example clipping through the
  GRU kernels' client axis, Gaussian noise) in both engines, configured
  with :class:`DPConfig` through ``FederationConfig.privacy``;
* :mod:`repro_torch.privacy.accountant` — the Rényi accountant behind
  every DP ``RoundRecord.epsilon``;
* :mod:`repro_torch.privacy.secagg` — the ``"secagg-fedavg"`` aggregator,
  whose server-side sum touches only pairwise-masked fixed-point tensors;
* :mod:`repro_torch.privacy.adversary` — label-flip / scaled-update /
  sign-flip attacker scenarios and the ``"krum[:f]"`` aggregator.

Only the leaf modules (``dp``, ``accountant``) load eagerly: both engines
import ``dp`` from inside ``repro_torch.federated``, and ``secagg`` and
``adversary`` import ``repro_torch.federated.api``, so they resolve lazily
on first attribute access.  The aggregator registry imports them on its
first use, which registers their specs.
"""

import importlib

from repro_torch.privacy.accountant import (
    RdpAccountant,
    epsilon_after,
    rdp_subsampled_gaussian,
)
from repro_torch.privacy.dp import (
    DPConfig,
    add_gaussian_noise,
    dp_value_and_grad,
    per_example_clip_factors,
    resolve_dp,
)

_LAZY = {
    "SecAggFedAvg": "secagg",
    "dequantize_total": "secagg",
    "masked_client_tensors": "secagg",
    "masked_sum": "secagg",
    "pair_masks": "secagg",
    "quantize_leaf": "secagg",
    "ring_offsets": "secagg",
    "ATTACKS": "adversary",
    "KrumAggregator": "adversary",
    "ScenarioConfig": "adversary",
    "apply_scenario": "adversary",
    "attacker_ids": "adversary",
    "flip_labels": "adversary",
    "poison_clients": "adversary",
}

__all__ = [
    "DPConfig",
    "RdpAccountant",
    "add_gaussian_noise",
    "dp_value_and_grad",
    "epsilon_after",
    "per_example_clip_factors",
    "rdp_subsampled_gaussian",
    "resolve_dp",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    module_name = _LAZY.get(name)
    if module_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"repro_torch.privacy.{module_name}")
    value = getattr(module, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
