"""Input shapes and shape-only stand-ins of every model input, cache and param.

The port of the shape half of the JAX package's ``launch/specs.py``:
``InputShape`` and the four assigned shapes, the long-context variant, and
the specs of a batch, a decode token, a decode cache and a param tree.  A
spec is a tensor on the ``meta`` device, which has a shape and a dtype and
holds no memory, the counterpart of JAX's ``ShapeDtypeStruct``; the cache
and param specs come from running ``init_cache`` and ``init`` under a fake
tensor mode, the counterpart of ``jax.eval_shape``, so nothing is allocated
or drawn, even for deepseek-v3-671b.

Out of scope, not ported:

* the sharding half (``param_spec``, ``params_shardings``,
  ``batch_shardings``, ``cache_shardings``): its rules shard params and
  caches over a ``"model"`` mesh axis, and the port's mesh
  (``launch/mesh.py``) is one-dimensional, over clients;
* ``launch/dryrun.py`` and ``launch/hlo_analysis.py``, which lower each
  step to XLA on stand-in devices and read the compiled HLO against TPU
  v5e constants: the port has no XLA program to lower;
* ``benchmarks/hillclimb.py``, which is built on those two.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ArchType
from repro_torch.models.zoo import Model
from repro_torch.tree import PyTree, tree_map


# --------------------------------------------------------------------------
# input shapes (assigned)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

LONG_CONTEXT_WINDOW = 8_192


def long_context_variant(cfg: ArchConfig) -> ArchConfig:
    """Sub-quadratic variant for long_500k: SSM/hybrid run natively; every
    full-attention family gets the sliding-window decode cache."""
    if cfg.arch_type in (ArchType.SSM, ArchType.HYBRID):
        return cfg
    return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)


def config_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    if shape.name == "long_500k":
        return long_context_variant(cfg)
    return cfg


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, torch.Tensor]:
    """Training / prefill batch specs."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict[str, torch.Tensor] = {}
    if cfg.arch_type == ArchType.VLM:
        text = s - cfg.num_frontend_tokens
        specs["tokens"] = _spec((b, text), torch.int32)
        specs["labels"] = _spec((b, text), torch.int32)
        specs["patch_embeds"] = _spec((b, cfg.num_frontend_tokens, cfg.d_model), torch.bfloat16)
    elif cfg.arch_type == ArchType.ENCDEC:
        specs["tokens"] = _spec((b, s), torch.int32)
        specs["labels"] = _spec((b, s), torch.int32)
        specs["src_embeds"] = _spec((b, Model.encoder_frames(s), cfg.d_model), torch.bfloat16)
    else:
        specs["tokens"] = _spec((b, s), torch.int32)
        specs["labels"] = _spec((b, s), torch.int32)
    return specs


def decode_token_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, torch.Tensor]:
    b = shape.global_batch
    return {"tokens": _spec((b, 1), torch.int32), "pos": _spec((), torch.int32)}


def _shapes_of(build: Callable[[], PyTree]) -> PyTree:
    """The tree ``build()`` would return, as meta tensors: ``build`` runs on
    fake tensors, which carry shapes and dtypes and no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = build()
    return tree_map(lambda t: _spec(t.shape, t.dtype), tree)


def cache_specs(model: Model, shape: InputShape) -> PyTree:
    """Specs of the decode cache (no allocation)."""
    return _shapes_of(lambda: model.init_cache(shape.global_batch, shape.seq_len, "cpu"))


def params_specs(model: Model) -> PyTree:
    """Specs of the param tree (nothing drawn, nothing allocated)."""
    return _shapes_of(lambda: model.init(torch.Generator(), "cpu"))
