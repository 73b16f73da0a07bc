"""Input shapes, shape-only stand-ins of every model input, cache and param,
and the sharding rules.

The port of the JAX package's ``launch/specs.py``.  Its shape half:
``InputShape`` and the four assigned shapes, the long-context variant, and
the specs of a batch, a decode token, a decode cache and a param tree.  A
spec is a tensor on the ``meta`` device, which has a shape and a dtype and
holds no memory, the counterpart of JAX's ``ShapeDtypeStruct``; the cache
and param specs come from running ``init_cache`` and ``init`` under a fake
tensor mode, the counterpart of ``jax.eval_shape``, so nothing is allocated
or drawn, even for deepseek-v3-671b.

The sharding half follows the reference's rules branch for branch:
``param_spec`` (and ``params_shardings`` over a tree) splits each param
over the ``"model"`` axis (the MoE experts over ``("data", "model")`` or,
with ``expert_sharding="tp"``, each expert's ffn dim), ``batch_shardings``
splits the batch dim over the data axes, and ``cache_shardings`` the
decode cache's batch dim and, in its ``"heads"`` mode, its heads or latent
dim.  Each falls back to replication where a dim does not divide.  The
rules run on a device-free ``AbstractMesh`` (``launch/mesh.py``'s
``make_production_mesh`` and ``make_host_mesh``): the port executes no
model axis, so they serve the dry run's per-device bytes
(``launch/dryrun.py``), not a placement.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ArchType
from repro_torch.distribution.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models.zoo import Model
from repro_torch.tree import PyTree, tree_map, tree_map_with_names


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


# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------

_LAST_DIM_MODEL = {"w_q", "w_k", "w_v", "w_gate", "w_up", "in_proj", "w_uq", "w_dq"}
_ROW_DIM_MODEL = {"w_o", "w_down", "out_proj"}


def param_spec(names: tuple[str, ...], leaf: torch.Tensor, cfg: ArchConfig,
               mesh: AbstractMesh) -> P:
    """PartitionSpec for one parameter leaf; ``names`` are the dict keys of
    its path."""
    name = names[-1] if names else ""
    ndim = len(leaf.shape)
    model_size = axis_size(mesh, "model")
    dsize = axis_size(mesh, "data") * axis_size(mesh, "pod")

    def spec_with(axis_idx: int, axis_val) -> P:
        spec = [None] * ndim
        spec[axis_idx] = axis_val
        return P(*spec)

    # --- MoE expert tensors: (..., E, D, F) / (..., E, F, D) --------------
    if cfg.moe is not None and ndim >= 3 and name in ("w_gate", "w_up", "w_down"):
        e_axis = ndim - 3
        if leaf.shape[e_axis] == cfg.moe.num_experts:
            if cfg.moe.expert_sharding == "tp":
                # shard each expert's ffn dim
                f_axis = ndim - 2 if name == "w_down" else ndim - 1
                if leaf.shape[f_axis] % model_size == 0:
                    return spec_with(f_axis, "model")
                return P()
            # 'ep': shard experts — over (data, model) when divisible, else model
            if leaf.shape[e_axis] % (dsize * model_size) == 0:
                return spec_with(e_axis, ("data", "model"))
            if leaf.shape[e_axis] % model_size == 0:
                return spec_with(e_axis, "model")
            return P()

    if name == "embed":
        return P("model", None) if leaf.shape[0] % model_size == 0 else P()
    if name == "head":
        return P(None, "model") if leaf.shape[1] % model_size == 0 else P()
    if name in ("w_uk", "w_uv"):  # (..., R, H, dh): shard heads
        h_axis = ndim - 2
        if leaf.shape[h_axis] % model_size == 0:
            return spec_with(h_axis, "model")
        return P()
    if name in _LAST_DIM_MODEL:
        if leaf.shape[-1] % model_size == 0:
            return spec_with(ndim - 1, "model")
        return P()
    if name in _ROW_DIM_MODEL:
        row_axis = ndim - 2
        if leaf.shape[row_axis] % model_size == 0:
            return spec_with(row_axis, "model")
        return P()
    # norms, biases, conv and SSM scalars, routers, MLA's w_dkv/w_kr, proj
    return P()


def params_shardings(param_tree: PyTree, cfg: ArchConfig, mesh: AbstractMesh) -> PyTree:
    return tree_map_with_names(
        lambda names, leaf: NamedSharding(mesh, param_spec(names, leaf, cfg, mesh)), param_tree)


def _batch_spec(mesh: AbstractMesh):
    """The data axes as one spec entry: a tuple of two, a name, or None."""
    daxes = data_axes(mesh)
    return daxes if len(daxes) > 1 else (daxes[0] if daxes else None)


def batch_shardings(batch_tree: PyTree, mesh: AbstractMesh) -> PyTree:
    spec = _batch_spec(mesh)
    dsize = 1
    for a in data_axes(mesh):
        dsize *= axis_size(mesh, a)

    def _shard(leaf):
        ndim = len(leaf.shape)
        if ndim == 0 or leaf.shape[0] % dsize != 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(spec, *([None] * (ndim - 1))))

    return tree_map(_shard, batch_tree)


# base ranks of the cache leaves without layer stacking
_CACHE_RANKS = {
    "k": 4, "v": 4, "cross_k": 4, "cross_v": 4,
    "c_kv": 3, "k_rope": 3,
    "ssm_state": 4, "conv_state": 3,
}


def cache_shardings(cache_tree: PyTree, cfg: ArchConfig, mesh: AbstractMesh,
                    mode: str = "heads") -> PyTree:
    """Decode caches: batch dim over data axes; heads/latent over model
    when divisible (``mode="heads"``), or the batch dim alone
    (``mode="batch"``).  Leaf layouts (with optional leading layer-stack
    dims):

      GQA k/v      (..., B, S, Hkv, hd)
      MLA c_kv     (..., B, S, R) / k_rope (..., B, S, dr)
      SSM state    (..., B, H, P, N) / conv (..., B, K, C)
      cross k/v    (..., B, T, Hkv, hd)
      slot_pos     (..., S)
    """
    dspec = _batch_spec(mesh)
    model_size = axis_size(mesh, "model")

    def _spec(names, leaf) -> P:
        name = names[-1] if names else ""
        shape = leaf.shape
        base_rank = _CACHE_RANKS.get(name)
        if base_rank is None:  # slot_pos and anything unnamed: replicated
            return P()
        lead = len(shape) - base_rank          # layer-stack dims
        spec = [None] * len(shape)
        spec[lead] = dspec                     # batch dim
        if mode == "batch":
            if shape[lead] == 1:
                spec[lead] = None
            return P(*spec)
        if name in ("k", "v", "cross_k", "cross_v"):
            hkv_dim, hd_dim = lead + 2, lead + 3
            if shape[hkv_dim] % model_size == 0:
                spec[hkv_dim] = "model"
            elif shape[hd_dim] % model_size == 0:
                spec[hd_dim] = "model"
        elif name == "c_kv":
            if shape[lead + 2] % model_size == 0:
                spec[lead + 2] = "model"
        elif name == "ssm_state":
            if shape[lead + 1] % model_size == 0:
                spec[lead + 1] = "model"       # SSD heads
        elif name == "conv_state":
            if shape[lead + 2] % model_size == 0:
                spec[lead + 2] = "model"       # conv channels
        # batch=1 long-context: no data sharding possible on batch
        if shape[lead] == 1:
            spec[lead] = None
        return P(*spec)

    return tree_map_with_names(lambda names, leaf: NamedSharding(mesh, _spec(names, leaf)),
                               cache_tree)
