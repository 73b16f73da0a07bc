"""Dry run: every (arch x input-shape x mesh), counted on meta tensors.

The port of the JAX package's ``launch/dryrun.py``.  For each combination
the reference jits the step with explicit shardings on 512 stand-in
devices, ``.lower().compile()``s it and reads the compiled program.  Here
the port's own step (``launch/steps.py``) runs once on ``meta`` tensors
(shapes and dtypes, no storage; nothing is allocated or computed) under
``launch/step_analysis.py``'s counter, and the sharding rules
(``launch/specs.py``) give the bytes each device holds.  Each record has:

  * ``memory`` — the step's argument bytes per device (params, the AdamW
    moments, the batch, the cache) from the rules, and on the host mesh the
    step's peak live bytes: does the layout fit?
  * ``hlo_analysis`` — the step's matmul FLOPs by dtype, its eager op
    traffic, and the hand-written kernels' calls and work;
  * ``roofline`` — the derived terms in seconds against the datasheet peaks
    of an NVIDIA H100 80GB HBM3 (SXM5) at 700 W: estimates, not
    measurements.

The reference's ``cost_raw`` (XLA's own ``cost_analysis()``, which counts a
loop body once) has no counterpart: there is no compiled program, and the
meta run counts every trip.  ``lower_s`` is the time to build the specs and
shardings, ``compile_s`` the meta run's.  Layouts change no FLOPs, so one
meta run of an arch x shape x variant serves every mesh of a sweep.

Records go to ``build/repro_torch/dryrun/`` (resumable: a record on disk is
skipped unless ``--force``); a failing combination writes ``.error.json``
beside it.  Besides the reference's ``single`` (16 x 16) and ``multi``
(2 x 16 x 16) meshes, ``--mesh host`` is the one-card layout (1 x 1).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distribution.sharding import NamedSharding, PartitionSpec as P
from repro_torch.launch.mesh import data_axes, make_host_mesh, make_production_mesh
from repro_torch.launch.specs import (
    INPUT_SHAPES,
    InputShape,
    batch_shardings,
    batch_specs,
    cache_shardings,
    cache_specs,
    config_for_shape,
    decode_token_specs,
    params_shardings,
    params_specs,
)
from repro_torch.launch.step_analysis import (
    RooflineTerms,
    memory_summary,
    model_flops_estimate,
    run_counted,
)
from repro_torch.launch.steps import (
    make_fed_round_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import tree_leaves, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"

# --- §Perf hillclimb variants ------------------------------------------------
# Each entry tweaks one knob relative to the baseline.  Variants are run
# with ``--variant <name>`` and recorded as separate result files so
# before/after roofline terms are directly comparable.  ``kv_chunk`` reaches
# no model, as in the reference, whose ``lower_combo`` does not pass it on.
VARIANTS: dict[str, dict] = {
    "baseline": {},
    "moe_tp": {"moe_sharding": "tp"},          # expert-TP instead of expert-parallel
    "moe_local": {"moe_sharding": "ep_local"},  # shard-local dispatch (see moe.py)
    "noremat": {"remat": False},               # trade HBM for recompute FLOPs
    "losschunk128": {"loss_chunk": 128},
    "losschunk4096": {"loss_chunk": 4096},
    "kvchunk4096": {"kv_chunk": 4096},
    "fed_k1": {"fed_local_steps": 1},          # FedAvg round, 1 local step
    "fed_k4": {"fed_local_steps": 4},
    "fed_k16": {"fed_local_steps": 16},
    "capacity1": {"capacity_factor": 1.0},
    "capacity2": {"capacity_factor": 2.0},
    "cache_batch": {"cache_mode": "batch"},    # decode cache: batch-only sharding
}

MESHES = ("single", "multi", "host")
NO_MODEL_AXIS = ("the port runs no model axis: a layout with a model axis over 1 is "
                 "counted for its bytes, and its collectives are not modelled")


def _apply_variant_cfg(cfg, spec: dict):
    if cfg.moe is not None:
        moe = cfg.moe
        if "moe_sharding" in spec:
            moe = dataclasses.replace(moe, expert_sharding=spec["moe_sharding"])
        if "capacity_factor" in spec:
            moe = dataclasses.replace(moe, capacity_factor=spec["capacity_factor"])
        if moe is not cfg.moe:
            cfg = dataclasses.replace(cfg, moe=moe)
    return cfg


def _mesh(mesh_kind: str):
    if mesh_kind == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


def _memoized(memo: dict | None, key, make):
    """``make()``, once a ``key`` where the caller keeps a memo."""
    if memo is None:
        return make()
    if key not in memo:
        memo[key] = make()
    return memo[key]


def _specs(model: Model, memo: dict | None):
    """The param specs of ``model``, once a sweep for each param layout
    (deepseek-v3's take ~16 s): the long-context window changes none."""
    return _memoized(memo, ("params", dataclasses.replace(model.cfg, sliding_window=None)),
                     lambda: params_specs(model))


def build_combo(arch: str, shape: str | InputShape, variant: str = "baseline"
                ) -> tuple[InputShape, Any, Model, AdamW]:
    """``(shape, cfg, model, optimizer)`` of a combination: what its step
    runs, on meta tensors here or on the card (``chip_smoke.py``)."""
    spec_v = VARIANTS[variant]
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg = _apply_variant_cfg(config_for_shape(get_config(arch), shape), spec_v)
    model = Model(cfg, remat=spec_v.get("remat", True), loss_chunk=spec_v.get("loss_chunk", 512))
    return shape, cfg, model, AdamW(learning_rate=1e-4, weight_decay=0.01)


def lower_combo(
    arch: str,
    shape: str | InputShape,
    mesh_kind: str,
    *,
    variant: str = "baseline",
    extra_tags: dict | None = None,
    memo: dict | None = None,
) -> dict[str, Any]:
    """Count one combination on meta tensors; returns the result record.

    ``shape`` is a name of ``INPUT_SHAPES`` or an ``InputShape`` of the
    caller's (``chip_smoke.py`` counts exactly what the card runs).
    ``memo``, a dict the caller keeps, shares param specs and meta runs
    across the combinations of a sweep."""
    spec_v = VARIANTS[variant]
    shape, cfg, model, optimizer = build_combo(arch, shape, variant)
    mesh = _mesh(mesh_kind)

    if "fed_local_steps" in spec_v:
        return _lower_fed_round(
            arch, shape, mesh_kind, cfg, mesh, model, optimizer,
            local_steps=spec_v["fed_local_steps"], extra_tags=extra_tags, memo=memo,
        )

    t0 = time.perf_counter()
    p_specs = _specs(model, memo)
    p_shardings = params_shardings(p_specs, cfg, mesh)
    arguments: dict[str, tuple] = {"params": (p_specs, p_shardings)}
    if shape.kind == "train":
        o_specs = optimizer.init(p_specs)
        arguments["mu"] = (o_specs.mu, p_shardings)
        arguments["nu"] = (o_specs.nu, p_shardings)
        b_specs = batch_specs(cfg, shape)
        arguments["batch"] = (b_specs, batch_shardings(b_specs, mesh))
        step, args = make_train_step(model, optimizer), (p_specs, o_specs, b_specs)
    elif shape.kind == "prefill":
        b_specs = batch_specs(cfg, shape)
        arguments["batch"] = (b_specs, batch_shardings(b_specs, mesh))
        step, args = make_prefill_step(model), (p_specs, b_specs)
    else:  # decode
        c_specs = cache_specs(model, shape)
        arguments["cache"] = (c_specs, cache_shardings(
            c_specs, cfg, mesh, mode=spec_v.get("cache_mode", "heads")))
        tok = decode_token_specs(cfg, shape)
        arguments["batch"] = (tok, {"tokens": batch_shardings({"tokens": tok["tokens"]}, mesh)[
            "tokens"], "pos": NamedSharding(mesh, P())})
        step, args = make_serve_step(model), (p_specs, tok["tokens"], c_specs, tok["pos"])
    t_lower = time.perf_counter() - t0

    def run():
        _, counter, peak = run_counted(step, *args)
        return counter.summary(), peak

    t0 = time.perf_counter()
    key = ("step", arch, shape, variant)
    analysis, peak = _memoized(memo, key, run)
    t_compile = time.perf_counter() - t0
    return _finalize_record(
        analysis, peak, arguments, arch, shape, mesh_kind, cfg, mesh,
        t_lower, t_compile, coll_bytes=0.0, extra_tags=extra_tags,
    )


def _finalize_record(
    analysis, peak, arguments, arch, shape, mesh_kind, cfg, mesh, t_lower, t_compile, *,
    coll_bytes, extra_tags,
):
    """The record: the reference's keys less ``cost_raw`` (see the module
    docstring).  ``coll_bytes`` is the step's collective traffic where the
    port makes one (the fed round's all-reduce), None on a model axis."""
    chips = mesh.size
    note = None
    if mesh.shape.get("model", 1) > 1:
        coll_bytes, note = None, NO_MODEL_AXIS
    terms = RooflineTerms(
        hlo_flops=analysis["flops"],
        hlo_bytes=analysis["bytes"],
        coll_bytes=coll_bytes,
        chips=chips,
        model_flops=model_flops_estimate(cfg, shape, shape.kind),
        flops_by_dtype=analysis["flops_by_dtype"],
        kernel_compute_s=analysis["kernel_compute_s"],
        collective_note=note,
    )
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_kind,
        "chips": chips,
        "kind": shape.kind,
        "lower_s": t_lower,
        "compile_s": t_compile,
        "memory": memory_summary(mesh, arguments, peak),
        "hlo_analysis": analysis,
        "roofline": terms.as_dict(),
        "tags": extra_tags or {},
    }


def _lower_fed_round(
    arch, shape, mesh_kind, cfg, mesh, model, optimizer, *, local_steps, extra_tags, memo,
):
    """The FedAvg round step: a client-replica axis over (pod, data)."""
    if shape.kind != "train":
        raise ValueError("fed variants apply to train shapes")
    daxes = data_axes(mesh)
    n_clients = 1
    for a in daxes:
        n_clients *= mesh.shape[a]
    local_batch = max(shape.global_batch // n_clients, 1)
    client_spec = daxes if len(daxes) > 1 else daxes[0]

    t0 = time.perf_counter()
    p_one = _specs(model, memo)
    base = params_shardings(p_one, cfg, mesh)

    def stack(t):
        return torch.empty((n_clients, *t.shape), dtype=t.dtype, device="meta")

    def stack_shard(s):
        return NamedSharding(mesh, P(client_spec, *s.spec))

    pc_specs = tree_map(stack, p_one)
    pc_shardings = tree_map(stack_shard, base)
    o_one = optimizer.init(p_one)
    oc_specs = AdamWState(0, tree_map(stack, o_one.mu), tree_map(stack, o_one.nu))
    b_specs = tree_map(
        lambda t: torch.empty((n_clients, local_steps, local_batch, *t.shape[1:]),
                              dtype=t.dtype, device="meta"),
        batch_specs(cfg, shape),
    )
    b_shardings = tree_map(
        lambda t: NamedSharding(mesh, P(client_spec, *([None] * (t.dim() - 1)))), b_specs)
    w_specs = torch.empty((n_clients,), dtype=torch.float32, device="meta")
    arguments = {
        "params": (pc_specs, pc_shardings),
        "mu": (oc_specs.mu, pc_shardings),
        "nu": (oc_specs.nu, pc_shardings),
        "batch": (b_specs, b_shardings),
        "weights": (w_specs, NamedSharding(mesh, P(client_spec))),
    }
    t_lower = time.perf_counter() - t0
    step = make_fed_round_step(model, optimizer)

    def run():
        _, counter, peak = run_counted(step, pc_specs, oc_specs, b_specs, w_specs)
        return counter.summary(), peak

    t0 = time.perf_counter()
    analysis, peak = _memoized(memo, ("fed", arch, shape, mesh_kind, local_steps), run)
    t_compile = time.perf_counter() - t0
    # The round's one collective: the FedAvg sum over the client axis, an
    # all-reduce of every param (launch/mesh.py::all_reduce_sum_); none on
    # one client.
    coll = float(sum(t.numel() * 4 for t in tree_leaves(p_one))) if n_clients > 1 else 0.0
    tags = dict(extra_tags or {})
    tags.update({"fed_local_steps": local_steps, "clients": n_clients, "local_batch": local_batch})
    record = _finalize_record(
        analysis, peak, arguments, arch, shape, mesh_kind, cfg, mesh, t_lower, t_compile,
        coll_bytes=coll, extra_tags=tags,
    )
    # normalize: model_flops for ONE local step x clients x local_steps
    record["roofline"]["model_flops"] = (
        record["roofline"]["model_flops"] / shape.global_batch * local_batch * n_clients * local_steps
    )
    return record


def result_path(arch: str, shape: str, mesh_kind: str, variant: str = "baseline") -> Path:
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}__{variant}.json"


def run_combo(arch: str, shape: str, mesh_kind: str, force: bool = False,
              variant: str = "baseline", memo: dict | None = None) -> dict[str, Any]:
    out = result_path(arch, shape, mesh_kind, variant)
    if out.exists() and not force:
        print(f"[skip] {arch} x {shape} x {mesh_kind} (cached)")
        return json.loads(out.read_text())
    print(f"[run ] {arch} x {shape} x {mesh_kind} ({variant}) ...", flush=True)
    t0 = time.perf_counter()
    try:
        record = lower_combo(arch, shape, mesh_kind, variant=variant, memo=memo)
        record["variant"] = variant
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
        r = record["roofline"]
        coll = "n/a" if r["collective_s"] is None else f"{r['collective_s']:.3e}s"
        print(
            f"[ ok ] {arch} x {shape} x {mesh_kind}: "
            f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
            f"collective={coll} dominant={r['dominant']} "
            f"(specs+meta run {time.perf_counter()-t0:.1f}s)",
            flush=True,
        )
        return record
    except Exception as exc:  # record failures — they are bugs to fix
        err = {
            "arch": arch, "shape": shape, "mesh": mesh_kind, "variant": variant,
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc()[-4000:],
        }
        out.parent.mkdir(parents=True, exist_ok=True)
        out.with_suffix(".error.json").write_text(json.dumps(err, indent=1))
        print(f"[FAIL] {arch} x {shape} x {mesh_kind}: {exc}", flush=True)
        return err


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=[*MESHES, "both"], default="single")
    ap.add_argument("--variant", choices=list(VARIANTS), default="baseline")
    ap.add_argument("--all", action="store_true", help="sweep all archs x shapes")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCH_IDS) if args.all or args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or args.shape is None else [args.shape]

    failures = 0
    memo: dict = {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_combo(arch, shape, mesh_kind, force=args.force, variant=args.variant,
                                memo=memo)
                if "error" in rec:
                    failures += 1
        memo.clear()  # one arch's specs and meta runs at a time
    if failures:
        raise SystemExit(f"{failures} combination(s) failed")
    print("all requested combinations counted OK")


if __name__ == "__main__":
    main()
