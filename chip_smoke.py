#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run with a non-zero
exit code and no result line:

1. device  — the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build   — compiles ``src/repro_torch/csrc/gru_scan.cu`` with nvcc for
             sm_90a (ptxas report included).
3. kernels — ``gru_scan`` and ``gru_scan_bwd`` on the card against their
             plain PyTorch versions at the main path's shapes and more
             (ragged batch, client axis, N = 2, 8, 64), two backward runs
             compared bit for bit, then times: kernel, plain version, the
             roofline bound, and cuDNN's GRU layer as a yardstick.
4. parity  — a small federation trained on the card against the same one
             trained on the CPU through the plain versions.
5. slice   — the paper's path at full width: the full 189-hospital cohort,
             2-layer GRU N=32, batch 128, AdamW 5e-3/5e-3; ``run_setting``
             for federated-src (3 rounds x 4 local epochs) and central (one
             epoch), with every kernel's launch count checked against what
             the run implies.
6. profile — one client's local round under torch.profiler: step time,
             device busy time and idle share, the kernels that take most of it.

The line before the last lists each kernel with its numbers; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
FWD_TOL = 1e-5
DX_TOL = 1e-5
DW_TOL = 1e-4                # times max(1, max|ref|): sums over B*T terms in another order
PARITY_TOL = 1e-4


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    # -- 1. device ------------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit(phase="device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -------------------------------------------------------------
    from repro_torch.kernels import backend
    from repro_torch.kernels.gru_scan import kernel as K

    t0 = time.perf_counter()
    lib_path = backend.build("gru_scan")
    K._library()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib_path.name,
         ptxas=lib_path.with_suffix(".log").read_text())

    # -- 3. kernels against their plain versions ------------------------------
    kernel_rows = check_kernels(torch, dev, K)

    # -- 4. the whole path on the card against the CPU ------------------------
    check_parity(torch)

    # -- 5. the slice at full width -------------------------------------------
    launches, cohort = run_slice(torch, K)
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")

    # -- 6. where a local step's time goes ------------------------------------
    profile_local_training(torch, cohort)

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

CASES = (
    # name, C (None = no client axis), B, T, N
    ("train", None, 128, 24, 32),
    ("predict", None, 2048, 24, 32),
    ("ragged", None, 100, 24, 32),
    ("clients", 3, 100, 24, 32),
    ("n8", None, 128, 24, 8),
    ("n64", None, 128, 24, 64),
    ("n2", None, 37, 5, 2),
)


def gru_inputs(torch, dev, c, b, t, n, seed):
    g = torch.Generator().manual_seed(seed)
    lead = () if c is None else (c,)

    def normal(*shape, scale=1.0):
        return (torch.randn(*lead, *shape, generator=g) * scale).to(dev)

    return (normal(b, t, 3 * n), normal(n, 3 * n, scale=0.3), normal(3 * n, scale=0.1),
            normal(b, t, n))


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check_kernels(torch, dev, K) -> list[dict]:
    from repro_torch.kernels.gru_scan.ref import gru_scan_bwd_ref, gru_scan_ref

    errs = {"gru_scan": 0.0, "gru_scan_bwd": 0.0}
    for i, (case, c, b, t, n) in enumerate(CASES):
        xg, w, bias, dy = gru_inputs(torch, dev, c, b, t, n, seed=i)
        h = K.gru_scan(xg, w, bias)
        h_ref = gru_scan_ref(xg, w, bias)
        dx, dw, db = K.gru_scan_bwd(xg, w, bias, h, dy)
        dx2, dw2, db2 = K.gru_scan_bwd(xg, w, bias, h, dy)
        torch.cuda.synchronize()
        dx_r, dw_r, db_r = gru_scan_bwd_ref(xg, w, bias, h, dy)
        e = {
            "fwd": max_err(h, h_ref),
            "dx": max_err(dx, dx_r),
            "dw": max_err(dw, dw_r),
            "db": max_err(db, db_r),
        }
        same_bits = all(torch.equal(x, y) for x, y in ((dx, dx2), (dw, dw2), (db, db2)))
        emit(phase="kernels", case=case, C=c, B=b, T=t, N=n, **e, bitwise_repeat=same_bits)
        require(e["fwd"] <= FWD_TOL, f"{case}: gru_scan forward error {e['fwd']}")
        require(e["dx"] <= DX_TOL, f"{case}: dx_gates error {e['dx']}")
        require(e["dw"] <= DW_TOL * max(1.0, float(dw_r.abs().max())), f"{case}: dW_hh error {e['dw']}")
        require(e["db"] <= DW_TOL * max(1.0, float(db_r.abs().max())), f"{case}: db_hh error {e['db']}")
        require(same_bits, f"{case}: two backward runs differ")
        errs["gru_scan"] = max(errs["gru_scan"], e["fwd"])
        errs["gru_scan_bwd"] = max(errs["gru_scan_bwd"], e["dx"], e["dw"], e["db"])

    # Times at the training step's shape (B=128, T=24, N=32), layer 2 (F = N).
    b, t, n = 128, 24, 32
    xg, w, bias, dy = gru_inputs(torch, dev, None, b, t, n, seed=100)
    h = K.gru_scan(xg, w, bias)
    fwd_ms = time_ms(torch, lambda: K.gru_scan(xg, w, bias), iters=500)
    bwd_ms = time_ms(torch, lambda: K.gru_scan_bwd(xg, w, bias, h, dy), iters=500)
    fwd_plain = time_ms(torch, lambda: gru_scan_ref(xg, w, bias), iters=20)
    bwd_plain = time_ms(torch, lambda: gru_scan_bwd_ref(xg, w, bias, h, dy), iters=20)
    cudnn_fwd, cudnn_bwd = cudnn_gru_ms(torch, dev, b, t, n, n)
    # Predict batches run the forward at B=2048.
    xg_p, w_p, b_p, _ = gru_inputs(torch, dev, None, 2048, t, n, seed=101)
    fwd_ms_predict = time_ms(torch, lambda: K.gru_scan(xg_p, w_p, b_p), iters=200)
    emit(phase="timing", shape={"B": b, "T": t, "N": n}, gru_scan_ms=fwd_ms,
         gru_scan_bwd_ms=bwd_ms, gru_scan_plain_ms=fwd_plain, gru_scan_bwd_plain_ms=bwd_plain,
         cudnn_gru_fwd_ms=cudnn_fwd, cudnn_gru_bwd_ms=cudnn_bwd,
         gru_scan_ms_at_B2048=fwd_ms_predict)

    fwd_bytes, fwd_ops, bwd_bytes, bwd_ops = work(b, t, n)
    rows = []
    for name, ms, plain, lib, nbytes, ops, line in (
        ("gru_scan", fwd_ms, fwd_plain, cudnn_fwd, fwd_bytes, fwd_ops, 51),
        ("gru_scan_bwd", bwd_ms, bwd_plain, cudnn_bwd, bwd_bytes, bwd_ops, 140),
    ):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/gru_scan.cu",
            "replaces": f"src/repro/kernels/gru_scan/kernel.py:{line}",
            "launches": 0,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib,
        })
    return rows


def work(b: int, t: int, n: int) -> tuple[int, int, int, int]:
    """Bytes each kernel must move (inputs once, outputs once) and its float ops.

    Forward per (row, step): the (1,N)x(N,3N) product (2*N*3N) and ~20 ops per
    unit for biases, two sigmoids, tanh and the blend.  Backward: the gate
    rebuild, d_gh W^T and h^T d_gh products (3 * 2*N*3N) and ~40 ops per unit.
    """
    f = 4
    w_bytes = f * (n * 3 * n + 3 * n)
    fwd_bytes = f * (b * t * 3 * n + b * t * n) + w_bytes
    bwd_bytes = f * (2 * b * t * 3 * n + 2 * b * t * n) + 2 * w_bytes
    fwd_ops = b * t * (2 * n * 3 * n + 20 * n)
    bwd_ops = b * t * (3 * 2 * n * 3 * n + 40 * n)
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def time_ms(torch, fn, iters: int, warmup: int = 10) -> float:
    """Mean device time per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cudnn_gru_ms(torch, dev, b, t, f, n) -> tuple[float, float]:
    """One cuDNN GRU layer (torch.nn.GRU) at the same B, T, F, N: forward, and
    backward alone.  A yardstick only; the port never calls it."""
    gru = torch.nn.GRU(f, n, batch_first=True).to(dev)
    x = torch.randn(b, t, f, device=dev, requires_grad=True)
    with torch.no_grad():
        fwd = time_ms(torch, lambda: gru(x), iters=500)
    out, _ = gru(x)
    dy = torch.randn_like(out)
    params = [x, *gru.parameters()]
    bwd = time_ms(
        torch, lambda: torch.autograd.grad(out, params, dy, retain_graph=True), iters=500
    )
    return fwd, bwd


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def check_parity(torch) -> None:
    """A 4-client federation, 2 rounds, dropout 0: card against CPU."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves

    clients = build_client_datasets(generate_cohort(CohortConfig().scaled(0.02), seed=1))
    cfg = GRUConfig(dropout=0.0)
    params0 = init_gru(torch.Generator().manual_seed(1), cfg, "cpu")
    fed_cfg = FederationConfig(rounds=2, local_epochs=1, recruitment="top-n-samples:4",
                               selection="uniform", seed=1)
    out = {}
    for device in ("cuda", "cpu"):
        fed = Federation(fed_cfg, clients, make_loss_fn(cfg), AdamW(), device=device)
        out[device] = fed.run(params0)
    diff = max(
        max_err(a.cpu(), b) for a, b in zip(tree_leaves(out["cuda"].params),
                                            tree_leaves(out["cpu"].params))
    )
    losses = {d: [r.mean_local_loss for r in out[d].history] for d in out}
    emit(phase="parity", max_param_diff=diff, losses=losses,
         local_steps=out["cuda"].total_local_steps)
    require(diff <= PARITY_TOL, f"card and CPU federations differ by {diff}")


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def run_slice(torch, K) -> dict[str, int]:
    from repro_torch.data.pipeline import build_client_datasets, global_dataset
    from repro_torch.data.synth_eicu import Cohort
    from repro_torch.experiments.paper import (
        ExperimentConfig,
        build_cohort,
        policies_for,
        run_setting,
    )
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    t0 = time.perf_counter()
    cohort = build_cohort(ExperimentConfig(), seed=0)
    n_test = len(global_dataset(cohort, Cohort.TEST))
    predict_batches = math.ceil(n_test / 2048)
    emit(phase="cohort", seconds=time.perf_counter() - t0, stays=int(cohort.y.size),
         hospitals=int(cohort.num_hospitals), test=n_test)

    fed_exp = ExperimentConfig(rounds=3, local_epochs=4)
    central_exp = ExperimentConfig(central_epochs=1)
    records = []

    K.gru_scan.launches = 0
    K.gru_scan_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = run_setting("federated-src", fed_exp, cohort, seed=0, progress=records.append)
    fed_s = time.perf_counter() - t0
    fed_counts = (K.gru_scan.launches, K.gru_scan_bwd.launches)
    t0 = time.perf_counter()
    central = run_setting("central", central_exp, cohort, seed=0)
    central_s = time.perf_counter() - t0
    counts = {"gru_scan": K.gru_scan.launches, "gru_scan_bwd": K.gru_scan_bwd.launches}

    for r in records:
        emit(phase="round", round=r.round_index, participants=len(r.participant_ids),
             mean_local_loss=r.mean_local_loss, local_steps=r.local_steps,
             round_time_s=r.round_time_s)
    round_s = sum(r.round_time_s for r in records)
    emit(phase="federated-src", recruited=fed["recruited"],
         federation_size=fed["federation_size"], local_steps=fed["local_steps"],
         local_steps_per_s=fed["local_steps"] / round_s, seconds=fed_s,
         metrics=fed["metrics"], launches=dict(zip(counts, fed_counts)))
    emit(phase="central", local_steps=central["local_steps"],
         local_steps_per_s=central["local_steps"] / central["tau_s"], seconds=central_s,
         metrics=central["metrics"])

    for out in (fed, central):
        require(all(math.isfinite(v) for v in out["metrics"].values()),
                f"{out['setting']}: metrics not finite: {out['metrics']}")
    require(all(math.isfinite(r.mean_local_loss) for r in records), "a round loss is not finite")

    federation = Federation(
        FederationConfig(**policies_for("federated-src", fed_exp), seed=0),
        build_client_datasets(cohort), make_loss_fn(GRUConfig()), AdamW(), device="cuda",
    )
    ids, _ = federation.build_federation()
    require(fed["federation_ids"] == ids.tolist(), "recruited set differs from build_federation")

    # Two GRU layers: two forward launches per local step and per predict
    # batch, two backward launches per local step.
    want_fed = (2 * fed["local_steps"] + 2 * predict_batches, 2 * fed["local_steps"])
    want_central = (2 * central["local_steps"] + 2 * predict_batches, 2 * central["local_steps"])
    require(fed_counts == want_fed, f"federated-src launches {fed_counts}, expected {want_fed}")
    got_central = (counts["gru_scan"] - fed_counts[0], counts["gru_scan_bwd"] - fed_counts[1])
    require(got_central == want_central,
            f"central launches {got_central}, expected {want_central}")
    return counts, cohort


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------


def profile_local_training(torch, cohort) -> None:
    """One client's local round (the largest hospital, 4 epochs, batch 128)
    under torch.profiler: wall time, summed device time of every GPU kernel,
    the device's idle share, and the kernels that take the most device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    clients = build_client_datasets(cohort)
    client = max(clients, key=lambda c: c.n_train)
    cfg = GRUConfig()
    trainer = LocalTrainer(make_loss_fn(cfg), AdamW(), batch_size=128, local_epochs=4,
                           device="cuda")
    params = init_gru(torch.Generator().manual_seed(0), cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer.train_client(params, client, np.random.default_rng(0), gen)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_client(params, client, np.random.default_rng(1), gen)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_s = sum(by_name.values()) / 1e6
    steps = trainer.steps_per_round(client)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", client=client.client_id, n_train=client.n_train, local_steps=steps,
         wall_s=wall_s, step_ms=wall_s / steps * 1e3,
         device_busy_s=device_s if device_s > 0 else None,
         device_idle_share=1.0 - device_s / wall_s if device_s > 0 else None,
         kernels_launched=sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA),
         top_device_us={name[:80]: us for name, us in top})


if __name__ == "__main__":
    sys.exit(main())
