#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run with a non-zero
exit code and no result line:

1. device  — the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build   — compiles ``src/repro_torch/csrc/gru_scan.cu`` and ``ssd.cu``
             with nvcc for sm_90a, one nvcc per source, started together
             (ptxas reports included).
3. kernels — ``gru_scan`` and ``gru_scan_bwd`` on the card against their
             plain PyTorch versions at the main path's shapes and more
             (ragged batch, client axis, N = 2, 8, 33, 64, the ARC
             cohort's 35 clients, all 189 clients in one launch, and a
             population round's 64 clients at B=4, T=4, N=4), two
             forward and two backward runs compared bit for bit, and each of
             the backward's two stage kernels against its plain twin; then
             times at one client, at 35 and at 189: per call, on the device
             alone (a CUDA graph), each backward stage alone, the plain
             version, the roofline bound, and cuDNN's GRU layer as a
             yardstick.
             ``ssd_chunk_scan`` against its plain versions (with and
             without the entry states) at the serving slice's shape, one
             chunk, the reduced config, zamba2-7b's prefill shape (H=112,
             N=64), and a ragged sequence with H=3 through ``ssd_full``;
             each of its four stage kernels against its plain stage in
             ``ref.py``; runs compared bit for bit; then times at the
             serving slice's shape and zamba2's (the call, and each stage
             alone), and the float32 and the 3xTF32 tensor-core bounds.
             ``ssd_chunk_scan_bwd`` against its plain version at the train
             slice's shape, one chunk, the reduced config, NC=3 with H=3
             and zamba2's shape, and each of its six stage kernels against
             its plain stage; runs compared bit for bit; then the same
             times at the train slice's shape and zamba2's.
4. parity  — a small federation trained on the card (default, vectorized
             engine, resident staging, dropout 0) against the same one trained
             on the CPU
             through the plain versions; on the card, with dropout 0.05, the
             vectorized engine against the sequential one and a chunked
             cohort against an unchunked one.
5. slice   — the paper's path at full width: the full 189-hospital cohort,
             2-layer GRU N=32, batch 128, AdamW 5e-3/5e-3; ``run_setting``
             for federated-src (3 rounds x 4 local epochs) on both engines
             and central (one epoch), with every kernel's launch count
             checked against what the run implies (on the vectorized
             engine: the batched steps its schedules give).
6. profile — one client's local round under torch.profiler: step time,
             device busy time and idle share, the GRU kernels' shares of it,
             and the kernels that take most of it.
7. mamba2 parity — mamba2-130m at full width in float32, B=2, a prompt
             of 300 tokens (ragged against the chunk of 256): prefill logits
             and hidden states on the card against the CPU, and the card's
             prefill logits against its decode path after the same prompt.
8. serve slice — the published mamba2-130m (bfloat16): ``make_prefill_step``
             at B=8 on a 2,048-token prompt (tokens/s, 24 SSD launches per
             call) and on its first 256 tokens, then those 256 and 64
             greedy tokens through ``make_serve_step`` (tokens/s, no SSD
             launch).
9. serve profile — one prefill call and one decode step under
             torch.profiler: wall time, device busy time and idle share, the
             kernels that take most of it.
10. mamba2 train parity — mamba2-130m at full width in float32, B=2,
             a sequence of 300 tokens: the loss, every gradient leaf
             and the params after one ``make_train_step`` on the card against
             the CPU; on the card, remat on against remat off.
11. train slice — the published mamba2-130m (bfloat16) through
             ``make_train_step`` with AdamW(1e-3) at B=8 x 2,048 tokens on one
             fixed batch: 2 warm-up and 5 timed steps (step time, tokens/s,
             peak memory, a finite and falling loss), with exactly 24 forward
             and 24 backward SSD launches a step (48 and 24 with remat).
12. train profile — one train step under torch.profiler: wall time,
             device busy time and idle share, the kernels that take most of
             it, and the SSD kernels' shares of device time.
13. cohort slice — federated-arc at full width on the full cohort (35
             recruited clients, all participating, 4 local epochs, one
             chunk), 2 rounds on three paths from one init: resident staging
             (the default), rebuild staging and the sequential engine: round
             time, real client-steps per second, batched steps, bytes staged
             and resident, staging seconds, the resident cohort's attach
             time, peak memory, exact launch counts; resident and rebuild
             params bit for bit equal, a resident round under 10 MB staged,
             the resident and sequential test MSLE within 1e-4.
14. paper scale — ``run_paper_scale(rounds=2, local_epochs=1, batch_size=4)``:
             189 clients of ~23 stays, the five settings on both engines,
             round times, speedups and the donation probe.
15. cohort profile — one vectorized federated-arc round under
             torch.profiler, rebuild staging then resident: device busy time
             (copies and kernels) and idle share, kernels a batched step,
             and the GRU kernels' shares of device and of kernel time.
16. cohort variants — one federated-arc round at full width from one
             init: unchunked, chunks of 12 with prefetch on and off (the
             same bits; prefetch engaged), chunks of 17 (17, 17, 1), and
             ``hierarchical:4``; each within 1e-6 of the unchunked round.
17. trimmed mean — federated-src, one round with ``trimmed-mean:0.1``
             (the per-client trainer): finite metrics, exact launches.
18. staging comparison — ``run_staging_comparison`` at its defaults
             (189 clients, hidden 8, four staging variants): round times,
             bytes, the byte ratio (at least 10) and the variants' largest
             param difference (at most 1e-4).
19. privacy — DP, secagg and krum on the card: ``gru_scan`` and
             ``gru_scan_bwd`` at DP's per-example shape, C·B clients of batch
             1 ((4480, 1, 24, 32) at arc, (24192, 1, 24, 32) for 189
             clients), against their plain versions and bit for bit, with
             device times beside the batched shape of the same work; a
             4-client DP federation (clip binding, noise 0, dropout 0) on the
             card against the CPU (params within 1e-5); on the card, the two
             engines under DP with noise and dropout 0.05 (round losses 1e-5,
             params 1e-4) and degenerate DP against unprotected (dropout 0,
             1e-5); federated-arc at full width with DP, 2 resident
             vectorized rounds and 1 sequential (round time, epsilon, GRU
             launches, per-example clients, peak memory), one profiled DP
             round of one local epoch (device operations a step); and one arc
             round each of ``secagg-fedavg`` (within its quantization bound
             of FedAvg) and ``krum:4``.
20. async  — the async runtime at full width (``AsyncFederation``, one
             ``_train_group`` call a task): (a) federated-arc's 35 clients, 2
             flushes of 4 local epochs, dropout 0.05, resident staging:
             ``fedbuff:35`` with constant latency (one-client tasks) and
             ``hierarchical-async:1`` each against the sync FedAvg arc run
             from the same init (round losses 1e-5, params 1e-4, staleness
             0), the sync round's time beside a flush's, exact launches;
             (b) all 189 clients and the recruited 35 under ``fedbuff:0.25``
             with ``lognormal:0.6`` and ``pareto:1.2`` latencies, client
             dropout 0.05, 8 flushes of 1 local epoch: sizes, tasks, dropped
             tasks, staleness, the virtual time of each flush, host seconds
             a flush and a task, real local steps a second, exact launches,
             and the shared time to target with the recruited speedup;
             (c) ``run_async_comparison()`` at its defaults, its timeline
             (sizes, flushes, tasks, dropped tasks, each flush's virtual
             time) equal to ``BENCH_async.json``'s; then one profiled flush
             of the recruited federation: the device's idle share.
21. control plane — ``launch/federation_service.py`` at full width:
             (a) ``job_spec_for("federated-arc", ExperimentConfig(rounds=3))``
             submitted uninterrupted (A); through the CLI in a subprocess
             with ``--preempt-after 1`` (exit 75), then ``resume`` through
             the CLI (exit 0) (B); in a subprocess killed with SIGKILL once
             its first snapshot has landed, then resumed (C);
             ``diff_runs(B, A)`` and ``diff_runs(C, A)`` empty, each run's
             largest final-param difference from A (at most 1e-5) and
             whether it is bit for bit; the snapshot's bytes on disk, its
             save and load times, a round's time with and without the
             checkpoint; (b) the recruited 35 under ``fedbuff:0.25``,
             ``lognormal:0.6`` and client dropout 0.05, 4 flushes of 1 epoch,
             preempted at flush 2 and resumed: virtual times, staleness,
             participants, tasks and dropped tasks exactly the uninterrupted
             run's, params within 1e-5; (c) (a)'s job with DP (clip 1, noise
             1), 2 rounds, cut after round 1: the epsilons exactly the
             uninterrupted run's, params within 1e-5; (d)
             ``run_service_overhead(device="cuda")`` at its defaults (not
             gated: host timing noise).  Every run launches both GRU kernels;
             the subprocesses report their counts.
22. observability — ``repro_torch.obs`` at full width: (a) federated-arc
             (35 recruited, 4 local epochs, resident, 2 rounds) with a
             ``Tracer`` and without, from one init: params bit for bit,
             launches equal, round spans equal to ``round_time_s`` exactly,
             the phases' span counts, ``trace.json`` loads, no event
             dropped; (b) the recruited 35 under ``fedbuff:0.25``,
             ``lognormal:0.6``, dropout 0.05, 2 flushes of 1 epoch, traced:
             flush spans equal to the records on both clocks, a task span a
             task, flow starts equal to flow ends; (c) the arc job (3
             rounds) with ``"observability": {"trace": true,
             "jax_profile_rounds": 1}`` through the CLI, preempted after
             round 1 (exit 75) and resumed (exit 0): ``trace.json`` holds
             the resumed rounds, ``metrics.jsonl`` follows ``records.jsonl``,
             ``python -m repro_torch.obs report`` renders it, each child's
             ``torch_profile/`` trace holds both GRU kernels' device events
             and its profiler no error, ``jit.*`` counts each child's
             library load, the final params are an untraced job's bit for
             bit; (d) ``run_obs_overhead`` (one repeat of 3 async flushes,
             not 3 of 10) and
             ``run_facade_overhead``, the async run's per-phase host time
             from its trace (not gated: host timing noise).
23. tables — (a) ``run_population_scale()`` at its defaults (10^3, 10^4
             and 10^5 synthetic clients, 3 rounds of 64 out of a 256-row LRU
             pool): its own assertions (exact-mode participant match,
             sub-linear decision and round time, O(1) membership), each GRU
             kernel once a batched step, one pooled round at 10^3 card
             against CPU (params 1e-5); (b) ``run_table4`` and ``run_table5``
             (seeds 0 and 1) and ``run_fig2`` (gamma_th 0.1 and 1.0, seed 0)
             at the paper's width, 1 round x 1 epoch and 1 central epoch:
             finite metrics, federation sizes equal to the CPU's
             recruitment, launches equal to what the runs imply, both
             tables printed; (c) ``recompute_elimination_report`` for the GRU
             pair at (35, 128, 24, 32) and the SSD pair at the reduced
             config: recompute eliminated, one backward launch and no
             forward in the residual backward, none in the oracle's.
24. LM zoo — the dense, VLM and hybrid families: (a) every reduced
             config of the slice (smollm-135m, qwen3-1.7b, yi-9b,
             nemotron-4-15b, internvl2-26b, zamba2-7b) and two variants
             (qwen3 with GQA group 2, zamba2 with 5 layers: 2 groups and a
             tail) in float32: logits, the loss and every gradient leaf on
             the card against the CPU, and the card's decode path (the
             VLM's patches through ``token_embeds``) against its forward;
             (b) the published qwen3-1.7b (bfloat16): 4 prefill calls at
             B=8 x 2,048, 16 prompt and 64 greedy tokens through the decode
             path, two train steps at the largest of B=8, 4, 2 that fits;
             (c) the published zamba2-7b: 2 prefill calls at B=8 x 2,048
             with exactly 68 ``ssd_chunk_scan`` launches each, 32 decode
             tokens with none, and a train step at B=1 x 2,048 cut to 60
             layers (50 Mamba layers; printed in ``reduced``) with 100
             forward and 50 backward SSD launches; (d) yi-9b,
             nemotron-4-15b and internvl2-26b at full width cut to 2 layers:
             prefill, the VLM's 256 patches through the decode path, 8
             greedy tokens, finite; (e) ``make_fed_round_step`` at
             full-width smollm-135m, 4 client slots of 3 local steps, one
             of weight 0: every slot equal after the round, a finite loss.
25. mesh   — the client axis over several processes (``launch/mesh.py``):
             (a) federated-arc's round (35 clients, 1 local epoch) with
             ``mesh="auto"`` in this process, where no process group
             exists, equal to ``mesh=None`` bit for bit; (b) the same round
             in two child processes, both on cuda:0, joined in a gloo group
             through a ``FileStore``: each rank's block, its ``gru_scan``
             and ``gru_scan_bwd`` launches (two a step of its block) and
             its round time, labelled as two ranks sharing one card; the
             ranks' params the same bits, within 1e-4 of the one-process
             round's and the losses within 1e-5; (c) with two cards or more,
             the same round over two GPUs under NCCL; with one, a line says
             that leg did not run.  The children's launches count.
26. MoE and encoder-decoder — the last families of the LM zoo: (a) the
             reduced deepseek-v3-671b (MLA, 4 experts top-2, a shared expert,
             MTP, one dense layer), llama4-scout-17b-a16e and
             seamless-m4t-large-v2, llama4 with ``moe_every=2`` and 5 layers,
             deepseek with ``ep_local`` and at capacity 0.5, in float32:
             logits, the loss and every gradient leaf on the card against
             the CPU, the routed ids equal, a repeated forward the same
             bits, decode (after ``encode_for_decode``) against the card's
             forward at capacity 8.0; (b) deepseek-v3-671b in bf16 at full
             width, 5 of 61 layers (3 dense, 2 MoE of 256 experts, top-8):
             prefill at B=2 x 2,048, 16 + 32 tokens through the latent-cache
             decode, its bytes a token beside a full-rank cache's; a train
             step of 2 layers with 16 of 256 experts and MTP (ce,
             router_aux, mtp_ce); (c) llama4-scout-17b-a16e, 8 of 48 layers
             served (B=8 x 2,048, 16 + 32 tokens), 1 trained; (d)
             seamless-m4t-large-v2 uncut: prefill at B=8 x 2,048 with 512
             frames, ``encode_for_decode`` and 16 + 64 tokens, a train step.
             The cuts are printed in ``reduced``; this path runs no kernel.

The line before the last lists each kernel with its numbers; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3   # H100 SXM dense TF32 on the tensor cores, three products per product
FWD_TOL = 1e-5
DX_TOL = 1e-5
DW_TOL = 1e-4                # times max(1, max|ref|): sums over B*T terms in another order
PARITY_TOL = 1e-4
ENGINE_LOSS_TOL = 1e-5       # the engines' round losses (phase 4)
CHUNK_TOL = 1e-6             # chunked, prefetched, hierarchical against one chunk (phases 4, 16)
DP_PARITY_TOL = 1e-5         # DP card against CPU; degenerate DP against none (phase 19)
RESUME_TOL = 1e-5            # a resumed job's final params against the uninterrupted one's (phase 21)
ARC_MSLE_TOL = 1e-4          # the engines' test MSLE on federated-arc (phase 13)
MAX_RESIDENT_STAGED = 10_000_000   # bytes a resident arc round may stage (phase 13)
SSD_TOL = 1e-4               # times max(1, max|ref|): sums of up to L*N and L*P products in another order
MAMBA_TOL = 1e-4             # 24 float32 layers, card against CPU: times max(1, max|ref|), a gradient leaf times its own max|ref|
DECAY_GRAD_TOL = 1e-3        # times its own max|ref|: the A_log and dt_bias leaves (phase 10)
DECAY_LEAVES = ("A_log", "dt_bias")
DECODE_ATOL, DECODE_RTOL = 2e-4, 1e-4   # decode path against prefill, as tests/test_decode.py
PARITY_PROMPTS = (300,)      # phases 7 and 10: B=2; 300 is ragged against the chunk of 256
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 2048, 64   # phase 8
SERVE_FEED = 256             # phase 8: prompt tokens fed through the decode path
TRAIN_B, TRAIN_SEQ, TRAIN_LR = 8, 2048, 1e-3     # phase 11
TRAIN_WARMUP, TRAIN_STEPS = 2, 5


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
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit(phase="device", name=device_name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -------------------------------------------------------------
    from repro_torch.kernels import backend
    from repro_torch.kernels.gru_scan import kernel as K
    from repro_torch.kernels.ssd import kernel as SK

    t0 = time.perf_counter()
    sources = ("gru_scan", "ssd")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = dict(zip(sources, pool.map(backend.build, sources)))
    K._library()
    SK._library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: v.name for k, v in libs.items()},
         ptxas={k: v.with_suffix(".log").read_text() for k, v in libs.items()})

    # -- 3. kernels against their plain versions ------------------------------
    kernel_rows = check_kernels(torch, dev, K)
    kernel_rows.append(check_ssd_kernel(torch, dev, SK))
    kernel_rows.append(check_ssd_bwd_kernel(torch, dev, SK))

    # -- 4. the whole path on the card against the CPU ------------------------
    check_parity(torch)

    # -- 5. the slice at full width -------------------------------------------
    launches, cohort = run_slice(torch, K)

    # -- 6. where a local step's time goes ------------------------------------
    profile_local_training(torch, cohort)

    # -- 7. Mamba2 at full width: card against CPU, prefill against decode ----
    check_mamba2_parity(torch)

    # -- 8. the serving slice: mamba2-130m, bfloat16 --------------------------
    serve_launches, serve_state = run_serve_slice(torch, SK)
    launches.update(serve_launches)

    # -- 9. where a prefill call's and a decode step's time goes --------------
    profile_serving(torch, *serve_state)
    del serve_state

    # -- 10. Mamba2 training at full width: card against CPU, remat on and off -
    check_mamba2_train_parity(torch)

    # -- 11. the train slice: mamba2-130m, bfloat16, B=8 x 2,048 ---------------
    train_launches, train_step = run_train_slice(torch, SK)
    launches["ssd_chunk_scan"] += train_launches["ssd_chunk_scan"]
    launches["ssd_chunk_scan_bwd"] = train_launches["ssd_chunk_scan_bwd"]

    # -- 12. where a train step's time goes -----------------------------------
    profile_training(torch, train_step)
    del train_step
    torch.cuda.empty_cache()

    # -- 13. the cohort slice: federated-arc at full width, three paths -------
    for kernel, n in run_cohort_slice(torch, K, cohort).items():
        launches[kernel] += n

    # -- 14. paper scale: 189 small clients, five settings, both engines ------
    for kernel, n in run_paper_scale_phase(torch, K).items():
        launches[kernel] += n

    # -- 15. where a vectorized round's time goes, rebuild then resident -------
    for staging in ("rebuild", "resident"):
        profile_cohort_round(torch, cohort, staging)

    # -- 16-17. chunks and prefetch; hierarchical and trimmed-mean -------------
    for kernel, n in run_chunk_and_aggregator_phase(torch, K, cohort).items():
        launches[kernel] += n

    # -- 18. the staging comparison --------------------------------------------
    for kernel, n in run_staging_comparison_phase(torch, K).items():
        launches[kernel] += n

    # -- 19. DP, secagg and krum on the card -----------------------------------
    for kernel, n in run_privacy_phase(torch, dev, K, cohort).items():
        launches[kernel] += n

    # -- 20. the async runtime at full width -----------------------------------
    for kernel, n in run_async_phase(torch, K, cohort).items():
        launches[kernel] += n

    # -- 21. the control plane: submit, preempt, kill, resume ------------------
    for kernel, n in run_control_plane_phase(torch, K).items():
        launches[kernel] += n

    # -- 22. observability: traces, profiled rounds, jit.* ---------------------
    for kernel, n in run_observability_phase(torch, K, cohort).items():
        launches[kernel] += n

    # -- 23. the population sweep, the paper's tables, the analysis ------------
    for kernel, n in run_tables_phase(torch, K, SK).items():
        launches[kernel] += n

    # -- 24. the attention families of the LM zoo: dense, VLM, hybrid ----------
    for kernel, n in run_lm_zoo_phase(torch, SK).items():
        launches[kernel] += n

    # -- 25. the client axis over several processes ----------------------------
    for kernel, n in run_mesh_phase(torch, K, cohort).items():
        launches[kernel] += n

    # -- 26. the MoE decoders with MLA, and the encoder-decoder -----------------
    for kernel, n in run_moe_encdec_phase(torch, K, SK).items():
        launches[kernel] += n

    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}), flush=True)
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
    ("n33", None, 37, 5, 33),      # two units a lane, N not a multiple of 4
    ("cohort", 35, 128, 24, 32),   # the ARC federation's 35 recruited clients in one launch
    ("ac", 189, 128, 24, 32),      # all 189 clients (federated-ac) in one launch
    ("population", 64, 4, 4, 4),   # a population round's 64 clients (phase 23)
)
COHORT = 35
AC_COHORT = 189


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
        h2 = K.gru_scan(xg, w, bias)
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
        same_bits = all(torch.equal(x, y) for x, y in ((h, h2), (dx, dx2), (dw, dw2), (db, db2)))
        emit(phase="kernels", case=case, C=c, B=b, T=t, N=n, **e, bitwise_repeat=same_bits)
        require(e["fwd"] <= FWD_TOL, f"{case}: gru_scan forward error {e['fwd']}")
        require(e["dx"] <= DX_TOL, f"{case}: dx_gates error {e['dx']}")
        require(e["dw"] <= DW_TOL * max(1.0, float(dw_r.abs().max())), f"{case}: dW_hh error {e['dw']}")
        require(e["db"] <= DW_TOL * max(1.0, float(db_r.abs().max())), f"{case}: db_hh error {e['db']}")
        require(same_bits, f"{case}: two forward or backward runs differ")
        check_gru_stages(torch, K, case, xg, w, bias, h, dy)
        errs["gru_scan"] = max(errs["gru_scan"], e["fwd"])
        errs["gru_scan_bwd"] = max(errs["gru_scan_bwd"], e["dx"], e["dw"], e["db"])

    # Times at the training step's shape (B=128, T=24, N=32), layer 2 (F = N),
    # for one client, the ARC cohort's 35 and all 189 in one launch.
    b, t, n = 128, 24, 32
    times = gru_times(torch, dev, K)
    xg, w, bias, dy = gru_inputs(torch, dev, None, b, t, n, seed=100)
    h = K.gru_scan(xg, w, bias)
    fwd_plain = time_ms(torch, lambda: gru_scan_ref(xg, w, bias), iters=20)
    bwd_plain = time_ms(torch, lambda: gru_scan_bwd_ref(xg, w, bias, h, dy), iters=20)
    cudnn_fwd, cudnn_bwd = cudnn_gru_ms(torch, dev, b, t, n, n)
    # Predict batches run the forward at B=2048.
    xg_p, w_p, b_p, _ = gru_inputs(torch, dev, None, 2048, t, n, seed=101)
    fwd_ms_predict = time_ms(torch, lambda: K.gru_scan(xg_p, w_p, b_p), iters=200)
    fwd_bytes, fwd_ops, bwd_bytes, bwd_ops = work(b, t, n)
    bounds = {}
    for c in (1, COHORT, AC_COHORT):
        bounds[f"C{c}"] = {
            "gru_scan": bound_ms(c * fwd_bytes, c * fwd_ops)[0],
            "gru_scan_bwd": bound_ms(c * bwd_bytes, c * bwd_ops)[0],
        }
    stages = {f"C{c}": gru_stage_ms(torch, dev, K, c, b, t, n) for c in (1, COHORT, AC_COHORT)}
    emit(phase="timing", shape={"B": b, "T": t, "N": n}, times=times, bound_ms=bounds,
         gru_scan_bwd_stage_device_ms=stages, gru_scan_plain_ms=fwd_plain,
         gru_scan_bwd_plain_ms=bwd_plain, cudnn_gru_fwd_ms=cudnn_fwd,
         cudnn_gru_bwd_ms=cudnn_bwd, gru_scan_ms_at_B2048=fwd_ms_predict)

    rows = []
    for name, plain, lib, nbytes, ops, line in (
        ("gru_scan", fwd_plain, cudnn_fwd, fwd_bytes, fwd_ops, 51),
        ("gru_scan_bwd", bwd_plain, cudnn_bwd, bwd_bytes, bwd_ops, 140),
    ):
        bound, bound_by = bound_ms(nbytes, ops)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/gru_scan.cu",
            "replaces": f"src/repro/kernels/gru_scan/kernel.py:{line}",
            "launches": 0,
            "max_abs_err": errs[name],
            "ms": times["C1"][name]["call_ms"],
            "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": lib,
        })
    return rows


def check_gru_stages(torch, K, case, xg, w, bias, h, dy) -> None:
    """Each stage kernel of the backward against its plain twin on the same
    inputs (the dW stage on the plain recurrence's outputs), and two runs of
    it bit for bit."""
    from repro_torch.kernels.gru_scan.ref import gru_bwd_dw_ref, gru_bwd_recur_ref

    dx_r, dgn_r = gru_bwd_recur_ref(xg, w, bias, h, dy)
    got = (*K.stage_recur(xg, w, bias, h, dy), *K.stage_dw(h, dx_r, dgn_r))
    again = (*K.stage_recur(xg, w, bias, h, dy), *K.stage_dw(h, dx_r, dgn_r))
    torch.cuda.synchronize()
    want = (dx_r, dgn_r, *gru_bwd_dw_ref(h, dx_r, dgn_r))
    names = ("recur.dx", "recur.dgn", "dw.dw", "dw.db")
    e = {k: max_err(g, r) for k, g, r in zip(names, got, want)}
    limit = {k: DX_TOL if k.startswith("recur") else DW_TOL * max(1.0, float(r.abs().max()))
             for k, r in zip(names, want)}
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    emit(phase="gru_stages", case=case, max_abs_err=e, bitwise_repeat=same)
    require(all(e[k] <= limit[k] for k in names), f"gru stages {case}: error {e}")
    require(same, f"gru stages {case}: two runs differ")


def gru_times(torch, dev, K) -> dict:
    """Per-call and device time of ``gru_scan`` and ``gru_scan_bwd`` at B=128,
    T=24, N=32 for one client (``C1``), 35 and 189 in one launch (``C35``,
    ``C189``; the graph holds 20 calls at 189).

    ``call_ms``: back-to-back wrapper calls under CUDA events, which the
    host's work per call (shape checks, allocations, the ctypes call) can
    pace; ``device_ms``: the same calls captured in a CUDA graph and replayed
    (``graph_ms``), the device's time alone."""
    b, t, n = 128, 24, 32
    out = {}
    for c, iters, graphed in ((1, 500, 100), (COHORT, 100, 100), (AC_COHORT, 50, 20)):
        xg, w, bias, dy = gru_inputs(torch, dev, None if c == 1 else c, b, t, n, seed=100 + c)
        h = K.gru_scan(xg, w, bias)
        calls = {"gru_scan": lambda: K.gru_scan(xg, w, bias),
                 "gru_scan_bwd": lambda: K.gru_scan_bwd(xg, w, bias, h, dy)}
        out[f"C{c}"] = {name: {"call_ms": time_ms(torch, fn, iters=iters),
                               "device_ms": graph_ms(torch, fn, calls=graphed)}
                        for name, fn in calls.items()}
    return out


def gru_stage_ms(torch, dev, K, c, b, t, n) -> dict[str, float]:
    """Device time of each launch of the backward alone (CUDA graph): the
    recurrence, and the dW stage with its reduce."""
    xg, w, bias, dy = gru_inputs(torch, dev, None if c == 1 else c, b, t, n, seed=300 + c)
    h = K.gru_scan(xg, w, bias)
    dxg = torch.empty_like(xg)
    dw, db = torch.empty_like(w), torch.empty_like(bias)
    dgn, partial = K._scratch(h, c, b, t, n)
    calls = 20 if c > COHORT else 100
    return {
        "recur": graph_ms(torch, lambda: K._stage(
            "gru_bwd_recur", (c, b, t, n), (xg, w, bias, h, dy), (dxg, dgn)), calls=calls),
        "dw_and_reduce": graph_ms(torch, lambda: K._stage(
            "gru_bwd_dw", (c, b, t, n, K.slice_rows(n)), (h, dxg, dgn), (partial, dw, db)),
            calls=calls),
    }


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time on this card: bytes over 3.35 TB/s or float32 ops over
    67 TFLOP/s, whichever is larger, and which it was."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def graph_ms(torch, fn, calls: int = 100, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph (the
    kernels launch on PyTorch's current stream, which capture redirects),
    replayed ``replays`` times under CUDA events, so no host work sits
    between launches.  Warmed up on a side stream before capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


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
# phase 3, ssd_chunk_scan
# ---------------------------------------------------------------------------

SSD_CASES = (
    # name, B, NC, L, H, P, N
    ("slice", 8, 8, 256, 24, 64, 128),     # the serving slice's prefill call
    ("one-chunk", 1, 1, 256, 24, 64, 128),
    ("reduced", 2, 4, 16, 16, 32, 16),     # mamba2-130m .reduced()
    ("zamba2", 8, 8, 256, 112, 64, 64),    # zamba2-7b's prefill call (phase 24)
)
SSD_TIMED = ("slice", "zamba2")
SSD_RAGGED = (2, 300, 3, 64, 128, 256)     # B, S, H, P, N, chunk: through ssd_full


def ssd_inputs(torch, dev, shape, seed):
    """x, B, C standard normal; dt = softplus(normal); A = -0.02 exp(0.5 z)
    (-0.054 to -0.007 at two sigma), so a 256-step chunk decays by about
    e^-1..e^-10 and the carried state matters."""
    *lead, h, p = shape[:-1]
    n = shape[-1]
    g = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(*lead, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g) * 0.5) * 0.02
    x = torch.randn(*lead, h, p, generator=g)
    bm = torch.randn(*lead, n, generator=g)
    cm = torch.randn(*lead, n, generator=g)
    return [t.to(dev) for t in (x, dt, a, bm, cm)]


def scaled_err(got, ref) -> float:
    return max_err(got, ref) / max(1.0, float(ref.abs().max()))


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The leaves' paths, in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, item in enumerate(tree) for q in leaf_paths(item, f"{prefix}/{i}")]
    return [prefix]


def leaf_err(got, ref) -> float:
    """The error relative to the largest entry of ``ref`` itself (no floor at
    1, so a leaf of small gradients is held as tightly as one of large)."""
    top = float(ref.abs().max())
    return max_err(got, ref) / top if top > 0 else max_err(got, ref)


def check_ssd_kernel(torch, dev, SK) -> dict:
    from repro_torch.kernels.ssd.ops import ssd_full
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref, ssd_chunk_states_ref, ssd_ref

    worst = 0.0
    for i, (case, b, nc, l_len, h, p, n) in enumerate(SSD_CASES):
        x, dt, a, bm, cm = ssd_inputs(torch, dev, (b, nc, l_len, h, p, n), seed=200 + i)
        args = (x, dt, torch.cumsum(dt * a, dim=2), bm, cm)
        y = SK.ssd_chunk_scan(*args)
        y2, states = SK.ssd_chunk_scan(*args, return_states=True)
        y3, states3 = SK.ssd_chunk_scan(*args, return_states=True)
        torch.cuda.synchronize()
        y_ref, s_ref = ssd_chunk_scan_ref(*args), ssd_chunk_states_ref(*args)
        e = {"y": scaled_err(y, y_ref), "states": scaled_err(states, s_ref)}
        same = torch.equal(y, y2) and torch.equal(y2, y3) and torch.equal(states, states3)
        emit(phase="ssd_kernels", case=case, B=b, NC=nc, L=l_len, H=h, P=p, N=n,
             scaled_err=e, max_abs_err=max_err(y, y_ref), max_abs_ref=float(y_ref.abs().max()),
             bitwise_repeat=same)
        require(max(e.values()) <= SSD_TOL, f"ssd {case}: error {e}")
        require(same, f"ssd {case}: two runs differ")
        worst = max(worst, max_err(y, y_ref), max_err(states, s_ref))
        check_ssd_stages(torch, SK, case, forward_stages(SK, *args))

    # Ragged S with H=3 through ssd_full (padding in the wrapper), against the
    # step-by-step recurrence on the same card.
    b, s, h, p, n, chunk = SSD_RAGGED
    x, dt, a, bm, cm = ssd_inputs(torch, dev, (b, s, h, p, n), seed=210)
    y = ssd_full(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    y_ref = ssd_ref(x, dt, a, bm, cm)
    e = scaled_err(y, y_ref)
    emit(phase="ssd_kernels", case="ragged-ssd_full", B=b, S=s, H=h, P=p, N=n, chunk=chunk,
         scaled_err=e, max_abs_err=max_err(y, y_ref))
    require(e <= SSD_TOL, f"ssd ragged through ssd_full: error {e}")
    worst = max(worst, max_err(y, y_ref))

    # Times at the serving slice's shape (the kernels line) and at zamba2-7b's.
    timed = {case: ssd_timing(torch, dev, SK, case, shape, seed=220 + i) for i, (case, *shape)
             in enumerate(c for c in SSD_CASES if c[0] in SSD_TIMED)}
    ms, plain, t_bytes, t_tc = (timed["slice"][k] for k in
                                ("ssd_chunk_scan_ms", "plain_ms", "bound_bytes_ms", "bound_tc_ms"))
    return {
        "name": "ssd_chunk_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:87",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(t_bytes, t_tc),
        "bound_by": "bytes" if t_bytes >= t_tc else "operations",
        "library_ms": None,
    }


def ssd_timing(torch, dev, SK, case: str, shape, seed: int) -> dict:
    """The forward call's device time (with and without the entry states),
    each stage alone, the plain version's time and the bounds at one shape."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref

    b, nc, l_len, h, p, n = shape
    x, dt, a, bm, cm = ssd_inputs(torch, dev, shape, seed=seed)
    args = (x, dt, torch.cumsum(dt * a, dim=2), bm, cm)
    ms = time_ms(torch, lambda: SK.ssd_chunk_scan(*args), iters=20, warmup=3)
    ms_states = time_ms(torch, lambda: SK.ssd_chunk_scan(*args, return_states=True),
                        iters=20, warmup=3)
    plain = time_ms(torch, lambda: ssd_chunk_scan_ref(*args), iters=3, warmup=1)
    g = torch.empty((b, nc, l_len, l_len), device=dev)
    local = torch.empty((b, nc, h, p, n), device=dev)
    carry = torch.empty_like(local)
    dims = (b, nc, l_len, h, p, n)
    stages = stage_ms(torch, SK, {
        "cb": ("ssd_stage_cb", (b, nc, l_len, n), (bm, cm), (g,)),
        "local": ("ssd_stage_local", (*dims, 0), (x, dt, args[2], bm), (local,)),
        "pass": ("ssd_stage_pass", (*dims, 0), (carry, args[2]), ()),
        "y": ("ssd_stage_y", dims, (x, dt, args[2], cm, g, local), (torch.empty_like(x),)),
    })
    nbytes, ops, ops_full, mma = ssd_work(b, nc, l_len, h, p, n)
    row = dict(ssd_chunk_scan_ms=ms, with_states_ms=ms_states, plain_ms=plain, bytes=nbytes,
               flops_causal=ops, flops_full_block=ops_full, flops_tile_products=mma,
               bound_bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
               bound_ops_ms=ops / PEAK_F32_FLOPS * 1e3, bound_tc_ms=tensor_core_ms(ops, mma),
               achieved_tflops=ops / ms / 1e9, stage_ms=stages)
    emit(phase="ssd_timing", case=case,
         shape={"B": b, "NC": nc, "L": l_len, "H": h, "P": p, "N": n}, **row,
         library_ms=None, library_note="no single PyTorch call computes the chunk scan")
    return row


def forward_stages(SK, xc, dtc, cum, bc, cc) -> list[tuple]:
    """(name, stage kernel, plain stage, inputs, mask) for each stage of the
    forward, each fed the plain versions of the stages before it."""
    from repro_torch.kernels.ssd import ref

    local = ref.chunk_local_ref(xc, dtc, cum, bc)
    g, states = ref.chunk_cb_ref(bc, cc), ref.state_pass_ref(local, cum)
    return [
        ("cb", SK.stage_cb, ref.chunk_cb_ref, (bc, cc), "causal"),
        ("local", SK.stage_local, ref.chunk_local_ref, (xc, dtc, cum, bc), None),
        ("pass", SK.stage_pass, ref.state_pass_ref, (local, cum), None),
        ("y", SK.stage_y, ref.chunk_y_ref, (xc, dtc, cum, cc, g, states), None),
    ]


def backward_stages(SK, xc, dtc, cum, bc, cc, states, dy) -> list[tuple]:
    """The same for the backward's stages."""
    from repro_torch.kernels.ssd import ref

    carry = ref.chunk_carry_ref(dy, cum, cc)
    ds = ref.state_pass_ref(carry, cum, reverse=True)
    g, dg = ref.chunk_cb_ref(bc, cc), ref.bwd_dg_ref(xc, dtc, cum, dy)
    return [
        ("carry", SK.stage_carry, ref.chunk_carry_ref, (dy, cum, cc), None),
        ("pass_reverse", lambda f, c: SK.stage_pass(f, c, reverse=True),
         lambda f, c: ref.state_pass_ref(f, c, reverse=True), (carry, cum), None),
        ("head", SK.stage_head, ref.bwd_head_ref, (xc, dtc, cum, bc, cc, states, ds, g, dy), None),
        ("dg", SK.stage_dg, ref.bwd_dg_ref, (xc, dtc, cum, dy), None),
        ("dbc", SK.stage_dbc, ref.bwd_dbc_ref, (xc, dtc, cum, bc, cc, states, ds, dg, dy), None),
    ]


def check_ssd_stages(torch, SK, case: str, stages: list[tuple]) -> None:
    """Each stage kernel against its plain stage on the same inputs, within
    SSD_TOL, and two runs of it bit for bit.  A "causal" stage forms only the
    causal tiles of an L x L block, so only m <= l is compared."""
    def tup(out):
        return out if isinstance(out, tuple) else (out,)

    errs, same = {}, True
    for name, kernel_fn, plain_fn, args, mask in stages:
        got, again = tup(kernel_fn(*args)), tup(kernel_fn(*args))
        torch.cuda.synchronize()
        want = tup(plain_fn(*args))
        for i, (g, a, r) in enumerate(zip(got, again, want)):
            if mask == "causal":
                g, a, r = torch.tril(g), torch.tril(a), torch.tril(r)
            key = f"{name}.{i}" if len(want) > 1 else name
            errs[key] = scaled_err(g, r) if bool(torch.isfinite(g).all()) else math.inf
            same = same and torch.equal(g, a)
        del got, again, want
    emit(phase="ssd_stages", case=case, scaled_err=errs, bitwise_repeat=same)
    require(max(errs.values()) <= SSD_TOL, f"ssd stages {case}: error {errs}")
    require(same, f"ssd stages {case}: two runs differ")


SSD_BWD_CASES = (
    # name, B, NC, L, H, P, N
    ("train", 8, 8, 256, 24, 64, 128),     # the train slice's backward call
    ("one-chunk", 1, 1, 256, 24, 64, 128),
    ("reduced", 2, 4, 16, 16, 32, 16),     # mamba2-130m .reduced()
    ("nc3-h3", 2, 3, 256, 3, 64, 128),     # the last row's dcum term across three chunks
    ("zamba2", 8, 8, 256, 112, 64, 64),    # zamba2-7b's shape (its train step runs B=1)
)


def check_ssd_bwd_kernel(torch, dev, SK) -> dict:
    """``ssd_chunk_scan_bwd`` against ``ssd_chunk_scan_bwd_ref`` on the same
    inputs (the entry states from the forward kernel, dy standard normal),
    two runs compared bit for bit; then times at the train slice's shape."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan_bwd_ref

    names = ("dx", "ddt", "dcum", "db", "dc")
    worst = 0.0

    def bwd_inputs(shape, seed):
        x, dt, a, bm, cm = ssd_inputs(torch, dev, shape, seed)
        args = (x, dt, torch.cumsum(dt * a, dim=2), bm, cm)
        _, states = SK.ssd_chunk_scan(*args, return_states=True)
        g = torch.Generator().manual_seed(seed + 1)
        return (*args, states, torch.randn(tuple(x.shape), generator=g).to(dev))

    for i, (case, b, nc, l_len, h, p, n) in enumerate(SSD_BWD_CASES):
        args = bwd_inputs((b, nc, l_len, h, p, n), seed=230 + i)
        got = SK.ssd_chunk_scan_bwd(*args)
        again = SK.ssd_chunk_scan_bwd(*args)
        torch.cuda.synchronize()
        ref = ssd_chunk_scan_bwd_ref(*args)
        e = {k: scaled_err(g, r) for k, g, r in zip(names, got, ref)}
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        emit(phase="ssd_bwd_kernels", case=case, B=b, NC=nc, L=l_len, H=h, P=p, N=n,
             scaled_err=e, max_abs_err={k: max_err(g, r) for k, g, r in zip(names, got, ref)},
             max_abs_ref={k: float(r.abs().max()) for k, r in zip(names, ref)},
             bitwise_repeat=same)
        require(finite, f"ssd bwd {case}: non-finite cotangents")
        require(max(e.values()) <= SSD_TOL, f"ssd bwd {case}: error {e}")
        require(same, f"ssd bwd {case}: two runs differ")
        worst = max(worst, *(max_err(g, r) for g, r in zip(got, ref)))
        del got, again, ref
        check_ssd_stages(torch, SK, case, backward_stages(SK, *args))
        del args

    timed = {case: ssd_bwd_timing(torch, dev, SK, case, bwd_inputs(tuple(shape), seed=240 + i))
             for i, (case, *shape) in enumerate(c for c in SSD_BWD_CASES
                                                if c[0] in ("train", "zamba2"))}
    ms, plain, t_bytes, t_tc = (timed["train"][k] for k in
                                ("ssd_chunk_scan_bwd_ms", "plain_ms", "bound_bytes_ms",
                                 "bound_tc_ms"))
    return {
        "name": "ssd_chunk_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:212",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(t_bytes, t_tc),
        "bound_by": "bytes" if t_bytes >= t_tc else "operations",
        "library_ms": None,
    }


def ssd_bwd_timing(torch, dev, SK, case: str, args) -> dict:
    """The backward call's device time, each stage alone, the plain
    version's time and the bounds at one shape."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan_bwd_ref

    xc, dtc, cum, bc, cc, states, dy = args
    b, nc, l_len, h, p = xc.shape
    n = bc.shape[-1]
    ms = time_ms(torch, lambda: SK.ssd_chunk_scan_bwd(*args), iters=10, warmup=2)
    plain = time_ms(torch, lambda: ssd_chunk_scan_bwd_ref(*args), iters=2, warmup=1)
    g = torch.empty((b, nc, l_len, l_len), device=dev)
    ds = torch.empty((b, nc, h, p, n), device=dev)
    carry = torch.empty_like(ds)
    grads = [torch.empty_like(t) for t in (xc, dtc, cum, bc, cc)]
    dims = (b, nc, l_len, h, p, n)
    stages = stage_ms(torch, SK, {
        "cb": ("ssd_stage_cb", (b, nc, l_len, n), (bc, cc), (g,)),
        "carry": ("ssd_stage_local", (*dims, 1), (dy, cum, cum, cc), (ds,)),
        "pass_reverse": ("ssd_stage_pass", (*dims, 1), (carry, cum), ()),
        "head": ("ssd_stage_head", dims, (xc, dtc, cum, bc, cc, states, ds, g, dy), grads[:3]),
        "dg": ("ssd_stage_dg", (b, nc, l_len, h, p), (xc, dtc, cum, dy), (g,)),
        "dbc": ("ssd_stage_dbc", dims, (xc, dtc, cum, bc, cc, states, ds, g, dy), grads[3:]),
    })
    nbytes, ops, mma = ssd_bwd_work(b, nc, l_len, h, p, n)
    row = dict(ssd_chunk_scan_bwd_ms=ms, plain_ms=plain, bytes=nbytes, flops=ops,
               flops_tile_products=mma, bound_bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
               bound_ops_ms=ops / PEAK_F32_FLOPS * 1e3, bound_tc_ms=tensor_core_ms(ops, mma),
               achieved_tflops=ops / ms / 1e9, stage_ms=stages)
    emit(phase="ssd_bwd_timing", case=case,
         shape={"B": b, "NC": nc, "L": l_len, "H": h, "P": p, "N": n}, **row, library_ms=None,
         library_note="no single PyTorch call computes the chunk scan's backward")
    return row


def tensor_core_ms(ops: int, mma: int) -> float:
    """The least time for ``ops`` float ops of which ``mma`` are tile products
    run on the tensor cores in 3xTF32: those at 495/3 TFLOP/s, the rest at
    67 TFLOP/s on the CUDA cores."""
    return (mma / PEAK_3XTF32_FLOPS + (ops - mma) / PEAK_F32_FLOPS) * 1e3


def ssd_side(name: str) -> str | None:
    """Which SSD call a device kernel belongs to: "fwd", "bwd" or None.  The
    stages that both run are instantiated once per direction
    (``<false>`` forward, ``<true>`` backward)."""
    if "ssd_" not in name:
        return None
    if "ssd_bwd_" in name or "<true>" in name:
        return "bwd"
    return "fwd"


def stage_ms(torch, SK, stages: dict[str, tuple]) -> dict[str, float]:
    """Each stage's time alone: CUDA events over back-to-back launches of its
    C entry point (``kernel._stage``: name, sizes, inputs, outputs), outputs
    allocated once.  The local stage forms every chunk here; the composite
    call skips the one chunk whose state the carry does not read."""
    return {name: time_ms(torch, lambda: SK._stage(*spec), iters=20, warmup=2)
            for name, spec in stages.items()}


def ssd_bwd_work(b: int, nc: int, l_len: int, h: int, p: int, n: int) -> tuple[int, int, int]:
    """Bytes the backward must move, its float ops over the causal pairs, and
    how many of those are tile products (the kernels' tensor-core work).

    Bytes: x, dy, dt, cum, B, C and the entry states read once; dx, ddt,
    dcum, dB and dC written once.  Scratch that one implementation keeps
    (the kernels' G, dG and dS) is not the function's.
    Per (batch, chunk) and causal pair, shared by the heads: C B^T
    recomputed, and dC = dG B, dB = dG^T C from the head-summed dG (2N
    each).  Per head and pair: dW = dy x^T and dx = W^T dy (2P each) and ~10
    for the decay, the weights and the dt and cum sums.  Per head and row,
    four products of 2NP each: U = (e dy) S (dC's carried term), V = B dS^T
    (dx's state term), Z = x dS (dB's) and the update of dS; the y_inter term
    of dcum is C . U (2N) and g is x . V (2P); ~10 for the decays.  The
    tile products are the 2N and 2P per pair and the 2NP per row.
    """
    rows = b * nc * l_len
    bytes_ = 4 * (3 * rows * h * p + 4 * rows * h + 4 * rows * n + b * nc * h * p * n)
    pairs = l_len * (l_len + 1) // 2
    per_head = pairs * (4 * p + 10) + l_len * (8 * n * p + 2 * n + 2 * p + 10)
    mma_per_head = pairs * 4 * p + l_len * 8 * n * p
    return (bytes_, b * nc * (3 * 2 * n * pairs + h * per_head),
            b * nc * (3 * 2 * n * pairs + h * mma_per_head))


def ssd_work(b: int, nc: int, l_len: int, h: int, p: int, n: int) -> tuple[int, int, int, int]:
    """Bytes the call must move (float32 inputs read once, y written once),
    its float ops counting the causal pairs l >= m of each L x L block that
    the scan needs (and, beside it, the full L x L block), and how many of the
    causal count are tile products (C B^T, W x, C S and the state update:
    the kernels' tensor-core work).

    Per (batch, chunk): C B^T once, 2N per pair (shared by the heads).  Per
    head: the weights exp(cum_l - cum_m) dt_m G (a subtraction, an exp and
    two products: 4 per pair) and W x (2P per pair); the carried-state term
    C S and the state update (2NP per row each) and the per-row decays (4).
    """
    bytes_ = 4 * (2 * b * nc * l_len * h * p + 2 * b * nc * l_len * h + 2 * b * nc * l_len * n)

    def ops_for(pairs: int, tile_products_only: bool = False) -> int:
        per_head = pairs * 2 * p + l_len * 4 * n * p
        if not tile_products_only:
            per_head += pairs * 4 + l_len * 4
        return b * nc * (2 * n * pairs + h * per_head)

    causal = l_len * (l_len + 1) // 2
    return bytes_, ops_for(causal), ops_for(l_len * l_len), ops_for(causal, True)



# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def check_parity(torch) -> None:
    """A 4-client federation, 2 rounds: on the default (vectorized) engine at
    dropout 0, card against CPU; on the card at dropout 0.05, the vectorized
    engine against the sequential one and two chunks against one."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    clients = build_client_datasets(generate_cohort(CohortConfig().scaled(0.02), seed=1))
    params0 = init_gru(torch.Generator().manual_seed(1), GRUConfig(), "cpu")
    base = dict(rounds=2, local_epochs=1, recruitment="top-n-samples:4", selection="uniform",
                seed=1)

    def run(dropout, device, **kw):
        fed = Federation(FederationConfig(**base, **kw), clients,
                         make_loss_fn(GRUConfig(dropout=dropout)), AdamW(), device=device)
        return fed.run(params0)

    out = {device: run(0.0, device) for device in ("cuda", "cpu")}
    diff = param_diff(out["cuda"].params, out["cpu"].params)
    losses = {d: [r.mean_local_loss for r in out[d].history] for d in out}
    emit(phase="parity", engine=FederationConfig().engine, max_param_diff=diff, losses=losses,
         local_steps=out["cuda"].total_local_steps)
    require(diff <= PARITY_TOL, f"card and CPU federations differ by {diff}")

    runs = {
        "vectorized": run(0.05, "cuda"),
        "sequential": run(0.05, "cuda", engine="sequential"),
        "chunked": run(0.05, "cuda", cohort_chunk=2),
    }
    losses = {k: [r.mean_local_loss for r in v.history] for k, v in runs.items()}
    loss_diff = max(abs(a - b) for a, b in zip(losses["vectorized"], losses["sequential"]))
    engine_diff = param_diff(runs["vectorized"].params, runs["sequential"].params)
    chunk_diff = param_diff(runs["vectorized"].params, runs["chunked"].params)
    emit(phase="engine_parity", dropout=0.05, losses=losses, max_loss_diff=loss_diff,
         max_param_diff=engine_diff, chunked_max_param_diff=chunk_diff)
    require(loss_diff <= ENGINE_LOSS_TOL, f"engines' round losses differ by {loss_diff}")
    require(engine_diff <= PARITY_TOL, f"engines' params differ by {engine_diff}")
    require(chunk_diff <= CHUNK_TOL, f"chunked and unchunked params differ by {chunk_diff}")


def param_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves

    return max(max_err(x.cpu(), y.cpu()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def reset_gru_counts(K) -> None:
    K.gru_scan.launches = 0
    K.gru_scan_bwd.launches = 0


def gru_counts(K) -> dict[str, int]:
    return {"gru_scan": K.gru_scan.launches, "gru_scan_bwd": K.gru_scan_bwd.launches}


def schedule_steps(records, sizes: dict[int, int], batch: int, epochs: int) -> int:
    """The batched steps a one-chunk vectorized run takes, from its rounds'
    participants alone: a step runs where any client has a real batch, so a
    round takes ``epochs × max ceil(n_c / B)`` over its participants."""
    return sum(epochs * max(-(-sizes[c] // batch) for c in r.participant_ids) for r in records)


def check_launches(what: str, got: dict[str, int], steps: int, predict_batches: int) -> None:
    """Two GRU layers: two forward launches per step and per predict batch,
    two backward launches per step."""
    want = {"gru_scan": 2 * steps + 2 * predict_batches, "gru_scan_bwd": 2 * steps}
    require(got == want, f"{what} launches {got}, expected {want}")


def run_slice(torch, K) -> tuple[dict[str, int], object]:
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
    clients = build_client_datasets(cohort)
    sizes = {c.client_id: c.n_train for c in clients}

    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    outs = {}
    for engine in ("vectorized", "sequential"):
        fed_exp = ExperimentConfig(rounds=3, local_epochs=4, engine=engine)
        records = []
        reset_gru_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed = run_setting("federated-src", fed_exp, cohort, seed=0, progress=records.append)
        fed_s = time.perf_counter() - t0
        counts = gru_counts(K)
        for r in records:
            emit(phase="round", engine=engine, round=r.round_index,
                 participants=len(r.participant_ids), mean_local_loss=r.mean_local_loss,
                 local_steps=r.local_steps, round_time_s=r.round_time_s)
        round_s = sum(r.round_time_s for r in records)
        steps = fed["cohort_steps"] if engine == "vectorized" else fed["local_steps"]
        emit(phase="federated-src", engine=engine, recruited=fed["recruited"],
             federation_size=fed["federation_size"], local_steps=fed["local_steps"],
             cohort_steps=fed["cohort_steps"], round_times_s=fed["round_times_s"],
             local_steps_per_s=fed["local_steps"] / round_s, seconds=fed_s,
             metrics=fed["metrics"], launches=counts)
        require(all(math.isfinite(v) for v in fed["metrics"].values()),
                f"federated-src ({engine}): metrics not finite: {fed['metrics']}")
        require(all(math.isfinite(r.mean_local_loss) for r in records),
                "a round loss is not finite")
        if engine == "vectorized":
            want = schedule_steps(records, sizes, fed_exp.batch_size, fed_exp.local_epochs)
            require(fed["cohort_steps"] == want,
                    f"batched steps {fed['cohort_steps']}, the schedules give {want}")
        check_launches(f"federated-src ({engine})", counts, steps, predict_batches)
        total = {k: total[k] + counts[k] for k in total}
        outs[engine] = fed

    require(outs["vectorized"]["local_steps"] == outs["sequential"]["local_steps"],
            "the engines count different local steps")
    fed_exp = ExperimentConfig(rounds=3, local_epochs=4)
    federation = Federation(
        FederationConfig(**policies_for("federated-src", fed_exp), seed=0),
        clients, make_loss_fn(GRUConfig()), AdamW(), device="cuda",
    )
    ids, _ = federation.build_federation()
    require(all(o["federation_ids"] == ids.tolist() for o in outs.values()),
            "recruited set differs from build_federation")

    central_exp = ExperimentConfig(central_epochs=1)
    reset_gru_counts(K)
    t0 = time.perf_counter()
    central = run_setting("central", central_exp, cohort, seed=0)
    central_s = time.perf_counter() - t0
    counts = gru_counts(K)
    emit(phase="central", local_steps=central["local_steps"],
         local_steps_per_s=central["local_steps"] / central["tau_s"], seconds=central_s,
         metrics=central["metrics"], launches=counts)
    require(all(math.isfinite(v) for v in central["metrics"].values()),
            f"central: metrics not finite: {central['metrics']}")
    check_launches("central", counts, central["local_steps"], predict_batches)
    total = {k: total[k] + counts[k] for k in total}
    return total, cohort


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------


def device_times(prof) -> tuple[dict[str, float], int]:
    """Summed device time (us) of each GPU kernel name in a profile, and the
    number of kernels the device ran."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    count = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            count += 1
    return by_name, count


def profile_local_training(torch, cohort) -> None:
    """One client's local round (the largest hospital, 4 epochs, batch 128)
    under torch.profiler: wall time, summed device time of every GPU kernel,
    the device's idle share, and the kernels that take the most device time."""
    import numpy as np
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
    by_name, count = device_times(prof)
    device_s = sum(by_name.values()) / 1e6
    steps = trainer.steps_per_round(client)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    gru_us = {side: sum(us for name, us in by_name.items() if gru_side(name) == side)
              for side in ("fwd", "bwd")}
    emit(phase="profile", client=client.client_id, n_train=client.n_train, local_steps=steps,
         wall_s=wall_s, step_ms=wall_s / steps * 1e3,
         device_busy_s=device_s if device_s > 0 else None,
         device_idle_share=1.0 - device_s / wall_s if device_s > 0 else None,
         kernels_launched=count,
         gru_scan_us=gru_us["fwd"], gru_scan_bwd_us=gru_us["bwd"],
         gru_scan_share_of_device=gru_us["fwd"] / (device_s * 1e6) if device_s > 0 else None,
         gru_scan_bwd_share_of_device=gru_us["bwd"] / (device_s * 1e6) if device_s > 0 else None,
         top_device_us={name[:80]: us for name, us in top})


def gru_side(name: str) -> str | None:
    """Which GRU call a device kernel belongs to: "fwd" (gru_scan), "bwd"
    (gru_scan_bwd: its recurrence, dW and reduce kernels) or None."""
    if "gru_scan_fwd_kernel" in name:
        return "fwd"
    if "gru_bwd_" in name or "gru_scan_bwd_" in name:
        return "bwd"
    return None


# ---------------------------------------------------------------------------
# phases 7-9: the Mamba2 serving path
# ---------------------------------------------------------------------------


def prompt_tokens(torch, vocab: int, b: int, s: int, seed: int):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, (b, s)))


def decode_prompt(serve, params, model, toks, device):
    """Feed ``toks`` (B, S) through the decode path; returns (last logits, cache)."""
    cache = model.init_cache(toks.shape[0], toks.shape[1], device)
    logits = None
    for t in range(toks.shape[1]):
        logits, cache = serve(params, toks[:, t : t + 1], cache, t)
    return logits, cache


def check_mamba2_parity(torch) -> None:
    """mamba2-130m at full width in float32: the card against the CPU (hidden
    states and prefill logits), and on the card the prefill logits against
    the decode path's after the same prompt (the property of
    tests/test_decode.py)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.zoo import Model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32")
    model = Model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda t: t.to("cuda"), params_cpu)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    failures = []
    for s in PARITY_PROMPTS:
        toks = prompt_tokens(torch, cfg.vocab_size, 2, s, seed=s)
        toks_card = toks.cuda()
        t0 = time.perf_counter()
        with torch.inference_mode():
            h_card = model.hidden(params, {"tokens": toks_card})[0].cpu()
            h_cpu = model.hidden(params_cpu, {"tokens": toks})[0]
        lg_card = prefill(params, {"tokens": toks_card})
        lg_cpu = prefill(params_cpu, {"tokens": toks})
        lg_dec, _ = decode_prompt(serve, params, model, toks_card, "cuda")
        torch.cuda.synchronize()
        e = {"hidden": scaled_err(h_card, h_cpu), "logits": scaled_err(lg_card.cpu(), lg_cpu)}
        dec_gap = (lg_dec - lg_card).abs()
        dec_ok = bool((dec_gap <= DECODE_ATOL + DECODE_RTOL * lg_card.abs()).all())
        finite = all(bool(torch.isfinite(t).all()) for t in (h_card, lg_card, lg_dec))
        emit(phase="mamba2_parity", B=2, S=s, dtype="float32", card_vs_cpu_scaled_err=e,
             decode_vs_prefill_max_abs=float(dec_gap.max()), decode_within_tol=dec_ok,
             max_abs_logit=float(lg_cpu.abs().max()), seconds=time.perf_counter() - t0)
        if not finite:
            failures.append(f"S={s}: non-finite outputs")
        if max(e.values()) > MAMBA_TOL:
            failures.append(f"S={s}: card against CPU {e}")
        if not dec_ok:
            failures.append(f"S={s}: decode against prefill {float(dec_gap.max())}")
    require(not failures, "; ".join(failures))


def run_serve_slice(torch, SK):
    """The published mamba2-130m (bfloat16, random weights from seed 0):
    prefill steps at B=8 on a 2,048-token prompt and one on its first
    SERVE_FEED tokens, then those tokens and 64 greedy ones through the
    decode path (the state does not grow, so a step costs the same at any
    position).  The SSD launch count is set to 0 just before and read just
    after."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.zoo import Model

    cfg = get_config("mamba2-130m")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    b, s, gen = SERVE_B, SERVE_PROMPT, SERVE_GEN
    toks = prompt_tokens(torch, cfg.vocab_size, b, s, seed=0).cuda()
    batch = {"tokens": toks}
    prefill, serve = make_prefill_step(model), make_serve_step(model)

    SK.ssd_chunk_scan.launches = 0
    call_s = []
    for _ in range(4):  # the first call is the cold one
        before = SK.ssd_chunk_scan.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        per_call = SK.ssd_chunk_scan.launches - before
        require(per_call == cfg.num_layers,
                f"a prefill call launched ssd_chunk_scan {per_call} times, not {cfg.num_layers}")
    feed = toks[:, :SERVE_FEED]
    short = prefill(params, {"tokens": feed})
    prefill_launches = SK.ssd_chunk_scan.launches
    warm_s = sum(call_s[1:]) / len(call_s[1:])

    t0 = time.perf_counter()
    lg, cache = decode_prompt(serve, params, model, feed, "cuda")
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    gap = float((lg - short).abs().max())
    finite = [bool(torch.isfinite(t).all()) for t in (logits, short, lg)]
    tok = torch.argmax(lg, dim=-1)[:, None]
    generated = []
    t0 = time.perf_counter()
    for k in range(gen):
        lg, cache = serve(params, tok, cache, SERVE_FEED + k)
        tok = torch.argmax(lg, dim=-1)[:, None]
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    finite.append(bool(torch.isfinite(lg).all()))
    decode_launches = SK.ssd_chunk_scan.launches - prefill_launches
    emit(phase="serve_slice", arch=cfg.name, dtype=cfg.dtype, B=b, prompt=s, gen=gen,
         feed=SERVE_FEED, prefill_call_s=call_s, prefill_tokens_per_s=b * s / warm_s,
         prefill_cold_tokens_per_s=b * s / call_s[0],
         decode_feed_tokens_per_s=b * SERVE_FEED / feed_s, decode_tokens_per_s=b * gen / decode_s,
         decode_step_ms=decode_s / gen * 1e3,
         ssd_launches={"prefill": prefill_launches, "decode": decode_launches},
         bf16_prefill_vs_decode_max_abs=gap, max_abs_logit=float(logits.abs().max()),
         sample=torch.cat(generated, dim=1)[0, :16].tolist(),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(all(finite), f"serve slice outputs not finite: {finite}")
    require(decode_launches == 0, f"the decode path launched ssd_chunk_scan {decode_launches} times")
    step = lambda: serve(params, tok, cache, SERVE_FEED + gen)  # one more decode step
    return {"ssd_chunk_scan": prefill_launches}, (lambda: prefill(params, batch), step)


def profile_serving(torch, prefill, decode_step) -> None:
    """One prefill call, then one decode step, of the serving slice under
    torch.profiler: wall time, device busy time and idle share, kernels."""
    from torch.profiler import ProfilerActivity, profile

    for what, fn in (("prefill", prefill), ("decode_step", decode_step)):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        by_name, count = device_times(prof)
        device_s = sum(by_name.values()) / 1e6
        ssd_us = sum(us for name, us in by_name.items() if ssd_side(name))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        emit(phase="serve_profile", call=what, B=SERVE_B, prompt=SERVE_PROMPT,
             wall_s=wall_s, device_busy_s=device_s if device_s > 0 else None,
             device_idle_share=1.0 - device_s / wall_s if device_s > 0 else None,
             ssd_share_of_device=ssd_us / 1e6 / device_s if device_s > 0 else None,
             kernels_launched=count, top_device_us={name[:80]: us for name, us in top})


# ---------------------------------------------------------------------------
# phases 10-12: the Mamba2 training path
# ---------------------------------------------------------------------------


def lm_batch(torch, vocab: int, b: int, s: int, seed: int) -> dict:
    import numpy as np

    from repro_torch.data.pipeline import lm_token_batch

    return {k: torch.from_numpy(v) for k, v in
            lm_token_batch(np.random.default_rng(seed), b, s, vocab).items()}


def loss_and_grads(torch, model, params, batch):
    """The loss and the gradient of every param leaf (leaf order)."""
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return loss.detach(), grads


def check_mamba2_train_parity(torch) -> None:
    """mamba2-130m at full width in float32: the loss, every gradient leaf and
    the params after one ``make_train_step`` on the card against the CPU; on
    the card, the loss and gradients with remat on against remat off.

    Every gradient leaf is held to MAMBA_TOL times max(1, max|ref|) and, more
    tightly where its entries are small, to MAMBA_TOL times its own max|ref|
    (``leaf_err``).  A_log and dt_bias are held to DECAY_GRAD_TOL times their
    own max|ref|: each of their entries is one sum, over every row of the
    batch, of the cotangent of the decay dt A, whose terms cancel to a small
    result; there two float32 summation orders differ most (the port against
    JAX on the CPU shows its largest leaf gap there too).

    Params after the step are held to PARITY_TOL where the CPU gradient is at
    least 1e-6.  Below that AdamW's first step lr g / (|g| + eps) turns a
    rounding difference of the gradient into a visible fraction of lr (the
    drift tests/test_torch_mamba2_train.py documents), so those entries are
    held to 2 lr + PARITY_TOL, the swing of a sign flip."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.zoo import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32")
    params_cpu = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(TRAIN_LR)
    failures = []
    for s in PARITY_PROMPTS:
        t0 = time.perf_counter()
        batch = lm_batch(torch, cfg.vocab_size, 2, s, seed=s)
        batch_card = {k: v.cuda() for k, v in batch.items()}
        model = Model(cfg, remat=False)
        on_card = lambda: tree_map(lambda t: t.to("cuda"), params_cpu)
        loss_cpu, g_cpu = loss_and_grads(torch, model, params_cpu, batch)
        loss_card, g_card = loss_and_grads(torch, model, on_card(), batch_card)
        loss_remat, g_remat = loss_and_grads(torch, Model(cfg, remat=True), on_card(),
                                             batch_card)
        cpu_params = tree_map(torch.clone, params_cpu)  # the step updates params in place
        cpu_params, _, _ = make_train_step(model, opt)(cpu_params, opt.init(cpu_params), batch)
        card_params = on_card()
        card_params, _, _ = make_train_step(model, opt)(card_params, opt.init(card_params),
                                                        batch_card)
        torch.cuda.synchronize()
        grad_err = max(scaled_err(g.cpu(), r) for g, r in zip(g_card, g_cpu))
        by_leaf = sorted(((leaf_err(g.cpu(), r), q) for q, g, r in
                          zip(leaf_paths(params_cpu), g_card, g_cpu)), reverse=True)
        decay = [(e, q) for e, q in by_leaf if q.endswith(DECAY_LEAVES)]
        other = [(e, q) for e, q in by_leaf if not q.endswith(DECAY_LEAVES)]
        remat_err = max(leaf_err(g, r) for g, r in zip(g_remat, g_card))
        small = sum(int((g.abs() < 1e-6).sum()) for g in g_cpu)
        total = sum(g.numel() for g in g_cpu)
        settled, unsettled, apart = 0.0, 0.0, 0
        for a, r, g in zip(tree_leaves(card_params), tree_leaves(cpu_params), g_cpu):
            gap = (a.cpu() - r).abs()
            big = g.abs() >= 1e-6
            if bool(big.any()):
                settled = max(settled, float(gap[big].max()))
            if not bool(big.all()):
                unsettled = max(unsettled, float(gap[~big].max()))
                apart += int((gap[~big] > PARITY_TOL).sum())
        loss_err = scaled_err(loss_card.cpu(), loss_cpu)
        remat_loss_err = scaled_err(loss_remat, loss_card)
        finite = all(bool(torch.isfinite(t).all()) for t in (*g_card, loss_card))
        emit(phase="mamba2_train_parity", B=2, S=s, dtype="float32", loss_cpu=float(loss_cpu),
             loss_card=float(loss_card), loss_scaled_err=loss_err, grad_scaled_err=grad_err,
             grad_leaf_err_worst=other[:4], grad_leaf_err_decay=decay,
             grad_entries=total, grad_entries_below_1e6=small, grad_share_below_1e6=small / total,
             params_max_abs_settled=settled, params_max_abs_below_1e6=unsettled,
             params_below_1e6_apart_over_tol=apart,
             remat_loss_scaled_err=remat_loss_err, remat_grad_leaf_err=remat_err,
             seconds=time.perf_counter() - t0)
        if not finite:
            failures.append(f"S={s}: non-finite loss or gradients")
        if max(loss_err, grad_err, other[0][0]) > MAMBA_TOL or decay[0][0] > DECAY_GRAD_TOL:
            failures.append(f"S={s}: card against CPU loss {loss_err}, grads {grad_err}, "
                            f"by leaf {other[0]}, {decay[0]}")
        if settled > PARITY_TOL or unsettled > 2 * TRAIN_LR + PARITY_TOL:
            failures.append(f"S={s}: params after the step {settled}, {unsettled}")
        if max(remat_loss_err, remat_err) > MAMBA_TOL:
            failures.append(f"S={s}: remat on against off {remat_loss_err}, {remat_err}")
    require(not failures, "; ".join(failures))


def run_train_slice(torch, SK):
    """The published mamba2-130m (bfloat16, random weights from seed 0)
    trained with AdamW(1e-3) at B=8 x 2,048 tokens on one fixed batch:
    TRAIN_WARMUP steps, then TRAIN_STEPS timed ones, each with exactly one
    forward (with entry states) and one backward SSD launch a layer; the
    counts are set to 0 just before the timed steps and read just after.
    Then one more step with remat on: two forward launches a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.zoo import Model
    from repro_torch.optim.adamw import AdamW

    cfg = get_config("mamba2-130m")
    layers = cfg.num_layers
    model = Model(cfg, remat=False)
    opt = AdamW(TRAIN_LR)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    opt_state = opt.init(params)
    batch = {k: v.cuda() for k, v in
             lm_batch(torch, cfg.vocab_size, TRAIN_B, TRAIN_SEQ, seed=0).items()}
    step = make_train_step(model, opt)
    for _ in range(TRAIN_WARMUP):
        params, opt_state, _ = step(params, opt_state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    SK.ssd_chunk_scan.launches = 0
    SK.ssd_chunk_scan_bwd.launches = 0
    step_s, losses, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = (SK.ssd_chunk_scan.launches, SK.ssd_chunk_scan_bwd.launches)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        per_step.append((SK.ssd_chunk_scan.launches - before[0],
                         SK.ssd_chunk_scan_bwd.launches - before[1]))
    counts = {"ssd_chunk_scan": SK.ssd_chunk_scan.launches,
              "ssd_chunk_scan_bwd": SK.ssd_chunk_scan_bwd.launches}
    peak = torch.cuda.max_memory_allocated()

    remat_step = make_train_step(Model(cfg, remat=True), opt)
    before = (SK.ssd_chunk_scan.launches, SK.ssd_chunk_scan_bwd.launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, metrics = remat_step(params, opt_state, batch)
    remat_loss = float(metrics["loss"])
    remat_s = time.perf_counter() - t0
    remat_counts = (SK.ssd_chunk_scan.launches - before[0],
                    SK.ssd_chunk_scan_bwd.launches - before[1])
    tokens = TRAIN_B * TRAIN_SEQ
    mean_s = sum(step_s) / len(step_s)
    emit(phase="train_slice", arch=cfg.name, dtype=cfg.dtype, B=TRAIN_B, seq=TRAIN_SEQ,
         lr=TRAIN_LR, step_s=step_s, step_ms=mean_s * 1e3, tokens_per_s=tokens / mean_s,
         losses=losses, peak_mem_gb=peak / 1e9, ssd_launches_per_step=per_step,
         remat_step_s=remat_s, remat_loss=remat_loss, remat_ssd_launches=remat_counts,
         remat_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(all(math.isfinite(v) for v in (*losses, remat_loss)), f"train losses {losses}")
    require(losses[-1] < losses[0], f"the train loss does not fall: {losses}")
    require(all(c == (layers, layers) for c in per_step),
            f"SSD launches a step {per_step}, expected {(layers, layers)}")
    require(remat_counts == (2 * layers, layers),
            f"SSD launches of a remat step {remat_counts}, expected {(2 * layers, layers)}")
    return counts, lambda: step(params, opt_state, batch)


def profile_training(torch, train_step) -> None:
    """One train step of the train slice under torch.profiler: wall time,
    device busy time and idle share, kernels, and the SSD kernels' shares."""
    from torch.profiler import ProfilerActivity, profile

    train_step()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name, count = device_times(prof)
    device_s = sum(by_name.values()) / 1e6
    fwd_us = sum(us for name, us in by_name.items() if ssd_side(name) == "fwd")
    bwd_us = sum(us for name, us in by_name.items() if ssd_side(name) == "bwd")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    share = (lambda us: us / 1e6 / device_s) if device_s > 0 else (lambda us: None)
    emit(phase="train_profile", B=TRAIN_B, seq=TRAIN_SEQ, wall_s=wall_s,
         device_busy_s=device_s if device_s > 0 else None,
         device_idle_share=1.0 - device_s / wall_s if device_s > 0 else None,
         ssd_fwd_share_of_device=share(fwd_us), ssd_bwd_share_of_device=share(bwd_us),
         ssd_fwd_us=fwd_us, ssd_bwd_us=bwd_us,
         kernels_launched=count, top_device_us={name[:80]: us for name, us in top})


# ---------------------------------------------------------------------------
# phases 13-15: the vectorized cohort engine at full width and at 189 clients
# ---------------------------------------------------------------------------


def arc_federation(torch, cohort, exp, tracer=None, **config):
    """federated-arc on the full cohort at full width: the paper's model and
    optimizer, every recruited client in every round, seed 0; ``tracer``
    records its spans."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.experiments.paper import policies_for
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    config = {**policies_for("federated-arc", exp), **config}
    return Federation(
        FederationConfig(rounds=exp.rounds, local_epochs=exp.local_epochs,
                         batch_size=exp.batch_size, seed=0, **config),
        build_client_datasets(cohort), make_loss_fn(GRUConfig()),
        AdamW(exp.learning_rate, weight_decay=exp.weight_decay), device="cuda", tracer=tracer,
    )


def run_federation(torch, K, fed):
    """``fed.run`` from the seed-0 init with the GRU counts set to 0 just
    before: the result, each round's cohort stats (None on the per-client
    trainer) and the launches."""
    from repro_torch.models.gru import GRUConfig, init_gru

    stats = []

    def on_round(record):
        if fed.effective_engine == "vectorized":
            stats.append(dict(fed.cohort_trainer.last_round_stats))

    params0 = init_gru(torch.Generator().manual_seed(0), GRUConfig(), "cuda")
    torch.cuda.synchronize()
    reset_gru_counts(K)
    result = fed.run(params0, progress=on_round)
    return result, stats or None, gru_counts(K)


def cohort_fields(fed, result, stats) -> dict:
    """What a cohort phase prints of a federated-arc run."""
    rounds = result.history
    dc = fed.cohort_trainer.device_cohort
    field = (lambda key: [st[key] for st in stats]) if stats else (lambda key: None)
    return dict(
        federation_size=int(result.federation_ids.size),
        participants=[len(r.participant_ids) for r in rounds],
        round_times_s=[r.round_time_s for r in rounds],
        local_steps=result.total_local_steps,
        client_steps_per_s=result.total_local_steps / sum(r.round_time_s for r in rounds),
        mean_local_loss=[r.mean_local_loss for r in rounds],
        attach_seconds=dc.attach_seconds if dc is not None else None,
        **{key: field(key) for key in (
            "staging", "chunks", "cohort_steps", "bytes_staged", "stage_seconds",
            "bytes_resident", "peak_device_bytes", "plans_prefetched", "slice_chunks")},
    )


def run_cohort_slice(torch, K, cohort) -> dict[str, int]:
    """federated-arc on the full cohort, 2 rounds x 4 local epochs, every
    recruited client in every round, one chunk, on three paths from the same
    init: resident staging (the default), rebuild staging and the sequential
    engine; each with its launches counted from 0 over its run and its
    predictions."""
    from repro_torch.data.pipeline import build_client_datasets, global_dataset
    from repro_torch.data.synth_eicu import Cohort
    from repro_torch.experiments.paper import ExperimentConfig, _predict
    from repro_torch.metrics.regression import evaluate_predictions
    from repro_torch.models.gru import GRUConfig

    exp = ExperimentConfig(rounds=2, local_epochs=4)
    sizes = {c.client_id: c.n_train for c in build_client_datasets(cohort)}
    test = global_dataset(cohort, Cohort.TEST)
    predict_batches = math.ceil(len(test) / 2048)
    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    outs = {}
    paths = {"resident": {}, "rebuild": {"staging": "rebuild"},
             "sequential": {"engine": "sequential"}}
    for path, config in paths.items():
        fed = arc_federation(torch, cohort, exp, **config)
        result, stats, _ = run_federation(torch, K, fed)
        metrics = evaluate_predictions(test.y, _predict(result.params, GRUConfig(), test))
        counts = gru_counts(K)
        rounds = result.history
        steps = sum(st["cohort_steps"] for st in stats) if stats else result.total_local_steps
        emit(phase="cohort_slice", setting="federated-arc", path=path,
             engine=fed.effective_engine, **cohort_fields(fed, result, stats),
             metrics=metrics, launches=counts)
        require(all(math.isfinite(v) for v in metrics.values()),
                f"federated-arc ({path}): metrics not finite: {metrics}")
        require(all(len(r.participant_ids) == result.federation_ids.size for r in rounds),
                "federated-arc: not every recruited client participated")
        if stats:
            want = schedule_steps(rounds, sizes, exp.batch_size, exp.local_epochs)
            require(steps == want, f"federated-arc batched steps {steps}, the schedules give {want}")
            require(all(st["staging"] == path for st in stats), f"{path}: staged {stats}")
        if path == "resident":
            staged = [st["bytes_staged"] for st in stats]
            require(max(staged) < MAX_RESIDENT_STAGED,
                    f"a resident arc round staged {staged} bytes")
        check_launches(f"federated-arc ({path})", counts, steps, predict_batches)
        total = {k: total[k] + counts[k] for k in total}
        outs[path] = (result, metrics)
        del fed, result
        torch.cuda.empty_cache()

    msle = {k: m["msle"] for k, (_, m) in outs.items()}
    staging_diff = param_diff(outs["resident"][0].params, outs["rebuild"][0].params)
    engine_diff = param_diff(outs["resident"][0].params, outs["sequential"][0].params)
    emit(phase="cohort_slice_parity", msle=msle, resident_rebuild_max_param_diff=staging_diff,
         max_param_diff=engine_diff,
         local_steps={k: r.total_local_steps for k, (r, _) in outs.items()})
    require(staging_diff == 0.0,
            f"federated-arc: resident and rebuild params differ by {staging_diff}")
    require(abs(msle["resident"] - msle["sequential"]) <= ARC_MSLE_TOL,
            f"federated-arc: the engines' test MSLE differ: {msle}")
    return total


def run_paper_scale_phase(torch, K) -> dict[str, int]:
    """``run_paper_scale`` on the card: 189 clients of ~23 stays, the five
    settings on both engines, and the donation probe."""
    from repro_torch.experiments.paper import run_paper_scale

    reset_gru_counts(K)
    t0 = time.perf_counter()
    # Cut to 2 rounds (from 3) to keep the script inside its time limit; the
    # steady-state round time is then round 1's.
    out = run_paper_scale(rounds=2, local_epochs=1, batch_size=4, verbose=False, device="cuda")
    seconds = time.perf_counter() - t0
    counts = gru_counts(K)
    rows = {}
    for setting, row in out["settings"].items():
        rows[setting] = {k: ({"round_time_s": v["round_time_s"], "time_unit": v["time_unit"],
                              "tau_s": v["tau_s"], "msle": v["metrics"]["msle"],
                              "local_steps": v["local_steps"]} if isinstance(v, dict) else v)
                         for k, v in row.items()}
        for v in row.values():
            if isinstance(v, dict):
                require(all(math.isfinite(m) for m in v["metrics"].values()),
                        f"paper scale {setting}: metrics not finite: {v['metrics']}")
    memory = {k: (v if not isinstance(v, dict) else
                  {"chunks": v["chunks"], "peak_device_bytes": v["peak_device_bytes"],
                   "bytes_staged": v["bytes_staged"]})
              for k, v in out["memory"].items()}
    emit(phase="paper_scale", num_clients=out["num_clients"], rounds=out["rounds"],
         local_epochs=out["local_epochs"], batch_size=out["batch_size"], seconds=seconds,
         settings=rows, memory=memory, launches=counts)
    require(out["num_clients"] == 189, f"paper scale has {out['num_clients']} clients")
    require(counts["gru_scan"] > 0 and counts["gru_scan_bwd"] > 0,
            f"paper scale launched {counts}")
    return counts


def profile_cohort_round(torch, cohort, staging: str, phase: str = "cohort_profile",
                         **config) -> None:
    """One vectorized federated-arc round (35 clients, 4 local epochs, one
    chunk) with ``staging`` under torch.profiler, after one unprofiled round
    (which attaches the resident cohort): wall time, device busy time and
    idle share, kernels a batched step, copy time, the GRU kernels' shares.
    ``config`` goes to the ``FederationConfig`` (phase 19: DP, one epoch)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import build_client_datasets, cohort_steps_per_epoch
    from repro_torch.experiments.paper import ExperimentConfig, policies_for
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.federated.cohort import client_generators
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    cfg = GRUConfig()
    exp = ExperimentConfig()
    clients = build_client_datasets(cohort)
    fed = Federation(FederationConfig(**policies_for("federated-arc", exp), seed=0,
                                      staging=staging, **config),
                     clients, make_loss_fn(cfg), AdamW(), device="cuda")
    ids, _ = fed.build_federation()
    arc = [fed.all_clients[int(i)] for i in ids]
    spe = cohort_steps_per_epoch([c.n_train for c in arc], exp.batch_size)
    trainer = fed.cohort_trainer
    params = init_gru(torch.Generator().manual_seed(0), cfg, "cuda")

    def round_(seed):
        gens = client_generators(np.random.default_rng([seed, 2]), len(arc), torch.device("cuda"))
        return trainer.train_cohort(params, arc, np.random.default_rng(seed), gens,
                                    steps_per_epoch=spe)

    round_(0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_(1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    stats = trainer.last_round_stats
    by_name, count = device_times(prof)
    copies = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and e.name.startswith(("Memcpy", "Memset")))
    device_s = sum(by_name.values()) / 1e6
    copy_s = sum(us for name, us in by_name.items() if name.startswith("Memcpy")) / 1e6
    kernel_s = device_s - copy_s
    gru_us = {side: sum(us for name, us in by_name.items() if gru_side(name) == side)
              for side in ("fwd", "bwd")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    share = (lambda us: us / 1e6 / device_s) if device_s > 0 else (lambda us: None)
    kernel_share = (lambda us: us / 1e6 / kernel_s) if kernel_s > 0 else (lambda us: None)
    steps = stats["cohort_steps"]
    emit(phase=phase, setting="federated-arc", staging=staging, clients=len(arc),
         device_copy_s=copy_s, device_kernel_s=kernel_s,
         gru_scan_share_of_kernels=kernel_share(gru_us["fwd"]),
         gru_scan_bwd_share_of_kernels=kernel_share(gru_us["bwd"]),
         cohort_steps=steps, bytes_staged=stats["bytes_staged"],
         bytes_resident=stats["bytes_resident"], stage_seconds=stats["stage_seconds"],
         peak_device_bytes=stats["peak_device_bytes"], wall_s=wall_s,
         step_ms=wall_s / steps * 1e3,
         device_busy_s=device_s if device_s > 0 else None,
         device_idle_share=1.0 - device_s / wall_s if device_s > 0 else None,
         kernels_launched=count, device_ops_per_step=count / steps,
         kernels_per_step=(count - copies) / steps, copies=copies,
         gru_scan_us=gru_us["fwd"], gru_scan_bwd_us=gru_us["bwd"],
         gru_scan_share_of_device=share(gru_us["fwd"]),
         gru_scan_bwd_share_of_device=share(gru_us["bwd"]),
         top_device_us={name[:80]: us for name, us in top})
    del fed, trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 16-18: chunks and prefetch, the grouped and stacked aggregators, the
# staging comparison
# ---------------------------------------------------------------------------


def run_chunk_and_aggregator_phase(torch, K, cohort) -> dict[str, int]:
    """One federated-arc round at full width from one init: unchunked,
    chunks of 12 with prefetch on and off, chunks of 17 (17, 17 and 1
    client), and ``hierarchical:4`` (four engine rounds); then
    federated-src with ``trimmed-mean:0.1`` (the per-client trainer)."""
    from repro_torch.data.pipeline import global_dataset
    from repro_torch.data.synth_eicu import Cohort
    from repro_torch.experiments.paper import ExperimentConfig, run_setting

    exp = ExperimentConfig(rounds=1, local_epochs=4)
    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    runs = {}
    variants = {
        "whole": {},
        "chunk12": {"cohort_chunk": 12},
        "chunk12-noprefetch": {"cohort_chunk": 12, "prefetch": False},
        "chunk17": {"cohort_chunk": 17},
        "hierarchical:4": {"aggregator": "hierarchical:4"},
    }
    for name, config in variants.items():
        fed = arc_federation(torch, cohort, exp, **config)
        result, stats, counts = run_federation(torch, K, fed)
        emit(phase="cohort_variant", setting="federated-arc", variant=name,
             **cohort_fields(fed, result, stats), launches=counts)
        if name != "hierarchical:4":
            # Each chunk is one round of the cohort engine: 2 + 2 launches a step.
            check_launches(f"federated-arc ({name})", counts, stats[0]["cohort_steps"], 0)
        require(all(math.isfinite(r.mean_local_loss) for r in result.history),
                f"{name}: a round loss is not finite")
        total = {k: total[k] + counts[k] for k in total}
        runs[name] = (result.params, stats[-1])
        del fed, result
        torch.cuda.empty_cache()

    diff = {name: param_diff(runs["whole"][0], p) for name, (p, _) in runs.items()
            if name != "whole"}
    prefetch_diff = param_diff(runs["chunk12"][0], runs["chunk12-noprefetch"][0])
    emit(phase="cohort_variants_parity", max_param_diff_vs_whole=diff,
         prefetch_on_off_max_param_diff=prefetch_diff,
         plans_prefetched={k: st["plans_prefetched"] for k, (_, st) in runs.items()})
    require(prefetch_diff == 0.0, f"prefetch on and off differ by {prefetch_diff}")
    require(runs["chunk12"][1]["prefetch"] and runs["chunk12"][1]["plans_prefetched"] > 0,
            f"prefetch did not engage: {runs['chunk12'][1]}")
    for name in ("chunk12", "chunk17", "hierarchical:4"):
        require(diff[name] <= CHUNK_TOL, f"{name} and the unchunked round differ by {diff[name]}")

    n_test = len(global_dataset(cohort, Cohort.TEST))
    reset_gru_counts(K)
    src = run_setting("federated-src",
                      ExperimentConfig(rounds=1, local_epochs=4, aggregator="trimmed-mean:0.1"),
                      cohort, seed=0)
    counts = gru_counts(K)
    emit(phase="trimmed_mean", setting="federated-src", engine=src["engine"],
         participants=src["federation_size"], local_steps=src["local_steps"],
         round_times_s=src["round_times_s"], metrics=src["metrics"], launches=counts)
    require(src["engine"] == "sequential", f"trimmed-mean ran on {src['engine']}")
    require(all(math.isfinite(v) for v in src["metrics"].values()),
            f"trimmed-mean: metrics not finite: {src['metrics']}")
    check_launches("federated-src (trimmed-mean)", counts, src["local_steps"],
                   math.ceil(n_test / 2048))
    return {k: total[k] + counts[k] for k in total}


def run_staging_comparison_phase(torch, K) -> dict[str, int]:
    """``run_staging_comparison`` at its defaults on the card."""
    from repro_torch.experiments.paper import run_staging_comparison

    reset_gru_counts(K)
    t0 = time.perf_counter()
    report = run_staging_comparison(verbose=False, device="cuda")
    counts = gru_counts(K)
    emit(phase="staging_comparison", seconds=time.perf_counter() - t0, launches=counts,
         **report)
    require(report["max_param_diff"] <= PARITY_TOL,
            f"staging variants differ by {report['max_param_diff']}")
    require(report["bytes_ratio"] >= 10.0, f"bytes ratio {report['bytes_ratio']}")
    return counts


# ---------------------------------------------------------------------------
# phase 19: DP, secagg and krum
# ---------------------------------------------------------------------------

# DP's per-example shape: C·B clients of batch 1, and the batched (C, B) shape
# of the same rows (arc's 35 clients and all 189, at batch 128).
PER_EXAMPLE_CASES = ((COHORT, 128), (AC_COHORT, 128))


def check_per_example_kernels(torch, dev, K) -> None:
    """``gru_scan`` and ``gru_scan_bwd`` at (C·B, 1, 24, 32) against their
    plain versions, two runs bit for bit; then both kernels' device times
    (CUDA graph) there and at (C, B, 24, 32), and the bounds of each."""
    from repro_torch.kernels.gru_scan.ref import gru_scan_bwd_ref, gru_scan_ref

    t, n = 24, 32
    for c, b in PER_EXAMPLE_CASES:
        examples = c * b
        xg, w, bias, dy = gru_inputs(torch, dev, examples, 1, t, n, seed=examples)
        h = K.gru_scan(xg, w, bias)
        h2 = K.gru_scan(xg, w, bias)
        dx, dw, db = K.gru_scan_bwd(xg, w, bias, h, dy)
        dx2, dw2, db2 = K.gru_scan_bwd(xg, w, bias, h, dy)
        torch.cuda.synchronize()
        dx_r, dw_r, db_r = gru_scan_bwd_ref(xg, w, bias, h, dy)
        e = {"fwd": max_err(h, gru_scan_ref(xg, w, bias)), "dx": max_err(dx, dx_r),
             "dw": max_err(dw, dw_r), "db": max_err(db, db_r)}
        same_bits = all(torch.equal(x, y) for x, y in ((h, h2), (dx, dx2), (dw, dw2), (db, db2)))
        require(e["fwd"] <= FWD_TOL, f"per-example {examples}: gru_scan error {e['fwd']}")
        require(e["dx"] <= DX_TOL, f"per-example {examples}: dx_gates error {e['dx']}")
        require(e["dw"] <= DW_TOL * max(1.0, float(dw_r.abs().max())),
                f"per-example {examples}: dW_hh error {e['dw']}")
        require(e["db"] <= DW_TOL * max(1.0, float(db_r.abs().max())),
                f"per-example {examples}: db_hh error {e['db']}")
        require(same_bits, f"per-example {examples}: two forward or backward runs differ")
        del dx_r, dw_r, db_r, dx2, dw2, db2, h2

        xb, wb, bb, dyb = gru_inputs(torch, dev, c, b, t, n, seed=c)
        hb = K.gru_scan(xb, wb, bb)
        calls = 20
        device_ms = {
            "per_example": {
                "gru_scan": graph_ms(torch, lambda: K.gru_scan(xg, w, bias), calls=calls),
                "gru_scan_bwd": graph_ms(torch, lambda: K.gru_scan_bwd(xg, w, bias, h, dy),
                                         calls=calls)},
            "batched": {
                "gru_scan": graph_ms(torch, lambda: K.gru_scan(xb, wb, bb), calls=calls),
                "gru_scan_bwd": graph_ms(torch, lambda: K.gru_scan_bwd(xb, wb, bb, hb, dyb),
                                         calls=calls)},
        }
        one = work(1, t, n)
        batched = work(b, t, n)
        bounds = {
            "per_example": {"gru_scan": bound_ms(examples * one[0], examples * one[1])[0],
                            "gru_scan_bwd": bound_ms(examples * one[2], examples * one[3])[0]},
            "batched": {"gru_scan": bound_ms(c * batched[0], c * batched[1])[0],
                        "gru_scan_bwd": bound_ms(c * batched[2], c * batched[3])[0]},
        }
        emit(phase="dp_kernels", per_example_shape=[examples, 1, t, n],
             batched_shape=[c, b, t, n], max_abs_err=e, bitwise_repeat=same_bits,
             device_ms=device_ms, bound_ms=bounds,
             dw_partials_bytes=K._scratch(h, examples, 1, t, n)[1].numel() * 4)
        del xg, w, bias, dy, h, dx, dw, db, xb, wb, bb, dyb, hb
        torch.cuda.empty_cache()


def small_federation_runs(torch):
    """A 4-client federation at full width, 2 rounds of 1 local epoch (phase
    4's), from one CPU init: ``run(dropout, device, **config)``."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    clients = build_client_datasets(generate_cohort(CohortConfig().scaled(0.02), seed=1))
    params0 = init_gru(torch.Generator().manual_seed(1), GRUConfig(), "cpu")
    base = dict(rounds=2, local_epochs=1, recruitment="top-n-samples:4", selection="uniform",
                seed=1)

    def run(dropout, device, **config):
        fed = Federation(FederationConfig(**base, **config), clients,
                         make_loss_fn(GRUConfig(dropout=dropout)), AdamW(), device=device)
        return fed.run(params0)

    return run, clients, params0


def clipped_share(torch, clients, params0, clip: float) -> float:
    """The share of a full batch's examples whose gradient the clip scales
    down, at the init, for the largest of ``clients``."""
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.privacy.dp import per_example_clip_factors, per_example_value_and_grad
    from repro_torch.tree import tree_map

    client = max(clients, key=lambda c: c.n_train)
    x, y = client.train.x[:128], client.train.y[:128]
    batch = (torch.from_numpy(x)[None], torch.from_numpy(y)[None], torch.ones(1, len(y)))
    _, grads = per_example_value_and_grad(
        make_loss_fn(GRUConfig(dropout=0.0)), tree_map(lambda p: p[None], params0), batch, None)
    return float((per_example_clip_factors(grads, clip) < 1.0).float().mean())


def check_dp_parity(torch) -> None:
    """Phase 19 (b) and (c): a DP federation on the card against the CPU, the
    engines against each other under DP on the card, degenerate DP against
    unprotected."""
    from repro_torch.privacy.dp import DPConfig

    run, clients, params0 = small_federation_runs(torch)
    clip = 0.1
    share = clipped_share(torch, clients, params0, clip)
    binding = DPConfig(clip_norm=clip, noise_multiplier=0.0)
    out = {device: run(0.0, device, privacy=binding) for device in ("cuda", "cpu")}
    diff = param_diff(out["cuda"].params, out["cpu"].params)
    losses = {d: [r.mean_local_loss for r in out[d].history] for d in out}
    emit(phase="dp_parity", clip_norm=clip, clipped_share_at_init=share, max_param_diff=diff,
         losses=losses, epsilon=[r.epsilon for r in out["cuda"].history])
    require(share > 0.5, f"the clip of {clip} scales {share} of the examples: not binding")
    require(diff <= DP_PARITY_TOL, f"card and CPU DP federations differ by {diff}")

    noisy = DPConfig(clip_norm=1.0, noise_multiplier=1.0)
    runs = {engine: run(0.05, "cuda", engine=engine, privacy=noisy)
            for engine in ("vectorized", "sequential")}
    losses = {k: [r.mean_local_loss for r in v.history] for k, v in runs.items()}
    loss_diff = max(abs(a - b) for a, b in zip(losses["vectorized"], losses["sequential"]))
    engine_diff = param_diff(runs["vectorized"].params, runs["sequential"].params)
    emit(phase="dp_engine_parity", dropout=0.05, privacy=noisy.to_state(), losses=losses,
         max_loss_diff=loss_diff, max_param_diff=engine_diff)
    require(loss_diff <= ENGINE_LOSS_TOL, f"DP engines' round losses differ by {loss_diff}")
    require(engine_diff <= PARITY_TOL, f"DP engines' params differ by {engine_diff}")

    # Degenerate DP (no clip, no noise) is the unprotected estimator: one
    # step's gradient and the round losses within 1e-5.  After AdamW steps an
    # entry whose gradient is near zero drifts further (1.5e-5 on the CPU at
    # this size; ROADMAP Queue 3), so its params are held to PARITY_TOL.
    degenerate = DPConfig(clip_norm=None, noise_multiplier=0.0)
    grad_diff = degenerate_step_diff(torch, clients, params0, degenerate)
    runs = {(engine, name): run(0.0, "cuda", engine=engine, privacy=dp)
            for engine in ("vectorized", "sequential")
            for name, dp in (("none", None), ("degenerate", degenerate))}
    loss_diff = {engine: max(abs(a.mean_local_loss - b.mean_local_loss) for a, b in zip(
        runs[engine, "none"].history, runs[engine, "degenerate"].history))
        for engine in ("vectorized", "sequential")}
    param_gap = {engine: param_diff(runs[engine, "none"].params, runs[engine, "degenerate"].params)
                 for engine in ("vectorized", "sequential")}
    emit(phase="dp_degenerate", step_grad_max_diff=grad_diff, max_loss_diff=loss_diff,
         max_param_diff=param_gap)
    require(grad_diff <= DP_PARITY_TOL, f"degenerate DP's step gradient differs by {grad_diff}")
    for engine in loss_diff:
        require(loss_diff[engine] <= DP_PARITY_TOL,
                f"degenerate DP's round losses differ by {loss_diff[engine]} ({engine})")
        require(param_gap[engine] <= PARITY_TOL,
                f"degenerate DP's params differ by {param_gap[engine]} ({engine})")


def degenerate_step_diff(torch, clients, params0, degenerate) -> float:
    """On the card, the degenerate DP estimator's gradient of one full batch
    (the largest client's first 128 examples) against the batch gradient."""
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.privacy.dp import dp_value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    loss_fn = make_loss_fn(GRUConfig(dropout=0.0))
    client = max(clients, key=lambda c: c.n_train)
    batch = tuple(torch.from_numpy(a).cuda() for a in (client.train.x[:128], client.train.y[:128]))
    batch = (*batch, torch.ones(len(batch[1]), device="cuda"))
    params = tree_map(lambda p: p.cuda().requires_grad_(True), params0)
    want = torch.autograd.grad(loss_fn(params, batch, None), tree_leaves(params))
    _, got = dp_value_and_grad(loss_fn, degenerate)(
        tree_map(lambda p: p.detach()[None], params), tuple(t[None] for t in batch), None)
    return max(max_err(g[0], w) for g, w in zip(tree_leaves(got), want))


def run_privacy_phase(torch, dev, K, cohort) -> dict[str, int]:
    """Phase 19: the GRU kernels at DP's per-example shape; DP parity; DP on
    federated-arc at full width, both engines; a profiled DP round; one arc
    round each of ``secagg-fedavg`` (with a FedAvg round from the same init on
    the same trainer) and ``krum:4``."""
    import numpy as np

    from repro_torch.experiments.paper import ExperimentConfig
    from repro_torch.privacy.dp import DPConfig
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    check_per_example_kernels(torch, dev, K)
    check_dp_parity(torch)

    privacy = DPConfig(clip_norm=1.0, noise_multiplier=1.0)
    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    for engine, rounds in (("vectorized", 2), ("sequential", 1)):
        exp = ExperimentConfig(rounds=rounds, local_epochs=4)
        fed = arc_federation(torch, cohort, exp, engine=engine, privacy=privacy)
        result, stats, counts = run_federation(torch, K, fed)
        steps = sum(st["cohort_steps"] for st in stats) if stats else result.total_local_steps
        eps = [r.epsilon for r in result.history]
        emit(phase="dp_slice", setting="federated-arc", engine=fed.effective_engine,
             privacy=privacy.to_state(), **cohort_fields(fed, result, stats), epsilon=eps,
             per_example_clients=([st["per_example_clients"] for st in stats] if stats
                                  else exp.batch_size),
             launches=counts)
        require(all(math.isfinite(r.mean_local_loss) for r in result.history),
                f"DP arc ({engine}): a round loss is not finite")
        require(all(e is not None and e > 0 for e in eps) and eps == sorted(eps),
                f"DP arc ({engine}): epsilons {eps}")
        if stats:
            want = result.federation_ids.size * exp.batch_size
            require(all(st["per_example_clients"] == want for st in stats),
                    f"DP arc: per-example clients {[st['per_example_clients'] for st in stats]}")
        check_launches(f"DP arc ({engine})", counts, steps, 0)
        total = {k: total[k] + counts[k] for k in total}
        del fed, result
        torch.cuda.empty_cache()

    profile_cohort_round(torch, cohort, "resident", phase="dp_profile", privacy=privacy,
                         local_epochs=1)

    exp = ExperimentConfig(rounds=1, local_epochs=4)
    runs = {}
    for aggregator in ("fedavg", "secagg-fedavg", "krum:4"):
        fed = arc_federation(torch, cohort, exp, engine="sequential", aggregator=aggregator)
        result, _, counts = run_federation(torch, K, fed)
        agg = fed.aggregator
        emit(phase="robust_aggregator", setting="federated-arc", aggregator=aggregator,
             engine=fed.effective_engine, participants=len(result.history[0].participant_ids),
             round_times_s=[r.round_time_s for r in result.history],
             mean_local_loss=[r.mean_local_loss for r in result.history],
             survivors=(int(agg.last_survivors.sum()) if aggregator == "secagg-fedavg" else None),
             krum_chosen=(agg.last_chosen.tolist() if aggregator.startswith("krum") else None),
             launches=counts)
        require(all(math.isfinite(float(p.abs().max())) for p in tree_leaves(result.params)),
                f"{aggregator}: params not finite")
        check_launches(f"arc ({aggregator})", counts, result.total_local_steps, 0)
        total = {k: total[k] + counts[k] for k in total}
        runs[aggregator] = (result, agg)
        del fed
        torch.cuda.empty_cache()

    (plain, _), (masked, secagg) = runs["fedavg"], runs["secagg-fedavg"]
    clients = len(plain.history[0].participant_ids)
    diff = param_diff(plain.params, masked.params)
    largest = max(float(p.abs().max()) for p in tree_leaves(plain.params))
    bound = clients / 2 ** (secagg.fraction_bits + 1) + largest * 2.0 ** -23
    emit(phase="secagg_parity", clients=clients, survivors=int(secagg.last_survivors.sum()),
         max_param_diff=diff, quantization_bound=bound,
         seconds=time.perf_counter() - t_phase)
    require(bool(np.all(secagg.last_survivors)), "secagg: a client dropped without a dropout model")
    require(diff <= bound, f"secagg and fedavg differ by {diff}, above {bound}")
    return total


# ---------------------------------------------------------------------------
# phase 20: the async runtime
# ---------------------------------------------------------------------------

ASYNC_TIMELINE_FIELDS = ("federation_size", "recruited", "buffer_size", "flushes", "tasks",
                         "dropped", "virtual_time", "mean_staleness")


def async_federation(torch, cohort, exp, tracer=None, **config):
    """An ``AsyncFederation`` on the full cohort at full width: the paper's
    model (dropout 0.05) and optimizer, seed 0, on the card; ``tracer``
    records its spans."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.federated.runtime import AsyncFederation, AsyncFederationConfig
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    return AsyncFederation(
        AsyncFederationConfig(rounds=exp.rounds, local_epochs=exp.local_epochs,
                              batch_size=exp.batch_size, seed=0, **config),
        build_client_datasets(cohort), make_loss_fn(GRUConfig()),
        AdamW(exp.learning_rate, weight_decay=exp.weight_decay), device="cuda", tracer=tracer,
    )


def run_async(torch, K, fed, progress=None):
    """``fed.run`` from the seed-0 init with the GRU counts set to 0 just
    before: the result, the host seconds of the run and the launches."""
    from repro_torch.models.gru import GRUConfig, init_gru

    params0 = init_gru(torch.Generator().manual_seed(0), GRUConfig(), "cuda")
    torch.cuda.synchronize()
    reset_gru_counts(K)
    t0 = time.perf_counter()
    result = fed.run(params0, progress=progress)
    return result, time.perf_counter() - t0, gru_counts(K)


def async_fields(fed, result, seconds) -> dict:
    """What phase 20 prints of an async run."""
    stats = fed.last_run_stats
    flush_s = [r.round_time_s for r in result.history]
    return dict(
        federation_size=int(result.federation_ids.size),
        buffer_size=getattr(fed.aggregator, "buffer_size", None),
        flushes=len(result.history), tasks=stats["tasks"], dropped=stats["dropped"],
        forced_flushes=stats["forced_flushes"], unflushed_updates=stats["unflushed_updates"],
        mean_staleness=result.summary()["mean_staleness"],
        staleness=[r.staleness for r in result.history],
        virtual_times=[r.virtual_time for r in result.history],
        participants=[len(r.participant_ids) for r in result.history],
        mean_local_loss=[r.mean_local_loss for r in result.history],
        flush_times_s=flush_s, seconds=seconds,
        host_s_per_flush=sum(flush_s) / max(len(flush_s), 1),
        host_s_per_task=seconds / max(stats["tasks"], 1),
        steps_trained=stats["steps_trained"],
        local_steps_per_s=stats["steps_trained"] / seconds,
    )


def run_async_phase(torch, K, cohort) -> dict[str, int]:
    """Phase 20: (a) fedbuff and hierarchical-async parity against a sync
    arc run; (b) the straggler comparison at full width; (c) the reference's
    own workload against ``BENCH_async.json``; one profiled flush."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.experiments.paper import (
        ExperimentConfig,
        policies_for,
        run_async_comparison,
        shared_time_to_target,
    )

    t_phase = time.perf_counter()
    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    sizes = {c.client_id: c.n_train for c in build_client_datasets(cohort)}
    recruited = policies_for("federated-arc", ExperimentConfig())["recruitment"]

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) parity: one-client tasks and one whole-federation region against
    # the sync FedAvg rounds of the same configuration and init.
    exp = ExperimentConfig(rounds=2, local_epochs=4)
    fed = arc_federation(torch, cohort, exp)
    sync, _, counts = run_federation(torch, K, fed)
    check_launches("sync arc", counts,
                   schedule_steps(sync.history, sizes, exp.batch_size, exp.local_epochs), 0)
    add(counts)
    sync_round_s = [r.round_time_s for r in sync.history]
    del fed
    for aggregator in (f"fedbuff:{sync.federation_ids.size}", "hierarchical-async:1"):
        fed = async_federation(torch, cohort, exp, recruitment=recruited, aggregator=aggregator,
                               latency="constant")
        result, seconds, counts = run_async(torch, K, fed)
        loss_diff = max(abs(a.mean_local_loss - s.mean_local_loss)
                        for a, s in zip(result.history, sync.history))
        diff = param_diff(result.params, sync.params)
        if aggregator.startswith("fedbuff"):
            steps = fed.last_run_stats["steps_trained"]   # one client a task: real = batched
        else:
            steps = schedule_steps(result.history, sizes, exp.batch_size, exp.local_epochs)
        emit(phase="async_parity", setting="federated-arc", aggregator=aggregator,
             **async_fields(fed, result, seconds), sync_round_times_s=sync_round_s,
             sync_mean_local_loss=[r.mean_local_loss for r in sync.history],
             max_loss_diff=loss_diff, max_param_diff=diff, batched_steps=steps,
             launches=counts)
        require([r.participant_ids for r in result.history]
                == [r.participant_ids for r in sync.history],
                f"{aggregator}: flush participants differ from the sync rounds'")
        require(all(r.staleness == 0.0 for r in result.history),
                f"{aggregator}: staleness {[r.staleness for r in result.history]}")
        require(loss_diff <= ENGINE_LOSS_TOL, f"{aggregator}: round losses differ by {loss_diff}")
        require(diff <= PARITY_TOL, f"{aggregator}: params differ by {diff} from sync FedAvg")
        check_launches(f"async arc ({aggregator})", counts, steps, 0)
        add(counts)
        del fed, result
    del sync
    torch.cuda.empty_cache()

    # (b) the straggler comparison: all clients against the recruited ones.
    exp = ExperimentConfig(rounds=8, local_epochs=1)
    for latency in ("lognormal:0.6", "pareto:1.2"):
        histories, row = {}, {}
        for name, rec in (("all-clients", "all"), ("recruited", recruited)):
            fed = async_federation(torch, cohort, exp, recruitment=rec,
                                   aggregator="fedbuff:0.25", latency=latency, dropout=0.05)
            result, seconds, counts = run_async(torch, K, fed)
            row[name] = async_fields(fed, result, seconds)
            emit(phase="async_straggler", federation=name, latency=latency, **row[name],
                 sync_arc_round_times_s=sync_round_s, launches=counts)
            require(len(result.history) == exp.rounds, f"{name} {latency}: {row[name]['flushes']}")
            require(all(math.isfinite(v) for v in row[name]["mean_local_loss"]),
                    f"{name} {latency}: a flush loss is not finite")
            check_launches(f"async {name} ({latency})", counts,
                           fed.last_run_stats["steps_trained"], 0)
            add(counts)
            histories[name] = result.history
            del fed, result
            torch.cuda.empty_cache()
        target, times = shared_time_to_target(histories)
        t_all, t_rec = times["all-clients"], times["recruited"]
        emit(phase="async_time_to_target", latency=latency, target_loss=target,
             time_to_target=times,
             recruited_speedup=t_all / t_rec if t_all is not None and t_rec else None,
             host_s={k: v["seconds"] for k, v in row.items()})

    # (c) the reference's workload at its defaults: the timeline is a
    # function of numpy streams alone, so it is the reference's record.
    reset_gru_counts(K)
    t0 = time.perf_counter()
    report = run_async_comparison(device="cuda", verbose=False)
    seconds = time.perf_counter() - t0
    counts = gru_counts(K)
    bench = json.loads((ROOT / "BENCH_async.json").read_text())
    mismatches = []
    for latency, row in report["latency"].items():
        for name in ("all-clients", "recruited"):
            got, want = row[name], bench["latency"][latency][name]
            for field in ASYNC_TIMELINE_FIELDS:
                if got[field] != want[field]:
                    mismatches.append((latency, name, field, got[field], want[field]))
            if [t for t, _ in got["trajectory"]] != [t for t, _ in want["trajectory"]]:
                mismatches.append((latency, name, "trajectory virtual times"))
            require(all(math.isfinite(v) for _, v in got["trajectory"]),
                    f"run_async_comparison {latency} {name}: a flush loss is not finite")
    emit(phase="async_comparison", seconds=seconds,
         rows={lat: {name: {f: row[name][f] for f in (*ASYNC_TIMELINE_FIELDS, "final_loss",
                                                      "time_to_target", "tau_s")}
                     for name in ("all-clients", "recruited")}
               | {"recruited_speedup": row["recruited_speedup"]}
               for lat, row in report["latency"].items()},
         timeline_mismatches=mismatches, launches=counts)
    require(not mismatches, f"run_async_comparison's timeline differs from BENCH_async.json: "
            f"{mismatches[:4]}")
    require(counts["gru_scan"] == counts["gru_scan_bwd"] > 0,
            f"run_async_comparison launches {counts}")
    add(counts)

    profile_async_flush(torch, K, cohort, recruited)
    emit(phase="async_seconds", seconds=time.perf_counter() - t_phase)
    return total


def profile_async_flush(torch, K, cohort, recruited) -> None:
    """The recruited federation (fedbuff:0.25, lognormal:0.6, dropout 0.05,
    1 local epoch) with torch.profiler on from the end of flush 1 to the end
    of flush 2: the flush's wall time, device busy time and idle share, its
    one-client GRU launches and device operations a local step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiments.paper import ExperimentConfig

    exp = ExperimentConfig(rounds=3, local_epochs=1)
    fed = async_federation(torch, cohort, exp, recruitment=recruited,
                           aggregator="fedbuff:0.25", latency="lognormal:0.6", dropout=0.05)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_flush(record):
        if record.round_index == 0:
            window["counts"] = gru_counts(K)
            prof.start()
            window["t0"] = time.perf_counter()
        elif record.round_index == 1:
            torch.cuda.synchronize()
            window["wall_s"] = time.perf_counter() - window["t0"]
            prof.stop()
            window["counts"] = {k: v - window["counts"][k] for k, v in gru_counts(K).items()}
            window["record"] = record

    run_async(torch, K, fed, progress=on_flush)
    by_name, count = device_times(prof)
    device_s = sum(by_name.values()) / 1e6
    wall_s = window["wall_s"]
    launches = window["counts"]
    steps = launches["gru_scan"] // 2   # two GRU layers: two forward launches a step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    gru_us = {side: sum(us for name, us in by_name.items() if gru_side(name) == side)
              for side in ("fwd", "bwd")}
    emit(phase="async_profile", federation="recruited", aggregator="fedbuff:0.25",
         latency="lognormal:0.6", flush=1, wall_s=wall_s,
         flush_record_time_s=window["record"].round_time_s,
         participants=len(window["record"].participant_ids), local_steps=steps,
         step_ms=wall_s / steps * 1e3 if steps else None,
         device_busy_s=device_s if device_s > 0 else None,
         device_idle_share=1.0 - device_s / wall_s if device_s > 0 else None,
         device_ops=count, device_ops_per_step=count / steps if steps else None,
         gru_scan_us=gru_us["fwd"], gru_scan_bwd_us=gru_us["bwd"], launches=launches,
         top_device_us={name[:80]: us for name, us in top})
    del fed
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 21: snapshots and the control plane
# ---------------------------------------------------------------------------

# A child that runs the job service's CLI and reports its GRU launches as the
# last line of its standard error.
CLI_CHILD = """
import json, sys
from repro_torch.kernels.gru_scan import kernel as K
from repro_torch.launch.federation_service import main
rc = main(sys.argv[1:])
print(json.dumps({"gru_scan": K.gru_scan.launches, "gru_scan_bwd": K.gru_scan_bwd.launches}),
      file=sys.stderr, flush=True)
sys.exit(rc)
"""
# A child that submits a job and prints its GRU launches after every record.
COUNTING_CHILD = """
import json, sys
from repro_torch.kernels.gru_scan import kernel as K
from repro_torch.launch.federation_service import submit_job

def report(record):
    print(json.dumps({"round": record.round_index, "gru_scan": K.gru_scan.launches,
                      "gru_scan_bwd": K.gru_scan_bwd.launches}), flush=True)

submit_job(json.loads(sys.argv[1]), sys.argv[2], subscribers=[report], device="cuda")
"""


def child_env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def run_cli_child(*argv, child: str = CLI_CHILD) -> tuple[int, dict[str, int], float]:
    """The CLI in a subprocess: its exit code, GRU launches (and whatever
    else ``child`` reports on its last line) and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", child, *argv], env=child_env(),
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stderr.strip().splitlines()
    require(bool(lines) and lines[-1].startswith("{"),
            f"CLI child {argv[:1]} reported no counts: {proc.stderr[-2000:]}")
    return proc.returncode, json.loads(lines[-1]), seconds


def kill_after_first_snapshot(spec: dict, run_dir: Path) -> tuple[dict[str, int], int, float]:
    """Submit ``spec`` in a subprocess and SIGKILL it as soon as its first
    snapshot's manifest exists: the launches it reported by then, the
    records it had streamed, and the seconds it ran."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", COUNTING_CHILD, json.dumps(spec),
                             str(run_dir)], env=child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        while not (run_dir / "checkpoint" / "snapshot.json").exists():
            if proc.poll() is not None:  # read stderr only once the child is gone
                require(False, f"the job to kill ended first: {proc.stderr.read()[-2000:]}")
            require(time.perf_counter() - t0 < 600, "no snapshot within 600 s")
            time.sleep(0.01)
        proc.send_signal(signal.SIGKILL)
    finally:
        out, _ = proc.communicate(timeout=120)
    require(proc.returncode == -signal.SIGKILL, f"the killed job exited {proc.returncode}")
    reports = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    require(bool(reports), "the killed job reported no record")
    last = reports[-1]
    return ({k: last[k] for k in ("gru_scan", "gru_scan_bwd")}, len(reports),
            time.perf_counter() - t0)


def final_arrays(run_dir: Path) -> dict:
    import numpy as np

    with np.load(run_dir / "final" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def resume_fields(run_dir: Path, reference: Path) -> dict:
    """A resumed run against the uninterrupted one: ``diff_runs``, the
    largest final-param difference and whether the params are the same bits."""
    import numpy as np

    from repro_torch.launch.federation_service import diff_runs

    a, b = final_arrays(run_dir), final_arrays(reference)
    return dict(diff_runs=diff_runs(str(run_dir), str(reference)),
                max_param_diff=max(float(np.max(np.abs(a[k] - b[k]))) for k in a),
                bitwise=all(a[k].tobytes() == b[k].tobytes() for k in a))


def run_control_plane_phase(torch, K) -> dict[str, int]:
    """Phase 21: (a) the sync arc job uninterrupted, preempted through the
    CLI and resumed, killed and resumed; the snapshot's size and times;
    (b) an async job preempted and resumed; (c) a DP job cut and resumed;
    (d) the service overhead."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.experiments.paper import (
        ExperimentConfig,
        build_cohort,
        job_spec_for,
        policies_for,
        run_service_overhead,
    )
    from repro_torch.federated.api import FederationSnapshot
    from repro_torch.launch.federation_service import (
        EX_TEMPFAIL,
        JobPreempted,
        read_records,
        resume_job,
        status_job,
        submit_job,
    )
    from repro_torch.models.gru import GRUConfig, init_gru

    t_phase = time.perf_counter()
    work = ROOT / "build" / "control_plane"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total = {"gru_scan": 0, "gru_scan_bwd": 0}

    def counted(what, counts):
        require(counts["gru_scan"] > 0 and counts["gru_scan_bwd"] > 0,
                f"{what} launched a GRU kernel no time: {counts}")
        for k in total:
            total[k] += counts[k]
        return counts

    def in_process(what, fn, *args, **kwargs):
        torch.cuda.synchronize()
        reset_gru_counts(K)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        return out, counted(what, gru_counts(K)), seconds

    def records(run_dir):
        return read_records(str(run_dir / "records.jsonl"))

    # (a) the sync arc job, four ways
    exp = ExperimentConfig(rounds=3)
    spec = job_spec_for("federated-arc", exp, seed=0)
    sizes = {c.client_id: c.n_train for c in build_client_datasets(build_cohort(exp, seed=0))}
    run_a, run_b, run_c = (work / name for name in ("A", "B", "C"))
    emitted = []
    result_a, counts_a, seconds_a = in_process(
        "A", submit_job, spec, str(run_a), device="cuda",
        subscribers=[lambda r: emitted.append(time.perf_counter())])
    recs_a = records(run_a)
    check_launches("control plane A", counts_a,
                   schedule_steps(recs_a, sizes, exp.batch_size, exp.local_epochs), 0)
    torch.cuda.empty_cache()
    spec_path = work / "arc.json"
    spec_path.write_text(json.dumps(spec))
    rc1, counts_b1, seconds_b1 = run_cli_child(
        "submit", "--spec", str(spec_path), "--run-dir", str(run_b), "--preempt-after", "1",
        "--quiet", "--device", "cuda")
    require(rc1 == EX_TEMPFAIL, f"the preempted CLI submit exited {rc1}, not {EX_TEMPFAIL}")
    status_b = status_job(str(run_b))
    require(status_b["status"] == "preempted" and status_b["checkpoint_round"] == 1,
            f"B after preemption: {status_b}")
    rc2, counts_b2, seconds_b2 = run_cli_child("resume", "--run-dir", str(run_b), "--quiet",
                                               "--device", "cuda")
    require(rc2 == 0, f"the CLI resume exited {rc2}")
    recs_b = records(run_b)
    check_launches("control plane B (submit)", counted("B submit", counts_b1),
                   schedule_steps(recs_b[:1], sizes, exp.batch_size, exp.local_epochs), 0)
    check_launches("control plane B (resume)", counted("B resume", counts_b2),
                   schedule_steps(recs_b[1:], sizes, exp.batch_size, exp.local_epochs), 0)
    counts_c1, streamed, seconds_c1 = kill_after_first_snapshot(spec, run_c)
    counted("C before the kill", counts_c1)
    status_c = status_job(str(run_c))
    require(status_c["status"] == "submitted", f"C after the kill: {status_c}")
    result_c, counts_c2, seconds_c2 = in_process("C resume", resume_job, str(run_c),
                                                 device="cuda")
    require(1 <= result_c["resumed_from"] < exp.rounds, f"C resumed from {result_c}")
    fields = {}
    for name, run_dir in (("B", run_b), ("C", run_c)):
        fields[name] = resume_fields(run_dir, run_a)
        require(fields[name]["diff_runs"] == [],
                f"{name} differs from the uninterrupted run: {fields[name]['diff_runs']}")
        require(fields[name]["max_param_diff"] <= RESUME_TOL,
                f"{name}'s params differ by {fields[name]['max_param_diff']}")

    # the snapshot: bytes on disk, save and load times
    ckpt = run_a / "checkpoint"
    snap_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
    like = init_gru(torch.Generator().manual_seed(0), GRUConfig(), "cuda")
    load_ms, save_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = FederationSnapshot.load(str(ckpt), like)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        snap.save(str(work / "snapshot_copy"), extra_state={"spec_hash": "timing"})
        save_ms.append((time.perf_counter() - t0) * 1e3)
    round_s = [r.round_time_s for r in recs_a]
    # record to record: a round plus the previous round's snapshot and streams
    with_checkpoint_s = [b - a for a, b in zip(emitted, emitted[1:])]
    emit(phase="control_plane_sync", setting="federated-arc", rounds=exp.rounds,
         spec_hash=result_a["spec_hash"], federation_size=result_a["summary"]["federation_size"],
         seconds={"A": seconds_a, "B_submit": seconds_b1, "B_resume": seconds_b2,
                  "C_until_killed": seconds_c1, "C_resume": seconds_c2},
         cli_exit_codes=[rc1, rc2], records_streamed_before_kill=streamed,
         resumed_from={"B": status_b["checkpoint_round"], "C": result_c["resumed_from"]},
         round_times_s=round_s, record_to_record_s=with_checkpoint_s,
         mean_local_loss=[r.mean_local_loss for r in recs_a],
         resumed=fields, launches={"A": counts_a, "B_submit": counts_b1, "B_resume": counts_b2,
                                   "C_until_killed": counts_c1, "C_resume": counts_c2})
    emit(phase="control_plane_snapshot", bytes_on_disk=snap_bytes,
         files={f.name: f.stat().st_size for f in ckpt.iterdir()},
         save_ms=save_ms, load_ms=load_ms, save_ms_min=min(save_ms), load_ms_min=min(load_ms),
         save_share_of_round=min(save_ms) / 1e3 / (sum(round_s) / len(round_s)))
    torch.cuda.empty_cache()

    # (b) an async job on the recruited federation, preempted at flush 2
    async_spec = {
        "name": "arc-async", "mode": "async", "rounds": 4, "local_epochs": 1,
        "batch_size": exp.batch_size, "seed": 0,
        "recruitment": policies_for("federated-arc", exp)["recruitment"],
        "aggregator": "fedbuff:0.25", "latency": "lognormal:0.6", "dropout": "bernoulli:0.05",
        "data": {"scale": exp.cohort_scale, "seed": 0},
        "optimizer": {"learning_rate": exp.learning_rate, "weight_decay": exp.weight_decay},
    }
    run_d, run_e = work / "async-full", work / "async-cut"
    result_d, counts_d, seconds_d = in_process("async full", submit_job, async_spec,
                                               str(run_d), device="cuda")

    def preempted(spec_, run_dir, at):
        try:
            submit_job(spec_, str(run_dir), device="cuda", preempt_after=at)
        except JobPreempted:
            return status_job(str(run_dir))
        require(False, f"{run_dir.name} was not preempted at {at}")

    status_e, counts_e1, seconds_e1 = in_process("async cut", preempted, async_spec, run_e, 2)
    require(status_e["status"] == "preempted" and status_e["checkpoint_round"] == 2,
            f"the async job after preemption: {status_e}")
    result_e, counts_e2, seconds_e2 = in_process("async resume", resume_job, str(run_e),
                                                 device="cuda")
    recs_d, recs_e = records(run_d), records(run_e)

    def timeline(recs):
        return [(r.round_index, r.virtual_time, r.staleness, r.participant_ids) for r in recs]

    tallies = {name: {k: out["summary"]["metrics"]["counters"].get(k, 0)
                      for k in ("async.tasks", "async.dropped")}
               for name, out in (("full", result_d), ("resumed", result_e))}
    async_fields_ = resume_fields(run_e, run_d)
    emit(phase="control_plane_async", federation_size=result_d["summary"]["federation_size"],
         aggregator="fedbuff:0.25", latency="lognormal:0.6", dropout=0.05, flushes=len(recs_d),
         virtual_times=[r.virtual_time for r in recs_d], staleness=[r.staleness for r in recs_d],
         participants=[len(r.participant_ids) for r in recs_d], tallies=tallies,
         timeline_equal=timeline(recs_e) == timeline(recs_d), resumed=async_fields_,
         flush_times_s=[r.round_time_s for r in recs_d],
         seconds={"full": seconds_d, "cut": seconds_e1, "resume": seconds_e2},
         launches={"full": counts_d, "cut": counts_e1, "resume": counts_e2})
    require(timeline(recs_e) == timeline(recs_d),
            "the resumed async job's timeline differs from the uninterrupted one's")
    require(tallies["full"] == tallies["resumed"], f"async tallies differ: {tallies}")
    require(async_fields_["diff_runs"] == [], f"async: {async_fields_['diff_runs']}")
    require(async_fields_["max_param_diff"] <= RESUME_TOL,
            f"async params differ by {async_fields_['max_param_diff']}")
    torch.cuda.empty_cache()

    # (c) the arc job under DP, 2 rounds, cut after round 1
    dp_spec = {**spec, "name": "federated-arc-dp", "rounds": 2,
               "privacy": {"clip_norm": 1.0, "noise_multiplier": 1.0}}
    run_f, run_g = work / "dp-full", work / "dp-cut"
    _, counts_f, seconds_f = in_process("DP full", submit_job, dp_spec, str(run_f),
                                        device="cuda")
    _, counts_g1, seconds_g1 = in_process("DP cut", preempted, dp_spec, run_g, 1)
    _, counts_g2, seconds_g2 = in_process("DP resume", resume_job, str(run_g), device="cuda")
    eps = {name: [r.epsilon for r in records(d)] for name, d in (("full", run_f),
                                                                   ("resumed", run_g))}
    dp_fields = resume_fields(run_g, run_f)
    emit(phase="control_plane_dp", setting="federated-arc", privacy=dp_spec["privacy"],
         epsilons=eps, resumed=dp_fields,
         round_times_s=[r.round_time_s for r in records(run_f)],
         seconds={"full": seconds_f, "cut": seconds_g1, "resume": seconds_g2},
         launches={"full": counts_f, "cut": counts_g1, "resume": counts_g2})
    require(eps["full"] == eps["resumed"] and all(e > 0 for e in eps["full"]),
            f"DP epsilons differ across the resume: {eps}")
    require(dp_fields["diff_runs"] == [], f"DP: {dp_fields['diff_runs']}")
    require(dp_fields["max_param_diff"] <= RESUME_TOL,
            f"DP params differ by {dp_fields['max_param_diff']}")
    torch.cuda.empty_cache()

    # (d) the control plane's overhead against a direct run (not gated)
    report, counts_h, seconds_h = in_process("service overhead", run_service_overhead,
                                             device="cuda", verbose=False)
    emit(phase="service_overhead", **report, seconds=seconds_h, launches=counts_h)
    shutil.rmtree(work, ignore_errors=True)
    emit(phase="control_plane_seconds", seconds=time.perf_counter() - t_phase)
    return total



# ---------------------------------------------------------------------------
# phase 22
# ---------------------------------------------------------------------------

# The CLI child of phase 22: it also reports each RoundProfiler the job made
# (its error and its trace), which the run dir does not record.
OBS_CHILD = """
import json, sys
import repro_torch.obs.profile as P
from repro_torch.kernels.gru_scan import kernel as K
from repro_torch.launch.federation_service import main

made = []

class Recorded(P.RoundProfiler):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        made.append(self)

P.RoundProfiler = Recorded
rc = main(sys.argv[1:])
print(json.dumps({"gru_scan": K.gru_scan.launches, "gru_scan_bwd": K.gru_scan_bwd.launches,
                  "profilers": [{"error": None if p.error is None else repr(p.error),
                                 "trace_path": p.trace_path} for p in made]}),
      file=sys.stderr, flush=True)
sys.exit(rc)
"""
# The device kernels of gru_scan's forward and of gru_scan_bwd's recurrence.
GRU_DEVICE_KERNELS = ("gru_scan_fwd_kernel", "gru_bwd_recur_kernel")


def same_bits(a, b) -> bool:
    from repro_torch.tree import tree_leaves

    return all(x.dtype == y.dtype and x.equal(y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def profiled_kernels(path: str) -> dict[str, int]:
    """The device kernel events of a ``torch.profiler`` Chrome trace: all of
    them, and those of each GRU kernel."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {"kernels": 0, **{name: 0 for name in GRU_DEVICE_KERNELS}}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel":
            counts["kernels"] += 1
            for name in GRU_DEVICE_KERNELS:
                if name in e.get("name", ""):
                    counts[name] += 1
    return counts


def spread(floors: list[float]) -> float:
    """How far apart a probe's repeats read: the largest floor over the least, less 1."""
    return max(floors) / min(floors) - 1.0


def run_observability_phase(torch, K, cohort) -> dict[str, int]:
    """Phase 22: (a) a traced and an untraced arc run from one init; (b) a
    traced async run; (c) a traced, profiled arc job through the CLI,
    preempted and resumed; (d) the overhead probes.  (a)-(c) are gated.
    (d) is printed, not gated: its budgets (tracer off 1% over the bare
    loop, on 5% over off, the facade 2%) sit inside the host's noise on the
    card, where host-clock times move ~30% between calls and the control
    plane's 2% probe read +3.09% and -2.44% in two runs."""
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.experiments.paper import (
        ExperimentConfig,
        job_spec_for,
        policies_for,
        run_facade_overhead,
        run_obs_overhead,
    )
    from repro_torch.launch.federation_service import EX_TEMPFAIL, read_records, submit_job
    from repro_torch.obs import Tracer
    from repro_torch.obs.report import phase_breakdown

    t_phase = time.perf_counter()
    work = ROOT / "build" / "observability"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    sizes = {c.client_id: c.n_train for c in build_client_datasets(cohort)}

    def add(counts):
        require(counts["gru_scan"] > 0 and counts["gru_scan_bwd"] > 0,
                f"a phase 22 run launched a GRU kernel no time: {counts}")
        for k in total:
            total[k] += counts[k]
        return counts

    # (a) federated-arc, traced and untraced, from one init
    exp = ExperimentConfig(rounds=2, local_epochs=4)
    tracer = Tracer()
    runs = {}
    for name, tr in (("traced", tracer), ("untraced", None)):
        fed = arc_federation(torch, cohort, exp, tracer=tr)
        t0 = time.perf_counter()
        result, stats, counts = run_federation(torch, K, fed)
        seconds = time.perf_counter() - t0
        check_launches(f"observability arc ({name})", counts,
                       sum(st["cohort_steps"] for st in stats), 0)
        runs[name] = (result, add(counts), seconds)
        del fed
    torch.cuda.empty_cache()
    traced, untraced = runs["traced"][0], runs["untraced"][0]
    summary = tracer.summary()["host"]
    span_counts = {name: int(row["count"]) for name, row in summary.items()}
    round_spans = [s.dur for s in tracer.spans("round")]
    trace_path = work / "arc_trace.json"
    tracer.export_chrome(str(trace_path))
    doc = json.loads(trace_path.read_text())
    bitwise = same_bits(traced.params, untraced.params)
    emit(phase="obs_sync", setting="federated-arc", rounds=exp.rounds,
         local_epochs=exp.local_epochs, events=len(tracer.events()), dropped=tracer.dropped,
         span_counts=span_counts,
         span_seconds={name: row["total_s"] for name, row in summary.items()},
         round_times_s={k: [r.round_time_s for r in v[0].history] for k, v in runs.items()},
         round_span_s=round_spans, trace_bytes=trace_path.stat().st_size,
         trace_events=len(doc["traceEvents"]), bitwise=bitwise,
         max_param_diff=param_diff(traced.params, untraced.params),
         launches={k: v[1] for k, v in runs.items()},
         seconds={k: v[2] for k, v in runs.items()})
    require(bitwise, "the traced arc run's params differ from the untraced run's")
    require(runs["traced"][1] == runs["untraced"][1],
            f"the tracer changed the launches: {runs['traced'][1]} vs {runs['untraced'][1]}")
    require(round_spans == [r.round_time_s for r in traced.history],
            "the round spans differ from the records' round_time_s")
    want = {"select": exp.rounds, "train": exp.rounds, "round": exp.rounds, "stage": exp.rounds}
    require(span_counts == want, f"span counts {span_counts}, predicted {want}")
    require(tracer.dropped == 0, f"the tracer dropped {tracer.dropped} events")
    del traced, untraced, runs, doc

    # (b) the recruited 35 on the async runtime, traced
    exp_b = ExperimentConfig(rounds=2, local_epochs=1)
    recruited = policies_for("federated-arc", ExperimentConfig())["recruitment"]
    atracer = Tracer()
    fed = async_federation(torch, cohort, exp_b, tracer=atracer, recruitment=recruited,
                           aggregator="fedbuff:0.25", latency="lognormal:0.6", dropout=0.05)
    result, seconds, counts = run_async(torch, K, fed)
    stats = fed.last_run_stats
    check_launches("observability async", add(counts), stats["steps_trained"], 0)
    host_flushes = atracer.spans("flush", clock="host")
    marks = [e for e in atracer.events() if e.name == "flush" and e.clock == "virtual"
             and e.phase == "i" and e.track == "server"]
    tasks = atracer.spans("task", clock="virtual")
    flows = [e.phase for e in atracer.events() if e.flow_id is not None]
    history = result.history
    emit(phase="obs_async", federation="recruited", aggregator="fedbuff:0.25",
         latency="lognormal:0.6", dropout=0.05, **async_fields(fed, result, seconds),
         events=len(atracer.events()), dropped_events=atracer.dropped,
         span_counts={k: int(v["count"]) for k, v in atracer.summary()["host"].items()},
         virtual_span_counts={k: int(v["count"])
                              for k, v in atracer.summary().get("virtual", {}).items()},
         task_spans=len(tasks), flow_starts=flows.count("s"), flow_ends=flows.count("f"),
         scheduler_instants=sum(e.track == "scheduler" for e in atracer.events()),
         flush_span_s=[s.dur for s in host_flushes], launches=counts)
    require([s.dur for s in host_flushes] == [r.round_time_s for r in history],
            "the host flush spans differ from the records' round_time_s")
    require([s.args["virtual_time"] for s in host_flushes] == [r.virtual_time for r in history]
            and [m.ts for m in marks] == [r.virtual_time for r in history],
            "the flush spans differ from the records' virtual_time")
    require(len(tasks) == stats["tasks"], f"{len(tasks)} task spans for {stats['tasks']} tasks")
    require(flows.count("s") == flows.count("f") == len(tasks),
            f"flow starts {flows.count('s')}, ends {flows.count('f')}, tasks {len(tasks)}")
    require(atracer.dropped == 0, f"the async tracer dropped {atracer.dropped} events")
    del fed, result, history
    torch.cuda.empty_cache()

    # (c) the arc job, traced and profiled, through the CLI: cut, resumed
    exp_c = ExperimentConfig(rounds=3)
    spec = job_spec_for("federated-arc", exp_c, seed=0)
    traced_spec = {**spec, "observability": {"trace": True, "jax_profile_rounds": 1}}
    spec_path = work / "arc-obs.json"
    spec_path.write_text(json.dumps(traced_spec))
    run_dir = work / "traced"
    rc1, child1, seconds1 = run_cli_child(
        "submit", "--spec", str(spec_path), "--run-dir", str(run_dir), "--preempt-after", "1",
        "--quiet", "--device", "cuda", child=OBS_CHILD)
    require(rc1 == EX_TEMPFAIL, f"the traced CLI submit exited {rc1}, not {EX_TEMPFAIL}")
    rc2, child2, seconds2 = run_cli_child("resume", "--run-dir", str(run_dir), "--quiet",
                                          "--device", "cuda", child=OBS_CHILD)
    require(rc2 == 0, f"the traced CLI resume exited {rc2}")
    recs = read_records(str(run_dir / "records.jsonl"))
    require([r.round_index for r in recs] == [0, 1, 2], f"records {[r.round_index for r in recs]}")
    steps = [schedule_steps([r], sizes, exp_c.batch_size, exp_c.local_epochs) for r in recs]
    counts1 = {k: child1[k] for k in total}
    counts2 = {k: child2[k] for k in total}
    check_launches("observability job (submit)", add(counts1), steps[0], 0)
    check_launches("observability job (resume)", add(counts2), sum(steps[1:]), 0)
    lines = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()
             if line.strip()]
    jdoc = json.loads((run_dir / "trace.json").read_text())
    job_rounds = [e for e in jdoc["traceEvents"] if e["name"] == "round" and e["ph"] == "X"]
    report_proc = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report",
                                  str(run_dir)], env=child_env(), capture_output=True,
                                 text=True, timeout=300)
    profilers = child1["profilers"] + child2["profilers"]
    profiled = {Path(p["trace_path"]).name: profiled_kernels(p["trace_path"])
                for p in profilers if p["trace_path"]}
    jit = [{"round_index": line["round_index"],
            "jit.compiles": line["counters"].get("jit.compiles", 0),
            "jit.compile_time_s": line["counters"].get("jit.compile_time_s", 0.0),
            "jit.round_compiles": line["gauges"].get("jit.round_compiles")} for line in lines]
    plain_dir = work / "plain"
    torch.cuda.synchronize()
    reset_gru_counts(K)
    submit_job(spec, str(plain_dir), device="cuda")
    check_launches("observability job (untraced)", add(gru_counts(K)), sum(steps), 0)
    a, b = final_arrays(run_dir), final_arrays(plain_dir)
    job_bitwise = all(a[k].tobytes() == b[k].tobytes() for k in a) and sorted(a) == sorted(b)
    emit(phase="obs_job", setting="federated-arc", rounds=exp_c.rounds,
         cli_exit_codes=[rc1, rc2], seconds={"submit": seconds1, "resume": seconds2},
         records=[r.round_index for r in recs], metrics_lines=[x["round_index"] for x in jit],
         jit=jit, trace_round_spans=[e["args"]["round"] for e in job_rounds],
         trace_events=len(jdoc["traceEvents"]), profilers=profilers, profiled=profiled,
         profiled_steps={"rounds_0": steps[0], "rounds_1": steps[1]},
         report_exit_code=report_proc.returncode, report_lines=len(report_proc.stdout.splitlines()),
         bitwise_vs_untraced=job_bitwise, launches={"submit": counts1, "resume": counts2})
    print(report_proc.stdout, flush=True)
    require([x["round_index"] for x in jit] == [r.round_index for r in recs]
            and [line["counters"]["rounds.completed"] for line in lines] == [1, 2, 3],
            f"metrics.jsonl is not in lockstep with records.jsonl: {jit}")
    require([e["args"]["round"] for e in job_rounds] == [1, 2],
            f"trace.json holds rounds {[e['args']['round'] for e in job_rounds]}, not [1, 2]")
    require([e["dur"] for e in job_rounds] == [r.round_time_s * 1e6 for r in recs[1:]],
            "the job's round spans differ from its records")
    require(report_proc.returncode == 0 and "per-phase time" in report_proc.stdout,
            f"the report CLI exited {report_proc.returncode}: {report_proc.stderr[-2000:]}")
    require(len(profilers) == 2 and all(p["error"] is None and p["trace_path"]
                                        for p in profilers),
            f"the children's profilers: {profilers}")
    require(sorted(profiled) == ["rounds_0.pt.trace.json", "rounds_1.pt.trace.json"]
            and all(c[name] > 0 for c in profiled.values() for name in GRU_DEVICE_KERNELS),
            f"the profiled rounds lack the GRU kernels' device events: {profiled}")
    require(jit[0]["jit.compiles"] >= 1 and jit[0]["jit.round_compiles"] >= 1,
            f"the submitting child counted no library load: {jit[0]}")
    require(jit[1]["jit.round_compiles"] >= 1 and jit[2]["jit.round_compiles"] == 0,
            f"the resumed child's jit.round_compiles: {jit[1:]}")
    require(job_bitwise, "the traced, profiled, resumed job's params differ from an "
            "untraced job's")

    # (d) the overhead probes (not gated).  Cut: one repeat of 3 async
    # flushes, not 3 of 10 (each repeat ~15 s), to keep the script inside its
    # time limit.
    # Under constant latency every flush re-dispatches all 189 clients
    # (~1.5 s a flush on the card), so 10 flushes cost ~60 s of the phase.
    torch.cuda.synchronize()
    reset_gru_counts(K)
    t0 = time.perf_counter()
    sample = work / "obs_async_trace.json"
    obs = run_obs_overhead(repeats=1, flushes=3, verbose=False, device="cuda",
                           trace_path=str(sample))
    obs_seconds = time.perf_counter() - t0
    obs_counts = add(gru_counts(K))
    # The last async run's host and virtual phases, from its own trace.
    sample_phases = phase_breakdown(json.loads(sample.read_text())["traceEvents"])
    emit(phase="obs_overhead", **obs, floor_spread_frac={k: spread(v)
                                                          for k, v in obs["floors"].items()},
         sample_phases=sample_phases, seconds=obs_seconds, launches=obs_counts)
    reset_gru_counts(K)
    t0 = time.perf_counter()
    facade = run_facade_overhead(repeats=2, verbose=False, device="cuda")
    facade_seconds = time.perf_counter() - t0
    facade_counts = add(gru_counts(K))
    emit(phase="facade_overhead", **facade,
         floor_spread_frac={"bare": spread(facade["bare_floors"]),
                            "facade": spread(facade["facade_floors"])},
         seconds=facade_seconds, launches=facade_counts)
    require(obs_counts["gru_scan"] == obs_counts["gru_scan_bwd"]
            and facade_counts["gru_scan"] == facade_counts["gru_scan_bwd"],
            f"a one-layer probe's launches: {obs_counts}, {facade_counts}")
    shutil.rmtree(work, ignore_errors=True)
    emit(phase="observability_seconds", seconds=time.perf_counter() - t_phase)
    return total


# ---------------------------------------------------------------------------
# phase 23: the population sweep, the paper's tables, the recompute analysis
# ---------------------------------------------------------------------------

POP_PARITY_TOL = 1e-5        # a pooled population round, card against CPU (phase 23)
TABLES_SEEDS = [0, 1]        # two seeds: Welch's test needs its degrees of freedom
FIG2_GAMMA_THS = [0.1, 1.0]
ANALYSIS_GRU = (COHORT, 128, 24, 32)        # C, B, T, N: the ARC cohort's batched step
ANALYSIS_SSD = SSD_CASES[2][1:]             # B, NC, L, H, P, N: the reduced config


def add_counts(total: dict[str, int], counts: dict[str, int]) -> None:
    for kernel, n in counts.items():
        total[kernel] = total.get(kernel, 0) + n


def run_population_part(torch, K) -> dict[str, int]:
    """(a) ``run_population_scale()`` at its defaults (10^3, 10^4, 10^5
    clients, 3 rounds of 64 out of a 256-row pool): its own assertions are
    the gates; each GRU kernel launches once a batched step (one layer); one
    pooled round at 10^3 on the card against the CPU from one init."""
    from repro_torch.experiments import population as pop
    from repro_torch.models.gru import init_gru

    torch.cuda.synchronize()
    reset_gru_counts(K)
    t0 = time.perf_counter()
    report = pop.run_population_scale(device="cuda")
    seconds = time.perf_counter() - t0
    counts = gru_counts(K)
    steps = sum(sum(e["cohort_steps"]) for e in report["entries"])
    fields = ("population", "recruitment_ingest_s", "recruitment_ingest_us_per_client",
              "recruitment_decision_s", "recruitment_exact_s", "membership_ns_per_lookup",
              "round_time_s", "round_times_s", "cohort_steps", "streaming_mode",
              "num_recruited_streaming", "num_recruited_exact", "participant_match",
              "pool_rows", "pool_uploads_total", "pool_evictions_total", "pool_bytes_resident",
              "last_round_pool_uploads", "slice_chunks_last_round")
    emit(phase="population", seconds=seconds, launches=counts,
         entries=[{k: e.get(k) for k in fields} for e in report["entries"]],
         **{k: report[k] for k in ("population_ratio", "recruitment_decision_ratio",
                                   "round_time_ratio", "membership_ns_ratio",
                                   "recruitment_sublinear", "round_sublinear")})
    want = {"gru_scan": pop.MODEL.num_layers * steps, "gru_scan_bwd": pop.MODEL.num_layers * steps}
    require(counts == want, f"population launches {counts}, the rounds' batched steps give {want}")
    require(report["populations"] == [1_000, 10_000, 100_000]
            and all(e["pool_rows"] == 256 for e in report["entries"]),
            f"population sweep {report['populations']}")

    clients = pop.synthetic_population_clients(1_000, seed=0)
    params0 = init_gru(torch.Generator().manual_seed(0), pop.MODEL, "cpu")
    rounds = {dev: pop.pooled_rounds(clients, params0, rounds=1, device=dev)
              for dev in ("cuda", "cpu")}
    diff = param_diff(rounds["cuda"]["params"], rounds["cpu"]["params"])
    pools = {dev: (r["device_cohort"].uploads, r["device_cohort"].evictions)
             for dev, r in rounds.items()}
    emit(phase="population_parity", population=1_000, max_param_diff=diff, pools=pools)
    require(diff <= POP_PARITY_TOL, f"a pooled round on the card and the CPU differ by {diff}")
    require(pools["cuda"] == pools["cpu"], f"the pools differ: {pools}")
    return counts


def run_tables_part(torch, K) -> dict[str, int]:
    """(b) Tables 4 and 5 and Fig. 2 at the paper's width, cut in depth:
    finite metrics; federation sizes equal to the CPU's recruitment of the
    same cohorts; two launches of each GRU kernel a batched (or central)
    step and two of the forward a predict batch."""
    import dataclasses

    from repro_torch.data.pipeline import build_client_datasets, global_dataset
    from repro_torch.data.synth_eicu import Cohort
    from repro_torch.experiments import tables
    from repro_torch.experiments.paper import ExperimentConfig, build_cohort, policies_for
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    exp = ExperimentConfig(rounds=1, local_epochs=1, central_epochs=1)
    reduced = {"rounds": [exp.rounds, 15], "local_epochs": [exp.local_epochs, 4],
               "central_epochs": [exp.central_epochs, 15], "seeds": [TABLES_SEEDS, [0, 1, 2]],
               "fig2_gamma_th": [FIG2_GAMMA_THS, list(tables.FIG2_GAMMA_THS)],
               "fig2_seeds": [[0], [0, 1]]}
    outs, counts, seconds = {}, {}, {}
    torch.cuda.synchronize()
    for part, call in (("table4", lambda: tables.run_table4(exp, TABLES_SEEDS)),
                       ("table5", lambda: tables.run_table5(exp, TABLES_SEEDS)),
                       ("fig2", lambda: tables.run_fig2(exp, [0], FIG2_GAMMA_THS))):
        reset_gru_counts(K)
        t0 = time.perf_counter()
        outs[part] = call()
        seconds[part] = time.perf_counter() - t0
        counts[part] = gru_counts(K)
    t4, t5, fig2 = outs["table4"], outs["table5"], outs["fig2"]
    print(tables.to_markdown_table4(t4), flush=True)
    print(tables.to_markdown_table4(t5), flush=True)

    # What the runs imply, and the federations the CPU's recruitment gives.
    cohorts = {seed: build_cohort(exp, seed) for seed in TABLES_SEEDS}
    clients = {seed: build_client_datasets(c) for seed, c in cohorts.items()}
    predict = {seed: math.ceil(len(global_dataset(c, Cohort.TEST)) / 2048)
               for seed, c in cohorts.items()}

    def cpu_federation(setting: str, e, seed: int) -> int:
        fed = Federation(FederationConfig(**policies_for(setting, e), seed=seed), clients[seed],
                         make_loss_fn(GRUConfig()), AdamW(), device="cpu")
        return int(fed.build_federation()[0].size)

    sizes = {}
    for part, table in (("table4", t4), ("table5", t5)):
        steps = batches = 0
        for setting, agg in table.items():
            for run in agg["runs"]:
                steps += run["local_steps"] if setting == "central" else run["cohort_steps"]
                batches += predict[run["seed"]]
                require(all(math.isfinite(v) for v in run["metrics"].values()),
                        f"{setting} seed {run['seed']}: metrics not finite: {run['metrics']}")
                if setting != "central":
                    sizes[f"{setting}/{run['seed']}"] = (
                        run["federation_size"], cpu_federation(setting, exp, run["seed"]))
        check_launches(part, counts[part], steps, batches)
    for point in fig2:
        e = dataclasses.replace(exp, gamma_th=point["gamma_th"])
        sizes[f"fig2/{point['gamma_th']}"] = (point["recruited"],
                                             cpu_federation("federated-src", e, 0))
        require(all(math.isfinite(point[m]["mean"]) for m in ("msle", "mae")),
                f"fig2 at gamma_th {point['gamma_th']}: {point}")
    fig2_launches = counts["fig2"]
    emit(phase="tables", reduced=reduced, seconds=seconds,
         tau_s={s: agg["tau_s"]["values"] for s, agg in {**t4, **t5}.items()},
         msle={s: agg["msle"]["values"] for s, agg in {**t4, **t5}.items()},
         significance_vs_sc={s: {m: v["p"] for m, v in agg["significance_vs_sc"].items()}
                             for s, agg in t4.items()},
         fig2=[{k: p[k] for k in ("gamma_th", "recruited", "local_steps")} for p in fig2],
         federation_sizes=sizes, launches=counts)
    require(all(card == cpu for card, cpu in sizes.values()),
            f"federation sizes differ from the CPU's recruitment: {sizes}")
    require(sizes["federated-arc/0"][0] == COHORT, f"arc recruited {sizes['federated-arc/0']}")
    # run_fig2 returns no batched-step counts: its backward launched, and its
    # forward's extra launches are its predict batches'.
    require(fig2_launches["gru_scan_bwd"] > 0 and fig2_launches["gru_scan"]
            - fig2_launches["gru_scan_bwd"] == 2 * predict[0] * len(FIG2_GAMMA_THS),
            f"fig2 launches {fig2_launches}")
    total: dict[str, int] = {}
    for c in counts.values():
        add_counts(total, c)
    return total


def run_analysis_part(torch, K, SK) -> dict[str, int]:
    """(c) ``recompute_elimination_report`` on the card: the GRU pair at the
    ARC cohort's batched step, the SSD pair at the reduced config.  The
    residual backward launches its backward kernel once and no forward; the
    oracle's launches no backward kernel; over the whole report the forward
    kernel launched twice (the residual's forward and the oracle's)."""
    from repro_torch.kernels.analysis import recompute_elimination_report
    from repro_torch.kernels.gru_scan.ops import GRUScan, gru_scan_oracle
    from repro_torch.kernels.ssd.ops import ssd_chunk_scan, ssd_chunk_scan_oracle

    dev = torch.device("cuda")
    c, b, t, n = ANALYSIS_GRU
    xg, w, bias, _ = gru_inputs(torch, dev, c, b, t, n, seed=230)
    x, dt, a, bm, cm = ssd_inputs(torch, dev, ANALYSIS_SSD, seed=231)
    ssd_args = (x, dt, torch.cumsum(dt * a, dim=2), bm, cm)
    wrappers = (K.gru_scan, K.gru_scan_bwd, SK.ssd_chunk_scan, SK.ssd_chunk_scan_bwd)
    total: dict[str, int] = {}
    for name, residual, oracle, args, fwd, bwd in (
        ("gru_scan", GRUScan.apply, gru_scan_oracle, (xg, w, bias), "gru_scan", "gru_scan_bwd"),
        ("ssd_chunk_scan", ssd_chunk_scan, ssd_chunk_scan_oracle, ssd_args,
         "ssd_chunk_scan", "ssd_chunk_scan_bwd"),
    ):
        torch.cuda.synchronize()
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        rep = recompute_elimination_report(residual, oracle, *args)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in wrappers}
        emit(phase="analysis", pair=name, seconds=time.perf_counter() - t0, launches=counts, **rep)
        res, orc = rep["residual_bwd"], rep["oracle_bwd"]
        require(rep["recompute_eliminated"], f"{name}: recompute not eliminated: {rep}")
        require(res["launches"][bwd] == 1 and res["launches"][fwd] == 0,
                f"{name}: the residual backward launched {res['launches']}")
        require(orc["launches"][bwd] == 0, f"{name}: the oracle backward launched {orc['launches']}")
        want = {k: 0 for k in counts} | {fwd: 2, bwd: 1}
        require(counts == want, f"{name}: the report launched {counts}, expected {want}")
        add_counts(total, counts)
    return total


def run_tables_phase(torch, K, SK) -> dict[str, int]:
    """Phase 23: (a) population, (b) tables, (c) analysis; their launches."""
    t_phase = time.perf_counter()
    total: dict[str, int] = {}
    for part in (lambda: run_population_part(torch, K), lambda: run_tables_part(torch, K),
                 lambda: run_analysis_part(torch, K, SK)):
        add_counts(total, part())
    emit(phase="tables_phase_seconds", seconds=time.perf_counter() - t_phase, launches=total)
    return total


# ---------------------------------------------------------------------------
# phase 24: the attention families of the LM zoo (dense, VLM, hybrid)
# ---------------------------------------------------------------------------

LM_PARITY_CASES = (
    # name, arch, changes to its reduced config
    ("smollm-135m", "smollm-135m", {}),          # GQA group 2, tied head
    ("qwen3-1.7b", "qwen3-1.7b", {}),            # qk-norm, group 1
    ("yi-9b", "yi-9b", {}),
    ("nemotron-4-15b", "nemotron-4-15b", {}),    # squared ReLU
    ("internvl2-26b", "internvl2-26b", {}),      # 8 patches prepended
    ("zamba2-7b", "zamba2-7b", {}),              # 1 group, no tail
    ("qwen3-group2", "qwen3-1.7b", {"num_kv_heads": 2}),
    ("zamba2-5layers", "zamba2-7b", {"num_layers": 5}),   # 2 groups and a tail layer
)
LM_PARITY_B, LM_PARITY_S = 2, 40     # 40 is ragged against the reduced SSD chunk of 16
LM_B, LM_PROMPT = 8, 2048            # (b) and (c): the prefill calls
LM_FEED = 16                         # prompt tokens fed through the decode path before generating
LM_TRAIN_B = (8, 4, 2)               # (b): the largest that fits
HYBRID_TRAIN_LAYERS = 60             # (c): 10 of zamba2-7b's 13 groups, 50 Mamba layers
WIDE_ARCHS = ("yi-9b", "nemotron-4-15b", "internvl2-26b")   # (d): full width, 2 layers
WIDE_B, WIDE_S, WIDE_GEN = 2, 512, 8
FED_C, FED_K, FED_B, FED_S = 4, 3, 2, 256   # (e)
FED_WEIGHTS = (120.0, 0.0, 80.0, 40.0)      # slot 1: a client recruitment excluded


def lm_inputs(torch, cfg, b: int, s: int, seed: int) -> dict:
    """Tokens and labels from ``lm_token_batch``; the VLM's patch
    embeddings, or the encoder-decoder's max(s // 4, 8) frame embeddings,
    drawn right after them from the same numpy stream (as ``train.py``)."""
    import numpy as np

    from repro_torch.data.pipeline import lm_token_batch
    from repro_torch.models.zoo import Model

    rng = np.random.default_rng(seed)
    batch = lm_token_batch(rng, b, s, cfg.vocab_size)
    if cfg.arch_type.value == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type.value == "encdec":
        batch["src_embeds"] = rng.normal(
            size=(b, Model.encoder_frames(s), cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def decode_through(model, params, batch, cache, greedy: int = 0):
    """The VLM's patches (``token_embeds``), then ``batch``'s tokens, then
    ``greedy`` argmax tokens through ``decode_step``; returns each token
    step's logits, the generated tokens and the cache."""
    import torch

    pos = 0
    patches = batch.get("patch_embeds")
    with torch.inference_mode():
        for i in range(0 if patches is None else patches.shape[1]):
            _, cache = model.decode_step(params, None, cache, pos, token_embeds=patches[:, i:i + 1])
            pos += 1
        logits, generated = [], []
        toks = batch["tokens"]
        for t in range(toks.shape[1]):
            lg, cache = model.decode_step(params, toks[:, t:t + 1], cache, pos)
            logits.append(lg)
            pos += 1
        for _ in range(greedy):
            tok = torch.argmax(logits[-1], dim=-1)[:, None]
            generated.append(tok)
            lg, cache = model.decode_step(params, tok, cache, pos)
            logits.append(lg)
            pos += 1
    return logits, generated, cache


def check_lm_zoo_parity(torch) -> None:
    """(a) Each reduced config of the slice, and the group-2 and 5-layer
    hybrid variants, in float32: logits, the loss and every gradient leaf
    on the card against the CPU (a leaf held to MAMBA_TOL times its own
    max|ref|, the hybrid's A_log and dt_bias to DECAY_GRAD_TOL, as phase
    10), and the card's decode path (patches included) against its own
    forward at the reference's decode tolerance."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import Model
    from repro_torch.tree import tree_map

    failures = []
    for name, arch, changes in LM_PARITY_CASES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        model = Model(cfg, remat=False)
        params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda t: t.to("cuda"), params_cpu)
        batch = lm_inputs(torch, cfg, LM_PARITY_B, LM_PARITY_S, seed=24)
        batch_card = {k: v.cuda() for k, v in batch.items()}
        with torch.inference_mode():
            lg_cpu = model.forward_logits(params_cpu, batch)
            lg_card = model.forward_logits(params, batch_card)
        loss_cpu, g_cpu = loss_and_grads(torch, model, params_cpu, batch)
        loss_card, g_card = loss_and_grads(torch, model, params, batch_card)
        n_patch = cfg.num_frontend_tokens if "patch_embeds" in batch else 0
        cache = model.init_cache(LM_PARITY_B, n_patch + LM_PARITY_S, "cuda")
        dec, _, _ = decode_through(model, params, batch_card, cache)
        torch.cuda.synchronize()
        dec = torch.stack(dec, dim=1)
        by_leaf = sorted(((leaf_err(g.cpu(), r), q) for q, g, r in
                          zip(leaf_paths(params_cpu), g_card, g_cpu)), reverse=True)
        decay = [(e, q) for e, q in by_leaf if q.endswith(DECAY_LEAVES)]
        other = [(e, q) for e, q in by_leaf if not q.endswith(DECAY_LEAVES)]
        e = {"logits": scaled_err(lg_card.cpu(), lg_cpu),
             "loss": scaled_err(loss_card.cpu(), loss_cpu), "grad_leaf_worst": other[0][0]}
        dec_gap = (dec - lg_card).abs()
        dec_ok = bool((dec_gap <= DECODE_ATOL + DECODE_RTOL * lg_card.abs()).all())
        finite = all(bool(torch.isfinite(t).all()) for t in (lg_card, dec, loss_card, *g_card))
        emit(phase="lm_parity", case=name, arch=arch, changes=changes, B=LM_PARITY_B,
             S=LM_PARITY_S, patches=n_patch, dtype=cfg.dtype, card_vs_cpu_scaled_err=e,
             grad_leaf_err_worst=other[:3], grad_leaf_err_decay=decay[:2],
             decode_vs_prefill_max_abs=float(dec_gap.max()), decode_within_tol=dec_ok,
             seconds=time.perf_counter() - t0)
        if not finite:
            failures.append(f"{name}: non-finite outputs")
        if max(e.values()) > MAMBA_TOL or (decay and decay[0][0] > DECAY_GRAD_TOL):
            failures.append(f"{name}: card against CPU {e}, {other[0]}, {decay[:1]}")
        if not dec_ok:
            failures.append(f"{name}: decode against prefill {float(dec_gap.max())}")
    require(not failures, "; ".join(failures))


def lm_serve(torch, SK, model, params, calls: int, gen: int, ssd_per_call: int,
             b: int = LM_B, frames: int = 0) -> tuple[dict, dict]:
    """``make_prefill_step`` at ``b`` x LM_PROMPT, ``calls`` times (the first
    cold; with ``frames`` source frames for the encoder-decoder); then,
    against a cache of LM_PROMPT + ``gen`` slots (a step attends over every
    slot, masked, so its cost is that of a full context; the encoder's
    K/V put in by ``encode_for_decode`` first), LM_FEED prompt tokens and
    ``gen`` greedy tokens through ``make_serve_step``.  Prefill calls must
    launch ``ssd_chunk_scan`` ``ssd_per_call`` times each, decode steps
    never.  Returns the numbers and the last cache."""
    import numpy as np

    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = model.cfg
    toks = prompt_tokens(torch, cfg.vocab_size, b, LM_PROMPT, seed=0).cuda()
    batch = {"tokens": toks}
    if frames:
        batch["src_embeds"] = torch.from_numpy(np.random.default_rng(1).normal(
            size=(b, frames, cfg.d_model)).astype(np.float32)).cuda()
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call_s, per_call = [], []
    for _ in range(calls):
        before = SK.ssd_chunk_scan.launches
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        per_call.append(SK.ssd_chunk_scan.launches - before)
    prefill_peak = torch.cuda.max_memory_allocated()
    short = prefill(params, {**batch, "tokens": toks[:, :LM_FEED]})

    before = SK.ssd_chunk_scan.launches
    cache = model.init_cache(b, LM_PROMPT + gen, "cuda")
    t0 = time.perf_counter()
    if frames:
        with torch.inference_mode():
            cache = model.encode_for_decode(params, batch["src_embeds"], cache)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    feed_logits = None
    for t in range(LM_FEED):
        feed_logits, cache = serve(params, toks[:, t:t + 1], cache, t)
    tok = torch.argmax(feed_logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generated = []
    for k in range(gen):
        lg, cache = serve(params, tok, cache, LM_FEED + k)
        tok = torch.argmax(lg, dim=-1)[:, None]
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = SK.ssd_chunk_scan.launches - before
    warm = call_s[1:] or call_s
    out = dict(B=b, prompt=LM_PROMPT, frames=frames, prefill_call_s=call_s,
               prefill_tokens_per_s=b * LM_PROMPT * len(warm) / sum(warm),
               prefill_peak_mem_gb=prefill_peak / 1e9, ssd_launches_per_prefill=per_call,
               encode_for_decode_s=encode_s if frames else None,
               feed=LM_FEED, gen=gen, decode_tokens_per_s=b * gen / decode_s,
               decode_step_ms=decode_s / gen * 1e3, decode_ssd_launches=decode_launches,
               bf16_decode_vs_prefill_max_abs=float((feed_logits - short).abs().max()),
               sample=torch.cat(generated, dim=1)[0, :16].tolist(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               finite=[bool(torch.isfinite(t).all()) for t in (logits, short, lg)])
    require(all(out["finite"]), f"{cfg.name} serving outputs not finite: {out['finite']}")
    require(all(n == ssd_per_call for n in per_call),
            f"{cfg.name}: prefill calls launched ssd_chunk_scan {per_call}, not {ssd_per_call}")
    require(decode_launches == 0, f"{cfg.name}: decode launched ssd_chunk_scan {decode_launches}")
    return out, cache


def lm_train(torch, SK, model, params, batch_sizes, steps: int, frames: int | None = None) -> dict:
    """``steps`` ``make_train_step`` calls with AdamW(TRAIN_LR) at the largest
    of ``batch_sizes`` that fits x LM_PROMPT tokens, on one fixed batch (and
    ``frames`` source frames for the encoder-decoder): step times, losses,
    the last step's metrics, peak memory and SSD launches a step."""
    import gc

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW

    cfg = model.cfg
    opt = AdamW(TRAIN_LR)
    step = make_train_step(model, opt)
    tried = []
    for b in batch_sizes:
        batch = {k: v.cuda() for k, v in lm_batch(torch, cfg.vocab_size, b, LM_PROMPT, 1).items()}
        if frames:
            g = torch.Generator(device="cuda").manual_seed(1)
            batch["src_embeds"] = torch.randn(b, frames, cfg.d_model, device="cuda", generator=g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, losses, per_step = [], [], []
        try:
            state = opt.init(params)
            for _ in range(steps):
                before = (SK.ssd_chunk_scan.launches, SK.ssd_chunk_scan_bwd.launches)
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))  # waits for the step
                step_s.append(time.perf_counter() - t0)
                per_step.append((SK.ssd_chunk_scan.launches - before[0],
                                 SK.ssd_chunk_scan_bwd.launches - before[1]))
        except torch.cuda.OutOfMemoryError:
            tried.append(b)
        else:
            return dict(B=b, seq=LM_PROMPT, lr=TRAIN_LR, out_of_memory_at_B=tried,
                        step_s=step_s, tokens_per_s=b * LM_PROMPT / step_s[-1], losses=losses,
                        metrics={k: float(v) for k, v in metrics.items()},
                        ssd_launches_per_step=per_step,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        finally:
            state = batch = None
        gc.collect()
        torch.cuda.empty_cache()
    require(False, f"{cfg.name}: no train batch of {batch_sizes} fits")


def run_lm_zoo_phase(torch, SK) -> dict[str, int]:
    """Phase 24: (a) parity at the reduced configs; (b) qwen3-1.7b and (c)
    zamba2-7b at full width and depth, bfloat16, served and trained; (d)
    yi-9b, nemotron-4-15b and internvl2-26b at full width cut to 2 layers;
    (e) the federated LM round at full-width smollm-135m.  Returns the SSD
    launches of (c)'s prefill calls and train step, the main path's."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_fed_round_step, make_prefill_step
    from repro_torch.models.transformer import hybrid_layout
    from repro_torch.models.zoo import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    check_lm_zoo_parity(torch)

    def init(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        return params, time.perf_counter() - t0

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # (b) qwen3-1.7b: 4 prefill calls, 64 decode tokens, a train step
    cfg = get_config("qwen3-1.7b")
    params, init_s = init(cfg)
    serve, _ = lm_serve(torch, SK, Model(cfg), params, calls=4, gen=64, ssd_per_call=0)
    trained = lm_train(torch, SK, Model(cfg), params, LM_TRAIN_B, steps=2)
    emit(phase="lm_dense", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
         params=sum(t.numel() for t in tree_leaves(params)), init_s=init_s, serve=serve,
         train=trained)
    require(all(math.isfinite(v) for v in trained["losses"]), f"qwen3 losses {trained['losses']}")
    del params
    release()

    # (c) zamba2-7b: prefill calls and 32 decode tokens at full depth; a train step cut in depth
    cfg = get_config("zamba2-7b")
    groups, per_group, tail = hybrid_layout(cfg)
    mamba_layers = groups * per_group + tail
    params, init_s = init(cfg)
    before = SK.ssd_chunk_scan.launches
    serve, _ = lm_serve(torch, SK, Model(cfg), params, calls=2, gen=32, ssd_per_call=mamba_layers)
    launches = {"ssd_chunk_scan": SK.ssd_chunk_scan.launches - before}
    del params
    release()
    cut = dataclasses.replace(cfg, num_layers=HYBRID_TRAIN_LAYERS)
    g, pg, tl = hybrid_layout(cut)
    cut_layers = g * pg + tl
    params, cut_init_s = init(cut)
    before = (SK.ssd_chunk_scan.launches, SK.ssd_chunk_scan_bwd.launches)
    trained = lm_train(torch, SK, Model(cut), params, (1,), steps=1)
    launches["ssd_chunk_scan"] += SK.ssd_chunk_scan.launches - before[0]
    launches["ssd_chunk_scan_bwd"] = SK.ssd_chunk_scan_bwd.launches - before[1]
    emit(phase="lm_hybrid", arch=cfg.name, dtype=cfg.dtype, layout=[groups, per_group, tail],
         init_s=init_s, serve=serve, train=trained, train_init_s=cut_init_s,
         train_layout=[g, pg, tl],
         reduced={"train_num_layers": [HYBRID_TRAIN_LAYERS, cfg.num_layers],
                  "why": "AdamW's functional update holds the old and new moments at once: "
                         "7 bf16 copies of 5.74 B params (80.3 GB) do not fit in 80 GB"},
         launches=launches)
    require(all(math.isfinite(v) for v in trained["losses"]), f"zamba2 losses {trained['losses']}")
    require(trained["ssd_launches_per_step"] == [(2 * cut_layers, cut_layers)],
            f"zamba2 train step SSD launches {trained['ssd_launches_per_step']}, expected "
            f"{(2 * cut_layers, cut_layers)} (remat: the forward twice)")
    del params
    release()

    # (d) the widest dense and VLM configs at full width, 2 layers
    for arch in WIDE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        model = Model(cfg)
        params, init_s = init(cfg)
        batch = {k: v.cuda() for k, v in lm_inputs(torch, cfg, WIDE_B, WIDE_S, seed=25).items()}
        t0 = time.perf_counter()
        logits = make_prefill_step(model)(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        n_patch = cfg.num_frontend_tokens if "patch_embeds" in batch else 0
        cache = model.init_cache(WIDE_B, n_patch + 1 + WIDE_GEN, "cuda")
        t0 = time.perf_counter()
        dec, generated, _ = decode_through(model, params, {**batch, "tokens": batch["tokens"][:, :1]},
                                           cache, greedy=WIDE_GEN)
        torch.cuda.synchronize()
        finite = [bool(torch.isfinite(t).all()) for t in (logits, *dec)]
        emit(phase="lm_wide", arch=arch, dtype=cfg.dtype, d_model=cfg.d_model,
             reduced={"num_layers": [2, get_config(arch).num_layers]}, init_s=init_s,
             B=WIDE_B, S=WIDE_S, patches=n_patch, prefill_s=prefill_s,
             decode_s=time.perf_counter() - t0, decode_steps=n_patch + 1 + WIDE_GEN,
             sample=torch.cat(generated, dim=1)[0].tolist(), finite=all(finite),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        require(all(finite), f"{arch}: non-finite outputs {finite}")
        del params, batch, cache
        release()

    # (e) the federated LM round at full-width smollm-135m
    cfg = get_config("smollm-135m")
    model = Model(cfg)
    one, _ = init(cfg)
    params_c = tree_map(lambda t: t[None].expand(FED_C, *t.shape).clone(), one)
    del one
    opt = AdamW(TRAIN_LR)
    toks = np.random.default_rng(26).integers(0, cfg.vocab_size, (FED_C, FED_K, FED_B, FED_S + 1))
    batches = {"tokens": torch.from_numpy(toks[..., :-1].copy()).cuda(),
               "labels": torch.from_numpy(toks[..., 1:].copy()).cuda()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params_c, state, loss = make_fed_round_step(model, opt)(params_c, opt.init(params_c), batches,
                                                            FED_WEIGHTS)
    loss = float(loss)
    round_s = time.perf_counter() - t0
    leaves = tree_leaves(params_c)
    equal = all(torch.equal(leaf[c], leaf[0]) for leaf in leaves for c in range(1, FED_C))
    finite = all(bool(torch.isfinite(leaf).all()) for leaf in leaves)
    emit(phase="lm_fed_round", arch=cfg.name, dtype=cfg.dtype, clients=FED_C, local_steps=FED_K,
         local_batch=FED_B, seq=FED_S, weights=FED_WEIGHTS, loss=loss, round_s=round_s,
         slots_equal=equal, params_finite=finite, steps=[int(s) for s in state.step],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(math.isfinite(loss) and finite and equal,
            f"fed round: loss {loss}, finite {finite}, slots equal {equal}")
    del params_c, state, batches
    release()
    emit(phase="lm_zoo_seconds", seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# phase 25: the client axis over several processes (launch/mesh.py)
# ---------------------------------------------------------------------------

MESH_LOSS_TOL = 1e-5         # a sharded round's losses against the one-process round's (phase 25)
MESH_PARAMS_TOL = 1e-4       # and its params
# One rank of phase 25's sharded round: joins a group of WORLD ranks over
# BACKEND through a FileStore, trains federated-arc's round (1 round, 1
# local epoch, seed 0) with mesh "auto" on cuda:DEVICE from the seed-0 init,
# writes its params to OUT and prints its block, launches and round time as
# the last line of its standard output.
MESH_CHILD = """
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, backend, device, store, out = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.set_device(int(device))
dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
try:
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.experiments.paper import ExperimentConfig, build_cohort, policies_for
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.kernels.gru_scan import kernel as K
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves

    exp = ExperimentConfig(rounds=1, local_epochs=1)
    fed = Federation(
        FederationConfig(rounds=1, local_epochs=1, batch_size=exp.batch_size, seed=0,
                         mesh="auto", **policies_for("federated-arc", exp)),
        build_client_datasets(build_cohort(exp, seed=0)), make_loss_fn(GRUConfig()),
        AdamW(exp.learning_rate, weight_decay=exp.weight_decay), device="cuda")
    params0 = init_gru(torch.Generator().manual_seed(0), GRUConfig(), "cuda")
    torch.cuda.synchronize()
    K.gru_scan.launches = K.gru_scan_bwd.launches = 0
    result = fed.run(params0)
    st = fed.cohort_trainer.last_round_stats
    np.savez(out, *[t.cpu().numpy() for t in tree_leaves(result.params)])
    print(json.dumps({"rank": rank, "world": world, "backend": backend, "device": int(device),
                      "shards": st["shards"], "rank_clients": st["rank_clients"],
                      "cohort_steps": st["cohort_steps"],
                      "losses": [r.mean_local_loss for r in result.history],
                      "participants": [len(r.participant_ids) for r in result.history],
                      "round_time_s": [r.round_time_s for r in result.history],
                      "gru_scan": K.gru_scan.launches, "gru_scan_bwd": K.gru_scan_bwd.launches}),
          flush=True)
finally:
    dist.destroy_process_group()
"""


def run_mesh_ranks(backend: str, devices: list[int], workdir: Path) -> list[tuple[dict, list]]:
    """The sharded arc round in one child process a rank, all started
    together: each rank's report and params."""
    import numpy as np

    store = workdir / f"{backend}.store"
    procs = [subprocess.Popen([sys.executable, "-c", MESH_CHILD, str(rank), str(len(devices)),
                               backend, str(dev), str(store), str(workdir / f"{backend}{rank}.npz")],
                              env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for rank, dev in enumerate(devices)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    reports = []
    for rank, (rc, out, err) in enumerate(outs):
        lines = out.strip().splitlines()
        require(rc == 0 and bool(lines) and lines[-1].startswith("{"),
                f"mesh rank {rank} ({backend}) exited {rc}: {err[-3000:]}")
        with np.load(workdir / f"{backend}{rank}.npz") as z:
            params = [z[f"arr_{i}"] for i in range(len(z.files))]
        reports.append((json.loads(lines[-1]), params))
    return reports


def run_mesh_phase(torch, K, cohort) -> dict[str, int]:
    """Phase 25: (a) federated-arc's round with ``mesh="auto"`` in this
    process (no process group: no mesh) against ``mesh=None``, bit for bit;
    (b) the same round over two gloo ranks sharing cuda:0, against the
    one-process round, each rank's GRU launches two a step of its block;
    (c) over two GPUs under NCCL, where the machine has them."""
    import tempfile

    import numpy as np

    from repro_torch.experiments.paper import ExperimentConfig
    from repro_torch.launch.mesh import DataMesh, block_of
    from repro_torch.tree import tree_leaves

    exp = ExperimentConfig(rounds=1, local_epochs=1)
    total = {"gru_scan": 0, "gru_scan_bwd": 0}
    runs = {}
    for mesh in (None, "auto"):
        fed = arc_federation(torch, cohort, exp, mesh=mesh)
        result, stats, counts = run_federation(torch, K, fed)
        check_launches(f"federated-arc (mesh {mesh})", counts, stats[0]["cohort_steps"], 0)
        add_counts(total, counts)
        runs[mesh] = result
        del fed
    one = runs[None]
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(one.params),
                                                    tree_leaves(runs["auto"].params)))
    emit(phase="mesh_auto", bitwise=bitwise,
         mean_local_loss=[[r.mean_local_loss for r in res.history] for res in runs.values()],
         round_time_s=[[r.round_time_s for r in res.history] for res in runs.values()])
    require(bitwise and [r.mean_local_loss for r in one.history] ==
            [r.mean_local_loss for r in runs["auto"].history],
            "mesh 'auto' in one process differs from no mesh")

    ref = [t.cpu().numpy() for t in tree_leaves(one.params)]
    n = len(one.history[0].participant_ids)
    legs = [("gloo", [0, 0])]
    if torch.cuda.device_count() >= 2:
        legs.append(("nccl", [0, 1]))
    else:
        emit(phase="mesh_nccl", ran=False,
             note="one card: the NCCL leg over two GPUs did not run")
    with tempfile.TemporaryDirectory() as workdir:
        for backend, devices in legs:
            t0 = time.perf_counter()
            reports = run_mesh_ranks(backend, devices, Path(workdir))
            seconds = time.perf_counter() - t0
            for rank, (rep, params) in enumerate(reports):
                block = block_of(n, DataMesh(None, rank, len(devices)))
                loss_gap = max(abs(a - r.mean_local_loss) for a, r in zip(rep["losses"],
                                                                         one.history))
                param_gap = max(float(np.max(np.abs(a - b))) for a, b in zip(params, ref))
                emit(phase="mesh_rank", **rep, block=[block.start, block.stop],
                     loss_gap=loss_gap, loss_bar=MESH_LOSS_TOL, param_gap=param_gap,
                     param_bar=MESH_PARAMS_TOL, seconds=seconds,
                     label=("two ranks sharing one card (gloo), not a multi-GPU time"
                            if backend == "gloo" else "two GPUs (NCCL)"))
                require(rep["shards"] == len(devices) and rep["rank_clients"] == len(block),
                        f"mesh rank {rank} trained {rep['rank_clients']} clients, "
                        f"its block is {len(block)}")
                check_launches(f"mesh rank {rank} ({backend})",
                               {k: rep[k] for k in total}, rep["cohort_steps"], 0)
                require(loss_gap <= MESH_LOSS_TOL and param_gap <= MESH_PARAMS_TOL,
                        f"mesh rank {rank} ({backend}) against one process: losses "
                        f"{loss_gap}, params {param_gap}")
                add_counts(total, {k: rep[k] for k in total})
            require(all(a.tobytes() == b.tobytes() for a, b in zip(reports[0][1], reports[1][1])),
                    f"the {backend} ranks' params differ")
    return total


# ---------------------------------------------------------------------------
# phase 26: the MoE decoders with MLA, and the encoder-decoder
# ---------------------------------------------------------------------------

MOE_PARITY_CASES = (
    # name, arch, changes to its reduced config, changes to its MoE config
    ("deepseek-v3-671b", "deepseek-v3-671b", {}, {}),   # MLA, 4 experts top-2, MTP, 1 dense
    ("llama4-scout-17b-a16e", "llama4-scout-17b-a16e", {}, {}),   # 4 experts top-1, shared
    ("seamless-m4t-large-v2", "seamless-m4t-large-v2", {}, {}),   # 2 encoder, 2 decoder layers
    ("llama4-moe-every2", "llama4-scout-17b-a16e", {"num_layers": 5}, {"moe_every": 2}),
    ("deepseek-ep-local", "deepseek-v3-671b", {}, {"expert_sharding": "ep_local"}),
    ("deepseek-capacity0.5", "deepseek-v3-671b", {}, {"capacity_factor": 0.5}),   # pairs drop
)
MOE_PARITY_B, MOE_PARITY_S = 2, 40   # 80 tokens: ep_local dispatches in 16 groups of 5
MOE_GEN = 32                         # (b), (c): generated after LM_FEED prompt tokens
DEEPSEEK_SERVE_LAYERS, DEEPSEEK_SERVE_B = 5, 2                # (b): 3 dense and 2 MoE of 61
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_EXPERTS = 2, 16          # (b): 1 dense, 1 MoE
LLAMA4_SERVE_LAYERS, LLAMA4_SERVE_B, LLAMA4_TRAIN_LAYERS = 8, 8, 1   # (c)
SEAMLESS_B, SEAMLESS_FRAMES, SEAMLESS_GEN = 8, 512, 64         # (d)
MEMORY_WHY = ("AdamW's functional update holds 7 bf16 copies of the params "
              "(old and new moments at once); 80 GB holds ~5.7 B params that way")


def moe_case_config(arch: str, changes: dict, moe_changes: dict):
    """``arch``'s reduced config with ``changes``, its MoE config with
    ``moe_changes``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if moe_changes:
        changes = {**changes, "moe": dataclasses.replace(cfg.moe, **moe_changes)}
    return dataclasses.replace(cfg, **changes)


def generous(cfg):
    """``cfg`` at capacity 8.0 when it has experts: a decode step of B tokens
    then drops no pair that the forward keeps (tests/test_decode.py)."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


class RoutedIds:
    """Records the expert ids of every ``route`` call while it is entered."""

    def __enter__(self):
        from repro_torch.models import moe

        self.ids, self._moe, self._route = [], moe, moe.route

        def recording(*args, **kwargs):
            out = self._route(*args, **kwargs)
            self.ids.append(out[2].detach().cpu())
            return out

        moe.route = recording
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def check_moe_parity(torch) -> None:
    """(a) Each case in float32: logits, the loss and every gradient leaf on
    the card against the CPU (a leaf held to MAMBA_TOL times its own
    max|ref|), the routed ids of every MoE layer equal, a repeated forward
    on the card the same bits, and the card's decode path (after
    ``encode_for_decode`` for the encoder-decoder) against its own forward
    at the reference's decode tolerance, the MoE cases at capacity 8.0."""
    from repro_torch.models.zoo import Model
    from repro_torch.tree import tree_map

    failures = []
    for name, arch, changes, moe_changes in MOE_PARITY_CASES:
        t0 = time.perf_counter()
        cfg = moe_case_config(arch, changes, moe_changes)
        model = Model(cfg, remat=False)
        params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda t: t.to("cuda"), params_cpu)
        batch = lm_inputs(torch, cfg, MOE_PARITY_B, MOE_PARITY_S, seed=27)
        batch_card = {k: v.cuda() for k, v in batch.items()}
        with torch.inference_mode():
            with RoutedIds() as ids_cpu:
                lg_cpu = model.forward_logits(params_cpu, batch)
            with RoutedIds() as ids_card:
                lg_card = model.forward_logits(params, batch_card)
            again = model.forward_logits(params, batch_card)
        loss_cpu, g_cpu = loss_and_grads(torch, model, params_cpu, batch)
        loss_card, g_card = loss_and_grads(torch, model, params, batch_card)
        dmodel = Model(generous(cfg), remat=False)
        with torch.inference_mode():
            full = dmodel.forward_logits(params, batch_card)
        cache = dmodel.init_cache(MOE_PARITY_B, MOE_PARITY_S, "cuda")
        if "src_embeds" in batch_card:
            with torch.inference_mode():
                cache = dmodel.encode_for_decode(params, batch_card["src_embeds"], cache)
        dec, _, _ = decode_through(dmodel, params, {"tokens": batch_card["tokens"]}, cache)
        torch.cuda.synchronize()
        dec = torch.stack(dec, dim=1)
        by_leaf = sorted(((leaf_err(g.cpu(), r), q) for q, g, r in
                          zip(leaf_paths(params_cpu), g_card, g_cpu)), reverse=True)
        e = {"logits": scaled_err(lg_card.cpu(), lg_cpu),
             "loss": scaled_err(loss_card.cpu(), loss_cpu), "grad_leaf_worst": by_leaf[0][0]}
        dec_gap = (dec - full).abs()
        dec_ok = bool((dec_gap <= DECODE_ATOL + DECODE_RTOL * full.abs()).all())
        ids_equal = (len(ids_card.ids) == len(ids_cpu.ids)
                     and all(torch.equal(a, b) for a, b in zip(ids_card.ids, ids_cpu.ids)))
        same_bits = torch.equal(again, lg_card)
        finite = all(bool(torch.isfinite(t).all()) for t in (lg_card, dec, loss_card, *g_card))
        emit(phase="moe_parity", case=name, arch=arch, changes=changes, moe_changes=moe_changes,
             B=MOE_PARITY_B, S=MOE_PARITY_S, dtype=cfg.dtype, card_vs_cpu_scaled_err=e,
             grad_leaf_err_worst=by_leaf[:3], moe_layers_routed=len(ids_card.ids),
             routed_ids_equal=ids_equal, repeat_same_bits=same_bits,
             decode_capacity=None if cfg.moe is None else 8.0,
             decode_vs_prefill_max_abs=float(dec_gap.max()), decode_within_tol=dec_ok,
             seconds=time.perf_counter() - t0)
        if not finite:
            failures.append(f"{name}: non-finite outputs")
        if max(e.values()) > MAMBA_TOL:
            failures.append(f"{name}: card against CPU {e}, {by_leaf[0]}")
        if not ids_equal or (cfg.moe is not None) != bool(ids_card.ids):
            failures.append(f"{name}: routed ids differ ({len(ids_card.ids)} MoE calls)")
        if not same_bits:
            failures.append(f"{name}: a repeated forward on the card gave other bits")
        if not dec_ok:
            failures.append(f"{name}: decode against prefill {float(dec_gap.max())}")
    require(not failures, "; ".join(failures))


def run_moe_encdec_phase(torch, K, SK) -> dict[str, int]:
    """Phase 26: (a) parity at the reduced configs and variants; (b)
    deepseek-v3-671b and (c) llama4-scout-17b-a16e at full width, bfloat16,
    cut in depth (and deepseek's train step in experts) to fit one card,
    served and trained; (d) seamless-m4t-large-v2 uncut, served through
    ``encode_for_decode`` and trained.  No kernel of the port runs on this
    path (the JAX package has none for MoE, MLA or cross-attention): the
    kernels' counts, set to 0 before it, are returned as read after it."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import Model, count_params_config
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    reset_gru_counts(K)
    SK.ssd_chunk_scan.launches = SK.ssd_chunk_scan_bwd.launches = 0
    check_moe_parity(torch)

    def init(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        require(n == count_params_config(cfg), f"{cfg.name}: {n} params, counted "
                f"{count_params_config(cfg)}")
        return params, time.perf_counter() - t0

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def train(cfg, batch_sizes, frames=None):
        params, init_s = init(cfg)
        out = lm_train(torch, SK, Model(cfg), params, batch_sizes, steps=1, frames=frames)
        require(all(math.isfinite(v) for v in out["metrics"].values()),
                f"{cfg.name} train metrics {out['metrics']}")
        del params
        release()
        return dict(out, init_s=init_s, params=count_params_config(cfg),
                    adamw_copies_gb=7 * 2 * count_params_config(cfg) / 1e9)

    # (b) deepseek-v3-671b: 5 of 61 layers served; 2 layers with 16 of 256 experts trained
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_SERVE_LAYERS)
    params, init_s = init(cfg)
    served, cache = lm_serve(torch, SK, Model(cfg), params, 2, MOE_GEN, 0, b=DEEPSEEK_SERVE_B)
    m = cfg.mla
    latent = cache["first_blocks"]
    latent_bytes = ((latent["c_kv"].shape[-1] + latent["k_rope"].shape[-1])
                    * latent["c_kv"].element_size())
    full_rank_bytes = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * 2
    del params, cache, latent
    release()
    cut = dataclasses.replace(full, num_layers=DEEPSEEK_TRAIN_LAYERS,
                              moe=dataclasses.replace(full.moe, first_dense=1,
                                                      num_experts=DEEPSEEK_TRAIN_EXPERTS))
    trained = train(cut, (2, 1))
    emit(phase="moe_deepseek", arch=full.name, dtype=cfg.dtype, init_s=init_s,
         serve_params=count_params_config(cfg), serve=served,
         latent_cache_bytes_per_token_layer=latent_bytes,
         full_rank_cache_bytes_per_token_layer=full_rank_bytes, train=trained,
         reduced={"serve_num_layers": [DEEPSEEK_SERVE_LAYERS, full.num_layers],
                  "serve_why": "61 layers hold 671.7 B params (1.34 TB in bf16); 5 layers, "
                               "3 dense and 2 MoE of 256 experts, hold 27.3 B (54.6 GB)",
                  "train_num_layers": [DEEPSEEK_TRAIN_LAYERS, full.num_layers],
                  "train_num_experts": [DEEPSEEK_TRAIN_EXPERTS, full.moe.num_experts],
                  "train_first_dense": [1, full.moe.first_dense],
                  "train_why": MEMORY_WHY + "; one MoE layer of 256 experts is 11.3 B"})
    require(latent_bytes == 1152 and full_rank_bytes == 81920,
            f"latent cache {latent_bytes} B, full rank {full_rank_bytes} B a token a layer")
    require("mtp_ce" in trained["metrics"], f"deepseek train metrics {trained['metrics']}")

    # (c) llama4-scout-17b-a16e: 8 of 48 layers served, 1 trained
    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, num_layers=LLAMA4_SERVE_LAYERS)
    params, init_s = init(cfg)
    served, cache = lm_serve(torch, SK, Model(cfg), params, 2, MOE_GEN, 0, b=LLAMA4_SERVE_B)
    del params, cache
    release()
    trained = train(dataclasses.replace(full, num_layers=LLAMA4_TRAIN_LAYERS), (8, 4, 2, 1))
    emit(phase="moe_llama4", arch=full.name, dtype=cfg.dtype, init_s=init_s,
         serve_params=count_params_config(cfg), serve=served, train=trained,
         decode_capacity_per_expert=max(int(LLAMA4_SERVE_B * full.moe.top_k / full.moe.num_experts
                                            * full.moe.capacity_factor), full.moe.top_k),
         reduced={"serve_num_layers": [LLAMA4_SERVE_LAYERS, full.num_layers],
                  "serve_why": "48 layers hold 107.8 B params (215.5 GB in bf16); 8 hold 19.7 B",
                  "train_num_layers": [LLAMA4_TRAIN_LAYERS, full.num_layers],
                  "train_why": MEMORY_WHY + "; one layer is 4.27 B with the embeddings"})

    # (d) seamless-m4t-large-v2 uncut: served through encode_for_decode, trained
    cfg = get_config("seamless-m4t-large-v2")
    params, init_s = init(cfg)
    served, cache = lm_serve(torch, SK, Model(cfg), params, 2, SEAMLESS_GEN, 0, b=SEAMLESS_B,
                             frames=SEAMLESS_FRAMES)
    require(tuple(cache["blocks"]["cross_k"].shape[1:3]) == (SEAMLESS_B, SEAMLESS_FRAMES),
            f"cross K/V {tuple(cache['blocks']['cross_k'].shape)}")
    del params, cache
    release()
    trained = train(cfg, (SEAMLESS_B, 4, 2, 1), frames=Model.encoder_frames(LM_PROMPT))
    emit(phase="encdec_seamless", arch=cfg.name, dtype=cfg.dtype, init_s=init_s,
         params=count_params_config(cfg), serve=served, train=trained)

    launches = {**gru_counts(K), "ssd_chunk_scan": SK.ssd_chunk_scan.launches,
                "ssd_chunk_scan_bwd": SK.ssd_chunk_scan_bwd.launches}
    emit(phase="moe_encdec_seconds", seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


if __name__ == "__main__":
    sys.exit(main())
