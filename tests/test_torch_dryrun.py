"""The port's dry run (``launch/dryrun.py``, ``launch/step_analysis.py``)
against the JAX package's (``launch/dryrun.py``, ``launch/hlo_analysis.py``).

* ``model_flops_estimate`` equals the reference's for every arch x shape.
* The matmul FLOPs of the port's train step, counted on meta tensors, equal
  the reference's ``analyze_hlo`` of its compiled step exactly for the
  reduced smollm-135m.  For the reduced qwen3-1.7b and deepseek-v3 the port
  counts more by exactly the named term: one head product, 2·B·S·d·V, for
  each CE (deepseek's main CE and its MTP CE over S-1) whose sequence is one
  ``loss_chunk`` and whose head is its own matrix.  The reference computes
  the CE's logits forward and its recompute as one dot there (XLA merges the
  two identical products once both one-trip loops are unrolled); the port
  computes both.  At two chunks the programs agree exactly (qwen3 at S =
  1,024), and a tied head (smollm) keeps the two products apart in XLA too.
* Calibration toys, the port of ``tests/test_hlo_analysis.py``: a matmul
  looped 5x and a matmul plus GELU, counted exactly, on meta and on CPU
  tensors alike; a backward's FLOPs; bytes linear in the trip count; the
  roofline arithmetic.
* The kernels' meta route: each of the four wrappers returns outputs of the
  kernel's shapes and dtypes, launches nothing and records the work
  ``kernels/work.py`` counts for the bounds.
* The live-storage peak of a reduced train step on meta tensors equals its
  peak on real CPU tensors.
* A record has the reference's keys less ``cost_raw``; a failing
  combination writes ``.error.json``; the CLI sweeps and skips what is done.
"""

import ast
import dataclasses
import inspect
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import hlo_analysis as jax_hlo  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models.zoo import Model as JaxModel  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.gru_scan import kernel as gru_kernel  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.step_analysis import (  # noqa: E402
    RooflineTerms,
    model_flops_estimate,
    run_counted,
)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.zoo import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

torch.set_num_threads(1)

REFERENCE_DRYRUN = Path(jax_hlo.__file__).with_name("dryrun.py")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# FLOPs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(specs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_matches_jax(arch, shape):
    ours, theirs = specs.INPUT_SHAPES[shape], jax_specs.INPUT_SHAPES[shape]
    cfg = specs.config_for_shape(get_config(arch), ours)
    jcfg = jax_specs.config_for_shape(jax_get_config(arch), theirs)
    assert model_flops_estimate(cfg, ours, ours.kind) == \
        jax_hlo.model_flops_estimate(jcfg, theirs, theirs.kind)


def reference_step_flops(arch: str, s: int, b: int) -> float:
    cfg = jax_get_config(arch).reduced()
    model = JaxModel(cfg, remat=True, loss_chunk=512)
    opt = JaxAdamW(learning_rate=1e-4, weight_decay=0.01)
    p = jax_specs.params_specs(model)
    batch = jax_specs.batch_specs(cfg, jax_specs.InputShape("t", s, b, "train"))
    compiled = jax.jit(jax_train_step(model, opt)).lower(
        p, jax.eval_shape(opt.init, p), batch).compile()
    return jax_hlo.analyze_hlo(compiled.as_text())["flops"]


def port_step_flops(arch: str, s: int, b: int) -> int:
    cfg = get_config(arch).reduced()
    model = Model(cfg, remat=True, loss_chunk=512)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    p = specs.params_specs(model)
    batch = specs.batch_specs(cfg, specs.InputShape("t", s, b, "train"))
    _, counter, _ = run_counted(make_train_step(model, opt), p, opt.init(p), batch,
                                track_peak=False)
    assert counter.kernels == {}
    return counter.matmul_flops


def merged_head_products(arch: str, s: int, b: int, loss_chunk: int = 512) -> int:
    """The FLOPs of the head products XLA merges: 2·B·n·d·V for each CE over
    n positions (S, and S-1 for the MTP CE) that is one chunk, where the
    head is its own matrix."""
    cfg = get_config(arch).reduced()
    if cfg.tie_embeddings:
        return 0
    lengths = [s] + ([s - 1] if cfg.mtp else [])
    return sum(2 * b * n * cfg.d_model * cfg.vocab_size
               for n in lengths if n <= loss_chunk)


@pytest.mark.parametrize("arch, s, b, gap", [
    ("smollm-135m", 256, 2, 0),
    ("qwen3-1.7b", 256, 2, 2 * 2 * 256 * 256 * 512),                       # 2^27
    ("deepseek-v3-671b", 256, 2, 2 * 2 * (256 + 255) * 256 * 512),         # 267,911,168
    ("qwen3-1.7b", 1024, 1, 0),                                            # two CE chunks
])
def test_step_flops_match_analyze_hlo_up_to_the_merged_head_products(arch, s, b, gap):
    assert merged_head_products(arch, s, b) == gap
    assert port_step_flops(arch, s, b) - reference_step_flops(arch, s, b) == gap


# ---------------------------------------------------------------------------
# calibration: known-FLOPs programs
# ---------------------------------------------------------------------------

TRIP = 5
N = 64


def looped(x, ws, act=torch.tanh):
    for w in ws:
        x = act(x @ w)
    return x.sum()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_looped_and_fused_matmul_flops_exact(device):
    x = torch.zeros(8, N, device=device)
    ws = torch.zeros(TRIP, N, N, device=device)
    for act in (torch.tanh, lambda y: torch.nn.functional.gelu(y + 1.0)):
        _, counter, _ = run_counted(looped, x, ws, act, track_peak=False)
        assert counter.flops_by_dtype == {"float32": TRIP * 2 * 8 * N * N}


def test_grad_flops_are_twice_the_forward():
    ws = meta(TRIP, N, N)

    def grad_x(x):
        x = x.detach().requires_grad_()
        return torch.autograd.grad(looped(x, ws), x)[0]

    fwd = run_counted(looped, meta(8, N), ws, track_peak=False)[1].matmul_flops
    both = run_counted(grad_x, meta(8, N), track_peak=False)[1].matmul_flops
    assert both == 2 * fwd   # the forward, then one product a layer for dx (none for dW)


def test_bytes_are_linear_in_the_trip_count():
    def traffic(trip):
        return run_counted(looped, meta(8, N), meta(trip, N, N), track_peak=False)[1].bytes

    assert traffic(8) - traffic(4) == traffic(4) - traffic(0) > 0


def test_roofline_terms_math():
    t = RooflineTerms(hlo_flops=989e12 * 2, hlo_bytes=3.35e12, coll_bytes=450e9 * 4, chips=2,
                      model_flops=989e12, flops_by_dtype={"bfloat16": 989e12 * 2})
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(2.0)
    assert t.dominant == "collective"
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.as_dict()["dominant"] == "collective"
    t = dataclasses.replace(t, coll_bytes=None, flops_by_dtype={"float32": 67e12 * 4},
                            kernel_compute_s=1.0)
    assert t.compute_s == pytest.approx(2.5)
    assert t.collective_s is None and t.dominant == "compute"


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("clients", [None, 3])
def test_gru_wrappers_on_meta_record_the_bounds_work(dtype, clients):
    lead = () if clients is None else (clients,)
    b, t, n = 4, 6, 5
    xg, w, bias = meta(*lead, b, t, 3 * n, dtype=dtype), meta(*lead, n, 3 * n), meta(*lead, 3 * n)
    before = (gru_kernel.gru_scan.launches, gru_kernel.gru_scan_bwd.launches)
    with work.recording() as log:
        h = gru_kernel.gru_scan(xg, w, bias)
        dxg, dw, db = gru_kernel.gru_scan_bwd(xg, w, bias, h, meta(*lead, b, t, n, dtype=dtype))
    assert (h.shape, h.dtype, h.device.type) == ((*lead, b, t, n), dtype, "meta")
    assert [(g.shape, g.dtype) for g in (dxg, dw, db)] == \
        [(x.shape, x.dtype) for x in (xg, w, bias)]
    assert (gru_kernel.gru_scan.launches, gru_kernel.gru_scan_bwd.launches) == before
    c = clients or 1
    fb, fo, bb, bo = work.gru_work(b, t, n, elem=xg.element_size())
    assert log["gru_scan"] == work.KernelWork(1, c * fo, c * fb, c * fo / work.PEAK_F32_FLOPS)
    assert log["gru_scan_bwd"] == work.KernelWork(1, c * bo, c * bb, c * bo / work.PEAK_F32_FLOPS)


@pytest.mark.parametrize("dtypes", [[d] * 5 for d in DTYPES] + [
    [torch.bfloat16, torch.float32, torch.float32, torch.float16, torch.bfloat16]], ids=str)
def test_ssd_wrappers_on_meta_record_the_bounds_work(dtypes):
    shape = (2, 3, 16, 4, 80, 8)   # P = 80: two p-tiles
    b, nc, l_len, h, p, n = shape
    dims = [(b, nc, l_len, h, p), (b, nc, l_len, h), (b, nc, l_len, h), (b, nc, l_len, n),
            (b, nc, l_len, n)]
    inputs = [meta(*d, dtype=t) for d, t in zip(dims, dtypes)]
    before = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
    with work.recording() as log:
        y = ssd_kernel.ssd_chunk_scan(*inputs)
        y2, states = ssd_kernel.ssd_chunk_scan(*inputs, return_states=True)
        grads = ssd_kernel.ssd_chunk_scan_bwd(*inputs, states, meta(*dims[0], dtype=dtypes[0]))
    assert (y.shape, y.dtype) == (y2.shape, y2.dtype) == (dims[0], dtypes[0])
    assert (states.shape, states.dtype) == ((b, nc, h, p, n), torch.float32)
    assert [(g.shape, g.dtype) for g in grads] == [(x.shape, x.dtype) for x in inputs]
    assert (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches) == before
    elem = dtypes[0].itemsize if len(set(dtypes)) == 1 else 4
    nbytes, ops, _, mma, mma16 = work.ssd_work(*shape, elem=elem)
    assert log["ssd_chunk_scan"] == work.KernelWork(
        2, 2 * ops, 2 * nbytes, 2 * work.tensor_core_ms(ops, mma, mma16, elem) / 1e3)
    nbytes, ops, mma, mma16 = work.ssd_bwd_work(*shape, elem=elem)
    assert log["ssd_chunk_scan_bwd"] == work.KernelWork(
        1, ops, nbytes, work.tensor_core_ms(ops, mma, mma16, elem) / 1e3)


def test_recording_closes_and_nests():
    x = [meta(1, 1, 8, 1, 4), meta(1, 1, 8, 1), meta(1, 1, 8, 1), meta(1, 1, 8, 2),
         meta(1, 1, 8, 2)]
    with work.recording() as outer:
        with work.recording() as inner:
            ssd_kernel.ssd_chunk_scan(*x)
        ssd_kernel.ssd_chunk_scan(*x)
    ssd_kernel.ssd_chunk_scan(*x)
    assert (outer["ssd_chunk_scan"].calls, inner["ssd_chunk_scan"].calls) == (2, 1)


# ---------------------------------------------------------------------------
# the peak
# ---------------------------------------------------------------------------


def test_meta_peak_equals_the_peak_on_cpu_tensors():
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, remat=True)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    shape = specs.InputShape("t", 64, 2, "train")
    p = specs.params_specs(model)
    _, on_meta, meta_peak = run_counted(make_train_step(model, opt), p, opt.init(p),
                                        specs.batch_specs(cfg, shape))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32))
             for k in ("tokens", "labels")}
    _, on_cpu, cpu_peak = run_counted(make_train_step(model, opt), params, opt.init(params), batch)
    assert meta_peak == cpu_peak > sum(t.numel() * 4 for t in jax.tree.leaves(params)) * 3
    assert on_meta.flops_by_dtype == on_cpu.flops_by_dtype
    assert (on_meta.bytes, on_meta.ops) == (on_cpu.bytes, on_cpu.ops)


# ---------------------------------------------------------------------------
# records, errors and the CLI
# ---------------------------------------------------------------------------


def reference_record_keys() -> set[str]:
    """The keys of the record the reference's ``_finalize_record`` builds,
    read from its source (importing it would claim 512 host devices)."""
    tree = ast.parse(REFERENCE_DRYRUN.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_finalize_record")
    record = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "record")
    return {k.value for k in record.keys}


def test_variants_match_the_reference():
    tree = ast.parse(REFERENCE_DRYRUN.read_text())
    variants = next(n.value for n in ast.walk(tree) if isinstance(n, ast.AnnAssign)
                    and getattr(n.target, "id", None) == "VARIANTS")
    assert ast.literal_eval(variants) == dryrun.VARIANTS
    for variant, spec in dryrun.VARIANTS.items():
        cfg = dryrun._apply_variant_cfg(get_config("llama4-scout-17b-a16e"), spec)
        assert cfg.moe.expert_sharding == spec.get("moe_sharding", "ep"), variant
        assert cfg.moe.capacity_factor == spec.get("capacity_factor", 1.5), variant


def test_a_record_has_the_reference_keys_and_counts_the_kernels():
    record = dryrun.lower_combo("mamba2-130m", specs.InputShape("t", 512, 2, "train"), "host")
    assert set(record) == reference_record_keys() - {"cost_raw"}
    theirs = jax_hlo.RooflineTerms(1.0, 1.0, 1.0, 1, 1.0).as_dict()
    assert set(theirs) <= set(record["roofline"])
    layers = get_config("mamba2-130m").num_layers
    kernels = record["hlo_analysis"]["kernels"]
    assert {k: v["calls"] for k, v in kernels.items()} == \
        {"ssd_chunk_scan": 2 * layers, "ssd_chunk_scan_bwd": layers}   # remat reruns the forward
    memory = record["memory"]
    assert memory["peak_memory_in_bytes"] > memory["argument_size_in_bytes"] == \
        sum(memory[f"{k}_bytes"] for k in ("params", "mu", "nu", "batch"))
    assert record["roofline"]["coll_bytes"] == 0.0 and record["roofline"]["collective_s"] == 0.0
    assert record["roofline"]["hlo_flops"] == record["hlo_analysis"]["flops"] > 0


SSD_ARCHS = ("mamba2-130m", "zamba2-7b")


@pytest.mark.parametrize("shape", list(specs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_combination_completes_on_the_host_mesh(arch, shape, monkeypatch):
    """Each arch x shape, reduced, through ``lower_combo``: the decode,
    VLM, encoder-decoder and long-context paths run on meta tensors (no
    data-dependent shape, no host read), the SSD kernels record their calls
    where prefill and training run them, and the arguments are counted."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    record = dryrun.lower_combo(arch, shape, "host")
    analysis, memory = record["hlo_analysis"], record["memory"]
    assert record["roofline"]["hlo_flops"] == analysis["flops"] > 0
    kind = specs.INPUT_SHAPES[shape].kind
    assert bool(analysis["kernels"]) == (arch in SSD_ARCHS and kind != "decode")
    parts = {"train": ("params", "mu", "nu", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch")}[kind]
    assert memory["argument_size_in_bytes"] == sum(memory[f"{p}_bytes"] for p in parts)
    assert memory["peak_memory_in_bytes"] >= memory["argument_size_in_bytes"]


def test_fed_round_record_counts_one_round(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch).reduced())
    shape = specs.InputShape("t", 32, 2, "train")
    record = dryrun.lower_combo("smollm-135m", shape, "host", variant="fed_k4")
    assert record["tags"] == {"fed_local_steps": 4, "clients": 1, "local_batch": 2}
    step = dryrun.lower_combo("smollm-135m", shape, "host")
    # four local steps and the average over one client slot (a product over C = 1)
    n_params = sum(t.numel() for t in jax.tree.leaves(specs.params_specs(Model(
        get_config("smollm-135m").reduced()))))
    assert record["hlo_analysis"]["matmul_flops"] == \
        4 * step["hlo_analysis"]["matmul_flops"] + 2 * n_params
    assert record["roofline"]["model_flops"] == 4 * step["roofline"]["model_flops"]


def test_sharded_records_leave_collectives_unmodelled():
    memo = {}
    host, single = (dryrun.lower_combo("smollm-135m", "decode_32k", kind, memo=memo)
                    for kind in ("host", "single"))
    assert host["hlo_analysis"] == single["hlo_analysis"]   # one meta run serves both
    assert single["roofline"]["coll_bytes"] is None and single["roofline"]["collective_s"] is None
    assert single["roofline"]["collective_note"] and single["roofline"]["dominant"] in (
        "compute", "memory")
    assert single["memory"]["peak_memory_in_bytes"] is None
    assert single["memory"]["argument_size_in_bytes"] < host["memory"]["argument_size_in_bytes"]


def test_failures_write_an_error_file_and_the_cli_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    err = dryrun.run_combo("smollm-135m", "decode_32k", "host", variant="fed_k1")
    assert "error" in err and err["error"].startswith("ValueError")
    saved = json.loads((tmp_path / "smollm-135m__decode_32k__host__fed_k1.error.json").read_text())
    assert saved["variant"] == "fed_k1" and "traceback" in saved
    with pytest.raises(SystemExit, match="1 combination"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "host",
                     "--variant", "fed_k1"])
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "both"])
    assert sorted(p.name for p in tmp_path.glob("*baseline.json")) == [
        "smollm-135m__decode_32k__multi__baseline.json",
        "smollm-135m__decode_32k__single__baseline.json"]
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "both"])
    assert capsys.readouterr().out.count("[skip]") == 2


def test_records_go_under_build_and_claim_no_devices():
    assert dryrun.RESULTS_DIR.parts[-3:] == ("build", "repro_torch", "dryrun")
    assert "XLA_FLAGS" not in inspect.getsource(dryrun)
