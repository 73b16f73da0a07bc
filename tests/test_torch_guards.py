"""Guards of the port: what it imports, where it runs, and no silent fallback.

* ``repro_torch`` imports neither ``jax`` nor anything of ``repro``.
* Entry points default to the card and raise where there is none.
* CPU tensors go through the plain versions and count no kernel launch;
  the router accepts nothing but CUDA, CPU and (for the dry run) meta
  tensors, all on one device.
* Every reference arch id builds its reduced ``Model`` on the CPU, the MoE
  and encoder-decoder families included.
* Each kernel module's ctypes signatures match the C prototypes of its source.
"""

import ctypes
import importlib.util
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs import UNPORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ref import gru_scan_bwd_ref, gru_scan_ref  # noqa: E402

torch.set_num_threads(1)

PKG = Path(repro_torch.__file__).parent
ROOT = PKG.parents[1]


def port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="repro_torch.")
    )


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour where no CUDA device is present")


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    modules = port_modules()
    assert "repro_torch.experiments.paper" in modules
    assert {"repro_torch.models.zoo", "repro_torch.models.attention", "repro_torch.launch.serve",
            "repro_torch.launch.train", "repro_torch.data.device_cohort",
            "repro_torch.federated.staging", "repro_torch.obs.trace", "repro_torch.obs.report",
            "repro_torch.obs.profile", "repro_torch.obs.__main__"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", [PKG, ROOT / "chip_smoke.py"], ids=["package", "chip_smoke"])
def test_sources_import_no_jax_and_no_repro(path):
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|import repro\b|from repro\b import)", re.M)
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def c_prototypes(source: str) -> dict[str, tuple[str, str]]:
    """``name -> (return type, "P"/"I" per argument)`` of every function
    defined in the ``extern "C"`` block of a CUDA source."""
    block = source.split('extern "C" {', 1)[1]
    protos = {}
    for ret, name, args in re.findall(r"^(\w+) (\w+)\(([^)]*)\)\s*\{", block, re.M):
        kinds = ["P" if "*" in a else "I" if a.split()[0] == "int" else "?" for a in args.split(",")]
        protos[name] = (ret, "".join(kinds))
    return protos


@pytest.mark.parametrize("name", ["gru_scan", "ssd"])
def test_ctypes_signatures_match_the_c_prototypes(name):
    import importlib

    module = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    protos = c_prototypes((PKG / "csrc" / f"{name}.cu").read_text())
    code = {ctypes.c_void_p: "P", ctypes.c_int: "I"}
    declared = {fn: ("int" if restype is ctypes.c_int else restype.__name__,
                     "".join(code.get(a, "?") for a in argtypes))
                for fn, (argtypes, restype) in module._SIGNATURES.items()}
    assert declared == protos
    if name == "gru_scan":
        assert protos["gru_scan_fwd"] == ("int", "PPPPPIIIIIP")


def test_kernel_sources_ship_with_the_package():
    assert (PKG / "csrc" / "gru_scan.cu").is_file()
    assert (PKG / "csrc" / "ssd.cu").is_file()


def test_entry_points_raise_without_a_card(no_cuda):
    from repro_torch.data.synth_eicu import CohortConfig, generate_cohort
    from repro_torch.experiments.paper import ExperimentConfig, run_setting
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    cohort = generate_cohort(CohortConfig(num_hospitals=4, total_stays=40, min_hospital_size=5), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_setting("central", ExperimentConfig(central_epochs=1), cohort, seed=0)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        init_gru(torch.Generator(), GRUConfig())
    with pytest.raises(RuntimeError):
        LocalTrainer(make_loss_fn(GRUConfig()), AdamW(), batch_size=4, local_epochs=1)


def test_lm_entry_points_raise_without_a_card(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.zoo import Model, params_from_jax

    for arch in ("mamba2-130m", "qwen3-1.7b", "internvl2-26b", "zamba2-7b", "deepseek-v3-671b",
                 "seamless-m4t-large-v2"):
        model = Model(get_config(arch).reduced())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init_cache(2, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, "--batch", "1", "--prompt-len", "1", "--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1", "--prompt-len", "1", "--gen", "1"])


def test_train_entry_point_raises_without_a_card(no_cuda):
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mode", "lm", "--steps", "1", "--batch", "1", "--seq", "4"])
    for arch in ("smollm-135m", "internvl2-26b", "zamba2-7b", "llama4-scout-17b-a16e",
                 "seamless-m4t-large-v2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--mode", "lm", "--arch", arch, "--steps", "1", "--batch", "1",
                        "--seq", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mode", "paper", "--scale", "0.01", "--rounds", "1", "--seeds", "0"])


def test_cpu_tensors_through_the_ssd_wrapper_count_no_launch():
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref, ssd_chunk_states_ref

    rng = torch.Generator().manual_seed(0)
    b, nc, l_len, h, p, n = 1, 2, 4, 3, 2, 5
    args = (torch.randn(b, nc, l_len, h, p, generator=rng), torch.rand(b, nc, l_len, h, generator=rng),
            -torch.rand(b, nc, l_len, h, generator=rng).cumsum(2),
            torch.randn(b, nc, l_len, n, generator=rng), torch.randn(b, nc, l_len, n, generator=rng))
    before = ssd_kernel.ssd_chunk_scan.launches
    y, states = ssd_kernel.ssd_chunk_scan(*args, return_states=True)
    y2 = ssd_ops.ssd_chunk_scan(*args)
    assert ssd_kernel.ssd_chunk_scan.launches == before
    assert torch.equal(y, ssd_chunk_scan_ref(*args)) and torch.equal(y2, y)
    assert torch.equal(states, ssd_chunk_states_ref(*args))


# The JAX package's ten arch ids (repro.configs.ARCH_IDS).
REFERENCE_ARCH_IDS = (
    "qwen3-1.7b", "mamba2-130m", "seamless-m4t-large-v2", "deepseek-v3-671b", "smollm-135m",
    "yi-9b", "internvl2-26b", "nemotron-4-15b", "llama4-scout-17b-a16e", "zamba2-7b",
)


@pytest.mark.parametrize("arch", REFERENCE_ARCH_IDS)
def test_unported_arch_ids_raise(arch):
    """No reference id is left unported: each builds its reduced ``Model``
    on the CPU, and its params land there.  (The name dates from when the
    MoE and encoder-decoder ids raised.)"""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.zoo import Model
    from repro_torch.tree import tree_leaves

    assert arch in ARCH_IDS and UNPORTED_ARCH_IDS == ()
    model = Model(get_config(arch).reduced(), remat=False)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(params))


def test_only_the_ssm_family_builds_a_model():
    """Every family builds a ``Model`` and counts its params, the MoE and
    encoder-decoder families made from a dense config included; an
    unknown id raises ``KeyError``.  (The name dates from when only the SSM
    family built.)"""
    import dataclasses

    from repro_torch.configs import ArchType, MoEConfig
    from repro_torch.models.zoo import Model, count_params_config

    cfg = get_config("smollm-135m")
    moe = dataclasses.replace(cfg, arch_type=ArchType.MOE, moe=MoEConfig(4, 2, 64))
    encdec = dataclasses.replace(cfg, arch_type=ArchType.ENCDEC, encoder_layers=2,
                                 frontend="audio")
    assert count_params_config(moe) > count_params_config(moe, active_only=True) > 0
    assert count_params_config(encdec) > count_params_config(cfg)
    for family in (moe, encdec):
        Model(family)
    for arch in ("smollm-135m", "internvl2-26b", "mamba2-130m", "zamba2-7b", "deepseek-v3-671b",
                 "llama4-scout-17b-a16e", "seamless-m4t-large-v2"):
        assert count_params_config(get_config(arch)) > 0
        Model(get_config(arch))
    with pytest.raises(KeyError):
        get_config("mamba3-1t")


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    rng = torch.Generator().manual_seed(0)
    xg, w, b = torch.randn(3, 4, 6, generator=rng), torch.randn(2, 6, generator=rng), torch.randn(6, generator=rng)
    dy = torch.randn(3, 4, 2, generator=rng)
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    h = kernel.gru_scan(xg, w, b)
    grads = kernel.gru_scan_bwd(xg, w, b, h, dy)
    assert (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches) == before
    assert torch.equal(h, gru_scan_ref(xg, w, b))
    assert all(torch.equal(g, r) for g, r in zip(grads, gru_scan_bwd_ref(xg, w, b, h, dy)))


def test_router_takes_only_cuda_or_cpu_tensors_on_one_device():
    """CUDA or CPU tensors, and meta tensors for the dry run (shapes only: a
    wrapper launches nothing and computes nothing there), all on one device."""
    assert backend.route(torch.zeros(1), torch.zeros(2)) == "cpu"
    assert backend.route(torch.zeros(1, device="meta")) == "meta"
    with pytest.raises(ValueError):
        backend.route(torch.zeros(1), torch.zeros(1, device="meta"))
    before = kernel.gru_scan.launches
    h = kernel.gru_scan(torch.zeros(3, 4, 6, device="meta"), torch.zeros(2, 6, device="meta"),
                        torch.zeros(6, device="meta"))
    assert (h.shape, h.device.type, kernel.gru_scan.launches) == ((3, 4, 2), "meta", before)
    with pytest.raises(ValueError):
        kernel.gru_scan(torch.zeros(3, 4, 6, device="meta"), torch.zeros(2, 6),
                        torch.zeros(6, device="meta"))


def test_resolve_device_takes_the_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_unported_options_say_so(tmp_path):
    from repro_torch.federated.api import FederationConfig, resolve_recruitment, resolve_selection
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.federated.cohort import CohortTrainer
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    # the mesh is ported: "auto" in one process is no mesh; a string that is
    # not "auto" is refused
    assert CohortTrainer(make_loss_fn(GRUConfig()), AdamW(), 4, 1, mesh="auto",
                         device="cpu").mesh is None
    with pytest.raises(ValueError, match="mesh"):
        CohortTrainer(make_loss_fn(GRUConfig()), AdamW(), 4, 1, mesh="ring", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        FederationConfig(engine="warp-drive")
    # DP-SGD is ported: what is not a DP config is refused, never ignored
    with pytest.raises(TypeError, match="privacy"):
        LocalTrainer(make_loss_fn(GRUConfig()), AdamW(), 4, 1, device="cpu", dp=object())
    with pytest.raises(ValueError, match="did you mean 'nu-greedy'"):
        resolve_recruitment("nu-gredy")
    with pytest.raises(ValueError, match="did you mean 'round-robin'"):
        resolve_selection("round-robbin:2")
    # the control plane: a spec with mesh "auto" is accepted (in one process
    # it is the null job); the span trace and profiled rounds are ported and run
    from repro_torch.launch.federation_service import submit_job, validate_job_spec

    assert validate_job_spec({"mode": "sync", "mesh": "auto"})["mesh"] == "auto"
    tiny = {"mode": "sync", "rounds": 1, "local_epochs": 1, "batch_size": 8, "mesh": "auto",
            "data": {"scale": 0.002, "num_hospitals": 4, "split_mode": "stratified"},
            "model": {"hidden_dim": 2, "num_layers": 1}}
    for i, (section, artifact) in enumerate((({}, "trace.json"),
                                             ({"trace": False, "jax_profile_rounds": 1},
                                              "torch_profile"))):
        run_dir = tmp_path / f"run{i}"
        out = submit_job({**tiny, "observability": section}, str(run_dir), device="cpu")
        assert out["status"] == "completed" and (run_dir / artifact).exists()


def test_privacy_and_runtime_modules_pull_in_no_jax_and_no_repro():
    modules = [m for m in port_modules()
               if m.startswith(("repro_torch.privacy", "repro_torch.federated.runtime"))]
    assert {"repro_torch.privacy.dp", "repro_torch.privacy.accountant",
            "repro_torch.privacy.secagg", "repro_torch.privacy.adversary",
            "repro_torch.federated.runtime.latency", "repro_torch.federated.runtime.scheduler",
            "repro_torch.federated.runtime.staleness",
            "repro_torch.federated.runtime.async_federation"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import repro_torch.privacy as p\n"
        "assert p.SecAggFedAvg and p.KrumAggregator and p.apply_scenario\n"
        "from repro_torch.federated.api import available_policies\n"
        "assert {'krum', 'secagg-fedavg', 'fedbuff', 'hierarchical-async'} <= "
        "set(available_policies()['aggregator'])\n"
        "from repro_torch.federated.runtime import AsyncFederation\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    for first in modules:  # whichever module loads first, no import cycle bites
        proc = subprocess.run(
            [sys.executable, "-c", f"import {first}\n" + code], capture_output=True, text=True,
            timeout=120, env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"},
        )
        assert proc.returncode == 0, first + proc.stdout + proc.stderr


def test_control_plane_modules_pull_in_no_jax_and_no_repro():
    """The checkpoint store, the metrics registry, the job service and the
    legacy server shims import neither JAX nor the reference, whichever of
    them loads first."""
    modules = ["repro_torch.checkpoint.store", "repro_torch.launch.federation_service",
               "repro_torch.federated.server", "repro_torch.obs", "repro_torch.obs.metrics",
               "repro_torch.obs.profile", "repro_torch.obs.trace", "repro_torch.obs.report",
               "repro_torch.obs.__main__", "repro_torch.launch"]
    assert set(modules) <= set(port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from repro_torch.launch import submit_job, registry_table\n"
        "from repro_torch.federated import FederatedServer\n"
        "from repro_torch.federated.runtime import AsyncFederationSnapshot\n"
        "registry_table()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    for first in modules:
        proc = subprocess.run(
            [sys.executable, "-c", f"import {first}\n" + code], capture_output=True, text=True,
            timeout=120, env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"},
        )
        assert proc.returncode == 0, first + proc.stdout + proc.stderr


def test_dp_chunks_above_the_grid_limit_raise_before_any_launch():
    """A DP chunk of more per-example clients than the card's grid y holds
    (65,535) trains, and its round equals the same clients in chunks that
    fit: round losses within 1e-5, params within 1e-4, both stagings.  The
    name dates from when the cohort engine refused such a chunk, and is kept
    so the test keeps its identity."""
    from repro_torch.data.pipeline import ArrayDataset, ClientDataset
    from repro_torch.federated.cohort import CohortTrainer, client_generators
    from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW
    from repro_torch.privacy.dp import DPConfig
    from repro_torch.tree import tree_leaves

    cfg = GRUConfig(input_dim=3, hidden_dim=4, num_layers=1)
    data = np.random.default_rng(1)
    clients = [ClientDataset(i, ds, ds) for i, ds in enumerate(
        ArrayDataset(data.normal(size=(2, 5, 3)).astype(np.float32),
                     data.uniform(0.5, 2.0, size=2).astype(np.float32))
        for _ in range(65535 // 128 + 1))]   # 512 · 128 = 65,536 per-example clients
    params = init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    for staging in ("rebuild", "resident"):
        rounds = []
        for chunk in (None, 64):
            rng = np.random.default_rng(0)
            gens = client_generators(rng, len(clients), torch.device("cpu"))
            trainer = CohortTrainer(make_loss_fn(cfg), AdamW(), 128, 1, staging=staging,
                                    cohort_chunk=chunk, dp=DPConfig(1.0, 0.5), device="cpu")
            rounds.append((*trainer.train_cohort(params, clients, rng, gens),
                           trainer.last_round_stats))
        (whole, losses, _, stats), (chunked, chunked_losses, _, _) = rounds
        assert stats["per_example_clients"] == 65536 > 65535
        assert np.abs(losses - chunked_losses).max() <= 1e-5
        assert max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(whole), tree_leaves(chunked))) <= 1e-4


TABLES_MODULES = ("repro_torch.metrics.stats", "repro_torch.configs.gru_eicu",
                  "repro_torch.experiments.tables", "repro_torch.experiments.run_full",
                  "repro_torch.experiments.noniid_ablation", "repro_torch.experiments.population",
                  "repro_torch.kernels.analysis")
TORCH_EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def import_alone(target: str) -> subprocess.Popen:
    """A fresh interpreter that imports ``target`` (a module, or an example's
    path) and exits 1 if JAX or the reference is then in ``sys.modules``."""
    if target.endswith(".py"):
        load = ("import importlib.util\n"
                f"spec = importlib.util.spec_from_file_location('ex', {target!r})\n"
                "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    else:
        load = f"import {target}\n"
    code = load + (
        "import sys\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"},
    )


@pytest.mark.parametrize("group", ["modules", "examples"])
def test_tables_modules_and_examples_pull_in_no_jax_and_no_repro(group):
    """Each module of the tables slice and each ``examples/torch_*.py``,
    imported alone in a fresh interpreter (all at once), leaves JAX and the
    reference out."""
    assert set(TABLES_MODULES) <= set(port_modules()) and len(TORCH_EXAMPLES) == 7
    targets = TABLES_MODULES if group == "modules" else [str(p) for p in TORCH_EXAMPLES]
    procs = {target: import_alone(target) for target in targets}
    failed = {}
    for target, proc in procs.items():
        out, _ = proc.communicate(timeout=240)
        if proc.returncode != 0:
            failed[target] = out
    assert not failed


def test_tables_entry_points_raise_without_a_card(no_cuda, monkeypatch):
    from repro_torch.experiments import noniid_ablation, population, tables
    from repro_torch.experiments.paper import ExperimentConfig

    tiny = ExperimentConfig(cohort_scale=0.005, rounds=1, local_epochs=1, central_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        population.run_population_scale(populations=(20,), rounds=1, round_clients=4,
                                        pool_rows=8, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.run_table4(tiny, [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        noniid_ablation.run_noniid_ablation(tiny, [0.35], [0])
    # An example may register a policy (torch_custom_policy: "median-band");
    # it stays in this test.
    from repro_torch.federated import api

    api._load_aggregators()
    for registry in ("_RECRUITMENTS", "_SELECTIONS", "_AGGREGATORS"):
        monkeypatch.setattr(api, registry, dict(getattr(api, registry)))
    for path in TORCH_EXAMPLES:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        argv = ["--scale", "0.005"] if path.stem in ("torch_federated_recruitment",
                                                     "torch_async_federation") else []
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv + (["--train"] if path.stem == "torch_recruitment_sweep" else []))
