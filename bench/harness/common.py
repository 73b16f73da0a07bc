"""What every cell's run shares: finding its files by name, the device, the
guard against JAX, and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from (``repro``; ``repro_torch`` is the program).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunFailed(Exception):
    """A run that cannot give a result: it prints none and exits non-zero."""


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A Python file of the benchmark loaded by its path (names may hold
    ``-`` and ``.``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(workload: str, bench_json: Path | None = None) -> dict:
    """The cell named ``workload`` from ``BENCHMARK.json``, with its
    configuration's file, its traffic file and its metrics' entries."""
    root = Path(bench_json).parent if bench_json else ROOT
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunFailed(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config_entry = configs[cell["config"]]
    config_file = root / config_entry["file"]

    def reported(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "name": workload,
        "chips": cell["chips"],
        "config_name": cell["config"],
        "config": load_json(config_file),
        "config_dir": config_file.parent,
        "traffic_name": cell["traffic"],
        "traffic": load_json(root / BENCH.name / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if reported(m)],
        "per_layer": [m for m in spec["per_layer"] if reported(m)],
    }


def cuda_devices(needed: int):
    """The card's name and count; a run without enough cards fails."""
    import torch

    if not torch.cuda.is_available():
        raise RunFailed("no CUDA device is available")
    if torch.cuda.device_count() < needed:
        raise RunFailed(f"the cell needs {needed} CUDA devices, "
                        f"{torch.cuda.device_count()} are available")
    return torch.cuda.get_device_name(0)


def check_entry(name: str, value: float, limit: float) -> dict:
    """One compared number beside its limit; passes when value <= limit."""
    ok = math.isfinite(value) and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def leaf_gaps(prog: dict, ref: dict, basis: dict | None = None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's.  Leaves
    whose ``basis`` norm (the reference's gradient; ``ref`` itself when
    none is given) is under a thousandth of the median leaf's are left out:
    round-off alone moves them."""
    basis = ref if basis is None else basis
    names = sorted(ref)
    med = sorted(ref[k] for k in names)[len(names) // 2]
    floor = 1e-3 * sorted(basis[k] for k in names)[len(names) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names if basis[k] >= floor}


def leaf_gap(prog: dict, ref: dict, basis: dict | None = None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, basis).values())


def median_leaf_gap(prog: dict, ref: dict) -> float:
    """The median of the leaves' gaps (``leaf_gaps``): the bulk of the
    params, where no one small leaf's noise leads."""
    gaps = sorted(leaf_gaps(prog, ref).values())
    return gaps[len(gaps) // 2]


def emit(result: dict, checks: list[dict]) -> None:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output, its checks last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} <= {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def cache_dirs() -> None:
    """Every compile cache at a fixed directory inside the checkout: the
    program's nvcc builds go to ``build/repro_torch`` of its own accord;
    Triton's and PyTorch's extension caches, which the program does not
    use today, are pinned beside them."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
