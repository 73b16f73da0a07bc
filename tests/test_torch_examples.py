"""The port's examples (``examples/torch_*.py``) on the CPU.

Each runs its ``main`` under ``--device cpu`` at its smallest flags; the two
whose smallest run would not fit the tests' time answer ``--help``, and
``federated_recruitment`` runs with ``--mesh auto`` cut to one round of one
epoch, equal to its run without a mesh.  Each takes the reference example's
flags plus ``--device``.  A policy an example registers stays in its test:
the port's registries are restored after each.
"""

import functools
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch.federated import api  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "custom_policy", "recruitment_sweep", "private_federation",
         "async_federation", "federated_recruitment")


@pytest.fixture(autouse=True)
def own_registries(monkeypatch):
    api._load_aggregators()  # the lazy tiers register into the real registries first
    for registry in ("_RECRUITMENTS", "_SELECTIONS", "_AGGREGATORS"):
        monkeypatch.setattr(api, registry, dict(getattr(api, registry)))


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def flags(path: Path) -> set[str]:
    return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', path.read_text()))


@pytest.mark.parametrize("name", NAMES)
def test_flags_are_the_reference_flags_and_device(name):
    assert flags(EXAMPLES / f"torch_{name}.py") == flags(EXAMPLES / f"{name}.py") | {"--device"}


@pytest.mark.parametrize("name, argv, expect", [
    ("quickstart", [], "test metrics:"),
    ("custom_policy", [], "median-band recruited"),
    ("recruitment_sweep", ["--scale", "0.02"], "strategy comparison at gamma_th=0.1"),
    ("async_federation", ["--scale", "0.01", "--flushes", "1"], "--- recruited:"),
])
def test_example_runs_on_the_cpu(capsys, name, argv, expect):
    load(name).main([*argv, "--device", "cpu"])
    assert expect in capsys.readouterr().out


@pytest.mark.parametrize("name", ["private_federation", "federated_recruitment"])
def test_example_answers_help(capsys, name):
    with pytest.raises(SystemExit) as done:
        load(name).main(["--help"])
    assert done.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_federated_recruitment_refuses_the_mesh(capsys, monkeypatch):
    """``--mesh auto`` is ported: in one process it is the run without a mesh,
    the same printed metrics (cut to one round of one epoch to fit).  The
    name dates from when the option was refused, and is kept so the test
    keeps its identity."""
    module = load("federated_recruitment")
    monkeypatch.setattr(module, "ExperimentConfig",
                        functools.partial(module.ExperimentConfig, rounds=1, local_epochs=1))
    printed = []
    for mesh in (["--mesh", "auto"], []):
        module.main(["--scale", "0.002", "--device", "cpu", *mesh])
        printed.append([re.sub(r" tau=\S+", "", line)  # host seconds differ
                        for line in capsys.readouterr().out.splitlines()
                        if "metrics:" in line or "recruited=" in line])
    assert printed[0] == printed[1] and len(printed[0]) == 4
