"""The run's guard against JAX compares whole top-level names."""

import pytest

from harness import common


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax",
                                  "repro", "repro.federated.api"])
def test_refuses(name):
    assert common.forbidden_modules(["numpy", name]) == [name]


@pytest.mark.parametrize("name", ["repro_torch", "repro_torch.federated.api", "jaxtyping", "reprolib"])
def test_admits(name):
    assert common.forbidden_modules(["numpy", name]) == []


def test_a_run_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.argv=['run']; sys.path.insert(0, 'bench'); import run; "
            "from drivers import federated, lm_train; import harness.profile; "
            "import repro_torch.federated.api, repro_torch.launch.steps; "
            "from harness import common; print(common.forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"
