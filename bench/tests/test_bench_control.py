"""The control comes out not correct: each cell's reference, put in the
program's place in the precision below the configuration's, fails one of
the cell's numbers at the cell's own size.  Needs the card."""

import json

import pytest

from harness import common

CELLS = [w["name"] for w in json.loads((common.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_incorrect(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = common.find_cell(workload)
    driver = common.load_module(common.BENCH / "drivers" / f"{cell['traffic']['kind']}.py", "d")
    checks = driver.control(cell, 2**31 + 101, "cuda", "control")
    assert not all(c["ok"] for c in checks), json.dumps(checks)
