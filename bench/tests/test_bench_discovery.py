"""A later change adds a cell, a traffic mix and a per-layer metric as new
files: the harness finds them by name, with no file of it edited."""

import json
import shutil

from harness import common


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "bench" / "traffic" / "federated-ac.json").read_text())
    traffic.update(local_epochs=2, why="a new mix: two local epochs")
    (root / "bench" / "traffic" / "federated-ac-2ep.json").write_text(json.dumps(traffic))
    (root / "bench" / "metrics" / "rounds_in_window.py").write_text(
        '"""Rounds the window held."""\n\n\ndef read(ctx):\n    return ctx.get("rounds")\n')
    spec["workloads"].append({"name": "fedavg-ac-2ep", "config": "gru-eicu",
                              "traffic": "federated-ac-2ep", "chips": 1, "why": "two epochs"})
    spec["per_layer"].append({"name": "rounds_in_window", "unit": "rounds", "better": "higher",
                              "source": "program_counter", "layer": "round program",
                              "moves": "fed_samples_per_s", "workloads": ["fedavg-ac-2ep"]})
    for m in spec["end_to_end"]:
        if m["name"] == "fed_samples_per_s":
            m["workloads"].append("fedavg-ac-2ep")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = common.find_cell("fedavg-ac-2ep", root / "BENCHMARK.json")
    assert cell["traffic"]["local_epochs"] == 2
    assert [m["name"] for m in cell["per_layer"]] == ["rounds_in_window"]
    reader = common.load_module(root / "bench" / "metrics" / "rounds_in_window.py", "m")
    assert reader.read({"rounds": 7}) == 7
    assert "fed_samples_per_s" in [m["name"] for m in cell["end_to_end"]]


def test_every_named_file_exists():
    spec = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert (common.ROOT / c["file"]).with_name("reference.py").is_file()
    for w in spec["workloads"]:
        traffic = common.load_json(common.BENCH / "traffic" / f"{w['traffic']}.json")
        assert (common.BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
    for m in spec["per_layer"]:
        assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file()
