"""Tiny cells for the CPU: the real cells' files, cut to a few small hospitals
or a few narrow layers, run through the same drivers."""

import copy
import json
import shutil
import time

from harness import cohort, common

# The paper's recruited federation: nu-greedy (0.5, 0.5, 0.1) on the seed-0 disclosures.
ARC = [9, 16, 19, 20, 24, 27, 28, 31, 33, 41, 47, 49, 50, 54, 61, 64, 71, 79, 89, 91, 106, 108,
       124, 125, 129, 131, 132, 139, 148, 150, 159, 160, 167, 168, 174]
DP = {"clip_norm": 1.0, "noise_multiplier": 1.0, "delta": 1e-05}


def fed_cell(tmp_path, dp: bool = False) -> dict:
    """fedavg-ac on three of the recruited hospitals, cut to 40, 136 and 68
    train stays in a copy of the configuration's folder under ``tmp_path``
    whose cohort file holds them so; or the same under DP-SGD."""
    cell = copy.deepcopy(common.find_cell("fedavg-ac"))
    small = {31: 40, 41: 136, 79: 68}
    folder = tmp_path / "gru-eicu"
    shutil.copytree(cell["config_dir"], folder, ignore=shutil.ignore_patterns("__pycache__"))
    structure = cohort.load_structure(folder / cell["config"]["cohort"])
    structure["hospitals"] = [dict(h, n_train=small[h["id"]])
                              for h in structure["hospitals"] if h["id"] in small]
    (folder / cell["config"]["cohort"]).write_text(json.dumps(structure))
    cell["config_dir"] = folder
    cell["traffic"]["federation"] = sorted(small)
    if dp:
        cell["traffic"]["privacy"] = dict(DP)
    return cell


def lm_cell(dtype: str = "float32") -> dict:
    cell = copy.deepcopy(common.find_cell("mamba2-train"))
    cell["config"].update(d_model=64, n_layer=2, vocab_size=512, d_state=16, headdim=16,
                          chunk_size=32, dtype=dtype)
    cell["traffic"].update(batch=4, seq_len=80)
    return cell


def run(cell: dict, seed: int = 2**31 + 3) -> tuple[dict, list]:
    import run as bench_run

    return bench_run.execute(cell, seed, 0.0, False, "cpu", time.perf_counter())


def numbers(checks) -> str:
    return json.dumps({c["name"]: c["value"] for c in checks})
