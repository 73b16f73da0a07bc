#!/usr/bin/env python3
"""A markdown table of the dry run's records, one row an arch x shape.

    python3 tools/dryrun_table.py [--dir build/repro_torch/dryrun] [--variant baseline]

Reads the records that ``python -m repro_torch.launch.dryrun`` wrote for
the ``single``, ``multi`` and ``host`` meshes and prints, for each arch x
input shape: the argument bytes a device holds on each mesh (params, the
AdamW moments, the batch, the cache), the step's peak live bytes on one
card (the host mesh's meta run), whether that peak fits one 80 GB card,
the step's FLOPs (matmuls and the kernels' work), the reference's
``model_flops`` estimate, and the step's ``compute_s`` and ``memory_s`` on
one card against the datasheet peaks of an NVIDIA H100 80GB HBM3 at 700 W
(estimates, not measurements).  A missing record prints as "-".
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi", "host")


def _gb(x) -> str:
    return "-" if x is None else f"{x / 1e9:.3g}"


def _sci(x) -> str:
    return "-" if x is None else f"{x:.3e}"


def rows(directory: Path, variant: str) -> list[str]:
    records: dict[tuple[str, str], dict[str, dict]] = {}
    for path in sorted(directory.glob(f"*__{variant}.json")):
        record = json.loads(path.read_text())
        records.setdefault((record["arch"], record["shape"]), {})[record["mesh"]] = record
    out = [
        "| arch | shape | GB a device: single / multi / one card | peak GB, one card | fits 80 GB "
        "| FLOPs a step | model FLOPs | compute_s / memory_s, one card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), by_mesh in sorted(records.items()):
        args = " / ".join(_gb(by_mesh[m]["memory"]["argument_size_in_bytes"]) if m in by_mesh
                          else "-" for m in MESHES)
        host = by_mesh.get("host")
        any_record = next(iter(by_mesh.values()))
        peak = host["memory"]["peak_memory_in_bytes"] if host else None
        fits = "-" if host is None else ("yes" if host["memory"]["fits_one_card"] else "no")
        terms = "-" if host is None else (
            f"{_sci(host['roofline']['compute_s'])} / {_sci(host['roofline']['memory_s'])}")
        out.append(f"| {arch} | {shape} | {args} | {_gb(peak)} | {fits} "
                   f"| {_sci(any_record['roofline']['hlo_flops'])} "
                   f"| {_sci(any_record['roofline']['model_flops'])} | {terms} |")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", type=Path, default=ROOT / "build" / "repro_torch" / "dryrun")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args()
    print("\n".join(rows(args.dir, args.variant)))


if __name__ == "__main__":
    main()
