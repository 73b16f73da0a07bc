"""The benchmark's synthetic eICU-like cohort: a fixed structure, values from the seed.

A frozen copy of ``repro_torch/data/synth_eicu.py::generate_cohort`` (the
program's generator at the time the benchmark was written) split in two:

* the *structure* is what the original generator draws at its seed 0: the
  189 hospitals' train sizes (the split included), their case-mix
  parameters (LoS shift and scale, feature offsets, noise scale) and the
  feature loadings.  ``derive_structure`` computes it and
  ``configs/gru-eicu/cohort.json`` holds it, with the seed-0 disclosure
  histograms that recruitment reads.  A cell's work (hospital sizes, the
  federation, the batched steps a round) is a function of the structure
  alone, so it is the same for every ``--seed``.
* the *values* (LoS, latent severity, every feature's noise, the unit
  column) are drawn from ``--seed`` on top of the structure by
  ``make_hospitals``, in a few bulk calls of a ``torch.Generator`` on the
  device.

Only train stays are made: a federated round reads nothing else.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# --- the original generator's constants (paper Table 2) --------------------
NUM_HOSPITALS = 189
TOTAL_STAYS = 89_127
TRAIN_FRACTION = 62_375 / TOTAL_STAYS
NUM_TEMPORAL = 20
NUM_STATIC = 18
NUM_HOURS = 24
LOS_MU0 = float(np.log(2.27))
LOS_SIGMA0 = float(np.sqrt(2.0 * np.log(3.69 / 2.27)))
MU_SHIFT = 0.35
SIGMA_SCALE = (0.75, 1.30)
MIN_HOSPITAL_SIZE = 25
SIZE_POWER = 1.3
NOISE = 1.0
SEVERITY_NOISE = 1.05
LOS_BIN_EDGES = (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 14.0, np.inf)
MIN_TRAIN = 2  # hospitals with fewer train stays are dropped (208 -> 189 in the paper)


def _hospital_sizes(rng: np.random.Generator) -> np.ndarray:
    raw = rng.pareto(SIZE_POWER, size=NUM_HOSPITALS) + 1.0
    budget = TOTAL_STAYS - MIN_HOSPITAL_SIZE * NUM_HOSPITALS
    extra = np.floor(raw / raw.sum() * budget).astype(np.int64)
    sizes = extra + MIN_HOSPITAL_SIZE
    remainder = TOTAL_STAYS - int(sizes.sum())
    order = np.argsort(-sizes)
    sizes[order[:remainder]] += 1
    return sizes


def derive_structure(seed: int = 0) -> dict:
    """The original generator's draws at ``seed``, in its order, reduced to
    the structure: per-hospital train sizes and case mix, the loadings, and
    each hospital's disclosure histogram of its train LoS."""
    rng = np.random.default_rng(seed)
    sizes = _hospital_sizes(rng)
    hospital_id = np.repeat(np.arange(NUM_HOSPITALS, dtype=np.int32), sizes)
    n = TOTAL_STAYS
    mu_shift = rng.normal(0.0, MU_SHIFT, size=NUM_HOSPITALS)
    sig_scale = rng.uniform(*SIGMA_SCALE, size=NUM_HOSPITALS)
    mu_h = LOS_MU0 + mu_shift
    sigma_h = LOS_SIGMA0 * sig_scale
    log_los = rng.normal(mu_h[hospital_id], sigma_h[hospital_id])
    y = np.clip(np.exp(log_los).astype(np.float32), 2.0 / 24.0, 120.0)
    rng.normal(0.0, SEVERITY_NOISE, size=n)
    offset_t = rng.normal(0.0, 0.3, size=(NUM_HOSPITALS, NUM_TEMPORAL))
    offset_s = rng.normal(0.0, 0.3, size=(NUM_HOSPITALS, NUM_STATIC))
    noise_h = rng.uniform(1.0, 1.0, size=NUM_HOSPITALS)
    load_t = rng.normal(0.0, 1.0, size=NUM_TEMPORAL)
    trend = rng.normal(0.0, 0.15, size=NUM_TEMPORAL)
    rng.normal(0.0, NOISE, size=(n, NUM_HOURS, NUM_TEMPORAL))
    load_s = rng.normal(0.0, 0.8, size=NUM_STATIC)
    rng.normal(0.0, NOISE, size=(n, NUM_STATIC))
    rng.integers(0, 4, size=n)
    split = np.full(n, 2, dtype=np.int8)
    perm = rng.permutation(n)
    n_train = int(round(TRAIN_FRACTION * n))
    split[perm[:n_train]] = 0
    train = split == 0
    hospitals = []
    for h in range(NUM_HOSPITALS):
        m = train & (hospital_id == h)
        if int(m.sum()) < MIN_TRAIN:
            continue
        counts, _ = np.histogram(y[m], bins=np.asarray(LOS_BIN_EDGES))
        hospitals.append({
            "id": h,
            "n_train": int(m.sum()),
            "mu": float(mu_h[h]),
            "sigma": float(sigma_h[h]),
            "noise": float(noise_h[h]),
            "offset_t": [float(v) for v in offset_t[h]],
            "offset_s": [float(v) for v in offset_s[h]],
            "seed0_histogram": [int(c) for c in counts],
        })
    return {
        "source_seed": seed,
        "hours": NUM_HOURS,
        "temporal": NUM_TEMPORAL,
        "static": NUM_STATIC,
        "los_mu0": LOS_MU0,
        "los_sigma0": LOS_SIGMA0,
        "noise": NOISE,
        "severity_noise": SEVERITY_NOISE,
        "los_bin_edges": [float(e) for e in LOS_BIN_EDGES[:-1]] + ["inf"],
        "load_t": [float(v) for v in load_t],
        "trend": [float(v) for v in trend],
        "load_s": [float(v) for v in load_s],
        "hospitals": hospitals,
    }


def load_structure(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def select(structure: dict, ids) -> list[dict]:
    """The structure's hospitals with these ids, in ascending id order."""
    wanted = set(int(i) for i in ids)
    chosen = [h for h in structure["hospitals"] if h["id"] in wanted]
    if len(chosen) != len(wanted):
        raise ValueError(f"ids not in the cohort: {sorted(wanted - {h['id'] for h in chosen})}")
    return chosen


def make_hospitals(structure: dict, hospitals: list[dict], seed: int, device):
    """Each hospital's train ``(x (n, 24, 38) float32, y (n,) float32)`` as
    numpy arrays, drawn from ``seed`` on ``device`` in bulk."""
    import torch

    sizes = [h["n_train"] for h in hospitals]
    n = sum(sizes)
    t_h, f_t, f_s = structure["hours"], structure["temporal"], structure["static"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    f32 = dict(dtype=torch.float32, device=device)
    hid = torch.repeat_interleave(torch.arange(len(hospitals), device=device),
                                  torch.tensor(sizes, device=device))
    mu = torch.tensor([h["mu"] for h in hospitals], **f32)[hid]
    sigma = torch.tensor([h["sigma"] for h in hospitals], **f32)[hid]
    noise_h = torch.tensor([h["noise"] for h in hospitals], **f32)[hid]
    offset_t = torch.tensor([h["offset_t"] for h in hospitals], **f32)[hid]
    offset_s = torch.tensor([h["offset_s"] for h in hospitals], **f32)[hid]
    load_t = torch.tensor(structure["load_t"], **f32)
    trend = torch.tensor(structure["trend"], **f32)
    load_s = torch.tensor(structure["load_s"], **f32)

    log_los = mu + sigma * torch.randn(n, generator=gen, **f32)
    y = torch.clamp(torch.exp(log_los), 2.0 / 24.0, 120.0)
    severity = (torch.log(y) - structure["los_mu0"]) / structure["los_sigma0"]
    severity = severity + structure["severity_noise"] * torch.randn(n, generator=gen, **f32)
    hours = torch.arange(t_h, **f32)
    x_t = (severity[:, None, None] * load_t
           + trend * (hours[:, None] / t_h) * severity[:, None, None]
           + 0.10 * torch.sin(2 * np.pi * hours[:, None] / 24.0)
           + offset_t[:, None, :]
           + noise_h[:, None, None] * structure["noise"]
           * torch.randn((n, t_h, f_t), generator=gen, **f32))
    x_s = (severity[:, None] * load_s + offset_s
           + noise_h[:, None] * structure["noise"] * torch.randn((n, f_s), generator=gen, **f32))
    unit = torch.randint(0, 4, (n,), generator=gen, device=device)
    x_s[:, :4] = torch.nn.functional.one_hot(unit, 4).to(torch.float32)
    x = torch.cat([x_t, x_s[:, None, :].expand(n, t_h, f_s)], dim=-1)
    x_np, y_np = x.cpu().numpy(), y.cpu().numpy()
    out, start = [], 0
    for size in sizes:
        out.append((x_np[start:start + size], y_np[start:start + size]))
        start += size
    return out


def steps_per_round(sizes, batch: int, epochs: int) -> tuple[int, int]:
    """(batched steps a round, real client-steps a round) of one chunk of
    every client: the largest client's ceil(n / B) a epoch, and the sum of
    each client's."""
    per = [-(-int(n) // batch) for n in sizes]
    return max(per) * epochs, sum(per) * epochs
