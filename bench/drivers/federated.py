"""Federated rounds of the paper's GRU through ``repro_torch``'s ``Federation``.

Set-up: the cohort's values from the seed on the cell's fixed structure,
the federation the traffic file names (checked against ν-greedy on the
seed-0 disclosures where it is a recruited one), the benchmark's own
initial params, and one ``Federation.run`` with an unbounded round budget.
Its first ``check_rounds`` rounds (the captures happen in the first) belong
to set-up; each client's mean local loss in them is kept for the reference.  The window
then runs whole rounds, each continuing from the last one's params, until
the first round that ends at or after ``--seconds``: its rate is every real
training sample of those rounds over the window's seconds.  A traced run
profiles one more round after the window.  The run is stopped by the
snapshot hook, the program's state freed, and the reference replays the
first rounds to judge them.
"""

from __future__ import annotations

import time

import numpy as np

from harness import cohort as cohort_mod
from harness import common, profile


class _Stop(Exception):
    pass


def _EveryMember():
    """The selection policy of the paper's ac and arc settings (every member
    of the federation every round, as ``"uniform"`` with no fraction), which
    also keeps each round's per-client mean local losses as the round
    program hands them to ``observe``."""
    from repro_torch.federated.api import SelectionPolicy

    class EveryMember(SelectionPolicy):
        def __init__(self):
            self.losses: list[np.ndarray] = []

        def select(self, round_index, federation_ids, rng):
            return np.sort(np.asarray(federation_ids))

        def observe(self, participant_ids, losses):
            self.losses.append(np.asarray(losses, dtype=np.float64).copy())

    return EveryMember()


def federation_ids(cell: dict, structure: dict) -> list[int]:
    """The traffic's federation: every hospital, or its listed ids, which
    must be what ν-greedy chooses from the seed-0 disclosures."""
    traffic = cell["traffic"]
    if traffic["federation"] == "all":
        return [h["id"] for h in structure["hospitals"]]
    ids = sorted(int(i) for i in traffic["federation"])
    check = traffic.get("recruitment_check")
    if check is not None:
        from repro_torch.core.recruitment import ClientStats, RecruitmentConfig, recruit

        stats = [ClientStats(client_id=h["id"], counts=np.asarray(h["seed0_histogram"], np.float64),
                             n=h["n_train"]) for h in structure["hospitals"]]
        got = sorted(int(i) for i in recruit(stats, RecruitmentConfig(*check)).recruited_ids)
        if got != ids:
            raise common.RunFailed(f"nu-greedy on the seed-0 disclosures returns {got}, "
                                   f"not the traffic's federation {ids}")
    return ids


def inputs(cell: dict, seed: int, device: str):
    """The reference module, the federation's hospitals, their arrays from
    the seed, and the benchmark's initial params."""
    import torch

    cfg = cell["config"]
    ref = common.load_module(cell["config_dir"] / "reference.py", "gru_reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    structure = cohort_mod.load_structure(cell["config_dir"] / cfg["cohort"])
    chosen = cohort_mod.select(structure, federation_ids(cell, structure))
    arrays = cohort_mod.make_hospitals(structure, chosen, seed, device)
    model = {k: cfg[k] for k in ("input_dim", "hidden_dim", "num_layers", "dropout")}
    return ref, chosen, arrays, ref.init_params(model, seed, device)


def control(cell: dict, seed: int, device: str, mode: str) -> list:
    """The compared numbers with the reference in the program's place:
    ``"control"`` in float32 with every product's operands rounded to TF32,
    or a fault planted in it in float32 (``"half_batch"``)."""
    import torch

    ref, _, arrays, params0 = inputs(cell, seed, device)
    program = {"control": {"dtype": torch.float32, "tf32": True},
               "float32": {"dtype": torch.float32}}.get(mode, {"dtype": torch.float32,
                                                               "fault": mode})
    return judge(cell, ref, params0, arrays, seed, device, None, program=program)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    import torch

    from repro_torch.data.pipeline import ArrayDataset, ClientDataset
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.models.gru import GRUConfig, make_loss_fn
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim.adamw import AdamW

    cfg, traffic = cell["config"], cell["traffic"]
    ref, chosen, arrays, params0 = inputs(cell, seed, device)
    clients = [ClientDataset(h["id"], ArrayDataset(x, y), ArrayDataset(x[:0], y[:0]))
               for h, (x, y) in zip(chosen, arrays)]
    samples_a_round = sum(len(y) for _, y in arrays) * traffic["local_epochs"]
    model = {k: cfg[k] for k in ("input_dim", "hidden_dim", "num_layers", "dropout")}
    tracer = Tracer(capacity=1 << 20) if trace else None
    selection = _EveryMember()
    fed = Federation(
        FederationConfig(rounds=10**9, local_epochs=traffic["local_epochs"],
                         batch_size=cfg["batch_size"], recruitment="all", selection=selection,
                         aggregator="fedavg", seed=seed, privacy=traffic.get("privacy"),
                         staging=traffic["staging"], cohort_chunk=traffic.get("cohort_chunk")),
        clients, make_loss_fn(GRUConfig(**model)),
        AdamW(cfg["learning_rate"], weight_decay=cfg["weight_decay"]),
        device=device, tracer=tracer)

    n_check = traffic["check_rounds"]
    state = {"losses": [], "window": [], "t0": None, "t_end": None, "prof": None,
             "cohort_steps": []}
    sync = (lambda: torch.cuda.synchronize()) if device != "cpu" else (lambda: None)

    def progress(record):
        state["cohort_steps"].append(fed.cohort_trainer.last_round_stats.get("cohort_steps"))

    def hook(snap):
        done = snap.round_index
        record = snap.history[-1]
        if done <= n_check:
            state["losses"].append(selection.losses[-1])
            if done == n_check:
                sync()
                state["t0"] = time.perf_counter()
            return
        if state["prof"] is not None:
            state["prof"]["steps"] = state["cohort_steps"][-1]
            raise _Stop
        state["window"].append((record, state["cohort_steps"][-1]))
        if time.perf_counter() - state["t0"] >= seconds:
            state["t_end"] = time.perf_counter()
            if not trace:
                raise _Stop
            state["prof"] = {"trace": profile.Session(device)}

    try:
        fed.run(_unflat_like(params0), progress=progress, snapshot_hook=hook)
    except _Stop:
        pass
    prof = state["prof"]
    traced = prof["trace"].finish() if prof is not None else None
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    window_s = state["t_end"] - state["t0"]
    rounds = state["window"]
    spans = tracer.events() if tracer is not None else []
    del fed
    if device != "cpu":
        torch.cuda.empty_cache()

    checks = judge(cell, ref, params0, arrays, seed, device, state["losses"])
    real_steps = sum(r.local_steps for r, _ in rounds)
    slots = sum(c * len(r.participant_ids) for r, c in rounds)
    ctx = {
        "rate": samples_a_round * len(rounds) / window_s,
        "window_s": window_s,
        "rounds": len(rounds),
        "useful_step_share": 100.0 * real_steps / slots,
        "round_overhead_s": _round_overhead(spans, [r.round_index for r, _ in rounds]),
        "trace": traced,
        "units": prof["steps"] if prof is not None else None,
        "work": _gru_work_a_round(cfg, traffic, arrays),
        "params": cfg["params"],
        "time_steps": cfg["time_steps"],
    }
    return {
        "setup_s": state["t0"] - t_start,
        "e2e": {"fed_samples_per_s": ctx["rate"], "peak_device_gib": peak / 2**30},
        "ctx": ctx,
        "attempted": len(rounds),
        "failed": 0,
        "peak_bytes": peak,
        "checks": checks,
    }


def judge(cell, ref, params0, arrays, seed, device, losses, program=None):
    """The reference's first rounds against the program's, by each client's
    mean local loss's gap to the reference's, relative to the reference's:
    in each round the median over the participants, and in the first round
    also the mean weighted by the clients' train stays, which the largest
    hospitals (most of the samples, every step past the median client's)
    carry.  The round's mean loss and its update, leaf by leaf, are not
    compared: local AdamW amplifies rounding in the larger clients from seed
    to seed (``PERF.md``).  ``program`` runs a second reference in the
    program's place (the control, or a planted fault)."""
    import torch

    cfg, traffic = cell["config"], cell["traffic"]
    n_check = traffic["check_rounds"]
    model = {k: cfg[k] for k in ("input_dim", "hidden_dim", "num_layers", "dropout")}
    train = {k: cfg[k] for k in ("batch_size", "learning_rate", "weight_decay", "b1", "b2", "eps")}
    train["local_epochs"] = traffic["local_epochs"]
    dp = traffic.get("privacy")

    def replay(dtype, tf32=False, fault=None):
        rng, gen_rng = np.random.default_rng(seed), np.random.default_rng([seed, 2])
        p, out = params0, []
        for _ in range(n_check):
            p, loss = ref.train_round(p, arrays, rng, gen_rng, model, train, dtype=dtype,
                                      device=device, dp=dp, tf32=tf32, fault=fault)
            out.append(loss)
        return out

    ref_l = replay(torch.float64)
    if program is not None:
        losses = replay(**program)
    limits = traffic["limits"]
    gaps = [np.abs(a - b) / np.abs(b) for a, b in zip(losses, ref_l)]
    stays = np.asarray([len(y) for _, y in arrays], dtype=np.float64)
    checks = [common.check_entry(f"loss{r + 1}_client_gap", float(np.median(g)),
                                 limits[f"loss{r + 1}_client_gap"])
              for r, g in enumerate(gaps)]
    checks.insert(1, common.check_entry("loss1_weighted_gap",
                                        float(np.average(gaps[0], weights=stays)),
                                        limits["loss1_weighted_gap"]))
    return checks


def _unflat_like(tree):
    """A copy of ``tree`` whose leaves are fresh tensors."""
    if isinstance(tree, dict):
        return {k: _unflat_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflat_like(v) for v in tree]
    return tree.detach().clone()


def _round_overhead(spans, rounds) -> float | None:
    """Mean over the window's rounds of the ``round`` event's seconds less
    its ``train`` span's."""
    if not spans:
        return None
    total = {s.args.get("round"): s.dur for s in spans if s.name == "round" and s.args}
    train = {s.args.get("round"): s.dur for s in spans if s.name == "train" and s.args}
    diffs = [total[r] - train[r] for r in rounds if r in total and r in train]
    return sum(diffs) / len(diffs) if diffs else None


def _gru_work_a_round(cfg, traffic, arrays) -> dict:
    """Real samples and real client-steps a round: what the setting
    requires of the GRU kernels (padding rows and steps left out)."""
    b, e = cfg["batch_size"], traffic["local_epochs"]
    sizes = [len(y) for _, y in arrays]
    return {
        "samples": sum(sizes) * e,
        "client_steps": sum(-(-n // b) for n in sizes) * e,
        "per_example": traffic.get("privacy") is not None,
        "hidden": cfg["hidden_dim"],
        "layers": cfg["num_layers"],
        "time_steps": cfg["time_steps"],
    }
