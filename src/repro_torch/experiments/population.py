"""Population-scale tier: recruitment + rounds at 10^3 — 10^5 clients.

The paper recruits from 189 ICUs; the ROADMAP north star is cross-device
scale.  This experiment measures the two costs that must stay flat as the
population grows past anything that fits one resident array:

* **recruitment** — the streaming nu-greedy path
  (``repro_torch.core.recruitment.StreamingRecruiter``) split into its two
  phases: *ingest* (one bounded-memory pass over the disclosure stream;
  inherently one visit per client, reported as per-client microseconds)
  and the *decision* (``finalize()`` — sort the bounded candidate pool and
  cross iota; this is the server-side cost that replaces the exact
  oracle's full-population ``np.stack`` + argsort and must stay flat).
  The exact ``recruit`` runs alongside as the parity/tolerance oracle.
* **per-round training** — a ``CohortTrainer`` with
  ``resident_budget_bytes`` bounding the device cohort to an LRU pool:
  each round samples a fixed ``round_clients`` cohort out of the full
  population and uploads only the rows not already resident, so
  steady-state round time tracks the cohort, not the population.

The port of the JAX package's ``experiments/population.py``: the same
streams (numpy, byte for byte), defaults, report keys and assertions.  The
rounds (``pooled_rounds``) start from the port's ``init_gru`` with a
``torch.Generator`` seeded with ``seed``, draw one dropout generator per
participant from ``default_rng([seed, 3])`` (``cohort.client_generators``;
the sampling and plan stream ``default_rng([seed, 2])`` stays the
reference's), and a round's time ends after ``torch.cuda.synchronize()`` on
the card.  Entries also carry ``cohort_steps``, each round's batched steps.
"""

from __future__ import annotations

import time
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.recruitment import (
    ClientStats,
    RecruitmentConfig,
    StreamingRecruiter,
    StreamingRecruitmentConfig,
    recruit,
)
from repro_torch.data.pipeline import ArrayDataset, ClientDataset
from repro_torch.device import resolve_device
from repro_torch.federated.cohort import CohortTrainer, client_generators
from repro_torch.models.gru import GRUConfig, init_gru, make_loss_fn
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import PyTree, tree_map

NUM_BINS = 10
SEQ_LEN, FEAT = 4, 6          # bench-scale features: the client *count* is
BATCH_SIZE = 4                # the dimension under test, not model FLOPs
N_RANGE = (3, 9)              # per-client stays; fixed so shapes (and the
                              # round's step count) are identical across scales
MODEL = GRUConfig(input_dim=FEAT, hidden_dim=4, num_layers=1)
N_MAX = N_RANGE[1] - 1
# One padded pool row: (n_max + 1) samples of x plus y, float32.
ROW_BYTES = (N_MAX + 1) * SEQ_LEN * FEAT * 4 + (N_MAX + 1) * 4
# steps_per_epoch pinned to the population-wide max so every cohort and
# every scale runs the same schedule length.
STEPS_PER_EPOCH = -(-N_MAX // BATCH_SIZE)

# The candidate pool is the decision's memory bound and must hold the
# recruited prefix (nu-greedy recruits a roughly population-independent
# *fraction*, so the absolute prefix grows with P).  The sweep pins the pool
# and picks gamma_th so the 10^5 prefix (~11%) still fits — that fixed pool
# is exactly what makes the finalize decision flat while the exact oracle's
# full-population sort keeps growing.
STREAM_POOL = 16_384
BENCH_RECRUITMENT = RecruitmentConfig(gamma_dv=0.5, gamma_sa=0.5, gamma_th=0.05)


def synthetic_population_stats(
    num_clients: int, seed: int = 0, chunk: int = 4096
) -> Iterator[ClientStats]:
    """Disclosure stream for a heavy-tailed, non-IID synthetic population.

    Sizes are lognormal (median ~20 stays, heavy right tail); each client's
    LoS histogram is a multinomial draw from its own mixture of a global
    prototype and client-specific noise.  Generated in vectorized chunks so
    the generator itself holds O(chunk) state — the stream really is a
    stream, even at 10^5 clients.
    """
    rng = np.random.default_rng(seed)
    prototype = rng.dirichlet(np.full(NUM_BINS, 2.0))
    start = 0
    while start < num_clients:
        m = min(chunk, num_clients - start)
        sizes = np.maximum(rng.lognormal(3.0, 1.0, size=m).astype(np.int64), 1)
        local = rng.dirichlet(np.full(NUM_BINS, 0.5), size=m)
        mix = rng.uniform(0.2, 0.9, size=(m, 1))
        probs = mix * prototype[None, :] + (1.0 - mix) * local
        counts = rng.multinomial(sizes, probs)
        for i in range(m):
            yield ClientStats(
                client_id=start + i, counts=counts[i], n=int(sizes[i])
            )
        start += m


def synthetic_population_clients(
    num_clients: int, seed: int = 0
) -> list[ClientDataset]:
    """Tiny per-client datasets for population-scale round timing.

    One vectorized draw for the whole population; each client's arrays are
    views into it, so 10^5 clients cost one ~100MB host allocation and no
    per-client RNG calls.
    """
    rng = np.random.default_rng(seed)
    lo, hi = N_RANGE
    sizes = rng.integers(lo, hi, size=num_clients)
    n_max = hi - 1
    x_all = rng.normal(size=(num_clients, n_max, SEQ_LEN, FEAT)).astype(np.float32)
    y_all = rng.uniform(0.5, 20.0, size=(num_clients, n_max)).astype(np.float32)
    clients = []
    for i in range(num_clients):
        n = int(sizes[i])
        ds = ArrayDataset(x_all[i, :n], y_all[i, :n])
        clients.append(ClientDataset(client_id=i, train=ds, val=ds))
    return clients


def _time_membership(result: Any, population: int, lookups: int = 2000) -> float:
    """ns per ``is_recruited`` lookup, including the one-time set build."""
    ids = np.random.default_rng(1).integers(0, population, size=lookups)
    t0 = time.perf_counter()
    hits = sum(result.is_recruited(int(i)) for i in ids)
    elapsed = time.perf_counter() - t0
    assert 0 <= hits <= lookups
    return 1e9 * elapsed / lookups


def pooled_rounds(
    clients: Sequence[ClientDataset],
    params: PyTree,
    *,
    rounds: int = 3,
    round_clients: int = 64,
    pool_rows: int = 256,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """``rounds`` FedAvg rounds of ``round_clients`` sampled clients out of an
    LRU pool of ``pool_rows`` resident rows, from ``params`` (copied to
    ``device``, the card by default).

    Returns the final ``params``, each round's host seconds (ended by a
    synchronize on the card) and batched steps, and the ``trainer`` and its
    ``device_cohort`` (the pool's counters).
    """
    dev = resolve_device(device)
    params = tree_map(lambda p: p.detach().to(dev), params)
    trainer = CohortTrainer(
        loss_fn=make_loss_fn(MODEL),
        optimizer=AdamW(learning_rate=5e-3, weight_decay=5e-3),
        batch_size=BATCH_SIZE,
        local_epochs=1,
        staging="resident",
        resident_budget_bytes=pool_rows * ROW_BYTES,
        device=dev,
    )
    dcohort = trainer.attach_device_cohort(clients)
    sample_rng = np.random.default_rng([seed, 2])
    generator_rng = np.random.default_rng([seed, 3])
    round_times: list[float] = []
    cohort_steps: list[int] = []
    for _ in range(rounds):
        cohort_ids = np.sort(
            sample_rng.choice(len(clients), size=round_clients, replace=False)
        )
        cohort = [clients[int(i)] for i in cohort_ids]
        t0 = time.perf_counter()
        generators = client_generators(generator_rng, len(cohort), dev)
        params, _, _ = trainer.train_cohort(
            params, cohort, sample_rng, generators, steps_per_epoch=STEPS_PER_EPOCH
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_times.append(time.perf_counter() - t0)
        cohort_steps.append(int(trainer.last_round_stats["cohort_steps"]))
    return {
        "params": params,
        "round_times_s": round_times,
        "cohort_steps": cohort_steps,
        "trainer": trainer,
        "device_cohort": dcohort,
    }


def run_population_scale(
    populations: Sequence[int] = (1_000, 10_000, 100_000),
    *,
    rounds: int = 3,
    round_clients: int = 64,
    pool_rows: int = 256,
    exact_limit: int = 100_000,
    config: RecruitmentConfig = BENCH_RECRUITMENT,
    stream_pool: int = STREAM_POOL,
    seed: int = 0,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Recruitment + per-round cost from 10^3 to 10^5 synthetic clients.

    Per population: streaming recruitment (ingest + decision, timed
    separately), the exact oracle for parity/tolerance (up to
    ``exact_limit``), an O(1)-membership micro-assertion on
    ``is_recruited``, and ``rounds`` training rounds of a fixed
    ``round_clients``-client cohort out of an LRU-pooled device cohort of
    ``pool_rows`` rows.  The summary asserts the population contract: the
    recruitment *decision* and the steady-state round time grow sub-linearly
    in population size (the one-pass ingest is inherently linear and is
    reported per client), and streaming matches the exact participant set
    whenever the population fits the exact buffer (the 10^3 leg).
    ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    params0 = init_gru(torch.Generator().manual_seed(seed), MODEL, dev)

    entries: list[dict[str, Any]] = []
    for pop in populations:
        # -- recruitment: one streaming pass + the finalize decision -------
        recruiter = StreamingRecruiter(
            config, stream=StreamingRecruitmentConfig(pool_size=stream_pool)
        )
        t0 = time.perf_counter()
        recruiter.extend(synthetic_population_stats(pop, seed=seed))
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = recruiter.finalize()
        decision_s = time.perf_counter() - t0

        entry: dict[str, Any] = {
            "population": int(pop),
            "recruitment_ingest_s": ingest_s,
            "recruitment_ingest_us_per_client": 1e6 * ingest_s / pop,
            "recruitment_decision_s": decision_s,
            "streaming_mode": streamed.mode,
            "num_recruited_streaming": streamed.num_recruited,
            "pool_exhausted": streamed.pool_exhausted,
        }

        if pop <= exact_limit:
            stats = list(synthetic_population_stats(pop, seed=seed))
            t0 = time.perf_counter()
            exact = recruit(stats, config)
            entry["recruitment_exact_s"] = time.perf_counter() - t0
            entry["num_recruited_exact"] = exact.num_recruited
            streamed_set = set(streamed.recruited_ids.tolist())
            exact_set = set(exact.recruited_ids.tolist())
            entry["overlap_jaccard"] = len(streamed_set & exact_set) / max(
                len(streamed_set | exact_set), 1
            )
            entry["participant_match"] = streamed_set == exact_set
            if streamed.mode == "exact":
                # acceptance contract: within the exact buffer the streaming
                # path IS the oracle — identical participant sets.
                assert entry["participant_match"], (
                    f"streaming/exact participant sets diverged at {pop} clients"
                )
            # O(1) amortized membership: timed on the result with the larger
            # recruited set so the old O(R)-scan regression would show.
            entry["membership_ns_per_lookup"] = _time_membership(exact, pop)
        else:
            entry["membership_ns_per_lookup"] = _time_membership(streamed, pop)

        # -- per-round cost out of the LRU-pooled device cohort ------------
        clients = synthetic_population_clients(pop, seed=seed)
        out = pooled_rounds(
            clients, params0, rounds=rounds, round_clients=round_clients,
            pool_rows=pool_rows, seed=seed, device=dev,
        )
        round_times = out["round_times_s"]
        dcohort = out["device_cohort"]
        stats_round = out["trainer"].last_round_stats or {}
        entry.update(
            {
                # steady state: round 0 pays the first launches and allocations
                "round_time_s": float(np.median(round_times[1:]))
                if len(round_times) > 1
                else round_times[0],
                "round_times_s": round_times,
                "cohort_steps": out["cohort_steps"],
                "pool_rows": dcohort.pool_rows,
                "pool_uploads_total": dcohort.uploads,
                "pool_evictions_total": dcohort.evictions,
                "pool_bytes_resident": dcohort.nbytes,
                "last_round_pool_uploads": stats_round.get("pool_uploads", 0),
                "slice_chunks_last_round": stats_round.get("slice_chunks", 0),
            }
        )
        entries.append(entry)
        if verbose:
            print(
                f"  [population {pop:>7,}] ingest={ingest_s:.2f}s "
                f"decision={decision_s * 1e3:.1f}ms "
                f"round={entry['round_time_s'] * 1e3:.1f}ms "
                f"recruited={streamed.num_recruited} ({streamed.mode})",
                flush=True,
            )

    report: dict[str, Any] = {
        "bench": "population_scale",
        "populations": [int(p) for p in populations],
        "rounds": rounds,
        "round_clients": round_clients,
        "pool_rows": pool_rows,
        "seed": seed,
        "entries": entries,
    }
    if len(entries) >= 2:
        first, last = entries[0], entries[-1]
        pop_ratio = last["population"] / first["population"]
        decision_ratio = last["recruitment_decision_s"] / max(
            first["recruitment_decision_s"], 1e-9
        )
        round_ratio = last["round_time_s"] / max(first["round_time_s"], 1e-9)
        membership = [e["membership_ns_per_lookup"] for e in entries]
        membership_ratio = max(membership) / max(min(membership), 1e-9)
        report.update(
            {
                "population_ratio": pop_ratio,
                "recruitment_decision_ratio": decision_ratio,
                "round_time_ratio": round_ratio,
                "membership_ns_ratio": membership_ratio,
                # the population contract, asserted: decision + round cost
                # grow sub-linearly (at most half the population growth)
                "recruitment_sublinear": bool(decision_ratio < pop_ratio / 2),
                "round_sublinear": bool(round_ratio < pop_ratio / 2),
            }
        )
        # Asserted only across a real spread: below 10x the millisecond-scale
        # timings are noise, not a scaling law.
        if pop_ratio >= 10:
            assert report["recruitment_sublinear"], (
                f"recruitment decision scaled {decision_ratio:.1f}x over a "
                f"{pop_ratio:.0f}x population — not sub-linear"
            )
            assert report["round_sublinear"], (
                f"round time scaled {round_ratio:.1f}x over a "
                f"{pop_ratio:.0f}x population — not sub-linear"
            )
        # O(1) amortized membership: per-lookup cost must not track the
        # population (generous 50x guard vs the ~{pop_ratio}x an O(R) scan
        # would show).
        assert membership_ratio < 50, (
            f"is_recruited lookups scaled {membership_ratio:.0f}x with "
            "population — membership is no longer O(1)"
        )
    return report
