"""One rank of the data-mesh tests' gloo groups, and the scenarios they run.

    PYTHONPATH=src python tests/_mesh_ranks.py RANK WORLD DIR

Joins a gloo group of WORLD ranks through a ``FileStore`` in DIR, runs every
scenario of that world size on the CPU from the initial params in
DIR/init.npz, and writes DIR/rank<RANK>.npz (each run's final params) and
DIR/rank<RANK>.json (losses, participants and round stats, and the
world-2 checks: the slice fast path, the pool's refusal, "auto" and the
control plane's jobs).  ``tests/test_torch_mesh.py`` runs the same
scenarios in one process and holds the ranks against them and against the
JAX package.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed

SEQ_LEN, FEAT = 4, 6
HIDDEN = 4
BASE = dict(rounds=2, local_epochs=2, batch_size=4, seed=0, recruitment="all",
            selection="uniform", aggregator="fedavg")
# name: (world size, clients, FederationConfig overrides); "fedbuff" runs the
# async facade.
SCENARIOS = {
    "rebuild": (2, 10, dict(staging="rebuild")),
    "resident": (2, 10, dict(staging="resident")),
    "chunked": (2, 10, dict(staging="resident", cohort_chunk=3)),
    "chunked-rebuild": (2, 10, dict(staging="rebuild", cohort_chunk=3)),
    "sampled": (2, 10, dict(staging="resident", selection="uniform:0.5")),
    "dp": (2, 10, dict(staging="resident", privacy={"clip_norm": 1.0, "noise_multiplier": 0.0})),
    "hierarchical": (2, 10, dict(staging="resident", aggregator="hierarchical:2")),
    "fedbuff": (2, 10, dict(staging="resident", aggregator="fedbuff:10", latency="constant")),
    "padded": (4, 7, dict(staging="rebuild")),
    "padded-resident": (4, 7, dict(staging="resident")),
}
JOB = {"mode": "sync", "rounds": 2, "local_epochs": 1, "batch_size": 8, "mesh": "auto",
       "data": {"scale": 0.002, "num_hospitals": 4, "split_mode": "stratified"},
       "model": {"hidden_dim": 2, "num_layers": 1}, "observability": {"trace": True}}


def make_clients(count: int, seed: int = 0):
    """``count`` clients of 2..9 stays, from ``seed``: numpy arrays, so the
    JAX package's datasets can wrap the same ones."""
    from repro_torch.data.pipeline import ArrayDataset, ClientDataset

    rng = np.random.default_rng(seed)
    clients = []
    for i, n in enumerate(rng.integers(2, 10, count)):
        x = rng.normal(size=(int(n), SEQ_LEN, FEAT)).astype(np.float32)
        y = rng.uniform(0.5, 20.0, size=int(n)).astype(np.float32)
        ds = ArrayDataset(x, y)
        clients.append(ClientDataset(client_id=i, train=ds, val=ds))
    return clients


def model_cfg():
    from repro_torch.models.gru import GRUConfig

    return GRUConfig(input_dim=FEAT, hidden_dim=HIDDEN, num_layers=1, dropout=0.0)


def run_scenario(name: str, init: dict, mesh=None):
    """One scenario's federation on the CPU from ``init`` (numpy leaves by
    name): ``(result, facade)``."""
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.federated.runtime import AsyncFederation, AsyncFederationConfig
    from repro_torch.models.gru import make_loss_fn, params_from_jax
    from repro_torch.optim.adamw import AdamW

    _, count, overrides = SCENARIOS[name]
    config = {**BASE, **overrides, "mesh": mesh}
    if name == "fedbuff":
        config.pop("selection")
        facade, cfg_cls = AsyncFederation, AsyncFederationConfig
    else:
        facade, cfg_cls = Federation, FederationConfig
    fed = facade(cfg_cls(**config), make_clients(count), make_loss_fn(model_cfg()),
                 AdamW(learning_rate=5e-3, weight_decay=5e-3), device="cpu")
    return fed.run(params_from_jax(init, "cpu")), fed


def leaves_of(params) -> list[np.ndarray]:
    """A params tree's leaves as numpy arrays, in ``tree_leaves`` order."""
    from repro_torch.tree import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(params)]


def params_of(leaves) -> dict:
    """The GRU params tree (numpy leaves) holding ``leaves`` in order."""
    from repro_torch.models.gru import init_gru
    from repro_torch.tree import tree_map

    it = iter(leaves)
    return tree_map(lambda _: next(it), init_gru(torch.Generator(), model_cfg(), "cpu"))


def summary(result, fed) -> dict:
    stats = fed.cohort_trainer.last_round_stats or {}
    return {
        "losses": [float(r.mean_local_loss) for r in result.history],
        "participants": [list(map(int, r.participant_ids)) for r in result.history],
        "local_steps": int(result.total_local_steps),
        "stats": {k: stats.get(k) for k in (
            "shards", "rank", "rank_clients", "cohort_steps", "chunks", "slice_chunks")},
    }


def slice_fastpath_check(mesh) -> dict:
    """A resident all-participants round of 12 clients in chunks of 4, the
    slice fast path on and off: the rank's sliced chunks and whether the
    params are the same bits."""
    from repro_torch.federated.cohort import CohortTrainer, client_generators
    from repro_torch.models.gru import init_gru, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    clients = make_clients(12, seed=5)
    out, sliced = [], []
    for fast in (True, False):
        trainer = CohortTrainer(make_loss_fn(model_cfg()), AdamW(), 4, 1, cohort_chunk=4,
                                mesh=mesh, staging="resident", slice_fastpath=fast,
                                device="cpu")
        params = init_gru(torch.Generator().manual_seed(1), model_cfg(), "cpu")
        gens = client_generators(np.random.default_rng(2), len(clients), torch.device("cpu"))
        got, _, _ = trainer.train_cohort(params, clients, np.random.default_rng(1), gens)
        out.append(leaves_of(got))
        sliced.append(trainer.last_round_stats["slice_chunks"])
    return {"slice_chunks": sliced,
            "bitwise": all(a.tobytes() == b.tobytes() for a, b in zip(*out))}


def pool_refusal(mesh) -> str:
    """The error of a device cohort pooled to two rows under ``mesh``, as
    the reference's ``test_pool_refuses_mesh`` builds it."""
    from repro_torch.data.device_cohort import build_device_cohort

    clients = make_clients(8, seed=7)
    max_n = max(c.n_train for c in clients)
    row_bytes = (max_n + 1) * SEQ_LEN * FEAT * 4 + (max_n + 1) * 4
    try:
        build_device_cohort(clients, mesh=mesh, resident_budget_bytes=2 * row_bytes,
                            device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def jobs(rank: int, root: str) -> dict:
    """The job with ``mesh: "auto"`` into a directory of each rank's own
    (only rank 0 may write), then into one shared directory cut after round
    1 and resumed by every rank."""
    from repro_torch.launch.federation_service import JobPreempted, resume_job, submit_job

    own = os.path.join(root, f"job_rank{rank}")
    full = submit_job(JOB, own, device="cpu")
    shared = os.path.join(root, "job_shared")
    try:
        submit_job(JOB, shared, device="cpu", preempt_after=1)
        preempted = False
    except JobPreempted:
        preempted = True
    # A preempted job is resumed by a later launch: here, once rank 0 has
    # written its snapshot.
    torch.distributed.barrier()
    resumed = resume_job(shared, device="cpu")
    return {"status": full["status"], "preempted": preempted, "resumed": resumed["status"],
            "resumed_from": resumed["resumed_from"]}


def main(rank: int, world: int, root: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_mesh, resolve_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), world),
                            rank=rank, world_size=world)
    try:
        with np.load(os.path.join(root, "init.npz")) as z:
            init = params_of([z[f"leaf{i}"] for i in range(len(z.files))])
        report: dict = {}
        arrays: dict[str, np.ndarray] = {}
        for name, (size, _, _) in SCENARIOS.items():
            if size != world:
                continue
            result, fed = run_scenario(name, init, mesh="auto")
            report[name] = summary(result, fed)
            arrays.update({f"{name}:{i}": v for i, v in enumerate(leaves_of(result.params))})
        if world == 2:
            mesh = make_data_mesh()
            auto = resolve_mesh("auto")
            report["auto"] = {"size": auto.size, "rank": auto.rank, "backend": auto.backend}
            report["slice"] = slice_fastpath_check(mesh)
            report["pool"] = pool_refusal(mesh)
            report["jobs"] = jobs(rank, root)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(root, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(report, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
