"""The client axis over several processes (``launch/mesh.py``) on the CPU.

The port of the mesh legs of ``tests/test_paper_scale.py``,
``tests/test_staging.py``, ``tests/test_population.py`` and
``tests/test_async_runtime.py``: where the reference shards the client
axis over host devices with ``shard_map``, the port splits it over the
ranks of a gloo process group.  Each world size is spawned once for the
module (``tests/_mesh_ranks.py``, 2 and 4 ranks joined through a
``FileStore``), runs every scenario of its size and writes its results;
this process holds them against

* each other: every rank returns the same params and losses, bit for bit;
* the port's one-process run of the same scenario: losses within 1e-5,
  params within 1e-4 (the sum over ranks is in another order than the
  one-process client order, and AdamW amplifies that, ROADMAP Queue 3);
* the JAX package's run from the same initial params at dropout 0: losses
  within 1e-5, params within 1e-4.

Scenarios: rebuild and resident staging at 2 ranks, chunked (3 clients a
chunk) on both stagings, sampled participation (resident: a participant
trains on the rank that holds its row), DP with ``DPConfig(1.0, 0.0)`` (the
clip binds, no noise), ``hierarchical:2``, ``fedbuff:10`` against sync
FedAvg under the mesh, and 7 clients at 4 ranks (the padding).  Beside
them: the slice fast path under the mesh, the pool's refusal of a mesh of
two, ``"auto"`` in one process equal to ``None`` bit for bit, and a job
whose files only rank 0 writes, cut and resumed by both ranks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _mesh_ranks as M  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data.pipeline import fill_cohort_schedule, skip_cohort_draws  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.federated.cohort import CohortTrainer  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    DataMesh,
    block_of,
    make_data_mesh,
    resolve_mesh,
)
from repro_torch.models import gru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.privacy import dp  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).resolve().parent / "_mesh_ranks.py"
LOSS_TOL = 1e-5
PARAMS_TOL = 1e-4
WORLDS = (2, 4)
SYNC = [name for name in M.SCENARIOS if name != "fedbuff"]
# The JAX run each scenario is held against: chunking and staging change
# the reference's numbers by nothing (chunked within 1e-6).
REFERENCE_OF = {"rebuild": "rebuild", "resident": "rebuild", "chunked": "rebuild",
                "chunked-rebuild": "rebuild", "sampled": "sampled", "dp": "dp",
                "hierarchical": "hierarchical", "padded": "padded",
                "padded-resident": "padded"}


def reference_init():
    jcfg = jax_gru.GRUConfig(input_dim=M.FEAT, hidden_dim=M.HIDDEN, num_layers=1, dropout=0.0)
    return jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(1), jcfg))


def max_gap(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y)))) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Start every rank of both worlds; the processes and their directories."""
    init = M.leaves_of(gru.params_from_jax(reference_init(), "cpu"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    worlds = {}
    for world in WORLDS:
        root = tmp_path_factory.mktemp(f"world{world}")
        np.savez(root / "init.npz", **{f"leaf{i}": a for i, a in enumerate(init)})
        procs = [subprocess.Popen([sys.executable, str(HELPER), str(rank), str(world),
                                   str(root)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for rank in range(world)]
        worlds[world] = (root, procs)
    yield worlds
    for _, procs in worlds.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def reference(launched):
    """The JAX package's run of each reference scenario, while the ranks run."""
    init = reference_init()
    loss_fn = jax_gru.make_loss_fn(
        jax_gru.GRUConfig(input_dim=M.FEAT, hidden_dim=M.HIDDEN, num_layers=1, dropout=0.0))
    out = {}
    for name in sorted(set(REFERENCE_OF.values())):
        _, count, overrides = M.SCENARIOS[name]
        config = {**M.BASE, **{k: v for k, v in overrides.items() if k != "staging"}}
        clients = [jax_pipeline.ClientDataset(
            c.client_id, jax_pipeline.ArrayDataset(c.train.x, c.train.y),
            jax_pipeline.ArrayDataset(c.val.x, c.val.y)) for c in M.make_clients(count)]
        result = JaxFederation(
            JaxFederationConfig(engine="vectorized", staging="rebuild", **config), clients,
            loss_fn, JaxAdamW(learning_rate=5e-3, weight_decay=5e-3)).run(init)
        out[name] = result
    return out


@pytest.fixture(scope="module")
def ranks(launched, reference):
    """Every rank's report and params, by world and rank."""
    out = {}
    for world, (root, procs) in launched.items():
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"rank {rank} of {world} failed:\n{err[-4000:]}"
        for rank in range(world):
            report = json.loads((root / f"rank{rank}.json").read_text())
            with np.load(root / f"rank{rank}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            out[world, rank] = (report, arrays)
    return out


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process run of each scenario: (result, facade)."""
    init = reference_init()
    return {name: M.run_scenario(name, init) for name in M.SCENARIOS}


def rank_params(ranks, name: str, rank: int = 0) -> list[np.ndarray]:
    world = M.SCENARIOS[name][0]
    arrays = ranks[world, rank][1]
    return [arrays[f"{name}:{i}"] for i in range(sum(k.startswith(f"{name}:") for k in arrays))]


# --------------------------------------------------------------------------
# the mesh itself, in one process
# --------------------------------------------------------------------------


def test_blocks_are_the_reference_layout():
    """n clients padded to a multiple of the axis size, block k to rank k."""

    def blocks(n, size):
        return [list(block_of(n, DataMesh(None, k, size))) for k in range(size)]

    assert blocks(7, 4) == [[0, 1], [2, 3], [4, 5], [6]]
    assert blocks(8, 2) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert blocks(2, 4) == [[0], [1], [], []]
    assert list(block_of(5, None)) == [0, 1, 2, 3, 4]
    # Every n and axis size: the blocks cover the clients once, in order,
    # each at most ceil(n / size) long (the padded width).
    for n in range(1, 13):
        for size in range(1, 6):
            got = blocks(n, size)
            assert sum(got, []) == list(range(n))
            assert max(map(len, got)) == -(-n // size)


def test_resolve_mesh_without_a_process_group():
    """``"auto"`` is no mesh in one process; anything but None, "auto" or a
    DataMesh is refused; the port never creates a group itself."""
    assert resolve_mesh(None) is None
    assert resolve_mesh("auto") is None
    with pytest.raises(ValueError, match="'auto'"):
        resolve_mesh("ring")
    with pytest.raises(TypeError, match="DataMesh"):
        resolve_mesh(object())
    with pytest.raises(RuntimeError, match="process group"):
        make_data_mesh()
    assert CohortTrainer(gru.make_loss_fn(M.model_cfg()), AdamW(), 4, 1, mesh="auto",
                         device="cpu").mesh is None


def test_skipped_draws_leave_the_generator_where_the_fill_does():
    clients = M.make_clients(5)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    x = np.zeros((5, 6, 4, M.SEQ_LEN, M.FEAT), np.float32)
    y, mask = np.zeros((5, 6, 4), np.float32), np.zeros((5, 6, 4), np.float32)
    fill_cohort_schedule([c.train for c in clients], 4, 2, a, 3, x, y, mask,
                         np.zeros((5, 6), bool))
    skip_cohort_draws([c.n_train for c in clients], 2, b)
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("staging,chunk", [("resident", 3), ("rebuild", None)])
def test_auto_in_one_process_is_no_mesh_bit_for_bit(staging, chunk):
    init = gru.params_from_jax(reference_init(), "cpu")
    out = []
    for mesh in (None, "auto"):
        fed = Federation(
            FederationConfig(**{**M.BASE, "staging": staging, "cohort_chunk": chunk,
                                "mesh": mesh}),
            M.make_clients(10), gru.make_loss_fn(M.model_cfg()), AdamW(), device="cpu")
        result = fed.run(init)
        assert fed.cohort_trainer.mesh is None
        assert fed.cohort_trainer.last_round_stats["shards"] == 1
        out.append(result)
    assert [r.mean_local_loss for r in out[0].history] == [r.mean_local_loss for r in out[1].history]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out[0].params),
                                                 tree_leaves(out[1].params)))


def test_the_dp_scenario_clips():
    """DPConfig(1.0, 0.0) binds on the scenarios' data: some example's
    gradient at the initial params is above the clip."""
    params = tree_map(lambda q: q.unsqueeze(0), gru.params_from_jax(reference_init(), "cpu"))
    c = M.make_clients(10)[0]
    batch = (torch.from_numpy(c.train.x[None]), torch.from_numpy(c.train.y[None]),
             torch.ones(1, c.n_train))
    _, grads = dp.per_example_value_and_grad(gru.make_loss_fn(M.model_cfg()), params, batch,
                                             None)
    assert float(dp.per_example_clip_factors(grads, 1.0).min()) < 1.0


# --------------------------------------------------------------------------
# sharded rounds against each other, the one-process port and the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(M.SCENARIOS))
def test_every_rank_returns_the_same_round(ranks, name):
    world = M.SCENARIOS[name][0]
    first = ranks[world, 0][0][name]
    for rank in range(1, world):
        report = ranks[world, rank][0][name]
        assert (report["losses"], report["participants"]) == (
            first["losses"], first["participants"])
        assert all(a.tobytes() == b.tobytes() for a, b in zip(
            rank_params(ranks, name, rank), rank_params(ranks, name)))
    stats = [ranks[world, r][0][name]["stats"] for r in range(world)]
    assert [s["rank"] for s in stats] == list(range(world))
    assert all(s["shards"] == world for s in stats)
    if name not in ("fedbuff", "hierarchical"):  # their stats are the last task's or group's
        # the last round's participants, each trained on exactly one rank
        assert sum(s["rank_clients"] for s in stats) == len(first["participants"][-1])


@pytest.mark.parametrize("name", list(M.SCENARIOS))
def test_sharded_round_matches_one_process(ranks, one_process, name):
    report = ranks[M.SCENARIOS[name][0], 0][0][name]
    result, _ = one_process[name]
    assert report["participants"] == [list(map(int, r.participant_ids)) for r in result.history]
    assert report["local_steps"] == result.total_local_steps
    loss_gap = max(abs(a - r.mean_local_loss) for a, r in zip(report["losses"], result.history))
    param_gap = max_gap(rank_params(ranks, name), M.leaves_of(result.params))
    print(f"{name}: sharded against one process: losses {loss_gap:.3g} (bar {LOSS_TOL}), "
          f"params {param_gap:.3g} (bar {PARAMS_TOL})")
    assert loss_gap <= LOSS_TOL and param_gap <= PARAMS_TOL


@pytest.mark.parametrize("name", SYNC)
def test_sharded_round_matches_the_reference(ranks, reference, name):
    report = ranks[M.SCENARIOS[name][0], 0][0][name]
    ref = reference[REFERENCE_OF[name]]
    assert report["participants"] == [list(map(int, r.participant_ids)) for r in ref.history]
    loss_gap = max(abs(a - r.mean_local_loss) for a, r in zip(report["losses"], ref.history))
    param_gap = max_gap(rank_params(ranks, name), jax.tree.leaves(ref.params))
    print(f"{name}: sharded against the reference: losses {loss_gap:.3g} (bar {LOSS_TOL}), "
          f"params {param_gap:.3g} (bar {PARAMS_TOL})")
    assert loss_gap <= LOSS_TOL and param_gap <= PARAMS_TOL


def test_blocks_split_the_round(ranks):
    """Rebuild staging: rank k trains block k of the round; 7 clients at 4
    ranks leave rank 3 one client.  Resident staging at full participation
    trains the same blocks (the rows each rank holds)."""
    for name, n in (("rebuild", 10), ("resident", 10), ("padded", 7), ("padded-resident", 7)):
        world = M.SCENARIOS[name][0]
        got = [ranks[world, r][0][name]["stats"]["rank_clients"] for r in range(world)]
        assert got == [len(block_of(n, DataMesh(None, r, world))) for r in range(world)]
    assert [ranks[4, r][0]["padded"]["stats"]["rank_clients"] for r in range(4)] == [2, 2, 2, 1]


def test_fedbuff_under_the_mesh_matches_sync_under_the_mesh(ranks):
    """The parity gate through the mesh: each one-client task trains on its
    owner's rank and the others add zeros to its all-reduce."""
    sync, asyn = ranks[2, 0][0]["resident"], ranks[2, 0][0]["fedbuff"]
    assert sync["participants"] == asyn["participants"]
    loss_gap = max(abs(a - b) for a, b in zip(sync["losses"], asyn["losses"]))
    param_gap = max_gap(rank_params(ranks, "resident"), rank_params(ranks, "fedbuff"))
    print(f"fedbuff against sync under the mesh: losses {loss_gap:.3g}, params {param_gap:.3g}")
    assert loss_gap <= LOSS_TOL and param_gap <= PARAMS_TOL


# --------------------------------------------------------------------------
# the slice fast path, the pool, "auto" and the control plane at 2 ranks
# --------------------------------------------------------------------------


def test_slice_fastpath_holds_under_the_mesh(ranks):
    """A rank's contiguous run of its own rows is sliced, and the sliced
    round is the gathered one bit for bit."""
    for rank in range(2):
        check = ranks[2, rank][0]["slice"]
        assert check["bitwise"] and check["slice_chunks"] == [2, 0]


def test_pool_refuses_a_mesh_of_two(ranks):
    assert all("single-host" in ranks[2, r][0]["pool"] for r in range(2))


def test_auto_resolves_to_the_process_group(ranks):
    assert [ranks[2, r][0]["auto"] for r in range(2)] == [
        {"size": 2, "rank": r, "backend": "gloo"} for r in range(2)]


def test_only_rank_0_writes_a_job(launched, ranks):
    root = launched[2][0]
    own = root / "job_rank0"
    assert {"job.json", "records.jsonl", "metrics.jsonl", "trace.json", "final",
            "result.json"} <= {p.name for p in own.iterdir()}
    assert not (root / "job_rank1").exists()
    for rank in range(2):
        assert ranks[2, rank][0]["jobs"] == {"status": "completed", "preempted": True,
                                             "resumed": "completed", "resumed_from": 1}
    shared = root / "job_shared"
    with np.load(own / "final" / "arrays.npz") as a, np.load(shared / "final" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    records = (shared / "records.jsonl").read_text().splitlines()
    metrics = (shared / "metrics.jsonl").read_text().splitlines()
    assert len(records) == len(metrics) == 2
