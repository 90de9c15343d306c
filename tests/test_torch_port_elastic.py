"""The port's elastic shuffle runner (``membership/elastic.py``) against the
JAX package's, on the same files: 4 Parquet files of 4,096 rows (a key
and a float column drawn by numpy from seed 5), 8 reducers, seed 11.

- A fixed world of 4 ranks gives equal reducer tables in both packages.
- ``member_crash:rank1:epoch0`` kills rank 1 at its first pickup; at the
  boundary rank 1 rejoins and rank 4 joins (5 ranks, an uneven split).
  Both packages' tables equal the fixed world's (``pa.Table.equals``), no
  row is lost, and both recompute the same reducers.
- A rank the detector already downed before the epoch is placed around.
- When every rank dies the runner's backstop completes the epoch.
- ``trainer_streams`` follows ``route_slices`` in both.
"""

import os

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import membership as jmem
from ray_shuffling_data_loader_tpu.membership import elastic as jel
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu_torch import membership as tmem
from ray_shuffling_data_loader_tpu_torch.membership import elastic as tel
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

NUM_FILES, ROWS_PER_FILE, NUM_REDUCERS, SEED = 4, 4096, 8, 11
SIDES = {"port": (tmem, tel, tfaults), "jax": (jmem, jel, jfaults)}


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    tfaults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    rng = np.random.default_rng(5)
    paths = []
    for i in range(NUM_FILES):
        start = i * ROWS_PER_FILE
        table = pa.table({
            "key": pa.array(np.arange(start, start + ROWS_PER_FILE,
                                      dtype=np.int64)),
            "x": pa.array(rng.standard_normal(ROWS_PER_FILE)
                          .astype(np.float32))})
        path = os.path.join(d, f"elastic_{i}.parquet")
        pq.write_table(table, path)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def fixed(files):
    """Each package's fixed world of 4 ranks, 2 epochs."""
    return {name: el.ElasticShuffleRunner(
                files, NUM_REDUCERS, seed=SEED,
                manager=mem.MembershipManager([0, 1, 2, 3])).run(2)
            for name, (mem, el, _) in SIDES.items()}


def _equal(got, want) -> bool:
    return len(got) == len(want) and all(a.equals(b)
                                         for a, b in zip(got, want))


def test_fixed_worlds_equal(fixed):
    for epoch in range(2):
        assert _equal(fixed["port"][epoch], fixed["jax"][epoch])
        assert tel.total_rows(fixed["port"][epoch]) == \
            NUM_FILES * ROWS_PER_FILE


@pytest.mark.parametrize("name", sorted(SIDES))
def test_shrink_then_grow_equals_the_fixed_world(name, files, fixed):
    mem, el, faults = SIDES[name]
    faults.install("member_crash:rank1:epoch0", seed=0)
    manager = mem.MembershipManager([0, 1, 2, 3])
    runner = el.ElasticShuffleRunner(files, NUM_REDUCERS, seed=SEED,
                                     manager=manager)
    epoch0 = runner.run_epoch(0)
    stats0 = dict(runner.last_stats)
    shrunk = manager.current_view()
    manager.member_join(1, reason="rejoin")
    manager.member_join(4, reason="grow")
    epoch1 = runner.run_epoch(1)
    faults.clear()
    assert shrunk.ranks == (0, 2, 3)
    assert manager.current_view().ranks == (0, 1, 2, 3, 4)
    assert manager.current_view().incarnation(1) == 1
    # Rank 1 died at its first pickup: both of its reducers recomputed.
    assert stats0["recomputed"] == 2 and stats0["duplicates_dropped"] == 0
    assert stats0["resize_stall_ms"] > 0.0
    assert runner.last_stats["recomputed"] == 0
    assert runner.last_stats["live_ranks"] == 5
    assert _equal(epoch0, fixed["jax"][0]) and _equal(epoch1,
                                                      fixed["jax"][1])
    rows = el.total_rows(epoch0) + el.total_rows(epoch1)
    assert rows == 2 * NUM_FILES * ROWS_PER_FILE  # rows_lost == 0


def test_both_packages_recompute_the_same_reducers(files):
    stats = {}
    for name, (mem, el, faults) in SIDES.items():
        faults.install("member_crash:rank2:epoch0,member_crash:rank0:epoch0",
                       seed=0)
        runner = el.ElasticShuffleRunner(
            files, NUM_REDUCERS, seed=SEED,
            manager=mem.MembershipManager([0, 1, 2, 3]))
        runner.run_epoch(0)
        faults.clear()
        stats[name] = {k: runner.last_stats[k]
                       for k in ("recomputed", "view_id", "live_ranks")}
    assert stats["port"] == stats["jax"]
    assert stats["port"]["recomputed"] == 4


def test_a_rank_downed_before_the_epoch_is_placed_around(files, fixed):
    manager = tmem.MembershipManager([0, 1, 2, 3])
    manager.member_down(3, reason="detector verdict")
    runner = tel.ElasticShuffleRunner(files, NUM_REDUCERS, seed=SEED,
                                      manager=manager)
    assert _equal(runner.run_epoch(1), fixed["jax"][1])
    assert runner.last_stats["live_ranks"] == 3
    assert runner.last_stats["recomputed"] == 0


@pytest.mark.parametrize("name", sorted(SIDES))
def test_every_rank_dead_the_backstop_completes(name, files, fixed):
    mem, el, faults = SIDES[name]
    faults.install("member_crash:rank0:epoch0,member_crash:rank1:epoch0",
                   seed=0)
    manager = mem.MembershipManager([0, 1])
    runner = el.ElasticShuffleRunner(files, NUM_REDUCERS, seed=SEED,
                                     manager=manager)
    outputs = runner.run_epoch(0)
    assert manager.current_view().ranks == ()
    assert runner.last_stats["recomputed"] == NUM_REDUCERS
    assert _equal(outputs, fixed["port"][0])


@pytest.mark.parametrize("num_trainers", [1, 2, 3, 5])
def test_trainer_streams_follow_route_slices(num_trainers):
    outputs = [object() for _ in range(NUM_REDUCERS)]
    streams = tel.trainer_streams(outputs, num_trainers)
    assert streams == jel.trainer_streams(outputs, num_trainers)
    spans = jir.route_slices(NUM_REDUCERS, num_trainers)
    assert [len(s) for s in streams] == [b - a for a, b in spans]
    assert sum(streams, []) == outputs


def test_runner_rejects_no_reducers(files):
    with pytest.raises(ValueError, match="num_reducers"):
        tel.ElasticShuffleRunner(files, 0, seed=SEED,
                                 manager=tmem.MembershipManager([0]))
