"""The port's sharded serving plane under process death (``serve_pipeline``
as one shard, ``runtime.supervisor.launch_supervised_queue_shards``), on
the CPU.

- Supervised shard processes, one SIGKILLed mid-epoch: the surviving
  shard's rank keeps flowing, the killed one restarts, and the merged
  two-rank stream equals the fault-free run's and the JAX package's
  lineage, table for table.
- Each shard journals only its own ranks (the journals are disjoint), a
  restarted shard resumes from its own ranks alone (as the JAX package's
  resume query says) and queues nothing of the others, and it sweeps
  the segments a killed incarnation left.
- The shard children run without torch and without a card.
"""

import importlib
import json
import os
import signal
import threading
import time
import zlib

import jax  # noqa: F401  (imported before any worker thread needs it)
import pytest

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

# The JAX package's name ``shuffle`` is its function; this is the module.
jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

TRAINERS, EPOCHS, REDUCERS, SEED, ROWS = 2, 2, 4, 9, 600
#: The surviving shard's longest wait for a table while its sibling is
#: dead: far below the restart and redial the dead shard's rank pays.
SURVIVOR_STALL_BUDGET_S = 15.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_shards"))
    filenames, _ = jdg.generate_data_local(ROWS, 2, 1, 0.0, d, seed=3)
    return filenames


def _streams(run, files):
    """Per ``(rank, epoch)``: the key lists of the fault-free lineage's
    tables, from a package's ``shuffle``."""
    streams = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            streams.setdefault((rank, epoch), []).extend(refs)

    run(files, consumer, EPOCHS, REDUCERS, TRAINERS,
        max_concurrent_epochs=1, seed=SEED, collect_stats=False,
        file_cache=None, executor_backend="thread")
    return {key: [r.result().column("key").to_pylist() for r in refs]
            for key, refs in streams.items()}


def _config(files, tmp_path, **kw):
    return dict(filenames=list(files), num_epochs=EPOCHS,
                num_trainers=TRAINERS, num_reducers=REDUCERS, seed=SEED,
                max_concurrent_epochs=1, file_cache=None,
                journal_path=str(tmp_path / "wm.wal"), **kw)


def test_shard_kill9_survivors_flow_and_stream_bit_identical(files,
                                                             tmp_path):
    """SIGKILL shard 1 after its rank's first table: rank 0 (shard 0)
    drains its whole run without stalling past the budget, shard 1
    restarts, rank 1 resumes exactly once, and every rank's every epoch
    equals the fault-free run and the JAX package's."""
    expected = _streams(tsh.shuffle, files)
    assert expected == _streams(jsh.shuffle, files)
    handle_root = str(tmp_path / "handles")
    supervisors, shard_map = tsup.launch_supervised_queue_shards(
        _config(files, tmp_path, handle_dir=handle_root), num_shards=2)
    assert [shard_map.shard_for_rank(r) for r in range(TRAINERS)] == [0, 1]
    got, errors = {}, []
    killed = threading.Event()
    survivor_wait = [0.0]

    def consume(rank):
        try:
            with tds.connect_remote_queue(shard_map, retries=12,
                                          max_batch=1,
                                          initial_backoff_s=0.05) as remote:
                ds = tds.ShufflingDataset(files, EPOCHS, TRAINERS, 50, rank,
                                          batch_queue=remote,
                                          shuffle_result=None, seed=SEED)
                for epoch in range(EPOCHS):
                    ds.set_epoch(epoch)
                    tables, it = [], ds.iter_tables()
                    while True:
                        start = time.monotonic()
                        table = next(it, None)
                        if rank == 0 and killed.is_set():
                            survivor_wait[0] = max(
                                survivor_wait[0], time.monotonic() - start)
                        if table is None:
                            break
                        tables.append(table.column("key").to_pylist())
                        if rank == 1 and not killed.is_set():
                            os.kill(supervisors[1].pid, signal.SIGKILL)
                            killed.set()
                    got[(rank, epoch)] = tables
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    try:
        for address in shard_map.addresses:
            assert tsup.wait_for_server(tuple(address), timeout_s=60)
        rank1 = threading.Thread(target=consume, args=(1,), daemon=True)
        rank1.start()
        assert killed.wait(timeout=60), "the kill point was never reached"
        rank0 = threading.Thread(target=consume, args=(0,), daemon=True)
        rank0.start()
        for thread in (rank0, rank1):
            thread.join(timeout=120)
            assert not thread.is_alive(), "a rank hung"
    finally:
        for supervisor in supervisors:
            supervisor.stop()
    if errors:
        raise errors[0]
    assert supervisors[1].restarts >= 1 and not supervisors[1].failed
    assert supervisors[0].restarts == 0
    assert survivor_wait[0] < SURVIVOR_STALL_BUDGET_S
    assert got == expected
    # Each shard's segments: released on ack, swept after the kill,
    # unlinked at the stop.
    assert [f for _, _, names in os.walk(handle_root) for f in names] == []


def test_shard_configs_and_children(files, tmp_path):
    """The launcher gives each shard its own port, journal and handle
    directory; the children load neither torch nor JAX and see no
    card."""
    supervisors, shard_map = tsup.launch_supervised_queue_shards(
        _config(files, tmp_path, handle_dir=str(tmp_path / "h"),
                child_env={"RSDL_QUEUE_LEASE_TIMEOUT_S": "30"}),
        num_shards=2)
    try:
        for address in shard_map.addresses:
            assert tsup.wait_for_server(tuple(address), timeout_s=60)
        for shard, sup in enumerate(supervisors):
            with open(os.path.join(sup.cleanup_dir, "server.json")) as f:
                config = json.load(f)
            assert (config["shard_index"], config["num_shards"]) == (shard, 2)
            assert config["port"] == shard_map.addresses[shard][1]
            assert config["journal_path"] == jckpt.shard_journal_path(
                str(tmp_path / "wm.wal"), shard, 2)
            assert config["handle_dir"] == str(tmp_path / "h" / f"s{shard}")
            with open(f"/proc/{sup.pid}/maps") as f:
                maps = f.read()
            assert "libtorch" not in maps and "xla_extension" not in maps
            with open(f"/proc/{sup.pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
            assert b"CUDA_VISIBLE_DEVICES=" in env
            assert b"RSDL_QUEUE_LEASE_TIMEOUT_S=30" in env
    finally:
        for sup in supervisors:
            sup.stop()
    assert shard_map.to_json() == jir.ShardMap(
        num_trainers=TRAINERS,
        addresses=[tuple(a) for a in shard_map.addresses]).to_json()


@pytest.mark.parametrize("shard", [0, 1])
def test_journals_disjoint_and_resume_restricted(shard, tmp_path):
    """Shard ``shard``'s journal records its own rank's queues only; the
    resume query over its ranks plans from its own progress alone (the
    unrestricted one would restart at epoch 0), as the JAX package's
    does."""
    base = str(tmp_path / "wm.wal")
    path = tckpt.shard_journal_path(base, shard, 2)
    ranks = tir.shard_ranks(shard, TRAINERS, 2)
    journal = tckpt.WatermarkJournal(path)
    journal.record(tir.queue_index(0, ranks[0], TRAINERS), 2, 100, done=True)
    journal.close()
    state = tckpt.WatermarkJournal.load(path)
    assert {tir.queue_rank(q, TRAINERS) for q in state} == set(ranks)
    port = tir.resume_from_watermarks(state, EPOCHS, TRAINERS, ranks=ranks)
    jstate = jckpt.WatermarkJournal.load(path)
    assert port == jir.resume_from_watermarks(jstate, EPOCHS, TRAINERS,
                                              ranks=ranks)
    assert port == (1, {})
    assert tir.resume_from_watermarks(state, EPOCHS, TRAINERS)[0] == 0


def _serve_shard(files, tmp_path, shard):
    config = _config(files, tmp_path, num_shards=2, shard_index=shard,
                     port=0)
    config["journal_path"] = tckpt.shard_journal_path(
        config["journal_path"], shard, 2)
    return config, tsvc.serve_pipeline(config)


def _drain_keys(remote, queue_idx):
    out = []
    while True:
        item = remote.get(queue_idx)
        if item is None:
            return out
        out.append(item.column("key").to_pylist())


def test_restarted_shard_serves_and_resumes_its_ranks_only(files, tmp_path):
    """Shard 1 in process: it serves rank 1 (a GET for rank 0 fails) and
    journals rank 1's queues alone. Restarted once epoch 0's sentinel is
    journaled as acked, it re-runs epoch 1 alone (the resume over its own
    ranks; over all ranks it would re-run epoch 0) and serves the
    remainder of the lineage; nothing of rank 0 is ever queued."""
    expected = _streams(tsh.shuffle, files)
    q0, q1 = (tir.queue_index(e, 1, TRAINERS) for e in range(EPOCHS))
    config, (server, result, queue) = _serve_shard(files, tmp_path, 1)
    try:
        with tsvc.RemoteQueue(server.address, num_trainers=TRAINERS,
                              max_batch=1, prefetch=False) as remote:
            got = _drain_keys(remote, q0)
            foreign = remote.get(tir.queue_index(0, 0, TRAINERS))
            first = remote.get(q1).column("key").to_pylist()
            remote.get(q1)  # acks the first table of epoch 1
        result.result()
        assert [queue.size(tir.queue_index(e, 0, TRAINERS))
                for e in range(EPOCHS)] == [0, 0]
    finally:
        server.close()
        queue.shutdown()
    assert got == expected[(1, 0)]
    assert first == expected[(1, 1)][0]
    assert "not served by shard 1/2" in str(foreign.error)
    path = config["journal_path"]
    state = tckpt.WatermarkJournal.load(path)
    assert {tir.queue_rank(q, TRAINERS) for q in state} == {1}
    assert (state[q0].seq, state[q1].seq) == (len(got) - 1, 0)
    # The consumer's ack of epoch 0's sentinel.
    journal = tckpt.WatermarkJournal(path)
    journal.record(q0, len(got), state[q0].rows, done=True)
    journal.close()
    state = tckpt.WatermarkJournal.load(path)
    ranks = tir.shard_ranks(1, TRAINERS, 2)
    assert tir.resume_from_watermarks(state, EPOCHS, TRAINERS,
                                      ranks=ranks) == (1, {q1: 1})
    assert tir.resume_from_watermarks(state, EPOCHS, TRAINERS)[0] == 0

    _, (server, result, queue) = _serve_shard(files, tmp_path, 1)
    try:
        with tsvc.RemoteQueue(server.address, num_trainers=TRAINERS,
                              max_batch=2) as remote:
            rest = _drain_keys(remote, q1)
        result.result()
        assert [queue.size(q) for q in range(EPOCHS * TRAINERS)] == \
            [0] * (EPOCHS * TRAINERS)
    finally:
        server.close()
        queue.shutdown()
    assert [first] + rest == expected[(1, 1)]


def test_restart_sweeps_a_killed_incarnation_segments(files, tmp_path):
    """Without ``handle_dir`` a shard's segments go to a directory named
    by its journal's path, so a restart finds and removes what a killed
    incarnation left."""
    config = _config(files, tmp_path, num_shards=2, shard_index=0, port=0)
    journal = os.path.abspath(config["journal_path"])
    handle_dir = os.path.join(
        tsvc.pp.shm_base_dir(),
        f"rsdl-qhandles-{zlib.crc32(journal.encode()):08x}")
    os.makedirs(handle_dir, exist_ok=True)
    stale = os.path.join(handle_dir, "h1_0.arrow")
    with open(stale, "wb") as f:
        f.write(b"left by a killed incarnation")
    server, result, queue = tsvc.serve_pipeline(config)
    try:
        assert not os.path.exists(stale)
        assert server._handle_dir == handle_dir
        with tsvc.RemoteQueue(server.address, num_trainers=TRAINERS,
                              delivery="handle") as remote:
            assert remote.get(0) is not None
            assert os.listdir(handle_dir)
        result.result()
    finally:
        server.close()
        queue.shutdown()
    assert not os.path.exists(handle_dir) or not os.listdir(handle_dir)
