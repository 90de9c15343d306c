"""The port's live rebalancing under process death, over supervised port
shard processes (``runtime.supervisor.launch_supervised_queue_shards``),
on the CPU: the SIGKILL matrix of the JAX package's
``tests/test_rebalance.py``.

- The source shard killed mid-PREPARE: the driver journals an abort and
  unseals, the source restarts from its watermark journal, and rank 0's
  stream equals the fault-free lineage.
- The target shard killed mid-ADOPT (the ``rebalance_commit`` site): the
  driver aborts and unseals the live source, the target restarts, and
  both ranks' streams equal the lineage.
- The driver process (which loads neither torch nor JAX) killed
  mid-decision: its journal ends in an intent, the restarted controller
  aborts it, and the shards never heard of it.
- ``serve_pipeline`` with ``config["placement"]`` owns, redirects and
  resumes the ranks the JAX package's does for the same overrides, and
  queues the same items.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import pytest

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import multiqueue_service as jsvc
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import rebalance as trb
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINERS, REDUCERS, SEED, ROWS = 2, 4, 13, 600
#: Every wait on a thread or a child process ends within this.
JOIN_S = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_rebalance"))
    filenames, _ = jdg.generate_data_local(ROWS, 2, 1, 0.0, d, seed=5)
    return filenames


@pytest.fixture(scope="module")
def lineage(files):
    """Per ``(rank, epoch)``: the key lists of the fault-free lineage's
    tables (one epoch)."""
    streams = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            streams.setdefault((rank, epoch), []).extend(refs)

    tsh.shuffle(files, consumer, 1, REDUCERS, TRAINERS,
                max_concurrent_epochs=1, seed=SEED, collect_stats=False,
                file_cache=None, executor_backend="thread")
    return {key: [r.result().column("key").to_pylist() for r in refs]
            for key, refs in streams.items()}


def _launch(files, tmp_path, chaos=None):
    child_env = {"RSDL_CHAOS_SPEC": chaos, "RSDL_CHAOS_SEED": "0"} \
        if chaos else None
    supervisors, shard_map = tsup.launch_supervised_queue_shards(dict(
        filenames=list(files), num_epochs=1, num_trainers=TRAINERS,
        num_reducers=REDUCERS, seed=SEED, max_concurrent_epochs=1,
        file_cache=None, journal_path=str(tmp_path / "wm.wal"),
        child_env=child_env), num_shards=2)
    try:
        for address in shard_map.addresses:
            assert tsup.wait_for_server(tuple(address), timeout_s=60)
    except BaseException:
        _stop(supervisors)
        raise
    return supervisors, shard_map


def _stop(supervisors):
    for supervisor in supervisors:
        supervisor.stop()


def _drain(shard_map, files, rank, on_table=None):
    """Rank ``rank``'s one epoch through a ``ShufflingDataset`` over the
    shard map, on a thread joined within ``JOIN_S``: its tables' key
    lists."""
    got, errors = [], []

    def run():
        try:
            with tds.connect_remote_queue(shard_map, retries=20,
                                          initial_backoff_s=0.05,
                                          max_batch=2) as remote:
                ds = tds.ShufflingDataset(files, 1, TRAINERS, 50, rank,
                                          batch_queue=remote,
                                          shuffle_result=None, seed=SEED)
                ds.set_epoch(0)
                for table in ds.iter_tables():
                    got.append(table.column("key").to_pylist())
                    if on_table is not None:
                        on_table(len(got))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True,
                              name=f"drain-rank{rank}")
    thread.start()
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive(), f"rank {rank}'s drain hung"
    if errors:
        raise errors[0]
    return got


def test_kill9_source_mid_prepare_aborts_and_stream_bit_identical(
        files, lineage, tmp_path):
    supervisors, shard_map = _launch(files, tmp_path,
                                     "rebalance_prepare:rank0:epoch1")
    journal = str(tmp_path / "rb.journal")
    controller = trb.RebalanceController(shard_map, journal_path=journal)
    errors = []

    def on_table(count):
        if count == 1:
            try:
                trb.migrate(controller, 0, target=1, reason="churn test",
                            timeout_s=30.0)
            except (OSError, RuntimeError) as e:
                errors.append(e)

    try:
        got = _drain(shard_map, files, 0, on_table)
        # Rank 0's prefetched frames can end its drain before the source
        # shard's supervisor has counted the death on its monitor thread;
        # a stop then would cut the count short. Wait for it first.
        deadline = time.monotonic() + JOIN_S
        while (errors and supervisors[0].restarts < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        _stop(supervisors)
        controller.close()
    assert errors, "the chaos site never fired"
    assert supervisors[0].restarts >= 1 and not supervisors[0].failed
    assert supervisors[1].restarts == 0
    state = trb.replay(journal)
    assert (state.pending, state.generation, state.overrides) == (None, 0,
                                                                  ())
    assert got == lineage[(0, 0)]


def test_kill9_target_mid_commit_aborts_and_both_streams_bit_identical(
        files, lineage, tmp_path):
    supervisors, shard_map = _launch(files, tmp_path,
                                     "rebalance_commit:rank0:epoch1")
    journal = str(tmp_path / "rb.journal")
    controller = trb.RebalanceController(shard_map, journal_path=journal)
    try:
        with pytest.raises((OSError, RuntimeError)):
            trb.migrate(controller, 0, target=1, reason="churn test",
                        timeout_s=30.0)
        got = {(rank, 0): _drain(shard_map, files, rank)
               for rank in range(TRAINERS)}
    finally:
        _stop(supervisors)
        controller.close()
    assert supervisors[1].restarts >= 1 and not supervisors[1].failed
    assert supervisors[0].restarts == 0
    kinds = [r["decision"].kind for r in trb.RebalanceJournal.load(journal)]
    assert kinds == ["bootstrap", "intent", "abort"]
    assert trb.replay(journal).pending is None
    assert got == lineage


_DRIVER = """
import os, signal, sys
from ray_shuffling_data_loader_tpu_torch import rebalance
from ray_shuffling_data_loader_tpu_torch.plan import ir
from ray_shuffling_data_loader_tpu_torch.runtime import faults
faults.configure_from_env()
controller = rebalance.RebalanceController(
    ir.ShardMap.from_json(sys.argv[1]), journal_path=sys.argv[2])
try:
    rebalance.migrate(controller, 0, target=1, reason="driver dies")
except faults.InjectedFault:
    # The decision plane is host code: no torch, no JAX.
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax")]
    os.kill(os.getpid(), signal.SIGKILL)
"""


def test_kill9_driver_mid_decision_aborts_on_restart(files, lineage,
                                                     tmp_path):
    supervisors, shard_map = _launch(files, tmp_path)
    journal = str(tmp_path / "rb.journal")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT,
               RSDL_CHAOS_SPEC="rebalance_abort:rank0:epoch1")
    try:
        driver = subprocess.run(
            [sys.executable, "-c", _DRIVER, shard_map.to_json(), journal],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=60)
        assert driver.returncode == -signal.SIGKILL, driver.stderr
        kinds = [r["decision"].kind
                 for r in trb.RebalanceJournal.load(journal)]
        assert kinds == ["bootstrap", "intent"]
        recovered = trb.RebalanceController(shard_map, journal_path=journal)
        state = recovered.current_state()
        recovered.close()
        got = {(rank, 0): _drain(shard_map, files, rank)
               for rank in range(TRAINERS)}
    finally:
        _stop(supervisors)
    assert (state.pending, state.generation, state.overrides) == (None, 0,
                                                                  ())
    assert trb.replay(journal).to_dict() == state.to_dict()
    assert [sup.restarts for sup in supervisors] == [0, 0]
    assert got == lineage


# ---------------------------------------------------------------------------
# serve_pipeline's placement against the JAX package's
# ---------------------------------------------------------------------------

PLACED_TRAINERS, PLACED_EPOCHS = 3, 2
PLACEMENT = {"generation": 1, "overrides": {"0": 1},
             "rank_generations": {"0": 1},
             "addresses": [["127.0.0.1", 1], ["127.0.0.1", 2]]}


def _queue_items(queue, num_queues):
    """Every queue's items as key lists (None: the sentinel)."""
    out = {}
    for q in range(num_queues):
        items = []
        while True:
            try:
                item = queue.get_nowait(q)
            except Exception:  # noqa: BLE001 - each package's Empty
                break
            table = item.result() if hasattr(item, "result") else item
            items.append(None if table is None
                         else table.column("key").to_pylist())
        out[q] = items
    return out


@pytest.mark.parametrize("shard", [0, 1])
def test_serve_pipeline_placement_equals_jax(files, shard, tmp_path):
    """Rank 0 moved to shard 1 at generation 1, epoch 0 of ranks 0 and 1
    consumed and two tables of rank 0's epoch 1: each package's shard
    owns, redirects and resumes the same ranks (the JAX ``_resume_plan``
    over the ranks the overrides give it) and queues the same items."""
    num_queues = PLACED_EPOCHS * PLACED_TRAINERS
    journal = str(tmp_path / "wm.wal")
    writer = jckpt.WatermarkJournal(journal)
    for rank in (0, 1):
        writer.record(jir.queue_index(0, rank, PLACED_TRAINERS), 4, 0,
                      done=True)
    writer.record(jir.queue_index(1, 0, PLACED_TRAINERS), 0, 0)
    writer.close()
    outcome = {}
    for pkg, svc in (("port", tsvc), ("jax", jsvc)):
        path = str(tmp_path / f"{pkg}.wal")
        shutil.copy(journal, path)
        config = dict(filenames=list(files), num_epochs=PLACED_EPOCHS,
                      num_trainers=PLACED_TRAINERS, num_reducers=REDUCERS,
                      seed=SEED, max_concurrent_epochs=1, file_cache=None,
                      num_workers=1, journal_path=path, port=0,
                      num_shards=2, shard_index=shard,
                      placement=json.loads(json.dumps(PLACEMENT)))
        server, result, queue = svc.serve_pipeline(config)
        try:
            result.result(timeout=JOIN_S)
            outcome[pkg] = {
                "owns": [server._owns_queue(q) for q in range(num_queues)],
                "moved": dict(server._moved),
                "extra": sorted(server._extra_ranks),
                "rank_gen": dict(server._rank_gen),
                "items": _queue_items(queue, num_queues)}
        finally:
            server.close()
            queue.shutdown()
    assert outcome["port"] == outcome["jax"]
    owned = [r for r in range(PLACED_TRAINERS)
             if {"0": 1}.get(str(r), r % 2) == shard]
    assert outcome["port"]["owns"] == [
        tir.queue_rank(q, PLACED_TRAINERS) in owned
        for q in range(num_queues)]
    start, skip = jsvc._resume_plan(jckpt.WatermarkJournal.load(journal),
                                    PLACED_EPOCHS, PLACED_TRAINERS,
                                    ranks=owned)
    streams = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            streams.setdefault((rank, epoch), []).extend(
                r.result().column("key").to_pylist() for r in refs)

    tsh.shuffle(files, consumer, PLACED_EPOCHS, REDUCERS, PLACED_TRAINERS,
                max_concurrent_epochs=1, seed=SEED, collect_stats=False,
                file_cache=None, executor_backend="thread")
    items = outcome["port"]["items"]
    for q in range(num_queues):
        epoch, rank = divmod(q, PLACED_TRAINERS)
        if rank not in owned or epoch < start:
            assert items[q] == [], q
        else:
            assert items[q] == (streams[(rank, epoch)][skip.get(q, 0):]
                                + [None]), q
    assert (start, skip) == ((1, {jir.queue_index(1, 0, 3): 1})
                             if shard == 1 else (0, {}))
