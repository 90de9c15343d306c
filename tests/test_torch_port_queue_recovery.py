"""The port's queue service under faults (``multiqueue_service.py``,
``runtime/supervisor.py``, ``checkpoint.WatermarkJournal``,
``plan.ir.resume_from_watermarks``), on the CPU.

- Chaos: ``conn_reset_midframe``, ``frame_corrupt`` and ``ack_lost`` each
  give the fault-free stream, exactly once.
- Manual acks replay what was not committed; the replay buffer stays
  within its budget (plus the one frame a GET always carries).
- Leases: expiry under ``fail_fast``, ``drain`` and ``redistribute``, and
  a port ``MembershipManager``'s ``down`` verdict expiring a lease at
  once.
- Journals: each package loads the other's ``WatermarkJournal`` (births,
  a torn tail and compaction included), line for line; the resume math
  equals the JAX package's on seeded states.
- A supervised port server process killed by ``SIGKILL`` mid-epoch: the
  consumer's stream equals the JAX package's in-process shuffle key for
  key, and the frames the restarted server regenerates carry their
  original journaled births. The supervisor's restart budget runs out
  loudly; the ``queue_server_crash`` site downs an in-process server.
"""

import importlib
import os
import random
import signal
import subprocess
import sys
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import membership as tmem
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

# The JAX package's name ``shuffle`` is its function; this is the module.
jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    tfaults.clear()


def _fill(n=12, sentinel=True, queues=1):
    queue = tmq.MultiQueue(queues)
    for i in range(n):
        queue.put(0, pa.table({"seq": [i, i * 10]}))
    if sentinel:
        queue.put(0, None)
    return queue


def _drain(remote, queue_idx=0):
    out = []
    while True:
        item = remote.get(queue_idx)
        if item is None:
            return out
        out.append(item.column("seq")[0].as_py())


def _wait(predicate, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


# ---------------------------------------------------------------------------
# Chaos on the wire
# ---------------------------------------------------------------------------

CHAOS = {
    "conn_reset_midframe": ("conn_reset_midframe:task0:after1",
                            "queue_client_reconnects"),
    "frame_corrupt": ("frame_corrupt:task0:after2", "queue_frames_nacked"),
    "ack_lost": ("ack_lost:task0", None),
}


@pytest.mark.parametrize("site", sorted(CHAOS))
def test_chaos_gives_the_fault_free_stream(site):
    spec, counter = CHAOS[site]
    before = tstats.process_recovery_totals()
    injector = tfaults.install(spec, seed=0)
    with tsvc.serve_queue(_fill(14)) as server:
        with tsvc.RemoteQueue(server.address, max_batch=3) as remote:
            assert _drain(remote) == list(range(14))
    after = tstats.process_recovery_totals()
    assert injector.fired(), "the fault never fired"
    if counter is not None:
        assert after[counter] - before[counter] >= 1
        assert (after["queue_frames_replayed"]
                - before["queue_frames_replayed"]) >= 1
    if site == "frame_corrupt":
        assert (after["queue_frames_corrupt"]
                - before["queue_frames_corrupt"]) >= 1


def test_manual_ack_replays_uncommitted():
    with tsvc.serve_queue(_fill(8)) as server:
        remote = tsvc.RemoteQueue(server.address, max_batch=2,
                                  ack_mode="manual", consumer_id=7)
        first = [remote.get(0).column("seq")[0].as_py() for _ in range(4)]
        remote.commit()
        assert remote.get(0).column("seq")[0].as_py() == 4  # uncommitted
        remote.close()  # the trainer dies without committing item 4
        with tsvc.RemoteQueue(server.address, max_batch=2,
                              ack_mode="manual", consumer_id=7) as resumed:
            rest = _drain(resumed)
    assert first == [0, 1, 2, 3]
    assert rest == [4, 5, 6, 7]


def test_replay_buffer_stays_bounded(monkeypatch):
    """Over its byte budget a GET pops one new frame at most: the unacked
    bytes never pass the budget by more than one frame, and an unacking
    consumer still gets the whole stream."""
    frame = tsvc._serialize(pa.table({"seq": [0, 0]})).size
    monkeypatch.setenv("RSDL_QUEUE_REPLAY_BYTES", str(2 * frame))
    peaks = []
    with tsvc.serve_queue(_fill(12)) as server:
        collect = server._collect_frames

        def recording(queue_idx, *args, **kwargs):
            frames = collect(queue_idx, *args, **kwargs)
            peaks.append(server._state(queue_idx).replay_bytes)
            return frames

        server._collect_frames = recording
        with tsvc.RemoteQueue(server.address, max_batch=8,
                              prefetch=False) as remote:
            assert _drain(remote) == list(range(12))
    assert peaks and max(peaks) <= 3 * frame + 64, (peaks, frame)
    monkeypatch.setenv("RSDL_QUEUE_REPLAY_BYTES", "1")
    with tsvc.serve_queue(_fill(6)) as server:
        with tsvc.RemoteQueue(server.address, max_batch=4,
                              ack_mode="manual") as remote:
            assert _drain(remote) == list(range(6))


def test_server_close_joins_blocked_handlers():
    queue = tmq.MultiQueue(1)  # empty: a GET blocks in the server
    server = tsvc.serve_queue(queue)
    remote = tsvc.RemoteQueue(server.address, retries=0, prefetch=False)
    fut = remote._io.submit(remote._fetch_batch, 0)
    assert _wait(lambda: len(server._conn_threads) == 1)
    time.sleep(0.1)
    server.close()
    assert not server._accept_thread.is_alive()
    assert not server._conn_threads
    with pytest.raises((ConnectionError, OSError)):
        fut.result(timeout=10)
    remote.close()


# ---------------------------------------------------------------------------
# Consumer leases
# ---------------------------------------------------------------------------


def _lease_env(monkeypatch, timeout_s, policy):
    monkeypatch.setenv("RSDL_QUEUE_LEASE_TIMEOUT_S", str(timeout_s))
    monkeypatch.setenv("RSDL_QUEUE_ON_DEAD_CONSUMER", policy)


def _two_rank_queue():
    queue = tmq.MultiQueue(2)  # one epoch, ranks 0 and 1
    for i in range(4):
        queue.put(0, pa.table({"seq": [i]}))
    for i in range(4, 6):
        queue.put(1, pa.table({"seq": [i]}))
    return queue


@pytest.mark.parametrize("policy", ["fail_fast", "drain", "redistribute"])
def test_lease_expiry(policy, monkeypatch):
    # The survivor's lease must outlive a loaded host's thread stalls.
    _lease_env(monkeypatch, 1.0 if policy == "redistribute" else 0.4,
               policy)
    before = tstats.process_recovery_totals()["queue_lease_expiries"]
    queue = _two_rank_queue()
    server = tsvc.serve_queue(queue, num_trainers=2)
    try:
        dead = tsvc.RemoteQueue(server.address, max_batch=1,
                                prefetch=False)
        assert dead.get(0).column("seq")[0].as_py() == 0
        survivor = None
        if policy == "redistribute":
            survivor = tsvc.RemoteQueue(server.address, max_batch=1,
                                        prefetch=False)
            assert survivor.get(1).column("seq")[0].as_py() == 4
        dead.close()  # the heartbeats stop, with no goodbye
        if policy == "fail_fast":
            assert _wait(server._closed.is_set)
        elif policy == "drain":
            assert _wait(lambda: queue.size(0) == 0)
            assert queue.size(1) == 2
        else:
            got = [survivor.get(1).column("seq")[0].as_py()
                   for _ in range(4)]
            survivor.close()
            # Rank 1's own table and rank 0's 3 undelivered ones.
            assert sorted(got) == [1, 2, 3, 5]
    finally:
        server.close()
    after = tstats.process_recovery_totals()["queue_lease_expiries"]
    assert after - before >= 1


def test_member_down_force_expires_the_lease(monkeypatch):
    """A ``down`` verdict from a port MembershipManager expires the rank's
    lease at once (the lease clock is 60 s here)."""
    _lease_env(monkeypatch, 60, "drain")
    queue = _two_rank_queue()
    manager = tmem.MembershipManager([0, 1])
    with tsvc.serve_queue(queue, num_trainers=2) as server:
        server.attach_membership(manager)
        with tsvc.RemoteQueue(server.address, max_batch=1,
                              prefetch=False) as remote:
            remote.get(0)
            start = time.monotonic()
            manager.member_down(0, reason="test")
            assert _wait(lambda: queue.size(0) == 0, timeout_s=10)
            assert time.monotonic() - start < 5
            assert queue.size(1) == 2


# ---------------------------------------------------------------------------
# Journals and the resume math
# ---------------------------------------------------------------------------


def _write_journal(ckpt, path):
    journal = ckpt.WatermarkJournal(path)
    journal.record_birth(0, 0, 11, 1.5, 1700000000.25)
    journal.record_birth(0, 4, 11, 2.5, 1700000001.5)
    journal.record(0, 0, 100)
    journal.record(0, 3, 400)
    journal.record(1, 2, 300, done=True)
    journal.record_birth(2, 0, 12, 3.0, 1700000002.0)
    journal.close()
    with open(path, "a") as f:
        f.write('{"crc": 1, "entry": {"q": 0, "seq": 9, "rows": 1, '
                '"done": false}}\n')   # a bad CRC: skipped
        f.write('{"crc": 123, "en')    # a torn tail: skipped


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_watermark_journal_interop(writer, tmp_path):
    w, r = (jckpt, tckpt) if writer == "jax" else (tckpt, jckpt)
    path = str(tmp_path / "wal" / "watermarks.wal")
    _write_journal(w, path)
    ours = r.WatermarkJournal.load(path)
    theirs = w.WatermarkJournal.load(path)
    assert ({q: vars(e) for q, e in ours.items()}
            == {q: vars(e) for q, e in theirs.items()})
    assert (ours[0].seq, ours[0].rows, ours[0].done) == (3, 400, False)
    assert ours[0].births == {4: (11, 2.5, 1700000001.5)}
    assert ours[1].done and ours[2].seq == -1
    assert (r.WatermarkJournal(path).resume_plan(2, 2)
            == w.WatermarkJournal(path).resume_plan(2, 2))
    r.WatermarkJournal(path).compact()
    with open(path) as f:
        compacted = f.read()
    other = str(tmp_path / "other.wal")
    _write_journal(w, other)
    w.WatermarkJournal(other).compact()
    with open(other) as f:
        assert f.read() == compacted  # line for line
    assert ({q: vars(e) for q, e in w.WatermarkJournal.load(path).items()}
            == {q: vars(e) for q, e in ours.items()})


def _random_state(rng, num_epochs, num_trainers, cls):
    state = {}
    for q in range(num_epochs * num_trainers):
        roll = rng.random()
        if roll < 0.25:
            continue
        seq = rng.randrange(-1, 6)
        state[q] = (cls(seq=seq, rows=100 * (seq + 1), done=roll > 0.6)
                    if rng.random() < 0.5 else
                    {"seq": seq, "done": roll > 0.6})
    return state


@pytest.mark.parametrize("seed", range(6))
def test_resume_from_watermarks_equals_jax(seed):
    rng = random.Random(seed)
    num_epochs, num_trainers = rng.randrange(1, 5), rng.randrange(1, 4)
    state = _random_state(rng, num_epochs, num_trainers,
                          tckpt.WatermarkEntry)
    jstate = {q: (jckpt.WatermarkEntry(seq=e.seq, rows=e.rows,
                                       done=e.done)
                  if isinstance(e, tckpt.WatermarkEntry) else e)
              for q, e in state.items()}
    ranks = sorted(rng.sample(range(num_trainers),
                              rng.randrange(1, num_trainers + 1)))
    for kw in ({}, {"ranks": ranks}):
        assert (tir.resume_from_watermarks(state, num_epochs,
                                           num_trainers, **kw)
                == jir.resume_from_watermarks(jstate, num_epochs,
                                              num_trainers, **kw))


# ---------------------------------------------------------------------------
# Server process death: SIGKILL, the journal and lineage regeneration
# ---------------------------------------------------------------------------

KILL_ROWS, KILL_FILES, KILL_REDUCERS, KILL_EPOCHS, KILL_SEED = 600, 2, 6, 2, 5


class _RecordingQueue(tsvc.RemoteQueue):
    """Logs each round trip: when it landed, whether it resumed, and the
    seq and birth of each frame."""

    def __init__(self, *args, **kwargs):
        self.log = []
        super().__init__(*args, **kwargs)

    def _fetch_batch(self, queue_index):
        items, resumed = super()._fetch_batch(queue_index)
        self.log.append((time.monotonic(), queue_index, resumed,
                         [(seq, birth) for seq, _, _, birth, _ in items]))
        return items, resumed


def _jax_keys(files):
    streams = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            streams.setdefault(epoch, []).extend(refs)

    jsh.shuffle(files, consumer, KILL_EPOCHS, KILL_REDUCERS, 1,
                max_concurrent_epochs=1, seed=KILL_SEED, collect_stats=False,
                file_cache=None, executor_backend="thread")
    return {epoch: [r.result().column("key").to_pylist() for r in refs]
            for epoch, refs in streams.items()}


def test_supervised_server_kill9_replays_the_remainder(tmp_path):
    files, _ = jdg.generate_data_local(KILL_ROWS, KILL_FILES, 1, 0.0,
                                       str(tmp_path), seed=8)
    expected = _jax_keys(files)
    supervisor, address = tsup.launch_supervised_queue_server(dict(
        filenames=files, num_epochs=KILL_EPOCHS, num_trainers=1,
        num_reducers=KILL_REDUCERS, seed=KILL_SEED, max_concurrent_epochs=1,
        journal_path=str(tmp_path / "watermarks.wal"), file_cache=None))
    try:
        assert tsup.wait_for_server(address, timeout_s=60)
        first_pid = supervisor.pid
        # Manual acks, committed after each table but the first: the kill
        # comes before any commit, so the restarted server sends queue 0
        # again from its first frame (the client drops what it has by
        # seq), regenerated from the lineage.
        remote = _RecordingQueue(address, retries=12, max_batch=1,
                                 initial_backoff_s=0.05, ack_mode="manual")
        ds = tds.ShufflingDataset(files, KILL_EPOCHS, 1, 50, 0,
                                  batch_queue=remote, shuffle_result=None,
                                  seed=KILL_SEED)
        got, t_kill = {}, None
        for epoch in range(KILL_EPOCHS):
            ds.set_epoch(epoch)
            got[epoch] = []
            for table in ds.iter_tables():
                got[epoch].append(table.column("key").to_pylist())
                if t_kill is None:
                    t_kill = time.monotonic()
                    os.kill(first_pid, signal.SIGKILL)
                else:
                    ds.commit_consumed()
        remote.close()
    finally:
        supervisor.stop()
    assert supervisor.restarts >= 1 and not supervisor.failed
    assert got == expected
    # Frames the first incarnation built (it sent them before the kill)
    # come again from the restarted one with their original births.
    sent_before = {seq for t, q, _, frames in remote.log
                   if t < t_kill and q == 0 for seq, _ in frames}
    again = [(seq, birth) for t, q, resumed, frames in remote.log
             if t > t_kill and q == 0 for seq, birth in frames
             if seq in sent_before]
    assert again, remote.log
    assert all(birth is not None and birth.t_mono < t_kill
               for _, birth in again), again


def test_supervisor_restart_budget_exhaustion(monkeypatch):
    monkeypatch.setenv("RSDL_SUPERVISOR_RETRY_MAX_ATTEMPTS", "3")
    monkeypatch.setenv("RSDL_SUPERVISOR_RETRY_INITIAL_BACKOFF_S", "0.01")
    monkeypatch.setenv("RSDL_SUPERVISOR_RETRY_MAX_BACKOFF_S", "0.02")
    before = tstats.process_recovery_totals()["queue_server_restarts"]
    spawned = []

    def spawn(restart_index):
        proc = subprocess.Popen([sys.executable, "-c", "pass"])
        spawned.append(proc)
        return proc

    supervisor = tsup.ProcessSupervisor(spawn, name="t").start()
    try:
        assert _wait(lambda: supervisor.failed, timeout_s=20)
    finally:
        supervisor.stop()
    assert supervisor.restarts == 3
    assert len(spawned) == 3  # the first and 2 restarts
    after = tstats.process_recovery_totals()["queue_server_restarts"]
    assert after - before == 3


def test_crash_site_downs_the_in_process_server():
    tfaults.install("queue_server_crash:task0", seed=0)
    server = tsvc.serve_queue(_fill(4))
    with tsvc.RemoteQueue(server.address, retries=1,
                          initial_backoff_s=0.05) as remote:
        with pytest.raises((RuntimeError, ConnectionError, OSError)):
            _drain(remote)
    assert server._closed.is_set()


def test_row_offsets_make_a_resumed_skip_exact():
    """A replaying queue's absolute row offsets: a dataset resumed at
    batch 3 skips rows before position 3 * batch whatever the stream
    replays."""
    queue = tmq.MultiQueue(1)
    for i in range(5):
        queue.put(0, pa.table({"k": np.arange(4 * i, 4 * i + 4)}))
    queue.put(0, None)
    with tsvc.serve_queue(queue) as server:
        with tsvc.RemoteQueue(server.address, max_batch=2) as remote:
            ds = tds.ShufflingDataset([], 1, 1, 3, 0, batch_queue=remote,
                                      shuffle_result=None)
            ds.set_epoch(0, skip_batches=3)
            keys = [b.column("k").to_pylist() for b in ds]
    assert keys == [[9, 10, 11], [12, 13, 14], [15, 16, 17], [18, 19]]
