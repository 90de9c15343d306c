"""The port's streaming plane (``streaming/``, ``checkpoint.StreamJournal``,
``shuffle.shuffle_epochs(on_epoch_done=)``, the drifting click stream and
the unbounded datasets) against the JAX package's, on the CPU.

The same seeded inputs go through both packages and every comparison is
exact: the synthetic source's events; a directory tail's manifest and its
replay, with a journal written by either package read by the other; the
window assembler under its count, byte and wait bounds and both late
policies (specs and their JSON); ``resume_state`` over a torn tail; the
runner's per-epoch key streams and summary (timings left out) over 8
files in 2-file windows, with its journal resume and the late-file case;
the window-boundary resize under ``member_crash``; the drifting stream's
tables and the online model's history; the unbounded datasets' errors;
and ``DeviceShufflingDataset(num_epochs=None)`` over a 3-window schedule
against ``JaxShufflingDataset``. The JAX side runs on threads (the
``thread_backend`` fixture): its process pool names table segments by
file index, which a stream's windows reuse. One test is the port's alone:
its runner on the process pool streams exactly the thread stream.
"""

import dataclasses
import importlib
import itertools
import json
import os
import subprocess
import sys
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import dataset as jds
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu import membership as jmem
from ray_shuffling_data_loader_tpu import multiqueue as jmq
from ray_shuffling_data_loader_tpu import streaming as jst
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.runtime import policy as jpolicy
from ray_shuffling_data_loader_tpu.streaming import window as jwin
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import membership as tmem
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import procpool
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import streaming as tst
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.runtime import policy as tpolicy
from ray_shuffling_data_loader_tpu_torch.streaming import window as twin
from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo as twl

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

# The JAX package's name ``shuffle`` is its function; this is the module.
jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

ROWS = 32
#: Each package's modules, by the role the tests give them.
PKGS = {
    "jax": dict(st=jst, win=jwin, ckpt=jckpt, mem=jmem, faults=jfaults,
                sh=jsh, mq=jmq, wl=jwl),
    "torch": dict(st=tst, win=twin, ckpt=tckpt, mem=tmem, faults=tfaults,
                  sh=tsh, mq=tmq, wl=twl),
}


def _make_stream_files(directory, num_files, rows=ROWS, prefix="part"):
    """Parquet files with globally unique int64 keys (JAX's test files)."""
    os.makedirs(directory, exist_ok=True)
    files = []
    for i in range(num_files):
        table = pa.table({
            "key": pa.array(range(i * rows, (i + 1) * rows),
                            type=pa.int64()),
            "labels": pa.array(np.arange(rows, dtype=np.float32) / rows),
        })
        path = os.path.join(directory, f"{prefix}_{i:03d}.parquet")
        pq.write_table(table, path)
        files.append(path)
    return files


@pytest.fixture(scope="module")
def files8(tmp_path_factory):
    return _make_stream_files(str(tmp_path_factory.mktemp("stream8")), 8)


def _events(events):
    return [dataclasses.astuple(e) for e in events]


def _drain_source(source):
    events = []
    while not source.exhausted:
        events.extend(source.poll())
    return events


def _spec_tuples(specs):
    return [(s.epoch, tuple(s.filenames), s.window, s.tenant_id,
             s.num_reducers) for s in specs]


class _Scripted:
    """One predefined event per poll (the JAX tests' scripted source)."""

    def __init__(self, events):
        self._events = list(events)
        self._pos = 0

    def poll(self, now=None):
        if self._pos >= len(self._events):
            return []
        self._pos += 1
        return [self._events[self._pos - 1]]

    @property
    def exhausted(self):
        return self._pos >= len(self._events)

    def close(self):
        pass


# ---------------------------------------------------------------------------
# Policy keys and the ingest journal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["window_max_files", "window_max_bytes",
                                 "window_max_wait_s", "window_late_policy"])
def test_stream_policy_keys_equal_jax(key, monkeypatch):
    assert tpolicy.resolve("stream", key) == jpolicy.resolve("stream", key)
    value = "quarantine" if key == "window_late_policy" else "7"
    monkeypatch.setenv(f"RSDL_STREAM_{key.upper()}", value)
    assert tpolicy.resolve("stream", key) == jpolicy.resolve("stream", key)
    assert twin.WindowPolicy.resolve().as_dict() == \
        jwin.WindowPolicy.resolve().as_dict()


def test_window_policy_resolution_and_validation_equal_jax():
    for pkg in (jwin, twin):
        assert pkg.WindowPolicy.resolve(
            max_files=0, max_bytes=0, max_wait_s=0.0).max_files == 1
        with pytest.raises(ValueError, match="late_policy 'drop'"):
            pkg.WindowPolicy(late_policy="drop")


def test_stream_journal_bytes_equal_jax_and_cross_load(tmp_path):
    entries = [{"kind": "file", "n": 0, "path": "/a.parquet", "ts": 1.5,
                "size": 10},
               {"kind": "watermark", "window": 0, "events": 2,
                "watermark": 2.25, "late": 0, "files": 2}]
    paths = {}
    for name, pkg in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.wal")
        journal = pkg["ckpt"].StreamJournal(paths[name])
        for entry in entries:
            journal.append(entry)
        journal.close()
    data = {name: open(path, "rb").read() for name, path in paths.items()}
    assert data["jax"] == data["torch"]
    assert tckpt.StreamJournal.load(paths["jax"]) == entries
    assert jckpt.StreamJournal.load(paths["torch"]) == entries


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_synthetic_source_events_equal_jax(files8, seed):
    kw = dict(seed=seed, total_events=11, mean_interarrival_s=0.5,
              jitter_pct=40.0, start_time=3.0)
    want = _events(_drain_source(jst.SyntheticEventSource(files8[:3], **kw)))
    got = _events(_drain_source(tst.SyntheticEventSource(files8[:3], **kw)))
    assert got == want and len(got) == 11
    # A clocked poll releases the same events by arrival time.
    cutoff = tst.SyntheticEventSource(files8, **kw).arrival_time(4)
    assert _events(tst.SyntheticEventSource(files8, **kw).poll(cutoff)) == \
        _events(jst.SyntheticEventSource(files8, **kw).poll(cutoff))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_directory_tail_manifest_and_replay_across_packages(tmp_path,
                                                            writer):
    """The tail that discovers writes the manifest; the other package's
    tail recovers from it, after the directory changed, and re-yields the
    journaled sequence first, then the newcomer."""
    reader = "torch" if writer == "jax" else "jax"
    stream_dir = str(tmp_path / "arrivals")
    journal = str(tmp_path / "manifest.wal")
    files = _make_stream_files(stream_dir, 2, prefix="a")
    tail = PKGS[writer]["st"].DirectoryTailSource(stream_dir,
                                                  journal_path=journal)
    first = tail.poll()
    assert [e.path for e in first] == sorted(files)
    assert tail.poll() == []
    late = _make_stream_files(stream_dir, 1, prefix="z")[0]
    second = tail.poll()
    tail.close()
    os.remove(late)
    newcomer = _make_stream_files(stream_dir, 1, prefix="b")[0]
    replays = {}
    for name in (reader, writer):
        # Each recovers from its own copy: a recovered tail appends.
        with open(journal, "rb") as f, \
                open(str(tmp_path / f"{name}.copy"), "wb") as out:
            out.write(f.read())
        recovered = PKGS[name]["st"].DirectoryTailSource(
            stream_dir, journal_path=str(tmp_path / f"{name}.copy"))
        replays[name] = _events(recovered.poll())
        recovered.close()
    assert replays[reader] == replays[writer]
    assert replays[reader][:3] == _events(first + second)
    assert [(e[0], e[1]) for e in replays[reader][3:]] == [(3, newcomer)]


def test_directory_tail_skips_half_written_files_as_jax(tmp_path):
    stream_dir = str(tmp_path / "arrivals")
    os.makedirs(stream_dir)
    pending = os.path.join(stream_dir, "pending.parquet")
    open(pending, "w").close()
    tails = [pkg["st"].DirectoryTailSource(stream_dir)
             for pkg in PKGS.values()]
    assert [t.poll() for t in tails] == [[], []]
    with open(pending, "wb") as f:
        f.write(b"x" * 16)
    jax_events, port_events = (_events(t.poll()) for t in tails)
    assert port_events == jax_events and len(port_events) == 1


# ---------------------------------------------------------------------------
# The window assembler
# ---------------------------------------------------------------------------

# (index, timestamp, size) per event: count, byte and wait bounds, and a
# late event behind the watermark.
_ASSEMBLY_EVENTS = [(0, 5.0, 60), (1, 6.0, 10), (2, 10.0, 70), (3, 4.0, 20),
                    (4, 11.0, 30), (5, 16.5, 90), (6, 17.0, 10),
                    (7, 2.0, 10), (8, 25.0, 40)]


@pytest.mark.parametrize("policy", [
    dict(max_files=2),
    dict(max_files=3, late_policy="quarantine"),
    dict(max_files=0, max_bytes=100),
    dict(max_files=0, max_bytes=100, late_policy="quarantine"),
    dict(max_files=0, max_wait_s=5.0),
    dict(max_files=4, max_bytes=120, max_wait_s=6.0),
], ids=["count", "count_quarantine", "bytes", "bytes_quarantine", "wait",
        "all_bounds"])
def test_window_assembler_specs_equal_jax(tmp_path, policy):
    out = {}
    for name, pkg in PKGS.items():
        journal = pkg["ckpt"].StreamJournal(str(tmp_path / f"{name}.wal"))
        assembler = pkg["win"].WindowAssembler(
            pkg["win"].WindowPolicy(**policy), journal=journal,
            first_epoch=3)
        events = [pkg["st"].StreamEvent(index=i, path=f"f{i}", timestamp=ts,
                                        size_bytes=size)
                  for i, ts, size in _ASSEMBLY_EVENTS]
        specs = list(assembler.specs(_Scripted(events)))
        journal.close()
        out[name] = {
            "specs": _spec_tuples(specs),
            "json": json.dumps(pkg["win"].specs_to_dicts(specs),
                               sort_keys=True),
            "quarantined": [e.index for e in assembler.quarantined],
            "late": assembler.late_events,
            "watermark": assembler.ingest_watermark,
            "journal": open(str(tmp_path / f"{name}.wal"), "rb").read(),
            "roundtrip": _spec_tuples(pkg["win"].specs_from_dicts(
                json.loads(json.dumps(pkg["win"].specs_to_dicts(specs))))),
        }
    assert out["torch"] == out["jax"]
    assert out["torch"]["roundtrip"] == out["torch"]["specs"]
    assert len(out["torch"]["specs"]) >= 3


def test_freeze_schedule_and_max_windows_equal_jax(files8):
    out = {}
    for name, pkg in PKGS.items():
        source = pkg["st"].SyntheticEventSource(files8, seed=11,
                                                total_events=7)
        out[name] = _spec_tuples(pkg["win"].freeze_schedule(
            source, policy=pkg["win"].WindowPolicy(max_files=2),
            max_windows=3, first_epoch=1))
    assert out["torch"] == out["jax"]
    assert [s[0] for s in out["torch"]] == [1, 2, 3]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_state_over_a_torn_tail_equal_jax(tmp_path, writer):
    pkg = PKGS[writer]
    path = str(tmp_path / "ingest.wal")
    journal = pkg["ckpt"].StreamJournal(path)
    assembler = pkg["win"].WindowAssembler(
        pkg["win"].WindowPolicy(max_files=2), journal=journal)
    for i in range(5):
        assembler.admit(pkg["st"].StreamEvent(i, f"f{i}", float(i), 1))
        assembler.maybe_close()
    journal.close()
    with open(path, "ab") as f:
        f.write(b'{"crc": 12, "entry": {"kind": "waterma')
    state = twin.resume_state(path)
    assert state == jwin.resume_state(path)
    assert state == {"next_window": 2, "events_sealed": 4,
                     "ingest_watermark": 3.0}


# ---------------------------------------------------------------------------
# The driver's hook and the runner
# ---------------------------------------------------------------------------


def test_on_epoch_done_fires_at_the_same_sites_as_jax(files8):
    """With two epochs in flight, each epoch's hook fires where the driver
    waits on it (the throttle before the next launch, then the final
    drain), interleaved with the spec pulls as in the JAX driver."""
    logs = {}
    for name, pkg in PKGS.items():
        log = []

        def specs(ir=jir if name == "jax" else tir, log=log):
            for epoch in range(4):
                log.append(("pull", epoch))
                yield ir.EpochSpec(epoch=epoch,
                                   filenames=tuple(files8[2 * epoch:
                                                          2 * epoch + 2]))

        pkg["sh"].shuffle_epochs(
            specs(), lambda *a: None, 2, 1, max_concurrent_epochs=2,
            seed=3, file_cache=None,
            on_epoch_done=lambda e, log=log: log.append(("done", e)))
        logs[name] = log
    assert logs["torch"] == logs["jax"]
    assert [e for kind, e in logs["torch"] if kind == "done"] == [0, 1, 2, 3]


def _collect(into):
    def consumer(rank, epoch, refs):
        if refs is None:
            into.setdefault(epoch, [])
            return
        for ref in refs:
            table = ref.result() if hasattr(ref, "result") else ref
            into.setdefault(epoch, []).extend(
                table.column("key").to_pylist())
    return consumer


def _summary(summary):
    return {k: v for k, v in summary.items()
            if k not in ("duration_s", "shuffle_s")}


def _run_and_resume(pkg, files, journal_path):
    """Two windows, then a resumed runner over the same journal with a
    fresh source: ``(keys, summary, resume_skip_events, keys2,
    summary2)``."""
    st = pkg["st"]
    policy = st.WindowPolicy(max_files=2)
    first = {}
    runner = st.StreamingShuffleRunner(
        st.SyntheticEventSource(files, seed=5, total_events=8),
        _collect(first), num_reducers=2, num_trainers=1, seed=5,
        max_concurrent_epochs=2, policy=policy, journal_path=journal_path,
        max_windows=2)
    summary = runner.run()
    runner.close()
    second = {}
    resumed = st.StreamingShuffleRunner(
        st.SyntheticEventSource(files, seed=5, total_events=8),
        _collect(second), num_reducers=2, num_trainers=1, seed=5,
        max_concurrent_epochs=2, policy=policy, journal_path=journal_path)
    skip = resumed.resume_skip_events
    summary2 = resumed.run()
    resumed.close()
    return first, _summary(summary), skip, second, _summary(summary2)


def test_runner_streams_and_journal_resume_equal_jax(files8, tmp_path):
    got = _run_and_resume(PKGS["torch"], files8, str(tmp_path / "t.wal"))
    want = _run_and_resume(PKGS["jax"], files8, str(tmp_path / "j.wal"))
    assert got == want
    first, summary, skip, second, summary2 = got
    assert sorted(first) == [0, 1] and sorted(second) == [2, 3]
    assert skip == 4
    assert summary["serve_watermark"] == summary["ingest_watermark"]
    assert summary2["windows_served"] == 2
    keys = [k for part in (first, second) for e in sorted(part)
            for k in part[e]]
    assert sorted(keys) == list(range(8 * ROWS))
    assert open(str(tmp_path / "t.wal"), "rb").read() == \
        open(str(tmp_path / "j.wal"), "rb").read()


@pytest.mark.parametrize("late_policy", ["admit", "quarantine"])
def test_late_file_during_window_close_equal_jax(tmp_path, late_policy):
    """JAX's late-file case: f3 arrives at t=4 behind the sealed watermark
    6; ``admit`` keeps its rows, ``quarantine`` drops exactly them."""
    files = _make_stream_files(str(tmp_path / "stream"), 5)
    timestamps = [5.0, 6.0, 10.0, 4.0, 11.0]
    out = {}
    for name, pkg in PKGS.items():
        st = pkg["st"]
        events = [st.StreamEvent(index=i, path=files[i],
                                 timestamp=timestamps[i],
                                 size_bytes=os.path.getsize(files[i]))
                  for i in range(5)]
        keys = {}
        runner = st.StreamingShuffleRunner(
            _Scripted(events), _collect(keys), num_reducers=2,
            num_trainers=1, seed=3, max_concurrent_epochs=1,
            policy=st.WindowPolicy(max_files=2, late_policy=late_policy))
        summary = _summary(runner.run())
        out[name] = (keys, summary,
                     [e.index for e in runner.assembler.quarantined])
    assert out["torch"] == out["jax"]
    keys, summary, quarantined = out["torch"]
    flat = [k for e in sorted(keys) for k in keys[e]]
    late_rows = set(range(3 * ROWS, 4 * ROWS))
    if late_policy == "admit":
        assert sorted(flat) == list(range(5 * ROWS)) and quarantined == []
    else:
        assert sorted(flat) == sorted(set(range(5 * ROWS)) - late_rows)
        assert quarantined == [3]
    assert summary["late_events"] == 1
    assert summary["ingest_watermark"] == 11.0


def test_window_boundary_resize_equal_jax(files8):
    """``member_crash:rank1:epoch1``: the window sealed at epoch 1 drops
    rank 1, so it and the later windows run 6 reducers instead of 8; the
    same reducers per window, views and stream as the JAX runner."""
    out = {}
    for name, pkg in PKGS.items():
        st = pkg["st"]
        keys, seen = {}, []
        pkg["faults"].install("member_crash:rank1:epoch1", seed=0)
        try:
            manager = pkg["mem"].MembershipManager([0, 1, 2, 3])
            runner = st.StreamingShuffleRunner(
                st.SyntheticEventSource(files8, seed=5, total_events=8),
                _collect(keys), num_reducers=8, num_trainers=1, seed=5,
                policy=st.WindowPolicy(max_files=2), max_windows=4,
                membership=manager)
            specs = runner._specs

            def recorded(specs=specs, seen=seen):
                for spec in specs():
                    seen.append((spec.epoch, spec.num_reducers,
                                 spec.window["view_id"],
                                 spec.window["view_ranks"]))
                    yield spec

            runner._specs = recorded
            summary = _summary(runner.run())
            runner.close()
        finally:
            pkg["faults"].clear()
        out[name] = (keys, seen, summary, manager.current_view().ranks)
    assert out["torch"] == out["jax"]
    keys, seen, _, ranks = out["torch"]
    assert tuple(ranks) == (0, 2, 3)
    assert [s[1] for s in seen] == [8, 6, 6, 6]
    flat = [k for e in sorted(keys) for k in keys[e]]
    assert sorted(flat) == list(range(8 * ROWS))


def test_port_runner_on_the_process_pool_streams_exactly_once(
        files8, tmp_path, monkeypatch):
    """The port's runner on its process pool (2 workers): every window's
    file 0 is another file, and the pool's segments are named by the
    file, so the stream equals the thread stream key for key, each key
    once. (The JAX pool names them by index and serves stale rows.)"""
    want, _, _, want2, _ = _run_and_resume(PKGS["torch"], files8,
                                           str(tmp_path / "thread.wal"))
    monkeypatch.setenv("RSDL_EXECUTOR_BACKEND", "process")
    monkeypatch.setenv("RSDL_EXECUTOR_WORKERS", "2")
    before = procpool.pool_totals()
    got, summary, skip, got2, summary2 = _run_and_resume(
        PKGS["torch"], files8, str(tmp_path / "process.wal"))
    after = procpool.pool_totals()
    assert (got, got2) == (want, want2)
    keys = [k for part in (got, got2) for e in sorted(part)
            for k in part[e]]
    assert sorted(keys) == list(range(8 * ROWS))
    assert skip == 4 and summary2["windows_served"] == 2
    # Two runs, a pool each; every file mapped once, so no segment hit.
    assert after["pools"] - before["pools"] == 2
    assert after["segment_cache_hits"] == before["segment_cache_hits"]
    assert after["segment_cache_bytes"] > before["segment_cache_bytes"]


# ---------------------------------------------------------------------------
# The drifting click stream
# ---------------------------------------------------------------------------


def test_drifting_stream_and_online_training_equal_jax(tmp_path):
    paths = {name: pkg["wl"].generate_drifting_stream(
                 12, 64, str(tmp_path / name), seed=3)
             for name, pkg in PKGS.items()}
    for port_file, jax_file in zip(paths["torch"], paths["jax"]):
        assert os.path.basename(port_file) == os.path.basename(jax_file)
        assert pq.read_table(port_file).equals(pq.read_table(jax_file))
        port_meta = pq.ParquetFile(port_file).metadata
        jax_meta = pq.ParquetFile(jax_file).metadata
        assert port_meta.num_row_groups == jax_meta.num_row_groups == 1
        assert ({port_meta.row_group(0).column(c).compression
                 for c in range(port_meta.num_columns)}
                == {jax_meta.row_group(0).column(c).compression
                    for c in range(jax_meta.num_columns)} == {"SNAPPY"})
    assert [twl.drifting_ctr(i) for i in range(12)] == \
        [jwl.drifting_ctr(i) for i in range(12)]
    history = twl.run_online_training(paths["torch"], num_windows=6,
                                      files_per_window=2, seed=3,
                                      num_reducers=2)
    assert history == jwl.run_online_training(
        paths["jax"], num_windows=6, files_per_window=2, seed=3,
        num_reducers=2)
    assert [rec["window"] for rec in history] == list(range(6))
    estimates = [rec["estimate"] for rec in history]
    assert max(estimates) - min(estimates) > 0.02


# ---------------------------------------------------------------------------
# Unbounded datasets
# ---------------------------------------------------------------------------


def test_unbounded_shuffling_dataset_errors_equal_jax():
    with pytest.raises(ValueError) as port_error:
        tds.ShufflingDataset([], None, num_trainers=1, batch_size=4, rank=0)
    with pytest.raises(ValueError) as jax_error:
        jds.ShufflingDataset([], None, num_trainers=1, batch_size=4, rank=0)
    assert str(port_error.value) == str(jax_error.value)
    assert "unbounded" in str(port_error.value)
    with pytest.raises(ValueError, match="must be >= 0"):
        tds.ShufflingDataset([], None, 1, 4, 0, batch_queue=tmq.MultiQueue(1),
                             shuffle_result=None, start_epoch=-1)
    ds = tds.ShufflingDataset([], None, 1, 4, 0, start_epoch=2,
                              batch_queue=tmq.MultiQueue(1),
                              shuffle_result=None)
    assert ds.num_epochs is None
    ds.set_epoch(1000)
    with pytest.raises(ValueError, match="precedes start_epoch"):
        ds.set_epoch(1)


def _fill_schedule(pkg, ir, specs, queue):
    def feed(rank, epoch, refs):
        index = ir.queue_index(epoch, rank, 1)
        if refs is None:
            queue.put(index, None)
        else:
            queue.put_batch(index, list(refs))
    pkg["sh"].shuffle_epochs(iter(specs), feed, 3, 1,
                             max_concurrent_epochs=2, seed=4,
                             file_cache=None, epochs_hint=len(specs))


_SPEC = {"feature_columns": ["key"], "feature_types": [np.int32],
         "label_column": "labels"}


@pytest.mark.parametrize("device_rebatch", [True, False],
                         ids=["bulk", "per_batch"])
def test_unbounded_device_dataset_equals_jax(files8, device_rebatch):
    """``DeviceShufflingDataset(num_epochs=None, device="cpu")`` over a
    3-window schedule equals ``JaxShufflingDataset(num_epochs=None)`` batch
    for batch. After the last window the producer prefetches into an
    epoch with no queue: ``close`` ends it, the consumer sees no error and
    no wait beyond its batches."""
    files = files8[:6]
    out = {}
    for name, pkg in PKGS.items():
        ir = jir if name == "jax" else tir
        specs = pkg["win"].freeze_schedule(
            pkg["st"].SyntheticEventSource(files, seed=2, total_events=6),
            policy=pkg["win"].WindowPolicy(max_files=2))
        queue = pkg["mq"].MultiQueue(len(specs))
        _fill_schedule(pkg, ir, specs, queue)
        if name == "jax":
            ds = jjd.JaxShufflingDataset(
                [], None, 1, 24, 0, batch_queue=queue, shuffle_result=None,
                drop_last=False, device_rebatch=device_rebatch, **_SPEC)
        else:
            ds = DeviceShufflingDataset(
                [], None, 1, 24, 0, batch_queue=queue, shuffle_result=None,
                drop_last=False, device="cpu",
                device_rebatch=device_rebatch, **_SPEC)
        batches = []
        try:
            assert ds.num_epochs is None
            for epoch in range(len(specs)):
                ds.set_epoch(epoch)
                batches.extend((epoch, np.asarray(f[0]).reshape(-1).tolist(),
                                np.asarray(lb).tolist()) for f, lb in ds)
        finally:
            start = time.monotonic()
            ds.close()
            close_s = time.monotonic() - start
        out[name] = batches
        if name == "torch":
            assert ds.binding == ("bulk" if device_rebatch else "per_batch")
            # One wait per batch and per epoch's end: none for the
            # producer's prefetch past the last window.
            assert len(ds.batch_wait_stats.wait_times) == \
                len(batches) + len(specs)
            # The producer ended within its join's bound.
            assert close_s < 4.0
    assert out["torch"] == out["jax"]
    keys = sorted(k for _, feats, _ in out["torch"] for k in feats)
    assert keys == list(range(6 * ROWS))
    assert [e for e, _, _ in out["torch"]] == sorted(
        e for e, _, _ in out["torch"])


def test_epoch_range_equal_jax():
    assert list(tir.epoch_range(2, 5)) == list(jir.epoch_range(2, 5))
    assert list(itertools.islice(tir.epoch_range(4, None), 3)) == \
        list(itertools.islice(jir.epoch_range(4, None), 3))


def test_streaming_modules_load_no_torch():
    """The streaming plane is host code: its modules, the drifting-stream
    workload and a runner's run load neither torch nor JAX."""
    code = ("import sys, tempfile\n"
            "from ray_shuffling_data_loader_tpu_torch import streaming\n"
            "from ray_shuffling_data_loader_tpu_torch.streaming import "
            "runner, source, window\n"
            "from ray_shuffling_data_loader_tpu_torch.workloads import "
            "dlrm_criteo\n"
            "d = tempfile.mkdtemp()\n"
            "files = dlrm_criteo.generate_drifting_stream(2, 16, d)\n"
            "dlrm_criteo.run_online_training(files, 1, 2)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_shuffling_data_loader_tpu'))\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
