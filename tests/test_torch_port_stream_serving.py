"""A stream's frozen window schedule on the port's serving plane
(``multiqueue_service.serve_pipeline``'s ``config["epochs"]``,
``streaming.runner.server_config``, the supervised shards), on the CPU.

- A port server of a schedule is read by a JAX ``RemoteQueue``, and a JAX
  server of the same schedule by a port ``RemoteQueue`` (the wire is
  shared): both equal the fault-free lineage of the schedule, and the
  serve watermark reaches the last window's ingest watermark.
- A supervised shard SIGKILLed at a window boundary (window 0 drained,
  nothing acked) replays window 0 with the same row offsets and tables,
  and serves the other windows as the fault-free lineage; its sibling
  never restarts.
- A trainer process SIGKILLed mid-window resumes from its
  ``LoaderCheckpoint`` against a supervised server of the schedule: no
  batch position missed or doubled across the window boundary.
- Tenancy stays refused, naming ROADMAP item 8.
"""

import os
import signal
import subprocess
import sys
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import multiqueue_service as jsvc
from ray_shuffling_data_loader_tpu.streaming import runner as jrunner
from ray_shuffling_data_loader_tpu.streaming import source as jsource
from ray_shuffling_data_loader_tpu.streaming import window as jwin
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup
from ray_shuffling_data_loader_tpu_torch.streaming import runner as trunner
from ray_shuffling_data_loader_tpu_torch.streaming import source as tsource
from ray_shuffling_data_loader_tpu_torch.streaming import window as twin

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 64


def _make_stream_files(directory, num_files, rows=ROWS):
    os.makedirs(directory, exist_ok=True)
    files = []
    for i in range(num_files):
        table = pa.table({
            "key": pa.array(range(i * rows, (i + 1) * rows),
                            type=pa.int64()),
            "labels": pa.array(np.zeros(rows, dtype=np.float32)),
        })
        path = os.path.join(directory, f"stream_{i:03d}.parquet")
        pq.write_table(table, path)
        files.append(path)
    return files


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _make_stream_files(str(tmp_path_factory.mktemp("serve6")), 6)


def _config(runner_mod, source_mod, files, tmp, trainers, reducers, seed,
            **extra):
    """The JAX streaming tests' server config: 2-file windows, one epoch
    in flight, no file cache."""
    source = source_mod.SyntheticEventSource(files, seed=seed,
                                             total_events=len(files))
    return runner_mod.server_config(
        source, num_trainers=trainers, num_reducers=reducers,
        journal_path=os.path.join(tmp, "watermarks.wal"), seed=seed,
        policy=(twin if runner_mod is trunner else jwin).WindowPolicy(
            max_files=2),
        max_concurrent_epochs=1,
        ingest_journal_path=os.path.join(tmp, "ingest.wal"),
        file_cache=None, **extra)


def _expected(config):
    """The fault-free key lists per ``(rank, epoch)`` of a schedule, from
    the port's driver on threads."""
    specs = twin.specs_from_dicts(config["epochs"])
    streams = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            streams.setdefault((rank, epoch), []).extend(refs)

    tsh.shuffle_epochs(iter(specs), consumer, config["num_reducers"],
                       config["num_trainers"], max_concurrent_epochs=1,
                       seed=config["seed"], file_cache=None,
                       epochs_hint=len(specs))
    return {key: [tuple(r.result().column("key").to_pylist()) for r in refs]
            for key, refs in streams.items()}


def _drain_all(remote, epochs, trainers):
    out = {}
    for epoch in range(epochs):
        for rank in range(trainers):
            tables = []
            while True:
                item = remote.get(tir.queue_index(epoch, rank, trainers))
                if item is None:
                    break
                tables.append(tuple(item.column("key").to_pylist()))
            out[(rank, epoch)] = tables
    return out


def test_server_config_equals_jax(files, tmp_path):
    port = _config(trunner, tsource, files, str(tmp_path / "t"), 2, 3, 7,
                   cast={"key": "int64"})
    jax = _config(jrunner, jsource, files, str(tmp_path / "j"), 2, 3, 7,
                  cast={"key": "int64"})
    strip = ("journal_path",)
    assert {k: v for k, v in port.items() if k not in strip} == \
        {k: v for k, v in jax.items() if k not in strip}
    assert len(port["epochs"]) == 3
    assert open(str(tmp_path / "t" / "ingest.wal"), "rb").read() == \
        open(str(tmp_path / "j" / "ingest.wal"), "rb").read()


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_schedule_served_across_packages(files, tmp_path, server, client):
    """One package's ``serve_pipeline`` of a frozen schedule, read by the
    other's client: the fault-free lineage, table for table. The port's
    server also sets the serve watermark to the last window's."""
    trainers, reducers, seed = 2, 3, 7
    config = _config(trunner, tsource, files, str(tmp_path), trainers,
                     reducers, seed, port=0)
    expected = _expected(config)
    serve = (tsvc if server == "torch" else jsvc).serve_pipeline
    srv, result, queue = serve(config)
    try:
        remote_cls = (tsvc if client == "torch" else jsvc).RemoteQueue
        with remote_cls(srv.address) as remote:
            got = _drain_all(remote, len(config["epochs"]), trainers)
        result.result(timeout=60)
    finally:
        srv.close()
        queue.shutdown()
    assert got == expected
    if server == "torch":
        samples = tmetrics.parse_exposition(tmetrics.render())
        assert samples["rsdl_stream_serve_watermark"][()] == \
            config["epochs"][-1]["window"]["ingest_watermark"]


def test_schedule_resume_skips_delivered_windows(files, tmp_path):
    """A restarted in-process server over the same journal starts at the
    first window not fully delivered and serves only what is left."""
    trainers = 1
    config = _config(trunner, tsource, files, str(tmp_path), trainers, 2,
                     5, port=0)
    expected = _expected(config)
    srv, result, queue = tsvc.serve_pipeline(config)
    try:
        with tsvc.RemoteQueue(srv.address) as remote:
            first = _drain_all(remote, 1, trainers)
        result.result(timeout=60)
    finally:
        srv.close()
        queue.shutdown()
    srv, result, queue = tsvc.serve_pipeline(config)
    try:
        with tsvc.RemoteQueue(srv.address) as remote:
            rest = {(0, epoch): [] for epoch in (1, 2)}
            for epoch in (1, 2):
                while True:
                    item = remote.get(tir.queue_index(epoch, 0, trainers))
                    if item is None:
                        break
                    rest[(0, epoch)].append(
                        tuple(item.column("key").to_pylist()))
        result.result(timeout=60)
    finally:
        srv.close()
        queue.shutdown()
    assert {**first, **rest} == expected


def test_shard_kill9_at_window_boundary_replays_window_0(files, tmp_path):
    """Rank 0 drains window 0 without acking; shard 0 is SIGKILLed at the
    boundary. The restarted shard replays window 0 with the same row
    offsets and tables, the other windows equal the fault-free lineage,
    offsets strictly increase, and shard 1 never restarts."""
    trainers = 2
    config = _config(trunner, tsource, files, str(tmp_path), trainers, 4, 9,
                     handle_dir=str(tmp_path / "handles"))
    epochs = len(config["epochs"])
    expected = _expected(config)
    supervisors, shard_map = tsup.launch_supervised_queue_shards(
        config, num_shards=2)
    assert shard_map.shard_for_rank(0) == 0

    def drain(ack_mode, epoch_list):
        out = {}
        with tsvc.ShardedRemoteQueue(shard_map, retries=12, max_batch=4,
                                     ack_mode=ack_mode) as remote:
            for epoch in epoch_list:
                stream = []
                while True:
                    item, offset = remote.get_positioned(
                        tir.queue_index(epoch, 0, trainers))
                    if item is None:
                        break
                    stream.append((offset,
                                   tuple(item.column("key").to_pylist())))
                out[epoch] = stream
        return out

    try:
        for address in shard_map.addresses:
            assert tsup.wait_for_server(tuple(address), timeout_s=60)
        first = drain("manual", [0])
        assert first[0]
        os.kill(supervisors[0].pid, signal.SIGKILL)
        full = drain("delivered", list(range(epochs)))
    finally:
        for supervisor in supervisors:
            supervisor.stop()
    assert supervisors[0].restarts >= 1
    assert supervisors[1].restarts == 0
    assert full[0] == first[0]
    for epoch in range(epochs):
        offsets = [offset for offset, _ in full[epoch]]
        assert offsets == sorted(set(offsets))
        assert [keys for _, keys in full[epoch]] == expected[(0, epoch)]


_TRAINER = """
import sys
from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as svc
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

host, port, ckpt_path, out_path, seed, epochs = sys.argv[1:7]
port, seed, epochs = int(port), int(seed), int(epochs)
remote = svc.RemoteQueue((host, port), ack_mode="manual", consumer_id=77)
ds = ShufflingDataset([], epochs, num_trainers=1, batch_size=30, rank=0,
                      batch_queue=remote, shuffle_result=None, seed=seed)
try:
    checkpoint = ckpt.LoaderCheckpoint.load(ckpt_path)
except FileNotFoundError:
    checkpoint = ckpt.LoaderCheckpoint(
        seed=seed, epoch=0, batches_consumed=0, num_epochs=epochs,
        num_trainers=1, rank=0, batch_size=30)
with open(out_path, "a") as out:
    for batch in ckpt.resume_iterator(ds, checkpoint, ckpt_path,
                                      checkpoint_every=1):
        keys = ",".join(str(k) for k in batch.column("key").to_pylist())
        out.write(f"{checkpoint.epoch}:{checkpoint.batches_consumed}:"
                  f"{keys}\\n")
        out.flush()
print("TRAINER DONE")
"""


def test_trainer_kill9_mid_window_resumes_exactly_once(files, tmp_path):
    """A trainer process over a supervised server of the schedule is
    SIGKILLed in window 0 and a fresh one resumes from its
    ``LoaderCheckpoint``: a position seen twice is the same batch, and the
    positions cover the fault-free batch grid of every window once."""
    seed = 13
    config = _config(trunner, tsource, files, str(tmp_path), 1, 3, seed)
    epochs = len(config["epochs"])
    specs = twin.specs_from_dicts(config["epochs"])
    grid = tmq.MultiQueue(epochs)
    tsh.shuffle_epochs(
        iter(specs),
        lambda rank, epoch, refs: tds.batch_consumer(grid, 1, rank, epoch,
                                                     refs),
        3, 1, max_concurrent_epochs=1, seed=seed, file_cache=None,
        epochs_hint=epochs)
    ds = tds.ShufflingDataset([], epochs, 1, 30, 0, batch_queue=grid,
                              shuffle_result=None, seed=seed)
    expected = {}
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        expected[epoch] = [tuple(b.column("key").to_pylist()) for b in ds]
    grid.shutdown()

    supervisor, address = tsup.launch_supervised_queue_server(config)
    ckpt_path = str(tmp_path / "loader.ckpt")
    out_path = str(tmp_path / "consumed.txt")
    try:
        assert tsup.wait_for_server(address, timeout_s=60)
        args = [sys.executable, "-c", _TRAINER, address[0], str(address[1]),
                ckpt_path, out_path, str(seed), str(epochs)]
        env = dict(os.environ, PYTHONPATH=REPO)
        first = subprocess.Popen(args, cwd=REPO, env=env,
                                 stdout=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if os.path.exists(out_path) and \
                    sum(1 for _ in open(out_path)) >= 2:
                break
            time.sleep(0.02)
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)
        assert first.returncode == -9
        second = subprocess.run(args, cwd=REPO, env=env,
                                capture_output=True, text=True, timeout=120)
        assert second.returncode == 0, second.stderr[-3000:]
        assert "TRAINER DONE" in second.stdout
    finally:
        supervisor.stop()
    merged = {}
    for line in open(out_path):
        epoch, index, keys = line.strip().split(":", 2)
        position = (int(epoch), int(index))
        batch = tuple(int(k) for k in keys.split(",") if k)
        if position in merged:
            assert merged[position] == batch
        merged[position] = batch
    for epoch in range(epochs):
        assert [merged[(epoch, i + 1)]
                for i in range(len(expected[epoch]))] == expected[epoch]
    assert len(merged) == sum(len(v) for v in expected.values())


def test_schedule_with_tenants_serves_as_jax(files, tmp_path):
    """A schedule with a ``tenants`` table and a ``tenant_id``, the calls
    that once raised: the configs equal JAX's and the port server serves
    the tenant's stream, its ledger back at 0 after the acks."""
    configs = {
        name: _config(runner_mod, source_mod, files,
                      str(tmp_path / name), 1, 2, 1, port=0,
                      tenants={"a": {"weight": 1, "ranks": [0]}},
                      tenant_id="a")
        for name, runner_mod, source_mod in (
            ("port", trunner, tsource), ("jax", jrunner, jsource))}
    port_epochs = configs["port"]["epochs"]
    assert port_epochs == configs["jax"]["epochs"]
    assert {e["tenant_id"] for e in port_epochs} == {"a"}
    srv, result, queue = tsvc.serve_pipeline(configs["port"])
    try:
        assert srv._tenants == {"a": {"weight": 1, "ranks": [0]}}
        with tsvc.RemoteQueue(srv.address, tenant="a") as remote:
            for epoch in range(len(port_epochs)):
                while remote.get(epoch) is not None:
                    pass
        assert srv._tenant_replay["a"] > 0  # the epochs' last batches
        # The client acks a batch on its next GET of the queue: ack the
        # last ones here.
        with srv._states_lock:
            states = dict(srv._states)
        for queue_idx, state in states.items():
            with state.lock:
                srv._apply_ack(queue_idx, state, state.sent_seq)
        assert srv._tenant_replay["a"] == 0
        assert tmetrics.counter("rsdl_tenant_bytes_delivered_total",
                                tenant="a").value > 0
        result.result(timeout=60)
    finally:
        srv.close()
        queue.shutdown()


def test_cast_applies_to_a_schedule(files, tmp_path):
    """The port's ``cast`` is the schedule's map transform too."""
    config = _config(trunner, tsource, files, str(tmp_path), 1, 2, 3,
                     port=0, cast={"key": "int32", "labels": "float64"})
    srv, result, queue = tsvc.serve_pipeline(config)
    try:
        with tsvc.RemoteQueue(srv.address) as remote:
            table = remote.get(tir.queue_index(0, 0, 1))
            assert table.schema.field("key").type == pa.int32()
            assert table.schema.field("labels").type == pa.float64()
            for epoch in range(len(config["epochs"])):
                index = tir.queue_index(epoch, 0, 1)
                while remote.get(index) is not None:
                    pass
        result.result(timeout=60)
    finally:
        srv.close()
        queue.shutdown()


def test_unbounded_device_dataset_over_a_served_schedule(files, tmp_path):
    """``DeviceShufflingDataset(num_epochs=None)`` over a port
    ``RemoteQueue`` of a served schedule: the batches of every window,
    then the producer's prefetch past the last window gets a failure
    frame (the server does not drop the connection), which never reaches
    the consumer, and ``close`` returns at once."""
    from ray_shuffling_data_loader_tpu_torch.device_dataset import (
        DeviceShufflingDataset)
    config = _config(trunner, tsource, files, str(tmp_path), 1, 2, 4,
                     port=0)
    epochs = len(config["epochs"])
    expected = _expected(config)
    srv, result, queue = tsvc.serve_pipeline(config)
    remote = tsvc.RemoteQueue(srv.address, retries=2)
    ds = DeviceShufflingDataset(
        [], None, 1, 16, 0, batch_queue=remote, shuffle_result=None,
        device="cpu", device_rebatch=True, feature_columns=["key"],
        feature_types=[np.int64], label_column="labels")
    try:
        got = {}
        for epoch in range(epochs):
            ds.set_epoch(epoch)
            got[epoch] = [k for features, _ in ds
                          for k in features[0].reshape(-1).tolist()]
        start = time.monotonic()
        ds.close()
        assert time.monotonic() - start < 1.0
        with tsvc.RemoteQueue(srv.address, retries=0) as other:
            past = other.get(tir.queue_index(epochs, 0, 1))
        assert isinstance(past, tds.ShuffleFailure)
        assert "past the 3 queues" in str(past.error)
        result.result(timeout=60)
    finally:
        ds.close()
        remote.close()
        srv.close()
        queue.shutdown()
    for epoch in range(epochs):
        assert got[epoch] == [k for table in expected[(0, epoch)]
                              for k in table]
