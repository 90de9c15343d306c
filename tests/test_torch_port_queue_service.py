"""The port's queue service (``multiqueue_service.py``, the widened
``multiqueue.py``, the queue keys of ``runtime/policy.py`` and the remote
queue's side of ``dataset.py``) against the JAX package's, on the CPU.

- The wire: the request, batch and frame structs and every op, flag, kind
  and sentinel value equal the JAX package's; a port client reads tables,
  sentinels and failure frames from a JAX ``serve_queue`` and a JAX client
  from a port one, with equal tables.
- The same batches over the wire: a port ``DeviceShufflingDataset(
  device="cpu")`` over a port ``RemoteQueue`` yields the batches of the
  in-process port dataset and of the JAX ``ShufflingDataset`` over a JAX
  ``RemoteQueue`` (same files, seed and reducers).
- The dataset's repairs: it takes the bare tables a remote queue yields,
  commits a manual-ack queue at each checkpoint save, and does not count
  ``birth_to_delivered`` again over a queue that observes it.
- The in-process queue's surface and the queue policy keys against the
  JAX package's; the tenancy calls that once raised (a server's
  ``tenants``, a client's ``tenant``, a stream's tenant) work as the JAX
  package's do, and a JAX tenant-bound client is bound by a port server;
  the service, the supervisor and a tenant-bound sharded client load no
  torch.
"""

import importlib
import os
import subprocess
import sys

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import dataset as jds
from ray_shuffling_data_loader_tpu import multiqueue as jmq
from ray_shuffling_data_loader_tpu import multiqueue_service as jsvc
from ray_shuffling_data_loader_tpu import streaming as jstreaming
from ray_shuffling_data_loader_tpu.runtime import policy as jpolicy
from ray_shuffling_data_loader_tpu.streaming import runner as jstream_runner
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import device_dataset as tdd
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import streaming as tstreaming
from ray_shuffling_data_loader_tpu_torch.runtime import latency as tlat
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as tpolicy
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup
from ray_shuffling_data_loader_tpu_torch.streaming import (
    runner as tstream_runner)

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ROWS, NUM_FILES, NUM_REDUCERS, NUM_EPOCHS = 3000, 3, 3, 2
BATCH, SEED = 256, 11


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_qservice"))
    filenames, _ = jdg.generate_data_local(NUM_ROWS, NUM_FILES, 1, 0.0, d,
                                           seed=4)
    return filenames


def _fill(mq, failure_cls, n=9):
    """Queue 0: n one-row-pair tables and the sentinel; queue 1: a
    failure."""
    queue = mq.MultiQueue(2)
    for i in range(n):
        queue.put(0, pa.table({"seq": [i, i * 10],
                               "x": np.arange(i, i + 2, dtype=np.float32)}))
    queue.put(0, None)
    queue.put(1, failure_cls(ValueError(f"boom {n}")))
    return queue


def _drain(remote, queue_idx=0):
    tables = []
    while True:
        item = remote.get(queue_idx)
        if item is None:
            return tables
        tables.append(item)


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------


def test_wire_constants_equal_jax():
    for name in ("_REQUEST", "_BATCH_HEADER", "_FRAME"):
        assert getattr(tsvc, name).format == getattr(jsvc, name).format
    assert tsvc._FRAME.size == jsvc._FRAME.size
    for name in ("TASK_NONE", "OP_GET_BATCH", "OP_HELLO", "OP_HEARTBEAT",
                 "OP_NACK", "OP_TENANT", "OP_REBALANCE", "FLAG_RESUME",
                 "FLAG_HANDLES_OK", "KIND_TABLE", "KIND_SENTINEL",
                 "KIND_FAILURE", "KIND_TABLE_HANDLE", "KIND_MOVED",
                 "CODEC_NONE", "NACK_CRC", "NACK_NO_HANDLE", "ACK_NONE",
                 "DEFAULT_MAX_BATCH", "_KIND_MASK"):
        assert getattr(tsvc, name) == getattr(jsvc, name), name
    payload = bytes(range(256)) * 7
    assert tsvc._crc(payload) == jsvc._crc(payload)


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_interop_tables_sentinels_failures(server_pkg):
    """Each package's client reads the other's server: equal tables, the
    sentinel, and the failure frame's text."""
    if server_pkg == "jax":
        queue = _fill(jmq, jds.ShuffleFailure)
        serve, client = jsvc.serve_queue, tsvc.RemoteQueue
    else:
        queue = _fill(tmq, tds.ShuffleFailure)
        serve, client = tsvc.serve_queue, jsvc.RemoteQueue
    with serve(queue) as server:
        with client(server.address, max_batch=3) as remote:
            tables = _drain(remote)
            failure = remote.get(1)
    assert len(tables) == 9
    for i, table in enumerate(tables):
        assert table.equals(pa.table({
            "seq": [i, i * 10], "x": np.arange(i, i + 2, dtype=np.float32)}))
    assert type(failure).__name__ == "ShuffleFailure"
    assert "boom 9" in str(failure.error)


def test_remote_queue_rejects_nonblocking_and_unreachable():
    queue = _fill(tmq, tds.ShuffleFailure, n=1)
    with tsvc.serve_queue(queue) as server:
        with tsvc.RemoteQueue(server.address) as remote:
            with pytest.raises(ValueError):
                remote.get(0, block=False)
    port = tsup.free_port()
    with pytest.raises(ConnectionError, match="could not reach"):
        tsvc.RemoteQueue(("127.0.0.1", port), retries=1,
                         initial_backoff_s=0.01)


def test_connect_remote_queue():
    queue = _fill(tmq, tds.ShuffleFailure, n=2)
    with tsvc.serve_queue(queue) as server:
        remote = tds.connect_remote_queue(tuple(server.address))
        try:
            assert isinstance(remote, tsvc.RemoteQueue)
            assert len(_drain(remote)) == 2
        finally:
            remote.close()


# ---------------------------------------------------------------------------
# The same batches over the wire
# ---------------------------------------------------------------------------


def _spec():
    spec = jwl.dlrm_spec()
    spec["feature_columns"].append("key")
    spec["feature_types"].append(np.dtype(np.int64))
    return spec


def _device_batches(ds):
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        out.append([([f.numpy() for f in features], label.numpy())
                    for features, label in ds])
    return out


def _jax_remote_batches(files, spec):
    queue, result = jds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, 1, BATCH, 2, NUM_REDUCERS, 0, seed=SEED,
        queue_name="port-qservice-jax")
    with jsvc.serve_queue(queue) as server:
        with jsvc.RemoteQueue(server.address) as remote:
            ds = jds.ShufflingDataset(files, NUM_EPOCHS, 1, BATCH, 0,
                                      batch_queue=remote,
                                      shuffle_result=None, seed=SEED)
            out = []
            for epoch in range(NUM_EPOCHS):
                ds.set_epoch(epoch)
                out.append([tdd.convert_to_arrays(
                    table, spec["feature_columns"],
                    [None] * len(spec["feature_columns"]),
                    spec["feature_types"], spec["label_column"], None,
                    spec["label_type"]) for table in ds])
    result.result()
    queue.shutdown()
    return out


def test_remote_device_dataset_equals_in_process_and_jax(files):
    spec = _spec()
    queue, result = tds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, 1, num_reducers=NUM_REDUCERS, seed=SEED)
    with tsvc.serve_queue(queue) as server:
        with tsvc.RemoteQueue(server.address, max_batch=2) as remote:
            remote_ds = tdd.DeviceShufflingDataset(
                files, NUM_EPOCHS, 1, BATCH, 0, batch_queue=remote,
                shuffle_result=None, seed=SEED, device="cpu",
                drop_last=False, **spec)
            over_wire = _device_batches(remote_ds)
            remote_ds.close()
    result.result()
    local_ds = tdd.DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, device="cpu", drop_last=False, **spec)
    in_process = _device_batches(local_ds)
    local_ds.close()
    jax_wire = _jax_remote_batches(files, spec)
    for epoch in range(NUM_EPOCHS):
        assert len(over_wire[epoch]) == len(in_process[epoch]) \
            == len(jax_wire[epoch]) == -(-NUM_ROWS // BATCH)
        for got, local, ref in zip(over_wire[epoch], in_process[epoch],
                                   jax_wire[epoch]):
            for a, b, c in zip(got[0] + [got[1]], local[0] + [local[1]],
                               ref[0] + [ref[1]]):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
        keys = np.sort(np.concatenate([b[0][-1].ravel()
                                       for b in over_wire[epoch]]))
        np.testing.assert_array_equal(keys, np.arange(NUM_ROWS))


# ---------------------------------------------------------------------------
# The dataset's repairs
# ---------------------------------------------------------------------------


class _Done:
    """A finished task ref (what an in-process queue holds)."""

    def __init__(self, table):
        self._table = table

    def result(self):
        return self._table


def _stamped(first, n):
    table = pa.table({"k": np.arange(first, first + n)})
    meta = {tlat.BIRTH_META_KEY: tlat.encode_stamp(tlat.now_stamp())}
    return table.replace_schema_metadata(meta)


def test_dataset_takes_materialized_tables():
    """A remote queue yields bare tables, not task refs."""
    queue = tmq.MultiQueue(1)
    queue.put(0, _stamped(0, 5))
    queue.put(0, _stamped(5, 7))
    queue.put(0, None)
    ds = tds.ShufflingDataset([], 1, 1, 4, 0, batch_queue=queue,
                              shuffle_result=None)
    ds.set_epoch(0)
    keys = [b.column("k").to_pylist() for b in ds]
    assert keys == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]


class _ManualQueue:
    """A manual-ack queue: counts its commits."""

    def __init__(self, tables):
        self._items = list(tables) + [None]
        self.commits = 0

    def get(self, queue_idx, block=True):
        return self._items.pop(0)

    def commit(self, queue_index=None):
        self.commits += 1


def test_resume_iterator_commits_at_each_save(tmp_path):
    queue = _ManualQueue([_Done(_stamped(0, 8))])
    ds = tds.ShufflingDataset([], 1, 1, 2, 0, batch_queue=queue,
                              shuffle_result=None, seed=3)
    checkpoint = tckpt.LoaderCheckpoint(seed=3, epoch=0, batches_consumed=0,
                                        num_epochs=1, num_trainers=1, rank=0,
                                        batch_size=2)
    path = str(tmp_path / "loader.json")
    batches = list(tckpt.resume_iterator(ds, checkpoint, path,
                                         checkpoint_every=1))
    assert len(batches) == 4
    # One commit per save: after each of 4 batches, then the epoch's end.
    assert queue.commits == 5
    ds.commit_consumed()
    assert queue.commits == 6


class _ObservingQueue(_ManualQueue):
    observes_delivery = True


def _delivered_count():
    return tmetrics.sketch(tlat.DELIVERY_METRIC, "",
                           hop=tlat.HOP_BIRTH_TO_DELIVERED,
                           queue="0").count


@pytest.mark.parametrize("observes", [False, True])
def test_birth_to_delivered_observed_once(observes):
    """An in-process queue's tables are observed by the dataset; a queue
    that observes delivery itself is not observed again."""
    cls = _ObservingQueue if observes else _ManualQueue
    queue = cls([_Done(_stamped(0, 3)), _Done(_stamped(3, 3))])
    ds = tds.ShufflingDataset([], 1, 1, 2, 0, batch_queue=queue,
                              shuffle_result=None)
    before = _delivered_count()
    ds.set_epoch(0)
    assert sum(b.num_rows for b in ds) == 6
    assert _delivered_count() - before == (0 if observes else 2)


def test_remote_hops_observed_once_per_frame():
    """Over a served queue: the server observes birth_to_queued, the
    client queued_to_delivered and birth_to_delivered, once per table,
    and the dataset on top adds nothing."""
    queue = tmq.MultiQueue(1)
    for i in range(4):
        queue.put(0, _stamped(3 * i, 3))
    queue.put(0, None)

    def counts():
        return {hop: tmetrics.sketch(tlat.DELIVERY_METRIC, "", hop=hop,
                                     queue="0").count
                for hop in (tlat.HOP_BIRTH_TO_QUEUED,
                            tlat.HOP_QUEUED_TO_DELIVERED,
                            tlat.HOP_BIRTH_TO_DELIVERED)}

    before = counts()
    with tsvc.serve_queue(queue) as server:
        with tsvc.RemoteQueue(server.address, max_batch=2) as remote:
            ds = tds.ShufflingDataset([], 1, 1, 4, 0, batch_queue=remote,
                                      shuffle_result=None)
            ds.set_epoch(0)
            assert sum(b.num_rows for b in ds) == 12
    after = counts()
    assert {hop: after[hop] - before[hop] for hop in after} == {
        hop: 4 for hop in after}


# ---------------------------------------------------------------------------
# The in-process queue and the policy keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_multiqueue_surface(pkg):
    mq = jmq if pkg == "jax" else tmq
    queue = mq.MultiQueue(2, maxsize=2)
    with pytest.raises(mq.Empty):
        queue.get_nowait(0)
    with pytest.raises(mq.Empty):
        queue.get(0, timeout=0.01)
    queue.put(0, "a")
    queue.put_nowait(0, "b")
    with pytest.raises(mq.Full):
        queue.put(0, "c", block=False)
    with pytest.raises(mq.Full):
        queue.put(0, "c", timeout=0.01)
    assert (queue.size(0), queue.sizes()) == (2, [2, 0])
    with pytest.raises(mq.Empty):
        queue.get_nowait_batch(0, 3)
    assert queue.get_nowait_batch(0, 2) == ["a", "b"]
    queue.put_nowait_batch(1, [1, 2])
    with pytest.raises(mq.Full):
        queue.put_nowait_batch(1, [3])
    assert queue.get(1) == 1
    queue.shutdown(force=True, grace_period_s=0.1)
    assert queue.get(1) == 2  # queued items stay readable
    with pytest.raises(mq.ShutdownError):
        queue.get(0)  # an empty queue wakes the getter
    with pytest.raises(RuntimeError):
        queue.put(0, "d")
    assert (mq.CONNECT_RETRIES, mq.CONNECT_INITIAL_BACKOFF_S) == (
        jmq.CONNECT_RETRIES, jmq.CONNECT_INITIAL_BACKOFF_S)


QUEUE_KEYS = ("queue_timeout_s", "queue_nodelay", "queue_replay_bytes",
              "queue_lease_timeout_s", "on_dead_consumer", "queue_delivery",
              "queue_compression", "queue_compression_min_bytes",
              "queue_sendmsg", "queue_shards", "queue_codec_threads",
              "tenant_drr_quantum_bytes", "tenant_active_window_s",
              "tenant_floor_pace_s")


@pytest.mark.parametrize("key", QUEUE_KEYS)
def test_queue_policy_keys_equal_jax(key, monkeypatch):
    for name in (f"RSDL_QUEUE_{key.upper()}", f"RSDL_{key.upper()}"):
        monkeypatch.delenv(name, raising=False)
    assert tpolicy.resolve("queue", key) == jpolicy.resolve("queue", key)
    raw = {"queue_nodelay": "off", "queue_sendmsg": "0",
           "on_dead_consumer": "drain", "queue_delivery": "handle",
           "queue_compression": "zlib"}.get(key, "7")
    monkeypatch.setenv(f"RSDL_QUEUE_{key.upper()}", raw)
    assert tpolicy.resolve("queue", key) == jpolicy.resolve("queue", key)


def test_supervisor_retry_defaults_equal_jax():
    importlib.import_module("ray_shuffling_data_loader_tpu.runtime."
                            "supervisor")
    for key in ("retry_max_attempts", "retry_initial_backoff_s",
                "retry_max_backoff_s"):
        assert tpolicy.resolve("supervisor", key) == \
            jpolicy.resolve("supervisor", key)


# ---------------------------------------------------------------------------
# Tenancy calls (each raised before the port had tenancy)
# ---------------------------------------------------------------------------


def _server_tenancy(pkg_svc, pkg_mq, **kw):
    server = pkg_svc.QueueServer(pkg_mq.MultiQueue(1), ("127.0.0.1", 0),
                                 **kw)
    try:
        return (server._tenants, server._rank_tenant,
                server._fair.snapshot() if server._fair else None)
    finally:
        server.close()


def ack_sent(server):
    """Ack every frame ``server`` sent and return its per-tenant replay
    ledger. A client acks a queue's frames on its next GET of that
    queue, so the batch that ended an epoch stays unacked until then."""
    with server._states_lock:
        states = dict(server._states)
    for queue_idx, state in states.items():
        with state.lock:
            if state.sent_seq > state.acked_seq:
                server._apply_ack(queue_idx, state, state.sent_seq)
    return dict(server._tenant_replay)


def _client_binding(pkg_svc, pkg_mq, pkg_ds, tenant, client_svc=None):
    """Serve queue 0, drain it through a client (of ``client_svc``,
    default the server's package) bound to ``tenant`` and return what the
    server recorded: the leases' tenants, the rank's tenant, the
    per-tenant replay ledger before and after the last acks, and the
    tables."""
    queue = _fill(pkg_mq, pkg_ds.ShuffleFailure, n=4)
    with pkg_svc.serve_queue(queue) as server:
        with (client_svc or pkg_svc).RemoteQueue(
                server.address, tenant=tenant) as remote:
            tables = _drain(remote)
        leases = sorted(le.tenant for le in server._leases.values())
        return (leases, dict(server._rank_tenant),
                dict(server._tenant_replay), ack_sent(server), tables)


def _runner_specs(pkg_streaming, files_):
    runner = pkg_streaming.StreamingShuffleRunner(
        pkg_streaming.SyntheticEventSource(files_, total_events=4), None,
        1, 1, tenant="a", max_windows=2,
        policy=pkg_streaming.WindowPolicy(max_files=2))
    return runner.tenant, [(s.epoch, s.filenames, s.tenant_id)
                           for s in runner._specs()]


def _config_with_tenant(pkg_runner, pkg_streaming, files_):
    return pkg_runner.server_config(
        pkg_streaming.SyntheticEventSource(files_, total_events=2), 1, 1,
        "unused.wal", tenant_id="a")


TENANT_CALLS = {
    "tenants": lambda files_: (
        _server_tenancy(tsvc, tmq, tenants={"a": {"weight": 1}}),
        _server_tenancy(jsvc, jmq, tenants={"a": {"weight": 1}})),
    "client_tenant": lambda files_: (
        _client_binding(tsvc, tmq, tds, "a"),
        _client_binding(jsvc, jmq, jds, "a")),
    "stream_runner_tenant": lambda files_: (
        _runner_specs(tstreaming, files_),
        _runner_specs(jstreaming, files_)),
    "stream_server_config_tenant": lambda files_: (
        _config_with_tenant(tstream_runner, tstreaming, files_),
        _config_with_tenant(jstream_runner, jstreaming, files_)),
}


@pytest.mark.parametrize("name", sorted(TENANT_CALLS))
def test_tenant_call_works_as_jax(name, files):
    port, jax_ = TENANT_CALLS[name](list(files))
    if name == "stream_runner_tenant":
        # Two TenantContext classes: compare their canonical bytes.
        assert port[0].to_json() == jax_[0].to_json()
        port, jax_ = port[1], jax_[1]
        assert all(tenant_id == "a" for _, _, tenant_id in port)
    if name == "client_tenant":
        assert port[0] == ["a"] and port[1] == {0: "a"}
        assert port[2]["a"] > 0 and port[3] == {"a": 0}
        assert [t.to_pydict() for t in port[4]] == \
            [t.to_pydict() for t in jax_[4]]
        port, jax_ = port[:4], jax_[:4]
    assert port == jax_


def test_jax_tenant_client_is_bound_by_the_port_server():
    """A JAX client bound to a tenant reads a port server's tables, the
    server binds its lease and rank to the tenant and the tenant's
    ledger is back at 0 after its acks, as on a JAX server."""
    port = _client_binding(tsvc, tmq, tds, "team-a", client_svc=jsvc)
    jax_ = _client_binding(jsvc, jmq, jds, "team-a")
    assert [t.to_pydict() for t in port[4]] == \
        [t.to_pydict() for t in jax_[4]]
    assert len(port[4]) == 4
    assert port[:4] == jax_[:4]
    assert port[0] == ["team-a"] and port[1] == {0: "team-a"}
    assert port[2]["team-a"] > 0 and port[3] == {"team-a": 0}


def test_service_and_supervisor_load_no_torch():
    """The service, the supervisor and its shard launcher's imports, the
    tenancy modules, and a tenant-bound sharded client reading handle
    frames from tenant-aware shards, load neither torch nor JAX."""
    code = ("import sys\n"
            "import pyarrow as pa\n"
            "from ray_shuffling_data_loader_tpu_torch import "
            "multiqueue, multiqueue_service, checkpoint, dataset\n"
            "from ray_shuffling_data_loader_tpu_torch.runtime import "
            "supervisor\n"
            "from ray_shuffling_data_loader_tpu_torch.plan import ir\n"
            "from ray_shuffling_data_loader_tpu_torch.tenancy import "
            "admission, fairshare\n"
            "assert checkpoint.shard_journal_path('j', 1, 2) == 'j.shard1'\n"
            "q = multiqueue.MultiQueue(2)\n"
            "q.put(1, pa.table({'x': [1, 2]}))\n"
            "with multiqueue_service.serve_queue_sharded(\n"
            "        q, num_shards=2, num_trainers=2,\n"
            "        tenants={'cold': {'weight': 1, 'ranks': [1]}}) as s:\n"
            "    m = ir.ShardMap.from_json(s.shard_map.to_json())\n"
            "    with dataset.connect_remote_queue(\n"
            "            m, delivery='handle', tenant='cold') as r:\n"
            "        assert r.get(1).num_rows == 2\n"
            "    assert s.servers[1]._rank_tenant == {1: 'cold'}\n"
            "assert supervisor.launch_supervised_queue_shards\n"
            "bad = sorted(m for m in sys.modules if m == 'torch' "
            "or m.startswith(('torch.', 'jax', "
            "'ray_shuffling_data_loader_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
