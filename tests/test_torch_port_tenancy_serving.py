"""The port's tenant-aware serving plane (``QueueServer(tenants=)``,
``OP_TENANT``, ``RemoteQueue(tenant=)``, the rebalance actuator's tenant
charges, supervised shards with ``config["tenants"]``) against the JAX
package's, on the CPU.

Everything is exact except the live shard's restart, whose waits are held
to a budget:

- The weighted-fair GET path: the same queues served to two tenants give
  the same frames per GET in both packages (the deficit round robin's
  split, with the quantum pinned), and a concurrent two-tenant drain
  gives each tenant the stream that was queued, bit for bit, with both
  ledgers at 0 after the last acks.
- Pop-time pinning: a frame's ack credits the tenant charged at its pop
  even if ``OP_TENANT`` rebinds the rank in between; handle frames keep
  their tenant through the downgrade and compressed frames' ledger
  follows the codec's bytes.
- ``OP_TENANT`` across packages both ways, re-announced after every
  HELLO; a malformed blob is logged and ignored; the client's per-tenant
  latency sketch.
- The actuator: after a committed in-process live move and its acks both
  shards' tenant ledgers read 0.
- A ``DeviceShufflingDataset`` over ``connect_remote_queue(addr,
  tenant=)`` yields the in-process batches.
- A port of the JAX package's ``test_tenancy_recovery.py`` over the
  port's supervised shards: the hot tenant's shard SIGKILLed mid-epoch,
  each tenant's stream exactly once and equal to the fault-free lineage.
"""

import importlib
import os
import signal
import socket
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import multiqueue as jmq
from ray_shuffling_data_loader_tpu import multiqueue_service as jsvc
from ray_shuffling_data_loader_tpu import tenancy as jten
from ray_shuffling_data_loader_tpu.runtime import metrics as jmetrics
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import device_dataset as tdd
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import rebalance as trb
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import tenancy as tten
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import latency as tlat
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

PKGS = {"port": (tsvc, tmq, tten, tmetrics),
        "jax": (jsvc, jmq, jten, jmetrics)}
TRAINERS = 2
#: The server-side table of the JAX package's recovery test.
TENANTS = {
    "hot": {"weight": 3.0, "priority": "interactive", "ranks": [0]},
    "cold": {"weight": 1.0, "priority": "batch", "ranks": [1]},
}
#: The untouched tenant's longest wait while the other's shard restarts.
UNDISTURBED_STALL_BUDGET_S = 15.0


def _tables(seed, n, rows=300):
    rng = np.random.default_rng(seed)
    return [pa.table({"key": np.arange(i * rows, (i + 1) * rows,
                                       dtype=np.int64),
                      "x": rng.standard_normal(rows).astype(np.float32)})
            for i in range(n)]


def _queue(mq, per_rank):
    """One epoch of ``TRAINERS`` ranks: rank r's tables, then its
    sentinel."""
    queue = mq.MultiQueue(TRAINERS)
    for rank, tables in per_rank.items():
        q = tir.queue_index(0, rank, TRAINERS)
        for table in tables:
            queue.put(q, table)
        queue.put(q, None)
    return queue


def ack_sent(server):
    """Ack every frame ``server`` sent; return its per-tenant ledger (a
    client acks a batch on its next GET of the queue, so the batch that
    ended a stream is acked here)."""
    with server._states_lock:
        states = dict(server._states)
    for queue_idx, state in states.items():
        with state.lock:
            if state.sent_seq > state.acked_seq:
                server._apply_ack(queue_idx, state, state.sent_seq)
    return dict(server._tenant_replay)


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# The weighted-fair GET path
# ---------------------------------------------------------------------------


def _drr_trace(pkg, per_rank, quantum, monkeypatch):
    """Alternate GETs of rank 0 (hot) and rank 1 (cold) on one server and
    record, per GET, the rank, the frame count and the deficits."""
    svc, mq, _, _ = PKGS[pkg]
    monkeypatch.setenv("RSDL_QUEUE_TENANT_DRR_QUANTUM_BYTES", str(quantum))
    server = svc.QueueServer(_queue(mq, per_rank), ("127.0.0.1", 0),
                             num_trainers=TRAINERS, tenants=TENANTS)
    trace, done = [], set()
    try:
        while len(done) < TRAINERS:
            for rank in range(TRAINERS):
                if rank in done:
                    continue
                frames = server._collect_frames(rank, 16, None, False, None)
                trace.append((rank, len(frames), [f.tenant for f in frames],
                              server._fair.deficit("hot"),
                              server._fair.deficit("cold")))
                if frames[-1].kind == svc.KIND_SENTINEL:
                    done.add(rank)
        return trace, dict(server._tenant_replay), ack_sent(server)
    finally:
        server.close()


@pytest.mark.parametrize("quantum_frames", [1, 4])
def test_drr_frames_per_get_equal_jax(quantum_frames, monkeypatch):
    per_rank = {0: _tables(1, 40), 1: _tables(2, 40)}
    quantum = quantum_frames * per_rank[0][0].nbytes
    port = _drr_trace("port", per_rank, quantum, monkeypatch)
    jax_ = _drr_trace("jax", per_rank, quantum, monkeypatch)
    assert port == jax_
    trace, before_ack, after_ack = port
    assert after_ack == {"hot": 0, "cold": 0}
    assert before_ack["hot"] > 0 and before_ack["cold"] > 0
    # Each GET's frames are charged to its rank's tenant.
    for rank, _, tenants, _, _ in trace:
        assert set(tenants) == {("hot", "cold")[rank]}
    # While both are active, hot gets more frames per GET than cold.
    both = trace[2:20]
    hot = sum(n for rank, n, *_ in both if rank == 0)
    cold = sum(n for rank, n, *_ in both if rank == 1)
    assert hot > cold


def _concurrent_drain(pkg, client_pkg, per_rank):
    svc, mq, ten, metrics = PKGS[pkg]
    csvc, _, cten, _ = PKGS[client_pkg]
    delivered = {t: metrics.counter("rsdl_tenant_bytes_delivered_total",
                                    tenant=t) for t in TENANTS}
    before = {t: c.value for t, c in delivered.items()}
    got, errors = {}, []
    with svc.serve_queue(_queue(mq, per_rank), num_trainers=TRAINERS,
                         tenants=TENANTS) as server:
        def consume(rank, tenant_id):
            try:
                ctx = cten.TenantContext(
                    tenant_id, priority=TENANTS[tenant_id]["priority"],
                    weight=TENANTS[tenant_id]["weight"])
                with csvc.RemoteQueue(server.address, max_batch=8,
                                      num_trainers=TRAINERS,
                                      tenant=ctx) as remote:
                    tables = []
                    while True:
                        item = remote.get(tir.queue_index(0, rank,
                                                          TRAINERS))
                        if item is None:
                            break
                        tables.append(item)
                    got[rank] = tables
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=consume, args=(r, t))
                   for t, spec in TENANTS.items() for r in spec["ranks"]]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        if errors:
            raise errors[0]
        ledgers = ack_sent(server)
        leases = sorted(le.tenant for le in server._leases.values())
    return (got, ledgers, leases,
            {t: c.value - before[t] for t, c in delivered.items()})


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_two_tenant_drain_streams_equal_what_was_queued(server_pkg,
                                                        client_pkg):
    per_rank = {0: _tables(3, 24), 1: _tables(4, 24)}
    got, ledgers, leases, delivered = _concurrent_drain(
        server_pkg, client_pkg, per_rank)
    for rank, tables in per_rank.items():
        assert [t.to_pydict() for t in got[rank]] == \
            [t.to_pydict() for t in tables]
    assert ledgers == {"hot": 0, "cold": 0}
    assert leases == ["cold", "hot"]
    assert delivered["hot"] > 0 and delivered["cold"] > 0
    # The delivered bytes equal the other package's server's.
    other = "jax" if server_pkg == "port" else "port"
    assert delivered == _concurrent_drain(other, client_pkg, per_rank)[3]


# ---------------------------------------------------------------------------
# Pop-time pinning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_ack_credits_tenant_charged_at_pop_time(pkg):
    """The JAX package's ``test_ack_credits_tenant_charged_at_pop_time``
    on both servers: a rank rebound between a frame's pop and its ack
    leaves no ledger negative or inflated."""
    svc, mq, ten, _ = PKGS[pkg]
    queue = mq.MultiQueue(1)
    queue.put(0, pa.table({"key": list(range(64))}))
    queue.put(0, None)
    with svc.serve_queue(queue, tenants={"late": {"weight": 2.0}}) as server:
        state = server._state(0)
        frames = server._collect_frames(0, 1, None, False, None)
        default = ten.DEFAULT_TENANT_ID
        assert frames[0].tenant == default
        charged = server._tenant_replay[default]
        assert charged == frames[0].size > 0
        with server._tenant_lock:
            server._rank_tenant[0] = "late"
        with state.lock:
            server._apply_ack(0, state, frames[-1].seq)
        assert server._tenant_replay[default] == 0
        assert server._tenant_replay.get("late", 0) == 0
    queue.shutdown()


def _pinned_paths(pkg, monkeypatch, tmp_path):
    svc, mq, ten, _ = PKGS[pkg]
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", "zlib")
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION_MIN_BYTES", "1")
    tables = [pa.table({"key": np.arange(2000), "run": np.full(2000, i)})
              for i in range(4)]
    queue = _queue(mq, {0: tables, 1: tables})
    with svc.QueueServer(queue, ("127.0.0.1", 0), num_trainers=TRAINERS,
                         tenants=TENANTS,
                         handle_dir=str(tmp_path / pkg)) as server:
        # Rank 0 as handle frames, downgraded as a NACK_NO_HANDLE does.
        handles = server._collect_frames(0, 2, None, False, None,
                                         handles_ok=True)
        kinds = [f.kind for f in handles]
        down = [server._downgrade_frame(f).tenant for f in handles]
        # Rank 1 streamed through the codec pool.
        streamed = server._collect_frames(1, 3, None, False, None)
        state = server._state(1)
        ledger = dict(server._tenant_replay)
        codecs = [f.codec for f in streamed]
        result = (kinds, down, [f.tenant for f in streamed], codecs,
                  ledger["cold"] == state.replay_bytes, ledger["cold"])
        after = ack_sent(server)
    queue.shutdown()
    return result, after


def test_handle_and_codec_frames_keep_their_tenant(monkeypatch, tmp_path):
    port = _pinned_paths("port", monkeypatch, tmp_path)
    jax_ = _pinned_paths("jax", monkeypatch, tmp_path)
    assert port == jax_
    (kinds, down, streamed, codecs, ledger_ok, _), after = port
    assert kinds == [tsvc.KIND_TABLE_HANDLE] * 2 and down == ["hot"] * 2
    assert streamed == ["cold"] * 3 and set(codecs) == {tsvc.CODEC_ZLIB}
    assert ledger_ok and after == {"hot": 0, "cold": 0}


# ---------------------------------------------------------------------------
# OP_TENANT on the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_op_tenant_binds_across_packages(server_pkg, client_pkg):
    """A client of either package bound to a tenant on a server that has
    no table: the lease and the rank it GETs belong to the tenant, the
    wire-announced weight is registered, and the ledger returns to 0."""
    svc, mq, _, _ = PKGS[server_pkg]
    csvc, _, cten, _ = PKGS[client_pkg]
    queue = _queue(mq, {1: _tables(5, 6)})
    ctx = cten.TenantContext("wire", priority="interactive", weight=5.0)
    with svc.serve_queue(queue, num_trainers=TRAINERS) as server:
        with csvc.RemoteQueue(server.address, num_trainers=TRAINERS,
                              tenant=ctx) as remote:
            q1 = tir.queue_index(0, 1, TRAINERS)
            while remote.get(q1) is not None:
                pass
        bound = ([le.tenant for le in server._leases.values()],
                 dict(server._rank_tenant), server._tenants,
                 server._fair.weight("wire"),
                 server._tenant_replay["wire"] > 0, ack_sent(server))
    assert bound == (["wire"], {1: "wire"}, {"wire": {"weight": 5.0}}, 5.0,
                     True, {"wire": 0})


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_malformed_tenant_blob_is_ignored(pkg):
    svc, mq, _, _ = PKGS[pkg]
    queue = _queue(mq, {0: _tables(6, 2)})
    with svc.serve_queue(queue, num_trainers=TRAINERS) as server:
        with socket.create_connection(server.address) as sock:
            sock.sendall(svc._REQUEST.pack(svc.OP_HELLO, 0, 7, 0, 0))
            blobs = (b"{not json", b'{"tenant_id": "BAD ID"}',
                     b'{"priority": "batch"}', b'{"tenant_id": "ok"}')
            sock.sendall(b"".join(
                svc._REQUEST.pack(svc.OP_TENANT, 0, 7, 0, len(blob)) + blob
                for blob in blobs))
            _wait_for(lambda: server._leases.get(7) is not None
                      and server._leases[7].tenant == "ok")
        assert server._tenants == {"ok": {"weight": 2.0}}
        # The server serves on.
        with svc.RemoteQueue(server.address,
                             num_trainers=TRAINERS) as remote:
            assert remote.get(0).num_rows == 300


def test_tenant_is_announced_again_after_every_hello():
    queue = _queue(tmq, {0: _tables(7, 3)})
    with tsvc.serve_queue(queue, num_trainers=TRAINERS) as server:
        binds = []
        original = server._bind_wire_tenant

        def counting(consumer_id, blob):
            binds.append(blob)
            original(consumer_id, blob)

        server._bind_wire_tenant = counting
        ctx = tten.TenantContext("again", priority="batch")
        with tsvc.RemoteQueue(server.address, num_trainers=TRAINERS,
                              prefetch=False, tenant=ctx) as remote:
            assert remote.get(0) is not None
            remote._reconnect()
            assert remote.get(0) is not None
            _wait_for(lambda: len(binds) == 2)
    assert binds == [ctx.to_json(), ctx.to_json()]
    assert binds[0] == jten.TenantContext("again",
                                          priority="batch").to_json()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_client_observes_tenant_delivery_latency(pkg):
    svc, mq, _, metrics = PKGS[pkg]
    hop = tlat.HOP_QUEUED_TO_DELIVERED
    sketch = metrics.sketch("rsdl_tenant_delivery_latency_seconds",
                            hop=hop, tenant=f"lat-{pkg}")
    before = sketch.count
    queue = _queue(mq, {0: _tables(8, 5)})
    with svc.serve_queue(queue, num_trainers=TRAINERS) as server:
        with svc.RemoteQueue(server.address, num_trainers=TRAINERS,
                             tenant=f"lat-{pkg}") as remote:
            while remote.get(0) is not None:
                pass
    # Five tables; the sentinel carries no stamps.
    assert sketch.count - before == 5


# ---------------------------------------------------------------------------
# The actuator's tenant charges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delivery", ["stream", "handle"])
def test_ledgers_read_zero_after_a_committed_move(delivery, tmp_path):
    """Rank 1 (cold) moves from shard 1 to shard 0 mid-stream: the
    source credits what it released, the target charges what it adopted,
    and after the acks both shards' tenant ledgers read 0."""
    tables = _tables(9, 8)
    queue = _queue(tmq, {1: tables})
    q1 = tir.queue_index(0, 1, TRAINERS)
    with tsvc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS,
                                 tenants=TENANTS) as sss:
        controller = trb.RebalanceController(
            sss.shard_map, journal_path=str(tmp_path / "rb.journal"))
        remote = tsvc.ShardedRemoteQueue(sss.shard_map, max_batch=2,
                                         delivery=delivery, tenant="cold")
        try:
            stream = [remote.get_positioned(q1) for _ in range(3)]
            held = sss.servers[1]._tenant_replay["cold"]
            assert held > 0
            assert trb.migrate(controller, 1, target=0).generation == 1
            # The target charged the frames it adopted; the source
            # credited the ones it released.
            adopted = sss.servers[0]._tenant_replay["cold"]
            released = sss.servers[1]._tenant_replay["cold"]
            while stream[-1][0] is not None:
                stream.append(remote.get_positioned(q1))
        finally:
            remote.close()
            controller.close()
        ledgers = [ack_sent(server) for server in sss.servers]
    assert [t.to_pydict() for t, _ in stream[:-1]] == \
        [t.to_pydict() for t in tables]
    assert adopted > 0 and released == 0
    assert ledgers == [{"cold": 0}, {"cold": 0}]


# ---------------------------------------------------------------------------
# A tenant-bound trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_tenancy_serving"))
    filenames, _ = jdg.generate_data_local(1200, 2, 1, 0.0, d, seed=6)
    return filenames


def test_device_dataset_trains_as_a_tenant_bound_consumer(files):
    spec = jwl.dlrm_spec()
    spec["feature_columns"].append("key")
    spec["feature_types"].append(np.dtype(np.int64))
    out = {}
    for name in ("remote", "local"):
        if name == "remote":
            queue, result = tds.create_batch_queue_and_shuffle(
                files, 1, TRAINERS, num_reducers=4, seed=3)
            server = tsvc.serve_queue(queue, num_trainers=TRAINERS,
                                      tenants=TENANTS)
            remote = tds.connect_remote_queue(
                server.address, max_batch=2, num_trainers=TRAINERS,
                tenant=tten.TenantContext("hot", priority="interactive",
                                          weight=3.0))
            kwargs = dict(batch_queue=remote, shuffle_result=None)
        else:
            kwargs = dict(num_reducers=4)
        ds = tdd.DeviceShufflingDataset(files, 1, TRAINERS, 100, 0, seed=3,
                                        device="cpu", drop_last=False,
                                        **kwargs, **spec)
        ds.set_epoch(0)
        out[name] = [[f.numpy() for f in features] + [label.numpy()]
                     for features, label in ds]
        ds.close()
        if name == "remote":
            remote.close()
            ledgers = ack_sent(server)
            leases = [le.tenant for le in server._leases.values()]
            server.close()
            queue.shutdown()
    assert len(out["remote"]) == len(out["local"]) >= 6
    for got, want in zip(out["remote"], out["local"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert leases == ["hot"] and ledgers.get("hot", 0) == 0


# ---------------------------------------------------------------------------
# A tenant's shard SIGKILLed
# ---------------------------------------------------------------------------


def _reference_streams(run, filenames, epochs, reducers, seed):
    streams = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            streams.setdefault((rank, epoch), []).extend(refs)

    run(filenames, consumer, epochs, reducers, TRAINERS,
        max_concurrent_epochs=1, seed=seed, collect_stats=False,
        file_cache=None, executor_backend="thread")
    return {key: [tuple(r.result().column("key").to_pylist())
                  for r in refs] for key, refs in streams.items()}


def test_tenant_streams_exactly_once_under_shard_kill9(tmp_path):
    """The JAX package's ``test_tenancy_recovery`` over the port's
    supervised shards: SIGKILL the hot tenant's shard after its first
    table; hot's tenant-bound reconnect replays exactly once, cold's
    shard is never restarted and its waits stay under the budget, and
    each tenant's stream equals the fault-free lineage (and JAX's)."""
    epochs, reducers, seed = 2, 4, 11
    filenames, _ = jdg.generate_data_local(600, 2, 1, 0.0, str(tmp_path))
    expected = _reference_streams(tsh.shuffle, filenames, epochs, reducers,
                                  seed)
    assert expected == _reference_streams(jsh.shuffle, filenames, epochs,
                                          reducers, seed)
    handle_root = str(tmp_path / "handles")
    supervisors, shard_map = tsup.launch_supervised_queue_shards(dict(
        filenames=filenames, num_epochs=epochs, num_trainers=TRAINERS,
        num_reducers=reducers, seed=seed, max_concurrent_epochs=1,
        journal_path=str(tmp_path / "wm-tenancy.wal"), file_cache=None,
        handle_dir=handle_root, tenants=TENANTS), num_shards=2)
    assert [shard_map.shard_for_rank(r) for r in range(TRAINERS)] == [0, 1]
    contexts = {0: tten.TenantContext("hot", priority="interactive",
                                      weight=3.0),
                1: tten.TenantContext("cold", priority="batch", weight=1.0)}
    got, errors = {}, []
    killed = threading.Event()
    cold_max_wait = [0.0]

    def consume(rank):
        try:
            with tds.connect_remote_queue(shard_map, retries=12,
                                          max_batch=1,
                                          initial_backoff_s=0.05,
                                          tenant=contexts[rank]) as remote:
                ds = tds.ShufflingDataset(filenames, epochs, TRAINERS, 50,
                                          rank, batch_queue=remote,
                                          shuffle_result=None, seed=seed)
                for epoch in range(epochs):
                    ds.set_epoch(epoch)
                    tables, it = [], ds.iter_tables()
                    while True:
                        start = time.monotonic()
                        table = next(it, None)
                        if rank == 1 and killed.is_set():
                            cold_max_wait[0] = max(
                                cold_max_wait[0], time.monotonic() - start)
                        if table is None:
                            break
                        tables.append(tuple(table.column("key").to_pylist()))
                        if rank == 0 and not killed.is_set():
                            os.kill(supervisors[0].pid, signal.SIGKILL)
                            killed.set()
                    got[(rank, epoch)] = tables
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    try:
        for address in shard_map.addresses:
            assert tsup.wait_for_server(tuple(address), timeout_s=60)
        hot = threading.Thread(target=consume, args=(0,), daemon=True)
        hot.start()
        assert killed.wait(timeout=60), "the kill point was never reached"
        cold = threading.Thread(target=consume, args=(1,), daemon=True)
        cold.start()
        for thread in (hot, cold):
            thread.join(timeout=120)
            assert not thread.is_alive(), "a consumer hung"
    finally:
        for supervisor in supervisors:
            supervisor.stop()
    if errors:
        raise errors[0]
    assert supervisors[0].restarts >= 1 and not supervisors[0].failed
    assert supervisors[1].restarts == 0
    assert cold_max_wait[0] < UNDISTURBED_STALL_BUDGET_S, cold_max_wait
    for rank in range(TRAINERS):
        assert {k: v for k, v in got.items() if k[0] == rank} == \
            {k: v for k, v in expected.items() if k[0] == rank}, rank
    assert [f for _, _, names in os.walk(handle_root) for f in names] == []
