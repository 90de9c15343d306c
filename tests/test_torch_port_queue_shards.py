"""The port's sharded serving plane (``plan.ir``'s placement and
``ShardMap``, ``checkpoint.shard_journal_path``, shared-memory handle
frames, frame compression, ``ShardedQueueServer``/``ShardedRemoteQueue``
and ``dataset.connect_remote_queue`` of a shard map) against the JAX
package's, on the CPU.

- Placement: ``queue_shard``, ``shard_ranks`` and ``shard_journal_path``
  equal the JAX package's over a grid of trainers and shards; a
  ``ShardMap``'s JSON is byte for byte the JAX one (overrides and
  generation included) and ``validate`` refuses the same bad maps with
  the same messages.
- The wire: a port client reads a JAX ``ShardedQueueServer`` and a JAX
  client a port one under streamed, handle and zlib delivery, tables
  equal; both servers put the same frame headers on the wire (kind and
  codec, seq, CRC, row offset, length, task), a handle's segment CRC and
  size included. A GET for a queue another shard owns gets a failure
  frame.
- Handles: wire bytes at least 10x below payload bytes; a consumer that
  cannot map a segment downgrades the queue to streamed frames, exactly
  once; pins and segment files are gone after the acks and after
  ``close``.
- Compression: codec resolution equals the JAX package's; a corrupted
  compressed frame is recovered exactly once; the codec pool's stream
  and counters equal inline compression's.
- A two-rank ``ShufflingDataset`` over ``connect_remote_queue(shard_map)``
  yields the in-process stream.
"""

import json
import os
import socket
import threading

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import multiqueue as jmq
from ray_shuffling_data_loader_tpu import multiqueue_service as jsvc
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import native as tnative
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

NUM_TRAINERS, NUM_EPOCHS = 2, 2


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    tfaults.clear()


def _table(queue_idx, i, rows=2000):
    """A table that compresses (runs of one value) and names its place."""
    return pa.table({"q": np.full(rows, queue_idx, dtype=np.int64),
                     "i": np.full(rows, i, dtype=np.int32),
                     "x": np.arange(rows, dtype=np.float32)})


def _fill(mq, per_queue=3, rows=2000):
    """Every (epoch, rank) queue: ``per_queue`` tables, then the
    sentinel."""
    queue = mq.MultiQueue(NUM_TRAINERS * NUM_EPOCHS)
    for q in range(NUM_TRAINERS * NUM_EPOCHS):
        for i in range(per_queue):
            queue.put(q, _table(q, i, rows))
        queue.put(q, None)
    return queue


def _drain(remote, queue_idx=0):
    tables = []
    while True:
        item = remote.get(queue_idx)
        if item is None:
            return tables
        tables.append(item)


# ---------------------------------------------------------------------------
# Placement and the shard map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trainers,shards", [(1, 1), (2, 2), (3, 2),
                                             (4, 3), (8, 2), (5, 4)])
def test_queue_shard_and_shard_ranks_equal_jax(trainers, shards):
    for q in range(3 * trainers):
        assert tir.queue_shard(q, trainers, shards) == \
            jir.queue_shard(q, trainers, shards)
    owned = [tir.shard_ranks(s, trainers, shards) for s in range(shards)]
    assert owned == [jir.shard_ranks(s, trainers, shards)
                     for s in range(shards)]
    assert sorted(r for ranks in owned for r in ranks) == list(
        range(trainers))


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_journal_path_equals_jax(num_shards):
    for shard in range(num_shards):
        assert tckpt.shard_journal_path("/j/wm.wal", shard, num_shards) == \
            jckpt.shard_journal_path("/j/wm.wal", shard, num_shards)


SHARD_MAPS = {
    "plain": {},
    "overrides": {"overrides": {3: 0, 1: 1}},
    "generation": {"generation": 4},
    "both": {"overrides": {2: 1}, "generation": 2},
}


@pytest.mark.parametrize("name", sorted(SHARD_MAPS))
def test_shard_map_json_byte_identical(name):
    kw = SHARD_MAPS[name]
    addresses = [("127.0.0.1", 4100), ("10.0.0.2", 4101)]
    port = tir.ShardMap(num_trainers=4, addresses=addresses, **kw)
    ref = jir.ShardMap(num_trainers=4, addresses=addresses, **kw)
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    # Each package loads the other's map, byte for byte.
    assert tir.ShardMap.from_json(ref.to_json()).to_json() == ref.to_json()
    assert jir.ShardMap.from_json(port.to_json()).to_json() == \
        port.to_json()
    for q in range(12):
        assert port.shard_for_queue(q) == ref.shard_for_queue(q)
        assert port.address_for_queue(q) == ref.address_for_queue(q)
    assert [port.ranks_for_shard(s) for s in range(2)] == \
        [ref.ranks_for_shard(s) for s in range(2)]


BAD_MAPS = {
    "version": '{"version": 2, "num_trainers": 1, "addresses": [["h", 1]]}',
    "no_trainers": '{"num_trainers": 0, "addresses": [["h", 1]]}',
    "no_addresses": '{"num_trainers": 1, "addresses": []}',
    "missing_key": '{"addresses": [["h", 1]]}',
    "generation": '{"num_trainers": 1, "addresses": [["h", 1]], '
                  '"generation": -1}',
    "override_rank": '{"num_trainers": 1, "addresses": [["h", 1]], '
                     '"overrides": {"5": 0}}',
    "override_shard": '{"num_trainers": 2, "addresses": [["h", 1]], '
                      '"overrides": {"1": 3}}',
    "not_json": '{"num_trainers": ',
    "not_object": '[1, 2]',
}


@pytest.mark.parametrize("name", sorted(BAD_MAPS))
def test_shard_map_validate_errors_equal_jax(name):
    text = BAD_MAPS[name]
    with pytest.raises(tir.PlanError) as port_err:
        tir.ShardMap.from_json(text)
    with pytest.raises(jir.PlanError) as jax_err:
        jir.ShardMap.from_json(text)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# The wire: both packages' shards
# ---------------------------------------------------------------------------


def _mode_env(monkeypatch, mode):
    """The client's delivery for a wire mode; for ``"zlib"`` also the
    compression of the servers about to start."""
    if mode == "zlib":
        monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", "zlib")
        monkeypatch.setenv("RSDL_QUEUE_COMPRESSION_MIN_BYTES", "64")
    return "handle" if mode == "handle" else "stream"


@pytest.mark.parametrize("mode", ["stream", "handle", "zlib"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_sharded_interop(server_pkg, mode, monkeypatch):
    """Each package's sharded client reads the other's shards through the
    shard map's JSON: every queue's tables, equal bit for bit."""
    delivery = _mode_env(monkeypatch, mode)
    if server_pkg == "jax":
        queue, serve, client = _fill(jmq), jsvc.serve_queue_sharded, \
            tsvc.ShardedRemoteQueue
    else:
        queue, serve, client = _fill(tmq), tsvc.serve_queue_sharded, \
            jsvc.ShardedRemoteQueue
    with serve(queue, num_shards=2, num_trainers=NUM_TRAINERS) as sharded:
        assert sharded.num_shards == 2
        with client(sharded.shard_map.to_json(), delivery=delivery,
                    max_batch=2) as remote:
            for q in range(NUM_TRAINERS * NUM_EPOCHS):
                tables = _drain(remote, q)
                assert [t.equals(_table(q, i))
                        for i, t in enumerate(tables)] == [True] * 3


def _raw_frames(address, queue_idx, handles):
    """HELLO (offering handles or not) and GETs of ``queue_idx`` until the
    sentinel, each acking the last frame: ``[(kind byte, seq, crc,
    row_offset, length, task, payload)]``."""
    frames = []
    with socket.create_connection(tuple(address), timeout=30) as sock:
        sock.sendall(tsvc._REQUEST.pack(
            tsvc.OP_HELLO, tsvc.FLAG_HANDLES_OK if handles else 0, 7, 0, 0))
        ack = tsvc.ACK_NONE
        while not frames or frames[-1][0] & 0x0F != tsvc.KIND_SENTINEL:
            sock.sendall(tsvc._REQUEST.pack(tsvc.OP_GET_BATCH, 0, queue_idx,
                                            4, ack))
            (count,) = tsvc._BATCH_HEADER.unpack(
                tsvc._recv_exact(sock, tsvc._BATCH_HEADER.size))
            for _ in range(count):
                (kind, _, seq, crc, row_offset, length, task,
                 *_) = tsvc._FRAME.unpack(tsvc._recv_exact(
                     sock, tsvc._FRAME.size))
                payload = (bytes(tsvc._recv_exact(sock, length))
                           if length else b"")
                frames.append((kind, seq, crc, row_offset, length, task,
                               payload))
                ack = seq
        # The sentinel's ack, so a handle frame's pin is released.
        sock.sendall(tsvc._REQUEST.pack(tsvc.OP_GET_BATCH, 0, queue_idx, 1,
                                        ack))
    return frames


def _comparable(frames):
    """A frame's identity with a handle blob's per-host path dropped."""
    out = []
    for kind, seq, crc, row_offset, length, task, payload in frames:
        if kind == tsvc.KIND_TABLE_HANDLE:
            blob = json.loads(payload)
            out.append((kind, seq, row_offset, task, blob["size"],
                        blob["crc"], blob["offset"]))
        else:
            out.append((kind, seq, crc, row_offset, length, task, payload))
    return out


@pytest.mark.parametrize("mode", ["stream", "handle", "zlib"])
def test_frames_equal_jax_on_the_wire(mode, monkeypatch):
    """The same queue served by each package: the same frame headers and
    payloads (zlib level 1 gives the same bytes), and for handles the
    same segment CRC and size."""
    _mode_env(monkeypatch, mode)
    got = {}
    for pkg, mq, svc in (("jax", jmq, jsvc), ("port", tmq, tsvc)):
        queue = _fill(mq)
        with svc.serve_queue_sharded(queue, num_shards=2,
                                     num_trainers=NUM_TRAINERS) as sharded:
            q = jir.queue_index(1, 1, NUM_TRAINERS)
            got[pkg] = _raw_frames(sharded.shard_map.address_for_queue(q),
                                   q, handles=mode == "handle")
    assert _comparable(got["port"]) == _comparable(got["jax"])
    kinds = {f[0] for f in got["port"][:-1]}
    want = {"stream": tsvc.KIND_TABLE, "handle": tsvc.KIND_TABLE_HANDLE,
            "zlib": tsvc.KIND_TABLE | tsvc.CODEC_ZLIB << 4}[mode]
    assert kinds == {want}
    if mode == "handle":
        # The port server's segments are gone once acked.
        for frame in got["port"][:-1]:
            assert not os.path.exists(json.loads(frame[6])["path"])


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_foreign_queue_gets_a_failure_frame(client_pkg):
    queue = _fill(tmq, per_queue=1)
    client = jsvc.RemoteQueue if client_pkg == "jax" else tsvc.RemoteQueue
    with tsvc.serve_queue_sharded(queue, num_shards=2,
                                  num_trainers=NUM_TRAINERS) as sharded:
        foreign = tir.queue_index(0, 1, NUM_TRAINERS)  # rank 1: shard 1
        with client(tuple(sharded.shard_map.addresses[0])) as remote:
            item = remote.get(foreign)
    assert type(item).__name__ == "ShuffleFailure"
    assert "not served by shard 0/2" in str(item.error)


# ---------------------------------------------------------------------------
# Handle frames
# ---------------------------------------------------------------------------


def _serve_deltas(fn):
    before = tstats.queue_serve_totals()
    fn()
    after = tstats.queue_serve_totals()
    return {k: after[k] - before[k] for k in
            ("queue_payload_bytes", "queue_bytes_on_wire",
             "queue_handle_hits", "queue_handle_misses",
             "queue_compression_saved_bytes")}


@pytest.mark.parametrize("delivery", ["auto", "stream"])
def test_handle_delivery_cuts_wire_bytes_10x(delivery):
    """On loopback ``"auto"`` sends handles: the wire carries at least 10x
    fewer bytes than the payload. ``"stream"`` sends every byte."""
    queue = tmq.MultiQueue(1)
    table = pa.table({"x": np.arange(20_000, dtype=np.int64)})
    queue.put(0, table)
    queue.put(0, None)

    def run():
        with tsvc.serve_queue(queue) as server:
            with tsvc.RemoteQueue(server.address,
                                  delivery=delivery) as remote:
                assert remote.get(0).equals(table)
                assert remote.get(0) is None

    d = _serve_deltas(run)
    assert d["queue_payload_bytes"] > 0
    if delivery == "auto":
        assert (d["queue_handle_hits"], d["queue_handle_misses"]) == (1, 0)
        assert d["queue_bytes_on_wire"] * 10 <= d["queue_payload_bytes"]
    else:
        assert (d["queue_handle_hits"], d["queue_handle_misses"]) == (0, 1)
        assert d["queue_bytes_on_wire"] == d["queue_payload_bytes"]


def test_handle_downgrade_on_unusable_segment(monkeypatch):
    """The client cannot map a segment: NACK_NO_HANDLE, the server streams
    the same frames again from its own segments, exactly once."""
    real_read = tsvc.pp.read_segment_buffer
    calls = {"n": 0}

    def flaky_read(path):
        calls["n"] += 1
        if calls["n"] == 1:  # the client's first handle
            raise OSError("a segment path of another host")
        return real_read(path)

    monkeypatch.setattr(tsvc.pp, "read_segment_buffer", flaky_read)
    queue = tmq.MultiQueue(1)
    for i in range(4):
        queue.put(0, pa.table({"seq": [i] * 100}))
    queue.put(0, None)
    nacked_before = tstats.process_recovery_totals()["queue_frames_nacked"]
    with tsvc.serve_queue(queue) as server:
        with tsvc.RemoteQueue(server.address, delivery="handle",
                              max_batch=2) as remote:
            seen = [t.column("seq")[0].as_py() for t in _drain(remote)]
    assert seen == [0, 1, 2, 3]
    assert calls["n"] >= 2  # the server's own read of the downgrade
    assert tstats.process_recovery_totals()["queue_frames_nacked"] \
        - nacked_before == 1


@pytest.mark.parametrize("released_by", ["acks", "close"])
def test_pins_and_segments_released(released_by, tmp_path):
    """A handle frame pins its segment until its ack (or the server's
    close, for frames never acked): the ledger and the directory end as
    they began."""
    ledger = tnative.buffer_ledger()
    before = ledger.bytes_in_use()
    frame_bytes = tsvc._serialize(_table(0, 0)).size
    queue = _fill(tmq, per_queue=3)
    handle_dir = str(tmp_path / "handles")
    server = tsvc.serve_queue(queue, num_trainers=NUM_TRAINERS,
                              handle_dir=handle_dir)
    try:
        max_batch = 1 if released_by == "acks" else 2
        with tsvc.RemoteQueue(server.address, delivery="handle",
                              max_batch=max_batch, prefetch=False) as remote:
            remote.get(0)
            assert ledger.bytes_in_use() - before == max_batch * frame_bytes
            assert len(os.listdir(handle_dir)) == max_batch
            if released_by == "acks":
                # Each GET acks the frame before it; the sentinel's GET
                # acks the last table.
                assert len(_drain(remote, 0)) == 2
                assert ledger.bytes_in_use() == before
                assert os.listdir(handle_dir) == []
    finally:
        server.close()
    assert ledger.bytes_in_use() == before
    assert not os.path.exists(handle_dir) or not os.listdir(handle_dir)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["off", "zlib", "zstd", "lz4", "brotli"])
def test_codec_resolution_equals_jax(name, monkeypatch):
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", name)
    if name == "brotli":
        for resolve in (tsvc._resolve_compression,
                        jsvc._resolve_compression):
            with pytest.raises(ValueError, match="must be off"):
                resolve()
        return
    port, ref = tsvc._resolve_compression(), jsvc._resolve_compression()
    if name == "off":
        assert port is None and ref is None
        return
    assert port[0] == ref[0]
    data = bytes(_table(0, 0).column("q").chunks[0].buffers()[1])
    packed = port[1](data)
    assert bytes(tsvc._decompress(port[0], packed)) == data
    assert bytes(jsvc._decompress(ref[0], packed)) == data


def test_compressed_frame_corruption_recovered_exactly_once(monkeypatch):
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", "zlib")
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION_MIN_BYTES", "64")
    queue = tmq.MultiQueue(1)
    for i in range(6):
        queue.put(0, pa.table({"seq": [i] * 500}))
    queue.put(0, None)
    before = tstats.process_recovery_totals()
    injector = tfaults.install("frame_corrupt:task0:after2", seed=0)
    with tsvc.serve_queue(queue) as server:
        with tsvc.RemoteQueue(server.address, delivery="stream",
                              max_batch=2) as remote:
            seen = [t.column("seq")[0].as_py() for t in _drain(remote)]
    after = tstats.process_recovery_totals()
    assert injector.fired()
    assert seen == list(range(6))
    assert after["queue_frames_corrupt"] - before["queue_frames_corrupt"] \
        == 1
    assert after["queue_frames_nacked"] - before["queue_frames_nacked"] == 1


def test_codec_pool_stream_equals_inline(monkeypatch):
    """Compressing on a pool of 2 threads or inline: the same tables, the
    same wire bytes and the same savings, ``wire + saved == payload``."""
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", "zlib")
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION_MIN_BYTES", "64")
    runs = {}
    for threads in ("0", "2"):
        monkeypatch.setenv("RSDL_QUEUE_CODEC_THREADS", threads)
        queue = _fill(tmq)
        tables = []

        def run():
            with tsvc.serve_queue(queue, num_trainers=NUM_TRAINERS) as srv:
                assert (srv._codec_pool is None) == (threads == "0")
                with tsvc.RemoteQueue(srv.address, delivery="stream",
                                      max_batch=4) as remote:
                    for q in range(NUM_TRAINERS * NUM_EPOCHS):
                        tables.extend(_drain(remote, q))

        runs[threads] = (tables, _serve_deltas(run))
    (inline, d_inline), (pooled, d_pooled) = runs["0"], runs["2"]
    assert len(inline) == len(pooled) == 12
    assert all(a.equals(b) for a, b in zip(inline, pooled))
    assert d_inline == d_pooled
    assert d_inline["queue_compression_saved_bytes"] > 0
    assert (d_inline["queue_bytes_on_wire"]
            + d_inline["queue_compression_saved_bytes"]
            == d_inline["queue_payload_bytes"])


def test_compressed_jax_frames_are_read(monkeypatch):
    """A JAX server's zlib frames, through a port client (the frame the
    one-server port refused before)."""
    queue = jmq.MultiQueue(1)
    table = pa.table({"x": np.zeros(4096, dtype=np.int64)})
    queue.put(0, table)
    queue.put(0, None)
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", "zlib")
    monkeypatch.setenv("RSDL_QUEUE_COMPRESSION_MIN_BYTES", "1")
    server = jsvc.serve_queue(queue)
    monkeypatch.delenv("RSDL_QUEUE_COMPRESSION")
    try:
        with tsvc.RemoteQueue(server.address, delivery="stream",
                              retries=0) as remote:
            assert remote.get(0).equals(table)
            assert remote.get(0) is None
    finally:
        server.close()
        queue.shutdown()


# ---------------------------------------------------------------------------
# A two-rank dataset over a shard map
# ---------------------------------------------------------------------------


def test_two_rank_dataset_over_shard_map_equals_in_process(tmp_path):
    files, _ = jdg.generate_data_local(600, 3, 1, 0.0, str(tmp_path), seed=6)
    kwargs = dict(num_reducers=4, seed=21)
    queue, result = tds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, NUM_TRAINERS, **kwargs)
    per_rank, errors = {}, []
    with tsvc.serve_queue_sharded(queue, num_shards=2,
                                  num_trainers=NUM_TRAINERS) as sharded:

        def consume(rank):
            try:
                with tds.connect_remote_queue(sharded.shard_map,
                                              max_batch=3) as remote:
                    assert isinstance(remote, tsvc.ShardedRemoteQueue)
                    ds = tds.ShufflingDataset(
                        files, NUM_EPOCHS, NUM_TRAINERS, 40, rank,
                        batch_queue=remote, shuffle_result=None, seed=21)
                    for epoch in range(NUM_EPOCHS):
                        ds.set_epoch(epoch)
                        per_rank[(rank, epoch)] = [
                            b.column("key").to_pylist() for b in ds]
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=consume, args=(r,), daemon=True)
                   for r in range(NUM_TRAINERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "a rank hung"
    result.result()
    queue.shutdown()
    if errors:
        raise errors[0]
    queue, result = tds.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, NUM_TRAINERS, **kwargs)
    for rank in range(NUM_TRAINERS):
        ds = tds.ShufflingDataset(files, NUM_EPOCHS, NUM_TRAINERS, 40, rank,
                                  batch_queue=queue, shuffle_result=result,
                                  seed=21)
        for epoch in range(NUM_EPOCHS):
            ds.set_epoch(epoch)
            assert per_rank[(rank, epoch)] == [
                b.column("key").to_pylist() for b in ds]
    result.result()
    for epoch in range(NUM_EPOCHS):
        keys = sorted(k for rank in range(NUM_TRAINERS)
                      for b in per_rank[(rank, epoch)] for k in b)
        assert keys == list(range(600))


def test_policy_shard_count_is_the_default(monkeypatch):
    monkeypatch.setenv("RSDL_QUEUE_SHARDS", "3")
    with tsvc.serve_queue_sharded(_fill(tmq, per_queue=1),
                                  num_trainers=NUM_TRAINERS) as sharded:
        assert sharded.shard_map.num_shards == 3
        assert [s._shard_index for s in sharded.servers] == [0, 1, 2]
    assert tir.SHARD_MAP_VERSION == jir.SHARD_MAP_VERSION
