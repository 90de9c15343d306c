"""The port's distributed shuffle (``parallel/{transport,distributed}.py``)
against the JAX package's: the shard plan, the wire format, the transport's
delivery rules, and the reducer tables of every global trainer in worlds
of threads standing in for hosts.

The files come from the JAX package's generator (6,000 rows in 6 files,
2 row groups each, seed 3). A stream is ``{(trainer, epoch): [reducer
table, ...]}``; the port's distributed stream must equal the JAX
package's ``shuffle_distributed`` and the port's one-process shuffle with
``num_trainers = world * trainers_per_host`` table for table
(``pa.Table.equals``), and every key must arrive once per epoch. Every
world joins its threads with a time limit and gives ``recv`` a timeout of
tens of seconds, so a hang fails one test.
"""

import os
import socket
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu.parallel import distributed as jdist
from ray_shuffling_data_loader_tpu.parallel import transport as jtp
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import train_shuffle
from ray_shuffling_data_loader_tpu_torch.parallel import distributed as tdist
from ray_shuffling_data_loader_tpu_torch.parallel import transport as ttp
from ray_shuffling_data_loader_tpu_torch.runtime import faults

RECV_TIMEOUT_S = 30.0
JOIN_S = 60.0
KEY = jdg.KEY_COLUMN


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_dist"))
    filenames, _ = jdg.generate_data_local(
        num_rows=6000, num_files=6, num_row_groups_per_file=2,
        max_row_group_skew=0.0, data_dir=d, seed=3)
    return filenames


def _join(threads, what: str) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), f"{what} hung"


def _world(host_main, transports) -> list:
    """Run ``host_main(h)`` for every transport in a thread of its own;
    returns ``[(host, error), ...]``."""
    errors = []

    def run(h):
        try:
            host_main(h)
        except BaseException as e:  # noqa: BLE001 - surfaced to the test
            errors.append((h, e))

    try:
        _join([threading.Thread(target=run, args=(h,), daemon=True)
               for h in range(len(transports))], "a host")
    finally:
        for t in transports:
            t.close()
    return errors


def _distributed_stream(pkg, tmod, filenames, num_epochs, num_reducers,
                        world, tph, seed, **kw):
    """{(global trainer, epoch): [reducer table, ...]} from ``pkg``'s
    ``shuffle_distributed`` over ``world`` threads as hosts."""
    transports = tmod.create_local_transports(world,
                                              recv_timeout_s=RECV_TIMEOUT_S)
    stream = {}

    def host_main(h):
        refs = {}

        def consumer(local_rank, epoch, batch_refs):
            if batch_refs is not None:
                refs.setdefault((local_rank, epoch), []).extend(batch_refs)

        pkg.shuffle_distributed(filenames, consumer, num_epochs,
                                num_reducers, transports[h],
                                trainers_per_host=tph,
                                max_concurrent_epochs=2, seed=seed,
                                num_workers=4, **kw)
        for (local_rank, epoch), rs in refs.items():
            stream[(h * tph + local_rank, epoch)] = [r.result() for r in rs]

    errors = _world(host_main, transports)
    if errors:
        raise errors[0][1]
    return stream


def _one_process_stream(filenames, num_epochs, num_reducers, num_trainers,
                        seed, **kw):
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    tsh.shuffle(filenames, consumer, num_epochs, num_reducers, num_trainers,
                seed=seed, **kw)
    return {k: [r.result() for r in rs] for k, rs in refs.items()}


def _assert_same_tables(got, want, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        assert len(got[k]) == len(want[k]), (what, k)
        for a, b in zip(got[k], want[k]):
            assert a.equals(b), f"{what}: trainer/epoch {k} differs"


def _keys(stream, epoch):
    return sorted(k for (_, e), tables in stream.items() if e == epoch
                  for t in tables for k in t.column(KEY).to_pylist())


# -- the shard plan ----------------------------------------------------------


@pytest.mark.parametrize("num_files,num_reducers,world,tph", [
    (6, 6, 3, 1), (10, 13, 4, 2), (1, 1, 1, 1), (7, 5, 2, 3), (3, 8, 5, 1)])
def test_shard_plan_equals_the_jax_plan(num_files, num_reducers, world, tph):
    got = tdist.ShardPlan(num_files, num_reducers, world, tph)
    want = jdist.ShardPlan(num_files, num_reducers, world, tph)
    for field in ("world", "trainers_per_host", "num_trainers", "num_files",
                  "num_reducers", "file_shards", "trainer_reducers"):
        assert getattr(got, field) == getattr(want, field), field
    for h in range(world):
        assert got.local_files(h) == want.local_files(h)
        assert got.local_trainers(h) == want.local_trainers(h)
        assert got.local_reducers(h) == want.local_reducers(h)
    assert ([got.file_host(f) for f in range(num_files)]
            == [want.file_host(f) for f in range(num_files)])
    assert ([got.reducer_host(r) for r in range(num_reducers)]
            == [want.reducer_host(r) for r in range(num_reducers)])


# -- IPC ---------------------------------------------------------------------


def _ipc_table(kind: str, rows: int = 50) -> pa.Table:
    rng = np.random.default_rng(0)
    cols = {"key": np.arange(rows, dtype=np.int64)}
    if kind == "primitive":
        cols["x"] = rng.random(rows).astype(np.float32)
        cols["flag"] = rng.random(rows) < 0.5
    elif kind == "fixed_size_list":
        values = pa.array(rng.integers(0, 30522, rows * 8, dtype=np.int32))
        cols["tokens"] = pa.FixedSizeListArray.from_arrays(values, 8)
    else:
        cols["image"] = pa.array(
            [rng.bytes(int(n)) for n in rng.integers(0, 200, rows)],
            type=pa.binary())
    return pa.table(cols)


@pytest.mark.parametrize("kind", ["primitive", "fixed_size_list", "binary"])
def test_ipc_round_trip(kind):
    table = _ipc_table(kind)
    for t in (table, table.slice(0, 0), table.slice(7, 20)):
        out = tdist.deserialize_table(tdist.serialize_table(t))
        assert out.schema.equals(t.schema) and out.equals(t)
        # The JAX package reads the port's stream and the other way round.
        assert jdist.deserialize_table(tdist.serialize_table(t)).equals(t)
        assert tdist.deserialize_table(jdist.serialize_table(t)).equals(t)


# -- the transport -----------------------------------------------------------


def _close_all(transports):
    for t in transports:
        t.close()


def test_port_and_jax_transports_exchange_frames_both_ways():
    addresses = [("127.0.0.1", 0)] * 2
    port = ttp.TcpTransport(0, addresses, recv_timeout_s=RECV_TIMEOUT_S)
    jax_side = jtp.TcpTransport(1, addresses, recv_timeout_s=RECV_TIMEOUT_S)
    pair = [port, jax_side]
    try:
        for t in pair:
            t.start()
        bound = [("127.0.0.1", t.bound_port()) for t in pair]
        for t in pair:
            t.addresses = bound
            t.connect()
        payloads = {(0, 3, 5): b"port to jax", (2, 0, 1): os.urandom(3 << 20)}
        for tag, data in payloads.items():
            port.send(1, tag, data)
            jax_side.send(0, tag, data[::-1])
        for tag, data in payloads.items():
            assert bytes(jax_side.recv(0, tag)) == data
            assert bytes(port.recv(1, tag)) == data[::-1]
    finally:
        _close_all(pair)


def test_round_trip_out_of_order_tags_and_counters():
    world = ttp.create_local_transports(2, recv_timeout_s=RECV_TIMEOUT_S)
    try:
        world[0].send(1, (0, 3, 5), b"hello")
        assert world[1].recv(0, (0, 3, 5)) == b"hello"
        world[1].send(0, (1, 0, 0), b"b")
        world[1].send(0, (0, 0, 0), b"a")
        assert world[0].recv(1, (0, 0, 0)) == b"a"
        assert world[0].recv(1, (1, 0, 0)) == b"b"
        sent, got = world[1].stats(), world[0].stats()
        assert (sent["frames_sent"], sent["bytes_sent"]) == (2, 2)
        assert (got["frames_received"], got["bytes_received"]) == (2, 2)
    finally:
        _close_all(world)


def test_self_send_and_a_payload_of_several_megabytes():
    world = ttp.create_local_transports(2, recv_timeout_s=RECV_TIMEOUT_S)
    try:
        world[0].send(0, (0, 0, 0), b"self")
        assert world[0].recv(0, (0, 0, 0)) == b"self"
        world[0].send(0, (4, 4, 4), b"y")
        with pytest.raises(ttp.TransportError, match="duplicate"):
            world[0].send(0, (4, 4, 4), b"y")
        big = os.urandom(9 << 20)
        world[0].send(1, (9, 9, 9), big)
        assert world[1].recv(0, (9, 9, 9)) == big
    finally:
        _close_all(world)


def test_recv_times_out():
    world = ttp.create_local_transports(2, recv_timeout_s=RECV_TIMEOUT_S)
    try:
        start = time.monotonic()
        with pytest.raises(ttp.TransportTimeout):
            world[0].recv(1, (0, 0, 0), timeout_s=0.2)
        assert time.monotonic() - start < 5
    finally:
        _close_all(world)


def _raw_frame(src, tag, payload: bytes, length=None) -> bytes:
    return ttp._HEADER.pack(ttp._MAGIC, src, 0, 0, *tag,
                            len(payload) if length is None else length
                            ) + payload


def test_a_resent_frame_is_dropped_and_each_message_is_consumed_once():
    t = ttp.TcpTransport(0, [("127.0.0.1", 0), ("127.0.0.1", 1)],
                         recv_timeout_s=RECV_TIMEOUT_S)
    t.start()
    try:
        with socket.create_connection(("127.0.0.1", t.bound_port())) as s:
            s.sendall(_raw_frame(1, (0, 2, 3), b"first")
                      + _raw_frame(1, (0, 2, 3), b"resent"))
            assert t.recv(1, (0, 2, 3)) == b"first"
            with pytest.raises(ttp.TransportTimeout):
                t.recv(1, (0, 2, 3), timeout_s=0.5)
    finally:
        t.close()


def test_a_dead_source_fails_recv_after_the_grace():
    grace = 0.3
    t = ttp.TcpTransport(0, [("127.0.0.1", 0), ("127.0.0.1", 1)],
                         recv_timeout_s=RECV_TIMEOUT_S,
                         reconnect_grace_s=grace)
    t.start()
    try:
        with socket.create_connection(("127.0.0.1", t.bound_port())) as s:
            # A frame, then a second one cut off mid-payload.
            s.sendall(_raw_frame(1, (0, 0, 0), b"whole")
                      + _raw_frame(1, (0, 1, 0), b"cut", length=100))
        start = time.monotonic()
        with pytest.raises(ttp.TransportError, match="died") as err:
            t.recv(1, (0, 1, 0))
        assert not isinstance(err.value, ttp.TransportTimeout)
        assert grace <= time.monotonic() - start < RECV_TIMEOUT_S / 2
        assert t.recv(1, (0, 0, 0)) == b"whole"
    finally:
        t.close()


def test_fault_sites_take_the_redial_and_retry_paths():
    world = ttp.create_local_transports(2, recv_timeout_s=RECV_TIMEOUT_S)
    try:
        faults.install("transport_send:epoch0:task3,transport_recv:epoch1")
        world[0].send(1, (0, 3, 0), b"resent on a new connection")
        assert world[1].recv(0, (0, 3, 0)) == b"resent on a new connection"
        world[0].send(1, (1, 0, 0), b"kept")
        with pytest.raises(faults.InjectedFault):
            world[1].recv(0, (1, 0, 0))
        assert world[1].recv(0, (1, 0, 0)) == b"kept"
    finally:
        faults.clear()
        _close_all(world)


# -- streams -----------------------------------------------------------------


@pytest.mark.parametrize("world,tph,num_reducers,seed", [
    (3, 1, 6, 23), (2, 2, 10, 41)])
def test_streams_equal_jax_and_the_one_process_shuffle(files, world, tph,
                                                       num_reducers, seed):
    got = _distributed_stream(tdist, ttp, files, 2, num_reducers, world,
                              tph, seed)
    jax_stream = _distributed_stream(jdist, jtp, files, 2, num_reducers,
                                     world, tph, seed)
    one = _one_process_stream(files, 2, num_reducers, world * tph, seed)
    _assert_same_tables(got, jax_stream, "vs JAX shuffle_distributed")
    _assert_same_tables(got, one, "vs the one-process shuffle")
    for epoch in range(2):
        assert _keys(got, epoch) == list(range(6000))


def test_reduce_transform_runs_once_per_row_in_the_distributed_reduce(files):
    seen, lock = [], threading.Lock()

    def tag(table: pa.Table) -> pa.Table:
        with lock:
            seen.extend(table.column(KEY).to_pylist())
        return table.append_column("tagged",
                                   pa.array([True] * table.num_rows))

    got = _distributed_stream(tdist, ttp, files, 1, 4, 2, 1, 5,
                              reduce_transform=tag)
    assert all("tagged" in t.column_names
               for tables in got.values() for t in tables)
    assert _keys(got, 0) == sorted(seen) == list(range(6000))
    plain = _one_process_stream(files, 1, 4, 2, 5)
    for k, tables in got.items():
        for a, b in zip(tables, plain[k]):
            assert a.drop_columns(["tagged"]).equals(b)


def _column_kind_files(tmp_path, kind: str):
    rng = np.random.default_rng(11)
    paths = []
    for f in range(4):
        n = 150
        cols = {KEY: np.arange(f * n, (f + 1) * n, dtype=np.int64),
                "labels": rng.random(n)}
        values = pa.array(rng.integers(0, 1000, n * 4, dtype=np.int32))
        cols["tokens"] = pa.FixedSizeListArray.from_arrays(values, 4)
        if kind == "binary":
            cols["image"] = pa.array(
                [rng.bytes(int(m)) for m in rng.integers(1, 300, n)],
                type=pa.binary())
        path = str(tmp_path / f"part_{f}.parquet")
        pq.write_table(pa.table(cols), path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("kind", ["binary", "fixed_size_list"])
def test_binary_and_fixed_size_list_worlds(tmp_path, kind):
    """Encoded-image tables (Arrow ``take``) and token rows (numpy
    rows) cross the wire as IPC and reduce to the same tables."""
    paths = _column_kind_files(tmp_path, kind)
    got = _distributed_stream(tdist, ttp, paths, 2, 4, 2, 1, 9)
    jax_stream = _distributed_stream(jdist, jtp, paths, 2, 4, 2, 1, 9)
    one = _one_process_stream(paths, 2, 4, 2, 9)
    _assert_same_tables(got, jax_stream, f"{kind} vs JAX")
    _assert_same_tables(got, one, f"{kind} vs one process")
    assert _keys(got, 1) == list(range(600))


def test_start_epoch_replays_exactly_the_remaining_epochs(files):
    full = _distributed_stream(tdist, ttp, files, 3, 6, 2, 1, 9)
    resumed = _distributed_stream(tdist, ttp, files, 3, 6, 2, 1, 9,
                                  start_epoch=1)
    assert sorted(resumed) == sorted(k for k in full if k[1] >= 1)
    _assert_same_tables(resumed, {k: v for k, v in full.items()
                                  if k[1] >= 1}, "resumed")


def test_a_failing_file_fails_every_host_within_its_timeout(files, tmp_path):
    bad = list(files)
    broken = str(tmp_path / "broken.parquet.snappy")
    with open(broken, "wb") as f:
        f.write(b"not parquet")
    bad[-1] = broken  # in host 1's shard
    timeout_s = 3.0
    transports = ttp.create_local_transports(2, recv_timeout_s=timeout_s)

    def host_main(h):
        queue, result = tdist.create_distributed_batch_queue_and_shuffle(
            bad, 1, 4, transports[h], seed=0, num_workers=4)
        d = tds.ShufflingDataset(bad, 1, 1, 100, 0, batch_queue=queue,
                                 shuffle_result=result)
        d.set_epoch(0)
        for _ in d:
            pass

    start = time.monotonic()
    errors = _world(host_main, transports)
    # Host 1 raises its map's error; host 0 its reducer's recv timeout.
    assert sorted(h for h, _ in errors) == [0, 1]
    by_host = dict(errors)
    assert isinstance(by_host[0], ttp.TransportTimeout)
    assert isinstance(by_host[1], pa.ArrowInvalid)
    assert time.monotonic() - start < timeout_s + 20


# -- checkpoint across worlds ------------------------------------------------


def _world_dataset_run(filenames, num_epochs, num_reducers, world, seed,
                       batch_size, start_epoch=0, trainer0_consume=None):
    """Every host consumes through ``ShufflingDataset``; host 0 runs
    ``trainer0_consume(dataset)`` and its result is returned, the others
    drain their epochs."""
    transports = ttp.create_local_transports(world,
                                             recv_timeout_s=RECV_TIMEOUT_S)
    out = {}

    def host_main(h):
        queue, result = tdist.create_distributed_batch_queue_and_shuffle(
            filenames, num_epochs, num_reducers, transports[h], seed=seed,
            num_workers=4, start_epoch=start_epoch)
        d = tds.ShufflingDataset(filenames, num_epochs, 1, batch_size, 0,
                                 batch_queue=queue, shuffle_result=result,
                                 seed=seed, start_epoch=start_epoch)
        if h == 0 and trainer0_consume is not None:
            out[0] = trainer0_consume(d)
            return
        for epoch in range(start_epoch, num_epochs):
            d.set_epoch(epoch)
            for _ in d:
                pass

    errors = _world(host_main, transports)
    if errors:
        raise errors[0][1]
    return out.get(0)


def _recording_consumer(seed, num_epochs, world, batch_size, crash_point,
                        path):
    def consume(d):
        c = tckpt.LoaderCheckpoint(
            seed=seed, epoch=0, batches_consumed=0, num_epochs=num_epochs,
            num_trainers=world, rank=0, batch_size=batch_size)
        stream = []
        for batch in tckpt.resume_iterator(d, c):
            stream.append((c.epoch, c.batches_consumed,
                           tuple(batch.column(KEY).to_pylist())))
            if (c.epoch, c.batches_consumed) == crash_point:
                c.save(path)
        return stream

    return consume


def test_checkpoint_resume_world3_to_world1(files, tmp_path):
    num_epochs, num_reducers, world, seed, bs = 3, 6, 3, 31, 128
    crash_point, path = (1, 3), str(tmp_path / "ckpt.json")
    full = _world_dataset_run(
        files, num_epochs, num_reducers, world, seed, bs,
        trainer0_consume=_recording_consumer(seed, num_epochs, world, bs,
                                             crash_point, path))
    expected = [keys for (e, i, keys) in full if (e, i) > crash_point]
    assert expected
    loaded = tckpt.LoaderCheckpoint.load(path)
    assert (loaded.epoch, loaded.batches_consumed) == crash_point
    d = tds.ShufflingDataset(files, num_epochs, world, bs, 0,
                             num_reducers=num_reducers, seed=seed,
                             start_epoch=loaded.epoch)
    resumed = [tuple(b.column(KEY).to_pylist())
               for b in tckpt.resume_iterator(d, loaded)]
    assert resumed == expected


def test_checkpoint_resume_world1_to_world3(files, tmp_path):
    num_epochs, num_reducers, world, seed, bs = 3, 6, 3, 47, 128
    crash_point, path = (1, 4), str(tmp_path / "ckpt.json")
    d = tds.ShufflingDataset(files, num_epochs, world, bs, 0,
                             num_reducers=num_reducers, seed=seed)
    full = _recording_consumer(seed, num_epochs, world, bs, crash_point,
                               path)(d)
    expected = [keys for (e, i, keys) in full if (e, i) > crash_point]
    assert expected
    loaded = tckpt.LoaderCheckpoint.load(path)
    resumed = _world_dataset_run(
        files, num_epochs, num_reducers, world, seed, bs,
        start_epoch=loaded.epoch,
        trainer0_consume=lambda ds: [
            tuple(b.column(KEY).to_pylist())
            for b in tckpt.resume_iterator(ds, loaded)])
    assert resumed == expected


# -- the entry point's device rule ------------------------------------------


def test_train_shuffle_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        train_shuffle.main(["--num-rows", "100"])
    args = train_shuffle.parse_args(["--cpu", "--process-group-backend",
                                     "gloo", "--record-dir", "r"])
    assert args.cpu and args.process_group_backend == "gloo"
    assert args.record_dir == "r" and args.mock_train_step_time is None
