"""The port's process pool (``procpool.py``, ``procpool_worker.py``) against
the JAX package's on the same files and seeds.

The reducer tables of the process backend must equal the port's thread
backend's, the JAX process pool's and the JAX thread backend's bit for
bit, over 2 epochs, with and without a map transform, and also when a
worker is SIGKILLed inside a map task (its task is resubmitted from
lineage and the worker respawned). Then: ``submit_once`` fails with
``WorkerDied``; segment files round-trip and read back with the JAX
package's readers; a corrupt file is quarantined as in JAX; the segment
cache serves a second epoch; segments are keyed by file name, so two
epochs whose file 0 names different files read each its own rows (the
JAX pool names them by index and serves stale rows there); ``"auto"``
decides as the JAX rule in each of its conditions, and keeps a
``__main__`` transform or an installed storage source on threads, and an
explicit ``"process"`` that cannot run raises; a worker of a driver whose
main module imports torch loads no torch; and the workers fork from one
worker template per process, with the driver's environment.

Pools are 2 workers wide over 4 files of 4,000 rows in all; each is shut
down in a ``finally`` and its segment directory is gone afterwards. No
kill waits on a timer: the map task writes its pid to a marker file
(``procpool.HoldOnFirstCall``) and holds until it is killed.
"""

import importlib
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import executor as jex
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu import stats as jstats
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import executor as tex
from ray_shuffling_data_loader_tpu_torch import native as tnative
from ray_shuffling_data_loader_tpu_torch import procpool
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch import transforms as ttr
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults

import torch_port_pool_tasks as tasks

jsh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")
jpool = importlib.import_module("ray_shuffling_data_loader_tpu.procpool")

NUM_ROWS = 4000
NUM_EPOCHS = 2
NUM_REDUCERS = 4
NUM_TRAINERS = 2
SEED = 5
WORKERS = 2
DEADLINE_S = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_procpool"))
    filenames, _ = jdg.generate_data_local(NUM_ROWS, 3, 2, 0.0, d, seed=3)
    return filenames


def _casts():
    spec = jwl.dlrm_spec()
    args = (spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"])
    return jjd.make_cast_transform(*args), ttr.make_cast_transform(*args)


def _collect(run, filenames, **kw):
    """``{(rank, epoch): [table, ...]}`` of one shuffle."""
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    run(filenames, consumer, NUM_EPOCHS, NUM_REDUCERS, NUM_TRAINERS,
        seed=SEED, num_workers=WORKERS, **kw)
    return {k: [r.result(timeout=DEADLINE_S) for r in v]
            for k, v in refs.items()}


def assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert len(got[k]) == len(want[k]), (what, k)
        for a, b in zip(got[k], want[k]):
            assert a.equals(b), f"{what}: rank/epoch {k} differs"


@pytest.fixture(scope="module")
def jax_process_streams(files):
    """The JAX process pool's stream without and with the cast, made once
    (each run starts a JAX pool)."""
    jcast, _ = _casts()
    return {name: _collect(jsh.shuffle, files, executor_backend="process",
                           map_transform=transform)
            for name, transform in (("plain", None), ("cast", jcast))}


@pytest.mark.parametrize("transform", ["plain", "cast"])
def test_process_backend_equals_thread_and_jax(files, jax_process_streams,
                                               transform):
    jcast, tcast = _casts()
    jt, tt = (jcast, tcast) if transform == "cast" else (None, None)
    got = _collect(tsh.shuffle, files, executor_backend="process",
                   map_transform=tt)
    assert tex.last_worker_pool()["backend"] == "process"
    assert len(tex.last_worker_pool()["pids"]) == WORKERS
    assert_same(got, _collect(tsh.shuffle, files, executor_backend="thread",
                              map_transform=tt), "port thread")
    assert_same(got, jax_process_streams[transform], "JAX process pool")
    assert_same(got, _collect(jsh.shuffle, files, executor_backend="thread",
                              map_transform=jt), "JAX thread")
    keys = np.concatenate([t.column("key").to_numpy()
                           for (_, epoch), ts in got.items() if epoch == 1
                           for t in ts])
    np.testing.assert_array_equal(np.sort(keys), np.arange(NUM_ROWS))


def _wait_for(path: str) -> int:
    """The pid a task wrote to ``path``, waiting up to the deadline."""
    deadline = time.monotonic() + DEADLINE_S
    text = ""
    while not text and time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
        if not text:
            time.sleep(0.01)
    assert text, f"no map task reported its start in {path}"
    return int(text)


def test_a_worker_killed_mid_shuffle_gives_the_same_stream(
        files, jax_process_streams, tmp_path):
    marker = str(tmp_path / "started")
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    before = tstats.fault_stats().snapshot()["recomputes_by_component"]
    run = tsh.run_shuffle_in_background(
        files, consumer, NUM_EPOCHS, NUM_REDUCERS, NUM_TRAINERS, seed=SEED,
        num_workers=WORKERS, executor_backend="process",
        map_transform=procpool.HoldOnFirstCall(marker))
    try:
        pid = _wait_for(marker)
        pids = tex.last_worker_pool()["pids"]
        assert pid in pids  # a worker, inside a map task
        os.kill(pid, signal.SIGKILL)
        run.result(timeout=DEADLINE_S)
    finally:
        open(marker + ".go", "w").close()
    got = {k: [r.result(timeout=DEADLINE_S) for r in v]
           for k, v in refs.items()}
    after = tstats.fault_stats().snapshot()["recomputes_by_component"]
    assert after.get("lineage", 0) - before.get("lineage", 0) >= 1
    respawned = tex.last_worker_pool()["pids"]
    assert pid not in respawned and len(respawned) == WORKERS
    assert_same(got, jax_process_streams["plain"], "after the kill")
    assert_same(got, _collect(tsh.shuffle, files,
                              executor_backend="thread"), "port thread")


def test_submit_once_raises_worker_died_and_the_pool_respawns():
    pool = procpool.ProcessPoolExecutor(num_workers=WORKERS)
    segment_dir = pool.segment_dir
    try:
        with pytest.raises(procpool.WorkerDied):
            pool.submit_once(tasks.die, 3).result(timeout=DEADLINE_S)
        # The slot came back: every worker answers again.
        reports = [pool.submit(tasks.worker_report).result(DEADLINE_S)
                   for _ in range(2 * WORKERS)]
        assert {r["pid"] for r in reports} <= set(pool.worker_pids())
        deadline = time.monotonic() + DEADLINE_S
        while pool.respawns < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.respawns == 1
        assert pool.submit(sum, [1, 2]).result(DEADLINE_S) == 3
    finally:
        pool.shutdown()
    assert not os.path.exists(segment_dir)
    with pytest.raises(RuntimeError, match="shut down"):
        pool.submit(sum, [1])


def test_segments_round_trip_and_read_as_jax(tmp_path):
    table = pa.table({"a": np.arange(1000, dtype=np.int32),
                      "b": np.linspace(0, 1, 1000)})
    path = str(tmp_path / "t.arrow")
    nbytes = procpool.write_table_segment(table, path)
    assert nbytes == os.path.getsize(path)
    assert procpool.open_table_segment(path).equals(table)
    assert jpool.open_table_segment(path).equals(table)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    buf = sink.getvalue()
    bpath = str(tmp_path / "b.seg")
    assert procpool.write_buffer_segment(buf, bpath) == buf.size
    assert procpool.read_segment_buffer(bpath).equals(buf)
    assert jpool.read_segment_buffer(bpath).equals(buf)

    offsets = np.array([0, 3, 3, 7], dtype=np.int64)
    flat = np.array([6, 1, 2, 0, 5, 4, 3], dtype=np.int64)
    ipath = str(tmp_path / "i.idx")
    procpool.write_index_segment(ipath, offsets, flat)
    for reader in (procpool.read_index_segment, jpool.read_index_segment):
        o, f = reader(ipath)
        np.testing.assert_array_equal(o, offsets)
        np.testing.assert_array_equal(f, flat)
    jpath = str(tmp_path / "j.idx")
    jpool.write_index_segment(jpath, offsets, flat)
    with open(ipath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()

    ledger = tnative.buffer_ledger()
    in_use = ledger.bytes_in_use()
    lease = procpool.pin_segment(4096)
    assert ledger.bytes_in_use() == in_use + 4096
    procpool.release_segment(lease, bpath, unlink=True)
    procpool.release_segment(lease)  # idempotent
    assert ledger.bytes_in_use() == in_use and not os.path.exists(bpath)


def test_a_corrupt_file_is_quarantined_as_in_jax(files, tmp_path):
    bad = str(tmp_path / "corrupt.parquet")
    with open(bad, "wb") as f:
        f.write(b"PAR1 this is not a parquet file")
    with_bad = [files[0], bad, files[2], files[3]]
    jbefore = len(jstats.fault_stats().snapshot()["recent_quarantines"])
    want = _collect(jsh.shuffle, with_bad, executor_backend="thread",
                    on_bad_file="skip", file_cache=None)
    before = tstats.fault_stats().snapshot()["quarantines"]
    got = _collect(tsh.shuffle, with_bad, executor_backend="process",
                   on_bad_file="skip")
    assert_same(got, want, "quarantine")
    snap = tstats.fault_stats().snapshot()
    assert snap["quarantines"] - before == NUM_EPOCHS
    fields = ("filename", "epoch", "file_index")

    def by_epoch(reports):
        # The error's text names the reader that met the file (the whole
        # file's or the streaming one, which the cache grant decides), so
        # its type is compared.
        return sorted(({**{k: r[k] for k in fields},
                        "error": r["error"].split(":")[0]} for r in reports),
                      key=lambda r: (r["epoch"], r["file_index"]))

    jreports = jstats.fault_stats().snapshot()["recent_quarantines"][
        jbefore:]
    assert (by_epoch(snap["recent_quarantines"][-NUM_EPOCHS:])
            == by_epoch(jreports[-NUM_EPOCHS:]))
    with pytest.raises(pa.ArrowInvalid):
        _collect(tsh.shuffle, with_bad, executor_backend="process")


def test_the_segment_cache_serves_the_next_epoch(files):
    pool = procpool.ProcessPoolExecutor(num_workers=WORKERS)
    segment_dir = pool.segment_dir
    try:
        # Both epochs in flight: epoch 1's maps wait for epoch 0's loads.
        got = _collect(tsh.shuffle, files, pool=pool)
        # Epoch 0 decoded each file into its segment; epoch 1 mapped them.
        assert pool.cache_hits == len(files)
        segs = sorted(f for f in os.listdir(segment_dir)
                      if f.startswith("table_"))
        assert segs == sorted(procpool.table_segment_name(f) for f in files)
        assert pool.bytes_cached == sum(
            os.path.getsize(os.path.join(segment_dir, f)) for f in segs)
    finally:
        pool.shutdown()
    assert not os.path.exists(segment_dir)
    assert_same(got, _collect(tsh.shuffle, files, executor_backend="thread"),
                "cached")


def _spec_stream(run, specs, **kw):
    refs = {}

    def consumer(rank, epoch, batch_refs):
        if batch_refs is not None:
            refs.setdefault((rank, epoch), []).extend(batch_refs)

    run(specs, consumer, NUM_REDUCERS, NUM_TRAINERS, seed=SEED,
        max_concurrent_epochs=1, **kw)
    return {k: [r.result(timeout=DEADLINE_S) for r in v]
            for k, v in refs.items()}


def test_segments_are_keyed_by_file_not_index(files):
    # File 0 of epoch 0 and file 0 of epoch 1 are different files (a
    # streaming window's list): each epoch must read its own rows.
    specs = [(0, (files[0], files[1])), (1, (files[2], files[1]))]
    tspecs = [tir.EpochSpec(e, f) for e, f in specs]
    pool = procpool.ProcessPoolExecutor(num_workers=WORKERS)
    try:
        got = _spec_stream(tsh.shuffle_epochs, tspecs, pool=pool)
        assert pool.cache_hits == 1  # files[1] in epoch 1
    finally:
        pool.shutdown()
    with jex.Executor(num_workers=WORKERS) as jthreads:
        want = _spec_stream(jsh.shuffle_epochs,
                            [jir.EpochSpec(e, f) for e, f in specs],
                            pool=jthreads)
    assert_same(got, want, "epochs with other files at the same index")
    assert_same(got, _spec_stream(tsh.shuffle_epochs, tspecs,
                                  executor_backend="thread"), "port thread")
    keys = {epoch: np.sort(np.concatenate(
        [t.column("key").to_numpy() for (_, e), ts in got.items()
         if e == epoch for t in ts])) for epoch in (0, 1)}
    assert not np.isin(keys[1], keys[0]).all()


@pytest.fixture
def auto_env(monkeypatch):
    monkeypatch.delenv("RSDL_EXECUTOR_BACKEND", raising=False)
    monkeypatch.delenv("RSDL_EXECUTOR_SHM_DIR", raising=False)
    for name in ("RSDL_CHAOS_SPEC", "RSDL_FAULTS_SPEC"):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    tfaults.clear()
    jfaults.clear()


@pytest.mark.parametrize("condition", [
    "all_hold", "one_core", "one_worker", "no_shm", "closure_transform",
    "installed_chaos", "env_chaos"])
def test_auto_decides_as_the_jax_rule(auto_env, tmp_path, condition):
    workers, transforms = WORKERS, ()
    if condition == "one_core":
        auto_env.setattr(os, "cpu_count", lambda: 1)
    elif condition == "one_worker":
        workers = 1
    elif condition == "no_shm":
        auto_env.setenv("RSDL_EXECUTOR_SHM_DIR", str(tmp_path / "missing"))
    elif condition == "closure_transform":
        transforms = (lambda table: table,)
    elif condition in ("installed_chaos", "env_chaos"):
        if condition == "env_chaos":
            # Set in the environment: the workers would reproduce it.
            auto_env.setenv("RSDL_CHAOS_SPEC", "map_read:file99")
        tfaults.install("map_read:file99")
        jfaults.install("map_read:file99")
    got = tex.resolve_backend("auto", num_workers=workers,
                              transforms=transforms)
    assert got == jpool.resolve_backend("auto", num_workers=workers,
                                        transforms=transforms)
    assert got == ("process" if condition in ("all_hold", "env_chaos")
                   else "thread")


@pytest.mark.parametrize("why", ["no_shm", "closure_transform"])
def test_an_explicit_process_that_cannot_run_raises(auto_env, tmp_path, why):
    transforms = ()
    if why == "no_shm":
        auto_env.setenv("RSDL_EXECUTOR_SHM_DIR", str(tmp_path / "missing"))
    else:
        transforms = (lambda table: table,)
    with pytest.raises(ValueError, match="executor_backend='process'"):
        tex.resolve_backend("process", num_workers=WORKERS,
                            transforms=transforms)
    # The JAX package runs such a shuffle on threads instead.
    assert jpool.resolve_backend("process", num_workers=WORKERS,
                                 transforms=transforms) == "thread"


class _ScriptTransform:
    """Stands for a map transform defined at the top of a user's script:
    it pickles by reference to ``__main__``."""

    def __call__(self, table):
        return table


@pytest.fixture
def script_transform(monkeypatch):
    cls = type("ScriptTransform", (_ScriptTransform,),
               {"__module__": "__main__"})
    monkeypatch.setattr(sys.modules["__main__"], "ScriptTransform", cls,
                        raising=False)
    return cls()


@pytest.mark.parametrize("condition", ["main_transform", "installed_source"])
def test_state_a_worker_cannot_see_keeps_auto_on_threads(
        auto_env, script_transform, condition):
    # Neither crosses to a worker: a worker's __main__ is its own module,
    # and an installed source lives in the driver only. The JAX rule
    # looks at neither (its spawned workers re-import __main__; its
    # workers read through their own source too).
    from ray_shuffling_data_loader_tpu_torch import storage as tst
    transforms = ()
    if condition == "main_transform":
        pickle.dumps(script_transform)  # it pickles; it does not ship
        assert not procpool.shippable(script_transform)
        transforms = (script_transform,)
    previous = tst.set_source(
        tst.LocalSource() if condition == "installed_source" else None)
    try:
        assert tex.resolve_backend("auto", num_workers=WORKERS,
                                   transforms=transforms) == "thread"
        with pytest.raises(ValueError, match="executor_backend='process'"):
            tex.resolve_backend("process", num_workers=WORKERS,
                                transforms=transforms)
    finally:
        tst.set_source(previous)
    # Putting a source the policy resolved back is no installation; a
    # module's callable ships.
    tst.set_source(tst.get_source())
    assert not tst.source_installed()
    assert procpool.shippable(procpool.HoldOnFirstCall("marker"))


_TORCH_DRIVER = """
import json, pickle, sys
import torch  # the driver's main module imports torch
sys.path[:0] = [{repo!r}, {tests!r}]
import torch_port_pool_tasks as tasks
from ray_shuffling_data_loader_tpu_torch import (device_dataset, procpool,
                                                 shuffle)
files = {files!r}
cast = device_dataset.make_cast_transform(["embeddings_name0"], ["int32"],
                                          "labels", "float32")
pool = procpool.ProcessPoolExecutor(num_workers={workers})
try:
    refs = []
    shuffle.shuffle(files, lambda r, e, b: refs.extend(b or []), 1, 2, 1,
                    pool=pool, map_transform=cast)
    rows = sum(r.result(60).num_rows for r in refs)
    # Each worker holds its report a moment, so each takes its own.
    blob = pickle.dumps((tasks.worker_report, (0.3,), {{}}))
    held = [pool.submit_kind("call", {{"blob": blob}}, affinity=i)
            for i in range({workers})]
    reports = [r.result(60) for r in held]
    pids = pool.worker_pids()
finally:
    pool.shutdown()
print(json.dumps({{"rows": rows, "reports": reports, "pids": pids,
                  "driver_torch": "torch" in sys.modules}}))
"""


def test_a_worker_of_a_torch_driver_loads_no_torch(files, tmp_path):
    script = tmp_path / "driver.py"
    script.write_text(_TORCH_DRIVER.format(
        repo=REPO, tests=os.path.join(REPO, "tests"), files=files,
        workers=WORKERS))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["driver_torch"] and out["rows"] == NUM_ROWS
    assert {r["pid"] for r in out["reports"]} <= set(out["pids"])
    for report in out["reports"]:
        assert not report["torch"] and not report["jax"], report
        assert report["cuda_visible_devices"] == ""


def test_workers_fork_from_one_template_with_the_drivers_env(monkeypatch):
    def reports(pool, env_name):
        blob = pickle.dumps((tasks.worker_report, (0.3, env_name), {}))
        refs = [pool.submit_kind("call", {"blob": blob}, affinity=i)
                for i in range(WORKERS)]
        return [r.result(DEADLINE_S) for r in refs]

    before = procpool.pool_totals()
    first = procpool.ProcessPoolExecutor(num_workers=WORKERS)
    try:
        template = procpool._worker_template()
        # Set after the template started: each pool's workers take the
        # driver's environment as it is at their start.
        monkeypatch.setenv("RSDL_TEMPLATE_PROBE", "one")
        second = procpool.ProcessPoolExecutor(num_workers=WORKERS)
        try:
            got = reports(second, "RSDL_TEMPLATE_PROBE")
        finally:
            second.shutdown()
    finally:
        first.shutdown()
    assert {r["ppid"] for r in got} == {template._popen.pid}
    assert [r["env"] for r in got] == ["one"] * WORKERS
    totals = {k: v - before[k] for k, v in procpool.pool_totals().items()}
    assert totals["templates"] <= 1 and totals["worker_starts"] == 2 * WORKERS
    assert first.ready_s is not None and totals["ready_s"] > 0
    # A template that ended is started again by the next pool.
    os.kill(template._popen.pid, signal.SIGKILL)
    template._popen.wait(DEADLINE_S)
    third = procpool.ProcessPoolExecutor(num_workers=WORKERS)
    try:
        got = reports(third, "")
    finally:
        third.shutdown()
    assert procpool._worker_template() is not template
    assert {r["ppid"] for r in got} == {procpool._worker_template()._popen.pid}


def test_hold_on_first_call_holds_one_call_only(tmp_path):
    marker = str(tmp_path / "m")
    hold = pickle.loads(pickle.dumps(procpool.HoldOnFirstCall(marker, 30)))
    table = pa.table({"x": [1, 2]})
    done = []
    first = threading.Thread(target=lambda: done.append(hold(table)))
    first.start()
    assert _wait_for(marker) == os.getpid()
    assert hold(table) is table  # later calls pass through
    assert first.is_alive()
    open(marker + ".go", "w").close()
    first.join(DEADLINE_S)
    assert done == [table]
