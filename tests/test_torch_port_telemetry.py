"""The port's telemetry spine (``runtime/{metrics,telemetry,latency}.py``
and its record sites) against the JAX package's, on the same inputs.

- Exposition: the same operations on a fresh registry of each package
  render byte-identical Prometheus text, which parses back the same in
  both; two shards written by the port merge as the JAX ``merge_series``
  merges them.
- Attribution: one synthetic event sequence gives equal per-epoch
  verdicts and run summaries; the recorder's ring keeps the same events.
- Latency: a stamp encoded by either package parses in the other; the
  clock anchors and the sketch quantiles agree.
- End to end: 4 Parquet files, seed 0, 4 reducers, batch 256, 2 epochs
  through the JAX ``dataset.ShufflingDataset`` and the port's record the
  same ``(kind, epoch, task)`` multisets of ``map_read``,
  ``reduce_gather``, ``queue_put``, ``queue_get``, ``queue_wait`` and
  ``batch_wait``; the port's batch stream is bit-identical with recording
  on and off; the port's ``DeviceShufflingDataset`` on the CPU records
  the ``train_step``, ``batch_wait``, ``convert`` and ``device_transfer``
  events the JAX ``JaxShufflingDataset`` records.
- ``stats``: the watchdog and fault snapshots keep their keys and read
  the registry; the CSV writers write the JAX package's columns.
"""

import collections
import csv
import itertools
import os
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import dataset as jds
from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu import stats as jstats
from ray_shuffling_data_loader_tpu.runtime import latency as jlat
from ray_shuffling_data_loader_tpu.runtime import metric_names as jnames
from ray_shuffling_data_loader_tpu.runtime import metrics as jmetrics
from ray_shuffling_data_loader_tpu.runtime import telemetry as jtel
from ray_shuffling_data_loader_tpu_torch import data_generation as tdg
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.runtime import latency as tlat
from ray_shuffling_data_loader_tpu_torch.runtime import metric_names as tnames
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import telemetry as ttel
from ray_shuffling_data_loader_tpu_torch.runtime import watchdog

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

_queue_ids = itertools.count()

NUM_EPOCHS = 2
NUM_REDUCERS = 4
BATCH = 256
SEED = 0
STAGE_KINDS = ("map_read", "reduce_gather", "queue_put", "queue_get",
               "queue_wait", "batch_wait")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """4 Parquet files of 500 rows (keys 0..1999)."""
    return tdg.generate_data(2000, 4, str(tmp_path_factory.mktemp("tel")),
                             seed=SEED)[0]


@pytest.fixture(autouse=True)
def fresh_recorders():
    """A fresh, large ring and attributor in both packages, recording on;
    the policy's state again afterwards."""
    jtel.configure(enabled_flag=True, capacity=1 << 16)
    ttel.configure(enabled_flag=True, capacity=1 << 16)
    yield
    jtel.configure()
    ttel.configure()


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------


def _drive_registry(metrics_mod):
    """The same operations on a fresh registry of either package."""
    reg = metrics_mod.Registry()
    reg.counter("rsdl_events_total", "events by kind", kind="map_read").inc()
    reg.counter("rsdl_events_total", "events by kind",
                kind="reduce_gather").inc(3)
    reg.counter("rsdl_watchdog_stalls_total", "by watch",
                name='a "quoted"\\name\nnl').inc(2)
    reg.counter("rsdl_fault_retries_total", "retries").inc(0.5)
    g = reg.gauge("rsdl_executor_workers", "width", pool="p")
    g.set(8)
    g.dec(3)
    g.inc(1.25)
    reg.gauge("rsdl_fault_recovery_max_seconds", "max").max(0.125)
    reg.gauge("rsdl_fault_recovery_max_seconds", "max").max(0.0625)
    h = reg.histogram("rsdl_stage_seconds", "latency", stage="reduce")
    for v in (0.00005, 0.003, 0.003, 0.2, 7.0, 100.0):
        h.observe(v)
    reg.histogram("rsdl_fault_recovery_seconds", "custom",
                  buckets=(0.5, 1.0)).observe(0.75)
    s = reg.sketch("rsdl_delivery_latency_seconds", "hops",
                   hop="birth_to_device", queue="0")
    for v in (0.0001, 0.002, 0.002, 0.03, 1.5, 40.0):
        s.observe(v)
    return reg


def test_exposition_is_byte_identical_and_round_trips():
    jtext = _drive_registry(jmetrics).render()
    ttext = _drive_registry(tmetrics).render()
    assert ttext == jtext
    assert tmetrics.parse_exposition_typed(ttext) == \
        jmetrics.parse_exposition_typed(jtext)
    samples, types = tmetrics.parse_exposition_typed(ttext)
    assert types["rsdl_delivery_latency_seconds"] == "sketch"
    # The merged view re-renders to text that parses to the same samples.
    again = tmetrics.render_merged(samples, types)
    assert tmetrics.parse_exposition(again) == samples
    assert again == jmetrics.render_merged(samples, types)
    # The sketch's quantiles from parsed text equal the JAX reading.
    assert tmetrics.sketch_quantiles(
        samples, "rsdl_delivery_latency_seconds", hop="birth_to_device") == \
        jmetrics.sketch_quantiles(
            samples, "rsdl_delivery_latency_seconds", hop="birth_to_device")


def test_metric_catalog_is_the_jax_packages():
    assert tnames.METRIC_NAMES == jnames.METRIC_NAMES


def test_two_port_shards_merge_as_jax_merges_them(tmp_path, monkeypatch):
    a = _drive_registry(tmetrics)
    b = _drive_registry(tmetrics)
    b.counter("rsdl_worker_tasks_total", "tasks", worker="1").inc(5)
    for pid, reg in ((101, a), (202, b)):
        with open(tmetrics.shard_path(str(tmp_path), pid), "w") as f:
            f.write(reg.render())
    tshards = tmetrics.read_shards(str(tmp_path))
    jshards = jmetrics.read_shards(str(tmp_path))
    assert sorted(tshards) == sorted(jshards) == [101, 202]
    tmerged = tmetrics.merge_series(
        [tshards[p][:2] for p in sorted(tshards)])
    jmerged = jmetrics.merge_series(
        [jshards[p][:2] for p in sorted(jshards)])
    assert tmerged == jmerged
    assert tmerged[0]["rsdl_events_total"][(("kind", "reduce_gather"),)] \
        == 6.0
    # write_shard writes this process's registry under its own pid.
    monkeypatch.setenv("RSDL_TELEMETRY_DIR", str(tmp_path))
    path = tmetrics.write_shard()
    assert path == tmetrics.shard_path(str(tmp_path), os.getpid())
    samples, _types, pids = tmetrics.federated_series()
    assert sorted(pids) == sorted([os.getpid(), 101, 202])
    assert samples["rsdl_federated_processes"][()] == 3.0


def test_concurrent_shard_writes_in_one_process(tmp_path, monkeypatch):
    # Two threads both inside write_shard before either renames: each
    # must rename its own temporary file, and the shard stays whole.
    monkeypatch.setenv("RSDL_TELEMETRY_DIR", str(tmp_path))
    both_writing = threading.Barrier(2, timeout=10)
    render = tmetrics.render

    def slow_render():
        both_writing.wait()
        return render()

    monkeypatch.setattr(tmetrics, "render", slow_render)
    errors, paths = [], []

    def write():
        try:
            paths.append(tmetrics.write_shard())
        except OSError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=write) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert paths == [tmetrics.shard_path(str(tmp_path), os.getpid())] * 2
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    assert os.getpid() in tmetrics.read_shards(str(tmp_path))


def test_file_exporter_writes_the_registry(tmp_path):
    tmetrics.gauge("rsdl_executor_workers", "width",
                   pool="exporter-test").set(3)
    path = tmetrics.write_file(str(tmp_path / "expo.prom"))
    with open(path) as f:
        samples = tmetrics.parse_exposition(f.read())
    assert samples["rsdl_executor_workers"][(("pool", "exporter-test"),)] \
        == 3.0


# ---------------------------------------------------------------------------
# Recorder and attribution
# ---------------------------------------------------------------------------


def _synthetic_events():
    """Epoch 0 stalls on reduce, epoch 1 keeps up, plus epoch-less
    events: (method, args) for StageAttribution."""
    rng = np.random.default_rng(3)
    out = []
    t = 100.0
    for epoch, wait in ((0, 0.08), (1, 0.001)):
        for task in range(6):
            t += 0.01
            out.append(("observe", ("map_read", epoch,
                                    float(rng.uniform(0.001, 0.02)), t)))
        for task in range(4):
            t += 0.02
            out.append(("observe", ("reduce", epoch,
                                    float(rng.uniform(0.05, 0.3)), t)))
        for batch in range(8):
            t += 0.03
            out.append(("observe", ("train_step", epoch, 0.02, t)))
            out.append(("observe_wait", (epoch, wait, t)))
            out.append(("observe", ("device_transfer", epoch, 0.004, t)))
    out.append(("observe", ("queue_wait", None, 0.01, t + 1.0)))
    return out


def test_attribution_verdicts_equal():
    jattr, tattr = jtel.StageAttribution(10.0), ttel.StageAttribution(10.0)
    for method, args in _synthetic_events():
        getattr(jattr, method)(*args)
        getattr(tattr, method)(*args)
    for epoch in (0, 1, 7):
        assert tattr.epoch_verdict(epoch) == jattr.epoch_verdict(epoch)
    assert tattr.run_summary() == jattr.run_summary()
    assert tattr.epoch_verdict(0)["bottleneck_stage"] == "reduce"
    assert tattr.epoch_verdict(1)["bottleneck_stage"] == "train_step"


def test_recorder_ring_equal_and_records_feed_the_registry():
    jrec, trec = jtel.FlightRecorder(5), ttel.FlightRecorder(5)
    for i in range(12):
        event = (float(i), "map_read", i % 2, i, None, 0.5 * i, 7,
                 {"x": i} if i % 3 else None)
        jrec.record(event)
        trec.record(event)
    assert trec.events() == jrec.events()
    assert trec.total_recorded == jrec.total_recorded == 12
    before = tmetrics.counter("rsdl_events_total", "",
                              kind="reduce_gather").value
    with ttel.span("reduce_gather", epoch=3, task=1):
        pass
    assert tmetrics.counter("rsdl_events_total", "",
                            kind="reduce_gather").value == before + 1
    last = ttel.recorder().events()[-1]
    assert (last["kind"], last["epoch"], last["task"]) == \
        ("reduce_gather", 3, 1)
    assert ttel.attribution().epoch_verdict(3)["stages"]["reduce"][
        "count"] == 1
    # A speculative attempt is ring-only.
    with ttel.speculative(1):
        ttel.record("map_read", epoch=3, task=0, dur_s=0.1)
    assert ttel.recorder().events()[-1]["spec"] == 1
    assert "map_read" not in ttel.attribution().epoch_verdict(3)["stages"]


def test_hard_off_is_a_noop_and_overheads_measure():
    ttel.configure(enabled_flag=False)
    before = ttel.recorder().total_recorded
    ttel.record("map_read", epoch=0, task=0, dur_s=1.0)
    with ttel.span("reduce_gather", epoch=0, task=0):
        pass
    token = ttel.span_begin("queue_wait")
    try:
        assert token is None
    finally:
        ttel.span_end(token)
    assert ttel.stamp() == 0.0
    assert ttel.recorder().total_recorded == before
    assert ttel.measure_record_overhead(200) > 0
    assert ttel.measure_disabled_overhead(200) > 0


def test_dump_loads_in_both_packages(tmp_path):
    from ray_shuffling_data_loader_tpu.runtime import trace as jtrace
    from ray_shuffling_data_loader_tpu_torch.runtime import trace as ttrace
    ttel.set_trace_seed(11)
    ttel.record("map_read", epoch=0, task=2, dur_s=0.25)
    path = ttel.dump(str(tmp_path / "d.jsonl"), reason="test")
    tdump, jdump = ttrace.load_dump(path), jtrace.load_dump(path)
    assert tdump == jdump
    assert tdump["meta"]["pid"] == os.getpid()
    assert any(e["kind"] == "map_read" and e["task"] == 2
               for e in tdump["events"])


def test_watchdog_escalation_records_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("RSDL_TELEMETRY_DUMP_DIR", str(tmp_path))
    import threading
    wd = watchdog.Watchdog(poll_interval_s=0.001)
    escalated = threading.Event()

    def on_stall(report):
        if report.escalation >= 2:
            escalated.set()

    before = tstats.watchdog_stats().snapshot()
    with wd.watch("test.stuck", deadline_s=0.005, on_stall=on_stall):
        assert escalated.wait(10.0)
    after = tstats.watchdog_stats().snapshot()
    assert after["watchdog_events"] >= before["watchdog_events"] + 2
    assert after["stall_escalations"] >= before["stall_escalations"] + 1
    assert after["stalls_by_name"]["test.stuck"] >= 2
    assert any(e["kind"] == "watchdog_stall"
               for e in ttel.recorder().events())
    assert any(n.startswith("rsdl-telemetry-") for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# Latency
# ---------------------------------------------------------------------------


def test_stamps_cross_parse_and_anchors_agree():
    stamp = tlat.now_stamp()
    assert jlat.parse_stamp(tlat.encode_stamp(stamp)) == tuple(stamp)
    jstamp = jlat.now_stamp()
    assert tlat.parse_stamp(jlat.encode_stamp(jstamp)) == tuple(jstamp)
    assert tlat.parse_stamp(b"garbage") is None
    assert tlat.BIRTH_META_KEY == jlat.BIRTH_META_KEY
    janch, tanch = jlat.ClockAnchors(), tlat.ClockAnchors()
    cases = [
        (tlat.Stamp(5, 10.0, 1000.0), 10.5, 1000.4),   # same host
        (tlat.Stamp(6, 1e9, 2000.0), 10.0, 1999.0),    # cross host, ahead
        (tlat.Stamp(6, 1e9, 2000.5), 10.0, 2003.0),
        (tlat.Stamp(7, -5e5, 100.0), 10.0, 103.0),
    ]
    for st, mono, unix in cases:
        jst = jlat.Stamp(*st)
        assert tanch.latency_s(st, mono, unix) == \
            janch.latency_s(jst, mono, unix)
    js, ts = jmetrics.Sketch(), tmetrics.Sketch()
    for v in np.random.default_rng(0).lognormal(-4, 1.5, 500):
        js.observe(float(v))
        ts.observe(float(v))
    for q in (0.5, 0.95, 0.99):
        assert ts.percentile(q) == js.percentile(q)
    assert ts.centroid_counts() == js.centroid_counts()


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def _stage_multiset(events):
    return collections.Counter(
        (e["kind"], e.get("epoch"), e.get("task")) for e in events
        if e["kind"] in STAGE_KINDS and not e.get("spec"))


def _port_tables(files):
    ds = tds.ShufflingDataset(files, NUM_EPOCHS, 1, BATCH, rank=0,
                              num_reducers=NUM_REDUCERS, seed=SEED,
                              num_workers=2)
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        out.append(list(ds))
    return out


def test_dataset_events_match_jax_and_stream_ignores_recording(files):
    jds_ = jds.ShufflingDataset(
        files, NUM_EPOCHS, 1, BATCH, rank=0, num_reducers=NUM_REDUCERS,
        seed=SEED, num_workers=2,
        queue_name=f"torch-port-telemetry-{next(_queue_ids)}")
    jtables = []
    for epoch in range(NUM_EPOCHS):
        jds_.set_epoch(epoch)
        jtables.append(list(jds_))
    jmulti = _stage_multiset(jtel.recorder().events())

    on = _port_tables(files)
    tevents = ttel.recorder().events()
    tmulti = _stage_multiset(tevents)
    assert tmulti == jmulti
    for kind, count in (("map_read", 4 * NUM_EPOCHS),
                        ("reduce_gather", NUM_REDUCERS * NUM_EPOCHS)):
        assert sum(n for (k, _, _), n in tmulti.items() if k == kind) == \
            count
    # Each reducer output carries its lineage and birth.
    verdict = ttel.attribution().epoch_verdict(0)
    assert {"map_read", "reduce", "queue_wait"} <= set(verdict["stages"])
    samples = tmetrics.parse_exposition(tmetrics.render())
    hops = tmetrics.sketch_quantiles(samples, tlat.DELIVERY_METRIC,
                                     hop=tlat.HOP_BIRTH_TO_DELIVERED)
    assert hops and all(v["count"] > 0 for v in hops.values())

    ttel.configure(enabled_flag=False)
    off = _port_tables(files)
    assert len(on) == len(off) == len(jtables)
    for e_on, e_off, e_j in zip(on, off, jtables):
        assert len(e_on) == len(e_off) == len(e_j)
        for a, b, c in zip(e_on, e_off, e_j):
            assert a.equals(b) and a.equals(c)


def _device_kinds(events):
    counts = collections.Counter()
    for e in events:
        if e["kind"] in ("train_step", "batch_wait", "convert",
                         "device_transfer"):
            counts[(e["kind"], e.get("epoch"), bool(e.get("attempt")))] += 1
    return counts


def test_device_dataset_events_match_jax(files):
    spec = {"feature_columns": ["key", "embeddings_name0"],
            "feature_types": [np.int64, np.int32], "label_column": "labels",
            "batch_size": BATCH, "num_reducers": NUM_REDUCERS, "seed": SEED}
    jds_ = jjd.JaxShufflingDataset(
        files, NUM_EPOCHS, 1, rank=0, num_workers=2,
        queue_name=f"torch-port-telemetry-{next(_queue_ids)}", **spec)
    tds_ = DeviceShufflingDataset(files, NUM_EPOCHS, 1, rank=0,
                                  device="cpu", num_workers=2, **spec)
    try:
        for ds in (jds_,):
            for epoch in range(NUM_EPOCHS):
                ds.set_epoch(epoch)
                for _ in ds:
                    pass
        jcounts = _device_kinds(jtel.recorder().events())
        batches = []
        for epoch in range(NUM_EPOCHS):
            tds_.set_epoch(epoch)
            n = 0
            for _ in tds_:
                time.sleep(0.005)  # the consumer's "step"
                n += 1
            batches.append(n)
        tevents = ttel.recorder().events()
        tcounts = _device_kinds(tevents)
    finally:
        jds_.close()
        tds_.close()
    assert tcounts == jcounts
    # One train_step per batch handed out (the gap before the next get,
    # the last one before the epoch's end), one batch_wait per get.
    assert tcounts[("train_step", 0, False)] == batches[0]
    assert tcounts[("batch_wait", 0, False)] == batches[0] + 1
    # train_step spans the consumer's work after the batch was handed out.
    assert min(e["dur_s"] for e in tevents
               if e["kind"] == "train_step") >= 0.004
    assert tcounts[("device_transfer", 0, False)] == batches[0]
    assert tds_.binding == "per_batch"
    for epoch in range(NUM_EPOCHS):
        assert ttel.attribution().epoch_verdict(epoch) is not None
    samples = tmetrics.parse_exposition(tmetrics.render())
    assert tmetrics.sketch_quantiles(samples, tlat.DELIVERY_METRIC,
                                     hop=tlat.HOP_BIRTH_TO_DEVICE)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


def test_stats_snapshots_keep_their_keys_and_read_the_registry():
    assert set(tstats.watchdog_stats().snapshot()) == {
        "watchdog_events", "stall_escalations", "fallbacks_engaged",
        "stalls_by_name", "recent_stalls"}
    assert set(tstats.fault_stats().snapshot()) == {
        "recomputes_by_component", "quarantines", "recent_quarantines",
        "recoveries_exhausted", "injected", "injected_by_site", "retries",
        "recomputes", "recovery_latency_total_s", "recovery_latency_max_s"}
    before = tstats.fault_stats().snapshot()
    tstats.fault_stats().record_injected("map_read", 0, 1)
    tstats.fault_stats().record_recompute("lineage", 0.25)
    after = tstats.fault_stats().snapshot()
    assert after["injected"] == before["injected"] + 1
    assert after["injected_by_site"]["map_read"] == \
        before["injected_by_site"].get("map_read", 0) + 1
    assert after["recomputes_by_component"]["lineage"] == \
        before["recomputes_by_component"].get("lineage", 0) + 1
    assert tstats._counter_total("rsdl_fault_recomputes_total") == \
        after["recomputes"]
    assert tstats.get_memory_stats(sample_hbm=True).hbm_bytes == 0
    assert set(tstats.process_recovery_totals()) == \
        set(jstats.process_recovery_totals())


def _trial(mod):
    def epoch(i):
        return mod.EpochStats(
            duration=1.0 + i,
            map_stats=mod.MapStats([0.1, 0.2], 0.5, [0.05, 0.07]),
            reduce_stats=mod.ReduceStats([0.3, 0.4], 0.6),
            consume_stats=mod.ConsumeStats([0.01], 0.02, [0.5]),
            throttle_stats=mod.ThrottleStats(0.0))
    sample = mod.MemorySample(timestamp=0.0, rss_bytes=10, pool_bytes=5)
    return [(mod.TrialStats([epoch(0), epoch(1)], 3.0), [(0.0, sample)])]


def test_csv_writers_write_the_jax_columns(tmp_path):
    assert tstats.TRIAL_FIELDNAMES == jstats.TRIAL_FIELDNAMES
    assert tstats.EPOCH_FIELDNAMES == jstats.EPOCH_FIELDNAMES
    rows = {}
    for name, mod in (("jax", jstats), ("port", tstats)):
        d = tmp_path / name
        mod.process_stats(_trial(mod), True, str(d), False, False,
                          num_rows=1000, num_files=2,
                          num_row_groups_per_file=1, batch_size=100,
                          num_reducers=2, num_trainers=1, num_epochs=2,
                          max_concurrent_epochs=2)
        rows[name] = {}
        for path in sorted(os.listdir(d)):
            with open(d / path, newline="") as f:
                rows[name][path] = list(csv.DictReader(f))
    assert sorted(rows["port"]) == sorted(rows["jax"])
    # The process-wide totals and verdicts differ between the packages'
    # registries; every column of the trial itself is equal.
    process_wide = set(tstats.TRIAL_FIELDNAMES[
        tstats.TRIAL_FIELDNAMES.index("watchdog_events"):])
    for path, jrows in rows["jax"].items():
        for prow, jrow in zip(rows["port"][path], jrows):
            assert prow.keys() == jrow.keys()
            for key in jrow:
                if key not in process_wide:
                    assert prow[key] == jrow[key], key


# ---------------------------------------------------------------------------
# Profiler ranges
# ---------------------------------------------------------------------------


def test_profile_trace_captures_every_threads_spans(tmp_path, monkeypatch):
    import threading

    import torch

    from ray_shuffling_data_loader_tpu_torch.utils import tracing

    def loader_thread():
        with tracing.trace_span("batch_convert", kind="convert", epoch=4):
            torch.ones(4).sum()

    with tracing.profile_trace(str(tmp_path)) as prof:
        t = threading.Thread(target=loader_thread)
        t.start()
        t.join(10.0)
        with tracing.step_span(7):
            torch.ones(2).sum()
    assert not t.is_alive()
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys.get("batch_convert") == 1 and keys.get("train#7") == 1
    assert os.listdir(tmp_path) == [f"rsdl-profile-{os.getpid()}.json"]
    # The span is also one flight-recorder event.
    assert any(e["kind"] == "convert" and e.get("epoch") == 4
               for e in ttel.recorder().events())
    monkeypatch.setenv("RSDL_PROFILE_DIR", str(tmp_path / "env"))
    with tracing.maybe_profile():
        with tracing.trace_span("spill_load"):
            pass
    assert os.listdir(tmp_path / "env")
