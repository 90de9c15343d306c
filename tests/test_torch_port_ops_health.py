"""The port's health plane (``runtime/health.py``) and its rebalance
trigger (``rebalance.slo_trigger``) against the JAX package's, on the
CPU.

- All twelve detectors on the synthetic series the JAX package's tests
  build (``tests/test_health.py``, ``test_latency.py``,
  ``test_rebalance.py``, ``test_streaming.py``; the two cache detectors,
  which JAX tests nowhere, on series of the same shape): tick by tick both
  packages give the same ``Breach`` or None and the same fires under the
  same hysteresis, one per episode despite noise.
- Verdicts go out as ``rsdl_health_state``/``rsdl_health_breaches_total``
  and ``health_breach``/``health_clear`` events; ``arm`` is None under
  ``RSDL_HEALTH=0``; SIGUSR2 installs on the main thread only.
- A port capsule has the JAX capsule's file set and validates through
  ``tools/rsdl_incident.py``; a capture inside the cooldown is None.
- The end-to-end twin on the thread backend: the chaos delay is installed
  only for epochs that start after the ring holds ``window + 3`` ticks of
  undelayed activity, so the droop baseline is long enough by
  construction on a loaded host; the detector fires exactly once and its
  capsule validates.
- The trigger: a ``tenant_delivery_slo`` fire drives one journaled live
  move between in-process shards with the stream unchanged, and on
  supervised shard processes whose source dies at PREPARE it journals
  the abort and the stream equals the fault-free lineage.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu.runtime import health as jhealth
from ray_shuffling_data_loader_tpu.runtime import history as jhist
from ray_shuffling_data_loader_tpu.runtime import telemetry as jtelemetry
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import rebalance as trb
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import tenancy as tten
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.runtime import health as thealth
from ray_shuffling_data_loader_tpu_torch.runtime import history as thist
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import supervisor as tsup
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as ttelemetry)

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jhealth, jhist), "port": (thealth, thist)}
#: Every wait on a thread or a child process ends within this.
JOIN_S = 120


@pytest.fixture(autouse=True)
def _fresh_capture_state(monkeypatch):
    """Capsule capture keeps a process-wide cooldown in each package, and
    would signal the pids of whatever pool an earlier test in this
    process left behind: these captures ask no other process."""
    for health in (jhealth, thealth):
        monkeypatch.setattr(health, "CAPSULE_COOLDOWN_S", 0.0)
        monkeypatch.setattr(health, "_last_capture_mono", None)
        monkeypatch.setattr(health, "_signal_candidate_pids", lambda: [])
    yield
    thealth.disarm()
    tfaults.clear()


def _labels(**kv):
    return tuple(sorted((k, str(v)) for k, v in kv.items()))


def _snap(t, samples):
    return {"t": t, "t_unix": 1.7e9 + t,
            "samples": {name: (dict(series) if isinstance(series, dict)
                               else {(): float(series)})
                        for name, series in samples.items()}}


# -- the synthetic series, one builder per detector ---------------------------

def _droop():
    events, t, out = 0.0, 0.0, []
    steps = ([100] * 12 + [3 if i % 4 == 0 else 1 for i in range(14)]
             + [100] * 8 + [0] * 8)
    for n in steps:
        events, t = events + n, t + 0.1
        out.append(_snap(t, {"rsdl_events_total": events}))
    return out


def _stall():
    out, t, wait_s, batches = [], 0.0, 0.0, 0
    for i in range(20):
        t += 0.1
        if i >= 8:  # the consumer now waits 90% of each tick
            wait_s += 0.09
            batches += 1
        out.append(_snap(t, {"rsdl_batch_wait_seconds_sum": wait_s,
                             "rsdl_batch_wait_seconds_count": batches}))
    return out


def _creep():
    out, t, rss = [], 0.0, 100 << 20
    for _ in range(30):  # +1 MiB per 0.1 s tick = 600 MiB/min
        t, rss = t + 0.1, rss + (1 << 20)
        out.append(_snap(t, {"rsdl_ledger_bytes_in_use": float(rss)}))
    return out


def _saturation():
    out, t = [], 0.0
    # Oscillates around the bound inside one episode.
    for depth in [10, 10, 150, 180, 90, 200, 160, 90, 220, 150, 90, 250]:
        t += 0.1
        out.append(_snap(t, {"rsdl_queue_depth": {
            _labels(queue="3"): float(depth)}}))
    return out


def _churn_and_drift(with_churn):
    out, t, expiries = [], 0.0, 0.0
    for i in range(16):
        t += 0.1
        expiries += 1 if i >= 8 else 0   # 10/s = 600/min >> 30/min
        samples = {"rsdl_trace_straggler_seconds": {
            _labels(stage="map_read"): 2.0 if i >= 10 else 0.2}}
        if with_churn:
            samples["rsdl_queue_lease_expiries_total"] = expiries
        out.append(_snap(t, samples))
    return out


def _centroids(series, key, slow_steps, recover=0, again=0):
    """Healthy mass at 10 ms, then a breach whose slow mass (5 s) lands
    unevenly, then (optionally) fast-only recovery and a second
    breach."""
    def labels(c):
        return (("c", str(c)), ("hop", "birth_to_delivered"), key)

    out, fast, slow, t = [], 0.0, 0.0, 0.0

    def add(with_slow):
        samples = {labels(0.01): fast}
        if with_slow:
            samples[labels(5.0)] = slow
        out.append(_snap(t, {series: samples}))

    for _ in range(8):
        fast, t = fast + 5, t + 0.1
        add(False)
    for i in range(slow_steps):
        slow, t = slow + (4 if i % 3 == 0 else 1), t + 0.1
        add(True)
    for _ in range(recover):
        fast, t = fast + 5, t + 0.1
        add(True)
    for i in range(again):
        slow, t = slow + 5, t + 0.1
        add(True)
    return out


def _freshness():
    out, t, labels = [], 0.0, (("queue", "0"),)
    for i in range(6):  # fresh deliveries: the gauge keeps changing
        t += 1.0
        out.append(_snap(t, {"rsdl_delivery_freshness_seconds": {
            labels: 0.2 + 0.01 * i}}))
    for _ in range(8):  # deliveries stop: the gauge freezes
        t += 1.0
        out.append(_snap(t, {"rsdl_delivery_freshness_seconds": {
            labels: 0.25}}))
    return out


def _cache(prefix, label):
    """Healthy (hits, no evictions), thrash (evictions 50/s, hits at
    ~5%), recovery, thrash again."""
    out, t = [], 0.0
    ev = hits = misses = 0.0
    other = 0.0
    phases = [("ok", 8), ("thrash", 10), ("ok", 8), ("thrash", 8)]
    for phase, n in phases:
        for i in range(n):
            t += 0.1
            if phase == "ok":
                hits += 10
                misses += 1
            else:
                ev += 5
                hits += 1 if i % 4 == 0 else 0
                misses += 10
            other += 20  # a second tenant's healthy hits
            if label is None:
                samples = {f"{prefix}_evictions_total": ev,
                           f"{prefix}_hits_total": hits,
                           f"{prefix}_misses_total": misses}
            else:
                # A quiet tenant's hits, which would dilute an aggregate
                # view of the thrashing one.
                samples = {
                    f"{prefix}_evictions_total": {
                        _labels(tenant=label): ev,
                        _labels(tenant="quiet"): 0.0},
                    f"{prefix}_hits_total": {
                        _labels(tenant=label): hits,
                        _labels(tenant="quiet"): other},
                    f"{prefix}_misses_total": {
                        _labels(tenant=label): misses,
                        _labels(tenant="quiet"): 1.0}}
            out.append(_snap(t, samples))
    return out


def _lag():
    out, t = [], 0.0
    for lag in [2.0] * 6 + [50.0] * 8 + [0.0] * 6 + [50.0] * 6:
        t += 0.1
        out.append(_snap(t, {"rsdl_stream_watermark_lag_seconds": lag}))
    return out


#: detector -> (snapshots, threshold overrides, env, fires expected).
CASES = {
    "throughput_droop": (_droop, dict(slo_droop_window_ticks=3,
                                      slo_droop_floor_eps=1.0), {}, 2),
    "stall_breach": (_stall, dict(slo_stall_pct=50.0,
                                  slo_droop_window_ticks=3), {}, 1),
    "ledger_creep": (_creep, {}, {}, 1),
    "queue_saturation": (_saturation, {}, {"RSDL_SLO_QUEUE_DEPTH": "100"},
                         1),
    "lease_churn": (lambda: _churn_and_drift(True),
                    dict(slo_lease_churn_per_min=30.0,
                         slo_droop_window_ticks=3), {}, 1),
    "straggler_drift": (lambda: _churn_and_drift(False),
                        dict(slo_straggler_drift_x=3.0), {}, 1),
    "delivery_latency_breach": (
        lambda: _centroids("rsdl_delivery_latency_seconds_centroid",
                           ("queue", "0"), 10),
        dict(slo_delivery_p99_s=1.0, slo_droop_window_ticks=3), {}, 1),
    "freshness_stall": (_freshness, dict(slo_freshness_s=5.0), {}, 1),
    "cache_thrash": (lambda: _cache("rsdl_storage", None),
                     dict(slo_droop_window_ticks=3), {}, 2),
    "tenant_cache_thrash": (
        lambda: _cache("rsdl_tenant_storage", "team-a"),
        dict(slo_droop_window_ticks=3), {}, 2),
    "tenant_delivery_slo": (
        lambda: _centroids("rsdl_tenant_delivery_latency_seconds_centroid",
                           ("tenant", "team-a"), 10, recover=8, again=6),
        dict(rebalance_slo_p99_s=1.0, slo_droop_window_ticks=3), {}, 2),
    "watermark_lag": (_lag, {}, {"RSDL_SLO_WATERMARK_LAG_S": "10"}, 2),
}


def _copy(snap):
    return {"t": snap["t"], "t_unix": snap["t_unix"],
            "samples": {name: dict(series)
                        for name, series in snap["samples"].items()}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detector_breaches_and_fires_equal_jax(name, monkeypatch):
    build, overrides, env, want_fires = CASES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    rigs = {}
    for pkg, (health, hist) in PKGS.items():
        ring = hist.HistoryRing(capacity=400, interval_s=0.1)
        fired = []
        monitor = health.HealthMonitor(
            ring, detectors=health.default_detectors(names=[name],
                                                     **overrides),
            fire_ticks=2, clear_ticks=4, capture=False,
            on_fire=fired.append)
        rigs[pkg] = (ring, monitor, fired)
    for i, snap in enumerate(build()):
        seen = {}
        for pkg, (ring, monitor, fired) in rigs.items():
            ring.append_snapshot(_copy(snap))
            breach = monitor.detectors[0].evaluate(ring)
            monitor.tick()
            seen[pkg] = (None if breach is None else breach.as_dict(),
                         monitor.total_fires,
                         [(v["detector"], v["value"], v["threshold"],
                           v["detail"], v["fires"]) for v in fired])
        assert seen["port"] == seen["jax"], (i, seen)
    for pkg, (ring, monitor, fired) in rigs.items():
        assert monitor.total_fires == want_fires, (pkg, monitor.summary())
        assert {v["detector"] for v in fired} == {name}
    port_summary = rigs["port"][1].summary()
    jax_summary = rigs["jax"][1].summary()
    assert port_summary == jax_summary


def test_twelve_detectors_registered_as_jax():
    assert sorted(thealth._DETECTOR_TYPES) == sorted(jhealth._DETECTOR_TYPES)
    assert sorted(CASES) == sorted(thealth._DETECTOR_TYPES)
    assert len(thealth.default_detectors()) == 12
    with pytest.raises(ValueError):
        thealth.default_detectors(names=["nope"])


def test_verdicts_are_metrics_and_events():
    ttelemetry.configure(enabled_flag=True, capacity=1 << 12)
    ring = thist.HistoryRing(capacity=64, interval_s=0.1)
    monitor = thealth.HealthMonitor(
        ring, detectors=thealth.default_detectors(
            names=["queue_saturation"], slo_queue_depth=10.0),
        fire_ticks=2, clear_ticks=2, capture=False,
        on_fire=lambda v: None).attach()
    breaches = tmetrics.counter("rsdl_health_breaches_total", "",
                                detector="queue_saturation")
    before = breaches.value
    t, states = 0.0, []
    for depth in (99.0, 99.0, 99.0, 1.0, 1.0):
        t += 0.1
        ring.append_snapshot(_snap(t, {"rsdl_queue_depth": {
            _labels(queue="0"): depth}}))
        state = tmetrics.get("rsdl_health_state",
                             {"detector": "queue_saturation"})
        states.append(None if state is None else state.value)
    monitor.detach()
    assert states[1:] == [1.0, 1.0, 1.0, 0.0], states
    assert breaches.value == before + 1
    kinds = [e["kind"] for e in ttelemetry.recorder().events()]
    assert "health_breach" in kinds and "health_clear" in kinds
    assert monitor.summary()["detectors"]["queue_saturation"]["fires"] == 1


def test_arm_honours_the_health_key_and_disarm(monkeypatch):
    monkeypatch.setenv("RSDL_HEALTH", "0")
    assert thealth.arm() is None
    monkeypatch.delenv("RSDL_HEALTH")
    monitor = thealth.arm(interval_s=0.02, detectors=("throughput_droop",),
                          capture=False)
    assert monitor is not None
    assert thealth.armed_monitor() is monitor
    assert thist.get_history() is monitor.ring
    deadline = time.monotonic() + 5.0
    while monitor.ring.ticks < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert monitor.ring.ticks >= 2
    assert thealth.disarm() is monitor
    assert thealth.armed_monitor() is None
    assert thist.get_history() is None


def test_incident_signal_installs_on_the_main_thread_only():
    previous = signal.getsignal(signal.SIGUSR2)
    try:
        assert thealth.install_incident_signal() is True
        off_main = []
        thread = threading.Thread(
            target=lambda: off_main.append(
                thealth.install_incident_signal()))
        thread.start()
        thread.join(timeout=JOIN_S)
        assert off_main == [False]
    finally:
        signal.signal(signal.SIGUSR2, previous)


def _incident_tool(capsule):
    return subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "tools",
                                      "rsdl_incident.py"), capsule,
         "--json"], capture_output=True, text=True, timeout=JOIN_S)


def test_capsule_layout_equals_jax_and_validates(tmp_path, monkeypatch):
    monkeypatch.setenv("RSDL_INCIDENT_DIR", str(tmp_path))
    paths = {}
    for pkg, (health, hist), telemetry in (
            ("jax",) + (PKGS["jax"],) + (jtelemetry,),
            ("port",) + (PKGS["port"],) + (ttelemetry,)):
        telemetry.configure()
        telemetry.record("map_read", epoch=0, task=0, dur_s=0.01)
        ring = hist.HistoryRing(capacity=8, interval_s=0.1)
        ring.tick()
        ring.tick()
        paths[pkg] = health.capture_incident(
            reason="test", ring=ring, profile_s=0.05, wait_s=0.1,
            verdict={"detector": "throughput_droop", "detail": "test"},
            stem=f"capsule-{pkg}")
    assert sorted(os.listdir(paths["port"])) == sorted(
        os.listdir(paths["jax"]))
    manifest = json.load(open(os.path.join(paths["port"], "capsule.json")))
    jax_manifest = json.load(open(os.path.join(paths["jax"],
                                               "capsule.json")))
    assert set(manifest) == set(jax_manifest)
    assert manifest["schema"] == "rsdl-incident-v1"
    assert manifest["pids"] == [os.getpid()]
    policy_blob = json.load(open(os.path.join(paths["port"],
                                              "policy.json")))
    assert "slo_droop_pct" in policy_blob["policy"]
    jhist.load_slice(json.load(open(os.path.join(paths["port"],
                                                 "history.json"))))
    out = _incident_tool(paths["port"])
    assert out.returncode == 0, out.stderr
    incident = json.loads(out.stdout)
    assert incident["pids"] == [os.getpid()]
    assert incident["activity_rates"] is not None
    # The cooldown suppresses an immediate second capture.
    monkeypatch.setattr(thealth, "CAPSULE_COOLDOWN_S", 60.0)
    assert thealth.capture_incident(reason="again", profile_s=0.0,
                                    wait_s=0.0) is None


# -- the end-to-end twin: chaos delay -> droop -> capsule ---------------------

E2E_INTERVAL_S, E2E_WINDOW, E2E_CHAOS_EPOCHS, E2E_DELAY_MS = 0.1, 8, 3, 600


def activity_ticks(ring):
    """Ticks since the ring's activity counters (the droop detector's
    series) first moved."""
    pts = thealth._combined_series(ring, thealth._ACTIVITY_SERIES)
    moved = next((i for i in range(1, len(pts)) if pts[i][1] > pts[0][1]),
                 None)
    return 0 if moved is None else len(pts) - moved


def test_chaos_delay_to_droop_to_capsule_with_a_tick_gated_baseline(
        tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    files = []
    for i in range(3):
        path = str(tmp_path / f"e2e_{i}.parquet")
        pq.write_table(pa.table({
            "key": pa.array(range(i * 64, (i + 1) * 64), type=pa.int64()),
            "labels": pa.array(rng.random(64).astype("float32"))}), path)
        files.append(path)
    inc_dir, trace_dir = str(tmp_path / "inc"), str(tmp_path / "trace")
    os.makedirs(trace_dir)
    monkeypatch.setenv("RSDL_TRACE_DIR", trace_dir)
    ttelemetry.configure()
    monitor = thealth.arm(
        interval_s=E2E_INTERVAL_S, capacity=600,
        detectors=("throughput_droop",), fire_ticks=2, clear_ticks=50,
        incident_dir=inc_dir, capture_cooldown_s=0.0,
        slo_droop_window_ticks=E2E_WINDOW, slo_droop_floor_eps=2.0)
    assert monitor is not None
    gate = {}

    def epoch_specs():
        epoch = 0
        while activity_ticks(monitor.ring) < E2E_WINDOW + 3:
            yield tir.EpochSpec(epoch, list(files))
            epoch += 1
        chaos = range(epoch, epoch + E2E_CHAOS_EPOCHS)
        gate.update(first_chaos_epoch=epoch,
                    ticks=activity_ticks(monitor.ring))
        tfaults.install(",".join(f"reduce_gather:epoch{e}:delay"
                                 f"{E2E_DELAY_MS}" for e in chaos), seed=0)
        for e in chaos:
            yield tir.EpochSpec(e, list(files))

    try:
        tsh.shuffle_epochs(
            epoch_specs(), lambda r, e, refs: [x.result() for x in refs]
            if refs is not None else None, 3, 1, max_concurrent_epochs=1,
            seed=7, file_cache=None, executor_backend="thread")
        capsules = monitor.wait_captures(timeout_s=30.0)
    finally:
        tfaults.clear()
        thealth.disarm()
    assert gate["ticks"] >= E2E_WINDOW + 3, gate
    assert monitor.total_fires == 1, monitor.summary()
    assert len(capsules) == 1, capsules
    out = _incident_tool(capsules[0])
    assert out.returncode == 0, out.stderr
    incident = json.loads(out.stdout)
    assert incident["verdict"]["detector"] == "throughput_droop"
    assert incident["pids"] == [os.getpid()]
    assert incident["activity_rates"]


# -- the trigger: tenant_delivery_slo -> migrate ------------------------------

TRAINERS = 2


def _tables(n, rows=2000):
    """Reducer-like outputs: each carries its birth stamp, which the
    client's ``birth_to_delivered`` sketch reads."""
    return [tsh.stamp_lineage(pa.table({
        "key": np.arange(i * rows, (i + 1) * rows),
        "run": np.full(rows, i, dtype=np.int32)}), 0, 0, i)
        for i in range(n)]


def test_tenant_slo_fire_drives_one_journaled_move(tmp_path):
    """Rank 1 (tenant ``trigger-hot``) reads its eight tables from shard 1
    with the ring ticking after each; the SLO sits below any real
    latency, so the detector breaches from its first window and fires
    once under hysteresis; the fire moves rank 1 to shard 0 mid-stream;
    the stream is every table once, in order, and the journal replays the
    move."""
    queue = tmq.MultiQueue(TRAINERS)
    tables = _tables(8)
    tenant = tten.TenantContext("trigger-hot", priority="interactive")
    moves = tmetrics.counter("rsdl_rebalance_moves_total",
                             "committed live queue migrations")
    before_moves = moves.value
    journal = str(tmp_path / "rb.journal")
    phases = {}
    ring = thist.HistoryRing(capacity=64, interval_s=0.1)
    with tsvc.ShardedQueueServer(
            queue, 2, num_trainers=TRAINERS,
            tenants={"trigger-hot": {"weight": 1, "ranks": [1]}}) as sss:
        q1 = tir.queue_index(0, 1, TRAINERS)
        for table in tables:
            queue.put(q1, table)
        queue.put(q1, None)
        controller = trb.RebalanceController(
            sss.shard_map, journal_path=journal, rebalance_slo_p99_s=1e-6)
        monitor = trb.slo_trigger(ring, controller, 1, target=0,
                                  fire_ticks=2, clear_ticks=50,
                                  phases=phases, slo_droop_window_ticks=3)
        remote = tsvc.ShardedRemoteQueue(sss.shard_map, max_batch=1,
                                         tenant=tenant)
        try:
            ring.tick()  # the window's base: before any delivery
            stream = []
            while not stream or stream[-1][0] is not None:
                stream.append(remote.get_positioned(q1))
                ring.tick()
            client_map = remote.shard_map
        finally:
            monitor.detach()
            remote.close()
            controller.close()
    assert monitor.total_fires == 1, monitor.summary()
    fire = monitor.summary()["detectors"]["tenant_delivery_slo"]["last"]
    assert "tenant trigger-hot" in fire["detail"], fire
    assert [_keys for _keys in (t.column("key").to_pylist()
                                for t, _ in stream[:-1])] == [
        t.column("key").to_pylist() for t in tables]
    replayed = trb.replay(journal)
    assert (replayed.overrides, replayed.pending) == (((1, 0),), None)
    records = trb.RebalanceJournal.load(journal)
    assert [r["decision"].kind for r in records] == ["bootstrap", "intent",
                                                     "commit"]
    assert "tenant trigger-hot" in records[1]["decision"].reason
    assert (client_map.overrides, client_map.generation) == ({1: 0}, 1)
    assert moves.value == before_moves + 1
    assert phases["intent_to_commit_s"] > 0


def test_tenant_slo_fire_on_supervised_shards_aborts_at_a_dead_source(
        tmp_path):
    """Supervised shard processes (one launch) whose children die at rank
    0's PREPARE: the fire's ``migrate`` journals the abort, the source
    restarts from its watermark journal, and rank 0's stream equals the
    fault-free lineage."""
    files = []
    for i in range(2):
        path = str(tmp_path / f"rb_{i}.parquet")
        pq.write_table(pa.table({"key": pa.array(
            range(i * 600, (i + 1) * 600), type=pa.int64())}), path)
        files.append(path)
    lineage = {}

    def consumer(rank, epoch, refs):
        if refs is not None:
            lineage.setdefault((rank, epoch), []).extend(refs)

    tsh.shuffle(files, consumer, 1, 4, TRAINERS, max_concurrent_epochs=1,
                seed=43, collect_stats=False, file_cache=None,
                executor_backend="thread")
    want = [r.result().column("key").to_pylist() for r in lineage[(0, 0)]]
    supervisors, shard_map = tsup.launch_supervised_queue_shards(dict(
        filenames=files, num_epochs=1, num_trainers=TRAINERS,
        num_reducers=4, seed=43, max_concurrent_epochs=1, file_cache=None,
        journal_path=str(tmp_path / "wm.wal"),
        tenants={"live": {"weight": 1, "ranks": [0]}},
        child_env={"RSDL_CHAOS_SPEC": "rebalance_prepare:rank0:epoch1",
                   "RSDL_CHAOS_SEED": "0"}), num_shards=2)
    journal = str(tmp_path / "rb.journal")
    ring = thist.HistoryRing(capacity=64, interval_s=0.1)
    got, errors = [], []
    controller = monitor = None
    try:
        for address in shard_map.addresses:
            assert tsup.wait_for_server(tuple(address), timeout_s=60)
        controller = trb.RebalanceController(
            shard_map, journal_path=journal, rebalance_slo_p99_s=1e-6)
        monitor = trb.slo_trigger(ring, controller, 0, target=1,
                                  fire_ticks=2, clear_ticks=50,
                                  slo_droop_window_ticks=3)
        ring.tick()  # the window's base: before any delivery

        def run():
            try:
                with tds.connect_remote_queue(
                        shard_map, retries=20, initial_backoff_s=0.05,
                        max_batch=1,
                        tenant=tten.TenantContext("live")) as remote:
                    ds = tds.ShufflingDataset(files, 1, TRAINERS, 50, 0,
                                              batch_queue=remote,
                                              shuffle_result=None, seed=43)
                    ds.set_epoch(0)
                    for table in ds.iter_tables():
                        got.append(table.column("key").to_pylist())
                        ring.tick()
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        thread = threading.Thread(target=run, daemon=True,
                                  name="trigger-drain-rank0")
        thread.start()
        thread.join(timeout=JOIN_S)
        assert not thread.is_alive(), "rank 0's drain hung"
        deadline = time.monotonic() + JOIN_S
        while supervisors[0].restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        if monitor is not None:
            monitor.detach()
        for supervisor in supervisors:
            supervisor.stop()
        if controller is not None:
            controller.close()
    if errors:
        raise errors[0]
    assert monitor.total_fires == 1, monitor.summary()
    kinds = [r["decision"].kind for r in trb.RebalanceJournal.load(journal)]
    assert kinds == ["bootstrap", "intent", "abort"], kinds
    state = trb.replay(journal)
    assert (state.pending, state.generation, state.overrides) == (None, 0,
                                                                  ())
    assert supervisors[0].restarts >= 1 and not supervisors[0].failed
    assert got == want
