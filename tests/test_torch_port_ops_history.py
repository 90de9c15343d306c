"""The port's ops-plane substrate (``runtime/{watchdog,history,policy,
profiler}.py``) against the JAX package's, on the CPU.

- The watchdog's ``every``/``cancel`` ticks on the monitor thread and
  stops; a periodic that raises keeps its schedule.
- The history ring: capacity, ``series``, ``rate``, the label filter and
  ``downsample_slice`` give the JAX ring's outputs on the same appended
  snapshots; a port slice loads through the JAX ``load_slice`` and a JAX
  slice through the port's (the two slices are equal), and
  ``merged_series`` over a mixed pair equals JAX's; a live tick samples
  the registry, RSS and the buffer ledger; ``start``/``stop`` tick the
  process-wide ring on the watchdog.
- The 23 ops-plane policy keys resolve to the JAX defaults, and an
  ``RSDL_SLO_*`` or ``RSDL_HEALTH_SLO_*`` override applies in both.
- ``SamplingProfiler.summary()`` has the JAX keys, ``by_stage`` bills a
  span opened on a busy thread, and ``maybe_sample`` writes the folded
  stacks where ``RSDL_PROFILE_FOLDED`` says.
"""

import json
import os
import threading
import time

import pytest

from ray_shuffling_data_loader_tpu.runtime import history as jhist
from ray_shuffling_data_loader_tpu.runtime import policy as jpolicy
from ray_shuffling_data_loader_tpu.runtime import profiler as jprof
from ray_shuffling_data_loader_tpu_torch.runtime import history as thist
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as tpolicy
from ray_shuffling_data_loader_tpu_torch.runtime import profiler as tprof
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as ttelemetry)
from ray_shuffling_data_loader_tpu_torch.runtime import watchdog as twd

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

#: The ops-plane keys this slice adds to the port's registry.
OPS_KEYS = (
    "profiler", "profiler_interval_s", "history_interval_s",
    "history_capacity", "health", "health_fire_ticks", "health_clear_ticks",
    "slo_droop_pct", "slo_droop_floor_eps", "slo_droop_window_ticks",
    "slo_stall_pct", "slo_creep_mb_per_min", "slo_queue_depth",
    "slo_lease_churn_per_min", "slo_straggler_drift_x", "slo_delivery_p99_s",
    "slo_freshness_s", "slo_cache_evictions_per_min", "slo_cache_hit_pct",
    "slo_watermark_lag_s", "incident_dir", "incident_profile_s",
    "incident_wait_s")
PKGS = {"jax": jhist, "port": thist}


def _labels(**kv):
    return tuple(sorted((k, str(v)) for k, v in kv.items()))


def _snap(t, samples):
    return {"t": t, "t_unix": 1.7e9 + t, "samples": samples}


def _both(capacity=10, interval_s=0.1):
    return {name: mod.HistoryRing(capacity=capacity, interval_s=interval_s)
            for name, mod in PKGS.items()}


def _copy(snap):
    """Each ring gets its own copy: a ring keeps the dict it is given."""
    return {"t": snap["t"], "t_unix": snap["t_unix"],
            "samples": {name: dict(series)
                        for name, series in snap["samples"].items()}}


def _noisy_rings(capacity=10):
    """Both packages' rings over the same 25 snapshots: two labelled
    children of the events counter, one of which resets at tick 12."""
    rings = _both(capacity=capacity)
    for i in range(25):
        snap = _snap(0.1 * i, {"rsdl_events_total": {
            _labels(kind="map_read"): 10.0 * i + (i % 3),
            _labels(kind="reduce_gather"): float(i if i < 12 else i - 12)}})
        for ring in rings.values():
            ring.append_snapshot(_copy(snap))
    return rings


def test_watchdog_every_ticks_cancels_and_survives_a_raise():
    wd = twd.get_watchdog()
    ticks, raises = [], []

    def bad():
        raises.append(1)
        raise RuntimeError("periodic failure")

    handle = wd.every(0.02, lambda: ticks.append(1), name="test-tick")
    failing = wd.every(0.02, bad, name="test-raise")
    deadline = time.monotonic() + 5.0
    while (len(ticks) < 3 or len(raises) < 3) and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    wd.cancel(handle)
    wd.cancel(failing)
    assert len(ticks) >= 3, "the periodic never ran on the monitor thread"
    assert len(raises) >= 3, "a raising periodic lost its schedule"
    count = len(ticks)
    time.sleep(0.15)
    assert len(ticks) == count, "cancel() did not stop the periodic"
    assert twd.PeriodicHandle("x", 0.0, lambda: None).interval_s == 0.01


def test_watchdog_periodic_keeps_its_schedule_under_a_watch_poll():
    """A watch makes the monitor poll every 0.06 s; a 0.1 s periodic
    still runs once per interval, since a late run does not push the
    next one back. A run a whole interval late skips what it missed and
    does not burst."""
    wd = twd.Watchdog(poll_interval_s=0.06)
    starts = []
    handle = wd.every(0.1, lambda: starts.append(time.monotonic()),
                      name="test-anchored")
    begin = time.monotonic()
    with wd.watch("test-hold", 60.0):
        time.sleep(2.0)
    elapsed = time.monotonic() - begin
    wd.cancel(handle)
    assert len(starts) >= int(elapsed / 0.1) - 2, (
        f"{len(starts)} runs in {elapsed:.2f} s at 0.1 s")

    slow = []

    def stall_once():
        slow.append(time.monotonic())
        if len(slow) == 1:
            time.sleep(0.35)

    handle = wd.every(0.1, stall_once, name="test-skip")
    time.sleep(1.0)
    wd.cancel(handle)
    gaps = [b - a for a, b in zip(slow[1:], slow[2:])]
    assert len(slow) >= 5 and min(gaps) >= 0.05, (
        f"a late periodic burst: gaps {gaps}")


@pytest.mark.parametrize("window", [1, 2, 5])
def test_ring_capacity_series_and_rate_equal_jax(window):
    rings = _noisy_rings()
    jax_ring, port_ring = rings["jax"], rings["port"]
    assert len(port_ring.snapshots()) == 10 == len(jax_ring.snapshots())
    assert port_ring.ticks == jax_ring.ticks == 25
    for name in ("rsdl_events_total", "rsdl_absent_total"):
        assert port_ring.series(name) == jax_ring.series(name)
        assert (port_ring.rate(name, window_ticks=window)
                == jax_ring.rate(name, window_ticks=window))
    assert port_ring.rate("rsdl_events_total", window_ticks=window)


@pytest.mark.parametrize("labels", [None, {"kind": "map_read"},
                                    {"kind": "reduce_gather"},
                                    {"kind": "nope"}, {}])
def test_label_filter_equals_jax(labels):
    rings = _noisy_rings()
    assert (rings["port"].series("rsdl_events_total", labels)
            == rings["jax"].series("rsdl_events_total", labels))
    assert (rings["port"].rate("rsdl_events_total", labels, 3)
            == rings["jax"].rate("rsdl_events_total", labels, 3))


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_slice_loads_in_the_other_package(writer, reader):
    rings = _noisy_rings(capacity=40)
    port_slice, jax_slice = rings["port"].slice(), rings["jax"].slice()
    assert json.dumps(port_slice) == json.dumps(jax_slice)
    blob = json.loads(json.dumps(rings[writer].slice(last_s=1.0)))
    loaded = PKGS[reader].load_slice(blob)
    assert (loaded.series("rsdl_events_total")
            == rings[writer].series("rsdl_events_total")[-len(
                blob["snapshots"]):])
    assert loaded.interval_s == 0.1
    with pytest.raises(ValueError):
        PKGS[reader].load_slice({"schema": "nope"})


def test_merged_series_of_a_mixed_pair_equals_jax():
    port_ring, jax_ring = thist.HistoryRing(40, 0.1), jhist.HistoryRing(
        40, 0.25)
    for i in range(12):
        port_ring.append_snapshot(_snap(0.1 * i, {"rsdl_events_total": {
            (): 2.0 * i}}))
        jax_ring.append_snapshot(_snap(0.1 * i + 0.03, {
            "rsdl_events_total": {(): 5.0 * i}}))
    slices = [json.loads(json.dumps(port_ring.slice())),
              json.loads(json.dumps(jax_ring.slice()))]
    got = thist.merged_series(slices, "rsdl_events_total")
    assert got and got == jhist.merged_series(slices, "rsdl_events_total")
    assert thist.merged_series([], "rsdl_events_total") == []


@pytest.mark.parametrize("keep", [2, 5, 40])
def test_downsample_slice_equals_jax(keep):
    data = _noisy_rings(capacity=25)["port"].slice()
    got = thist.downsample_slice(data, keep)
    assert got == jhist.downsample_slice(data, keep)
    assert got["snapshots"][-1] == data["snapshots"][-1]
    thist.load_slice(got)


def test_live_tick_samples_registry_rss_and_ledger():
    counter = tmetrics.counter("rsdl_events_total", "", kind="hist-test")
    ring = thist.HistoryRing(capacity=8, interval_s=0.1)
    seen = []
    ring.add_listener(lambda r: seen.append(r.ticks))
    counter.inc(3)
    ring.tick()
    counter.inc(4)
    ring.tick()
    series = ring.series("rsdl_events_total", {"kind": "hist-test"})
    assert [v - series[0][1] for _, v in series] == [0.0, 4.0]
    assert ring.series("rsdl_process_rss_bytes")[-1][1] > 0
    assert ring.series("rsdl_ledger_bytes_in_use")
    assert seen == [1, 2]
    assert ring.slice()["types"]["rsdl_events_total"] == "counter"


def test_start_stop_ticks_the_process_ring_on_the_watchdog():
    ring = thist.start(interval_s=0.02, capacity=50)
    try:
        assert thist.get_history() is ring
        deadline = time.monotonic() + 5.0
        while ring.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ring.ticks >= 3
    finally:
        thist.stop()
    assert thist.get_history() is None
    ticks = ring.ticks
    time.sleep(0.1)
    assert ring.ticks == ticks


@pytest.mark.parametrize("key", OPS_KEYS)
def test_ops_policy_key_defaults_equal_jax(key, monkeypatch):
    for name in list(os.environ):
        if name.startswith("RSDL_") and name.endswith(key.upper()):
            monkeypatch.delenv(name)
    assert tpolicy._ALL_KEYS[key][0] == jpolicy._KEYS[key][0]
    for component in ("health", "history", "telemetry"):
        assert (tpolicy.resolve(component, key)
                == jpolicy.resolve(component, key))
    assert key in tpolicy.describe()


@pytest.mark.parametrize("env,component,want", [
    ("RSDL_SLO_DROOP_PCT", "health", 33.0),
    ("RSDL_SLO_DROOP_PCT", "smoke", 33.0),
    ("RSDL_HEALTH_SLO_DROOP_PCT", "health", 33.0),
    ("RSDL_HEALTH_SLO_DROOP_PCT", "smoke", 60.0),
])
def test_slo_env_overrides_apply_in_both(env, component, want, monkeypatch):
    monkeypatch.setenv(env, "33")
    assert tpolicy.resolve(component, "slo_droop_pct") == want
    assert jpolicy.resolve(component, "slo_droop_pct") == want
    monkeypatch.setenv("RSDL_HEALTH", "off")
    assert tpolicy.resolve("health", "health") is False
    assert jpolicy.resolve("health", "health") is False


def _busy(stop, span_kind):
    with ttelemetry.span(span_kind):
        while not stop.is_set():
            sum(range(500))


def test_profiler_summary_keys_and_stage_billing():
    ttelemetry.configure(enabled_flag=True, capacity=1 << 12)
    stop = threading.Event()
    thread = threading.Thread(target=_busy, args=(stop, "reduce_gather"),
                              name="rsdl-busy-test", daemon=True)
    thread.start()
    try:
        with tprof.SamplingProfiler(interval_s=0.005) as prof:
            time.sleep(0.25)
    finally:
        stop.set()
        thread.join(timeout=10)
    summary = prof.summary()
    jax_keys = set(jprof.SamplingProfiler(interval_s=0.005).summary())
    assert set(summary) == jax_keys
    assert summary["samples"] > 5
    assert prof.by_stage().get("reduce_gather", 0) > 0, prof.by_stage()
    assert summary["threads_by_samples"].get("rsdl-busy-test", 0) > 0
    assert any(k.startswith("rsdl-busy-test;") for k in prof.folded())


def test_maybe_sample_writes_folded_stacks(tmp_path, monkeypatch):
    monkeypatch.delenv("RSDL_PROFILER", raising=False)
    monkeypatch.delenv("RSDL_PROFILE_FOLDED", raising=False)
    with tprof.maybe_sample() as prof:
        assert prof is None
    path = str(tmp_path / "sub" / "prof.folded")
    monkeypatch.setenv("RSDL_PROFILE_FOLDED", path)
    monkeypatch.setenv("RSDL_PROFILER_INTERVAL_S", "0.005")
    with tprof.maybe_sample() as prof:
        assert prof is not None
        time.sleep(0.1)
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert lines and all(line.rsplit(" ", 1)[1].isdigit() for line in lines)
