"""The port's runtime copies (``runtime/{policy,watchdog,retry,faults}.py``)
against the JAX package's, and the bulk binding under a stall and under
injected copy faults (the port's versions of ``tests/test_runtime.py``'s
wedged-transfer tests).

The policy resolves the same keys with the same defaults and precedence;
the fault draws, the spec parser and the retry backoffs equal the JAX
package's for the same seeds. A bulk dataset whose chunk copy is held
until the watchdog has fired (a 1e-4 s deadline) delivers the key stream
exactly once under "degrade" and "warn", and fails with the JAX package's
message under "raise"; a ``device_transfer@0.2`` chaos run delivers the
clean run's stream.
"""

import dataclasses
import itertools
import threading

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import jax_dataset as jjd
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.runtime import policy as jpolicy
from ray_shuffling_data_loader_tpu.runtime import retry as jretry
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import stats as tstats
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.runtime import faults, policy, retry
from ray_shuffling_data_loader_tpu_torch.runtime import watchdog

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)


_queue_ids = itertools.count()

# The keys the port copies, with the JAX package's defaults.
PORT_KEYS = {"device_rebatch": "auto", "watchdog": True,
             "bulk_transfer_deadline_s": 30.0, "stall_action": "degrade",
             "watchdog_poll_interval_s": 0.05, "device_double_buffer": True,
             "retry_max_attempts": 3, "retry_initial_backoff_s": 0.05,
             "retry_max_backoff_s": 2.0, "retry_deadline_s": 0.0}


@pytest.fixture(autouse=True)
def no_chaos():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """2 files of 128 rows: keys 0..255."""
    directory = tmp_path_factory.mktemp("runtime")
    filenames = []
    for i in range(2):
        rng = np.random.default_rng(i)
        table = pa.table({
            "key": pa.array(range(i * 128, (i + 1) * 128), type=pa.int64()),
            "emb_1": pa.array(rng.integers(0, 100, 128), type=pa.int64()),
            "labels": pa.array(rng.random(128), type=pa.float64()),
        })
        path = str(directory / f"input_{i}.parquet")
        pq.write_table(table, path)
        filenames.append(path)
    return filenames


SPEC = {"feature_columns": ["key", "emb_1"],
        "feature_types": [np.int64, np.int32], "label_column": "labels",
        "batch_size": 16, "num_reducers": 2, "seed": 0, "drop_last": False}


def _port_ds(files, **kw):
    return DeviceShufflingDataset(files, 2, 1, rank=0, device="cpu",
                                  **{**SPEC, **kw})


def _drain(ds, num_epochs=2):
    out = []
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        out.append([(f[0].numpy().ravel().copy(), f[1].numpy().copy(),
                     lb.numpy().copy()) for f, lb in ds])
    return out


@pytest.fixture(scope="module")
def want(files):
    """The JAX package's per-batch stream over the same files."""
    ds = jjd.JaxShufflingDataset(
        files, 2, 1, rank=0, num_workers=1, device_rebatch=False,
        queue_name=f"torch-port-runtime-{next(_queue_ids)}", **SPEC)
    try:
        return [[(np.asarray(f[0]).ravel(), np.asarray(f[1]),
                  np.asarray(lb)) for f, lb in epoch_batches]
                for epoch_batches in _jax_epochs(ds)]
    finally:
        ds.close()


def _jax_epochs(ds):
    for epoch in range(2):
        ds.set_epoch(epoch)
        yield list(ds)


def _assert_stream(got, want):
    assert len(got) == len(want)
    for epoch_got, epoch_want in zip(got, want):
        # Every key exactly once per epoch.
        keys = np.sort(np.concatenate([k for k, _, _ in epoch_got]))
        np.testing.assert_array_equal(keys, np.arange(256))
        assert len(epoch_got) == len(epoch_want)
        for g, w in zip(epoch_got, epoch_want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_policy_defaults_equal_the_jax_package(monkeypatch):
    for key in PORT_KEYS:
        for name in (f"RSDL_{key.upper()}",
                     f"RSDL_DEVICE_DATASET_{key.upper()}"):
            monkeypatch.delenv(name, raising=False)
    got = policy.resolve_all("device_dataset")
    assert got == PORT_KEYS
    assert got == {k: jpolicy.resolve("jax_dataset", k) for k in PORT_KEYS}
    with pytest.raises(ValueError):
        policy.resolve("device_dataset", "no_such_knob")
    with pytest.raises(ValueError):
        policy.resolve_all("device_dataset", no_such_knob=1)


def test_policy_env_precedence(monkeypatch, files):
    monkeypatch.setenv("RSDL_BULK_TRANSFER_DEADLINE_S", "7.5")
    assert policy.resolve("device_dataset",
                          "bulk_transfer_deadline_s") == 7.5
    # The component's own variable beats the global one.
    monkeypatch.setenv("RSDL_DEVICE_DATASET_BULK_TRANSFER_DEADLINE_S", "2.0")
    assert policy.resolve("device_dataset",
                          "bulk_transfer_deadline_s") == 2.0
    assert policy.resolve("shuffle", "bulk_transfer_deadline_s") == 7.5
    # An explicit kwarg beats both.
    assert policy.resolve("device_dataset", "bulk_transfer_deadline_s",
                          override=1.25) == 1.25
    # A registered component default sits below the environment.
    policy.register_defaults("elsewhere", stall_action="warn")
    assert policy.resolve("elsewhere", "stall_action") == "warn"
    monkeypatch.setenv("RSDL_STALL_ACTION", "raise")
    assert policy.resolve("elsewhere", "stall_action") == "raise"
    # RSDL_DEVICE_REBATCH=0 turns "auto" per-batch in both packages; an
    # explicit True still wins (allowed on the CPU, as in the JAX tests).
    monkeypatch.setenv("RSDL_DEVICE_REBATCH", "0")
    assert policy.resolve("device_dataset", "device_rebatch") is False
    assert jpolicy.resolve("jax_dataset", "device_rebatch") is False
    queue = tmq.MultiQueue(2)
    kw = {"batch_queue": queue, "shuffle_result": None}
    assert _port_ds(files, **kw).binding == "per_batch"
    assert _port_ds(files, device_rebatch=True, **kw).binding == "bulk"
    assert _port_ds(files, device_rebatch=True, runtime_policy={
        "watchdog": False}, **kw)._converter.watchdog is None
    with pytest.raises(ValueError, match="persistent_prefetch"):
        _port_ds(files, device_rebatch=True, persistent_prefetch=False, **kw)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------


def test_watchdog_fires_escalates_and_beat_resets_it():
    wd = watchdog.Watchdog(poll_interval_s=0.002)
    before = tstats.watchdog_stats().snapshot()
    reports = []
    second = threading.Event()

    def on_stall(report):
        reports.append(report)
        if report.escalation == 2:
            second.set()

    with wd.watch("test.stuck", deadline_s=0.01, on_stall=on_stall,
                  detail_fn=lambda: "queue_depth=0") as handle:
        assert second.wait(10)
    assert handle.stalled and handle.escalations >= 2
    assert [r.escalation for r in reports[:2]] == [1, 2]
    assert reports[0].detail == "queue_depth=0"
    assert reports[0].waited_s >= 0.01
    after = tstats.watchdog_stats().snapshot()
    assert after["watchdog_events"] >= before["watchdog_events"] + 2
    assert after["stall_escalations"] >= before["stall_escalations"] + 1
    assert after["stalls_by_name"]["test.stuck"] >= 2

    tick = threading.Event()
    with wd.watch("test.beating", deadline_s=0.2) as handle:
        for _ in range(40):  # 0.4 s in all, a beat every 10 ms
            tick.wait(0.01)
            handle.beat()
    assert not handle.stalled


# ---------------------------------------------------------------------------
# faults and retry: the same draws, rules and backoffs as the JAX package
# ---------------------------------------------------------------------------


def test_fault_draws_and_spec_parsing_equal_the_jax_package():
    assert faults.SITES == jfaults.SITES
    for seed in (0, 1, 7, 12345):
        for site in sorted(faults.SITES):
            for epoch in (None, 0, 3):
                for task in (None, 0, 1, 2, 17, 1000):
                    assert faults._stable_draw(seed, site, epoch, task) == \
                        jfaults._stable_draw(seed, site, epoch, task)
    specs = ["device_transfer@0.05", "device_transfer:task3:x2",
             "map_read:epoch1:file2,queue_get:task1:after2",
             "reduce_gather:delay50", "member_crash:rank2:epoch0",
             "transport_send@0.01:after1"]
    for spec in specs:
        assert [dataclasses.asdict(r) for r in faults.parse_spec(spec)] == \
            [dataclasses.asdict(r) for r in jfaults.parse_spec(spec)]
    for bad in ("no_such_site", "device_transfer:bogus3",
                "device_transfer@1.5", "device_transfer:x0"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
        with pytest.raises(ValueError):
            jfaults.parse_spec(bad)


def test_retry_backoffs_equal_the_jax_package_and_recoveries_count():
    for seed in (0, 1, 42):
        for bounds in ((0.05, 2.0), (0.01, 0.1), (0.0, 1.0)):
            ours = retry.RetryPolicy(initial_backoff_s=bounds[0],
                                     max_backoff_s=bounds[1], seed=seed)
            theirs = jretry.RetryPolicy(initial_backoff_s=bounds[0],
                                        max_backoff_s=bounds[1], seed=seed)
            assert list(itertools.islice(ours.backoffs(), 12)) == \
                list(itertools.islice(theirs.backoffs(), 12))
    slept, recovered = [], []
    calls = itertools.count()

    def flaky():
        if next(calls) < 2:
            raise faults.InjectedFault("device_transfer", None, 0, "test")
        return "ok"

    p = retry.RetryPolicy.for_component(
        "device_dataset", retryable=retry.transient_retryable, seed=0,
        sleep=slept.append)
    before = tstats.fault_stats().snapshot()
    assert p.call(flaky, on_recovery=lambda n, s: recovered.append(n)) == "ok"
    assert recovered == [2] and len(slept) == 2
    assert slept == list(itertools.islice(jretry.RetryPolicy(
        seed=0).backoffs(), 2))
    assert tstats.fault_stats()["retries"] == before["retries"] + 2
    with pytest.raises(ValueError):  # not transient: surfaces at once
        p.call(lambda: (_ for _ in ()).throw(ValueError("bug")))


# ---------------------------------------------------------------------------
# the bulk binding under a stall and under injected faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("action", ["degrade", "warn", "raise", "healthy"])
def test_stall_actions_on_a_wedged_bulk_copy(files, want, action):
    """The first chunk copy is held until the watchdog (1e-4 s deadline)
    has fired; "degrade" drops to per-batch copies for good, "warn" keeps
    the bulk path with half the chunk cap, "raise" fails the producer.
    "healthy" (30 s deadline) is left alone."""
    deadline = 30.0 if action == "healthy" else 1e-4
    runtime_policy = {"bulk_transfer_deadline_s": deadline}
    if action in ("warn", "raise"):
        runtime_policy["stall_action"] = action
    ds = _port_ds(files, device_rebatch=True, runtime_policy=runtime_policy)
    converter = ds._converter
    assert converter.watchdog is not None
    cap = converter.max_table_bytes
    before = tstats.watchdog_stats().snapshot()
    fired = threading.Event()
    on_stall = converter._on_bulk_stall

    def on_stall_then_release(report):
        on_stall(report)
        fired.set()

    converter._on_bulk_stall = on_stall_then_release
    if action != "healthy":
        transfer_table = converter.transfer_table
        held = []

        def wedged(arrays_label, n_batches, batch_size):
            if not held:
                held.append(True)
                assert fired.wait(10), "the watchdog never fired"
            return transfer_table(arrays_label, n_batches, batch_size)

        converter.transfer_table = wedged
    if action == "raise":
        ds.set_epoch(0)
        keys = []
        with pytest.raises(RuntimeError, match="stall_action='raise'"):
            for features, _ in ds:
                keys.extend(features[0].numpy().ravel())
        assert len(set(keys)) == len(keys)
        ds.close()
        return
    got = _drain(ds)
    ds.close()
    _assert_stream(got, want)
    after = tstats.watchdog_stats().snapshot()
    stats = ds.transfer_stats()
    if action == "healthy":
        assert converter.device_rebatch and not converter.fallback_engaged
        assert converter.max_table_bytes == cap
        return
    assert after["watchdog_events"] > before["watchdog_events"]
    assert after["stalls_by_name"]["device_dataset.bulk_transfer"] > \
        before["stalls_by_name"].get("device_dataset.bulk_transfer", 0)
    assert converter.max_table_bytes < cap
    if action == "degrade":
        assert converter.device_rebatch is False
        assert converter.fallback_engaged and stats["fallback_engaged"]
        assert after["fallbacks_engaged"] > before["fallbacks_engaged"]
    else:
        assert converter.device_rebatch is True
        assert not converter.fallback_engaged
        assert sum(c["bulk"] for c in
                   stats["copies_by_epoch"].values()) > 1


@pytest.mark.parametrize("device_rebatch", [True, False])
def test_device_transfer_chaos_delivers_the_clean_stream(
        files, want, device_rebatch):
    before = tstats.fault_stats().snapshot()
    faults.install("device_transfer@0.2", seed=0)
    ds = _port_ds(files, device_rebatch=device_rebatch, runtime_policy={
        "retry_initial_backoff_s": 0.001, "retry_max_backoff_s": 0.002})
    got = _drain(ds)
    ds.close()
    _assert_stream(got, want)
    after = tstats.fault_stats().snapshot()
    assert after["injected"] > before["injected"]
    assert after["recomputes"] > before["recomputes"]
