"""Policy registry: one resolution surface for the device binding's
runtime knobs (own copy of the JAX package's ``runtime/policy.py``, with
only the keys the port reads). Every knob resolves in one order::

    explicit kwarg > RSDL_<COMPONENT>_<KEY> env > RSDL_<KEY> env
                   > registered component default > library default

The port's loader is the component ``device_dataset``, so its own
overrides read ``RSDL_DEVICE_DATASET_<KEY>`` (the JAX package's loader
reads ``RSDL_JAX_DATASET_<KEY>``). The global ``RSDL_<KEY>`` variables
mean the same in both packages: ``RSDL_DEVICE_REBATCH=0`` turns every
``device_rebatch="auto"`` construction per-batch in either, and
``RSDL_BULK_TRANSFER_DEADLINE_S`` sets both loaders' watchdog deadline.
The keys, their defaults and their parsers are the JAX package's. The
transport's dial reads only the ``retry_*`` keys, as the component
``transport`` (``RSDL_TRANSPORT_RETRY_MAX_ATTEMPTS`` deepens only its
redial budget), with the JAX package's explicit overrides. The shuffle
engine reads its keys as the component ``shuffle``
(``RSDL_SHUFFLE_ON_BAD_FILE``, ``RSDL_SHUFFLE_FUSED_PIPELINE``, the
budget wait), the plan scheduler as ``plan`` (``RSDL_PLAN_*``), the spill
tier as ``spill``, the executor and the process pool as ``executor``
(``RSDL_EXECUTOR_WORKERS``, ``RSDL_EXECUTOR_SHM_DIR``, ...) and the
storage plane as ``storage`` (``RSDL_STORAGE_BACKEND``,
``RSDL_STORAGE_SIM_*``); the per-stage retry policies are the components
``map_read``, ``reduce``, ``lineage``, ``spill``, ``executor``,
``storage`` and ``procpool`` (the pool's worker respawns;
``RSDL_LINEAGE_RETRY_MAX_ATTEMPTS``, ...). The telemetry spine reads its
keys as the JAX package does: ``telemetry`` (``RSDL_TELEMETRY``,
``RSDL_TELEMETRY_CAPACITY``, ``RSDL_TRACE_DIR``, ...) and ``metrics``
(``RSDL_METRICS_FILE``, ``RSDL_TELEMETRY_DIR``, ...), with the JAX
defaults: recording is on. The failure detector reads its keys as the
component ``member`` (``RSDL_MEMBER_HEARTBEAT_S``,
``RSDL_MEMBER_SUSPECT_S``, ``RSDL_MEMBER_PHI``). The queue service
(``multiqueue_service``) reads its keys as the component ``queue``
(``RSDL_QUEUE_TIMEOUT_S``, ``RSDL_QUEUE_REPLAY_BYTES``,
``RSDL_QUEUE_ON_DEAD_CONSUMER``, ...) and its connect and refetch retries
as ``queue``; the supervisor's restart budget is the retry policy of the
component ``supervisor`` (``RSDL_SUPERVISOR_RETRY_MAX_ATTEMPTS``), whose
defaults ``runtime.supervisor`` registers. The rebalance controller reads
its keys as the component ``rebalance`` (``RSDL_REBALANCE_SLO_P99_S``,
``RSDL_REBALANCE_COOLDOWN_S``, ``RSDL_REBALANCE_MAX_MOVES``). The
streaming window assembler reads its keys as the component ``stream``
(``RSDL_STREAM_WINDOW_MAX_FILES``, ``RSDL_STREAM_WINDOW_LATE_POLICY``,
...). The ops plane reads its keys as the JAX package does: the history
ring as ``history``, the sampling profiler as ``telemetry``, the
detectors, their hysteresis and the capsules as ``health`` (or the
component a caller arms them for: ``RSDL_<COMPONENT>_SLO_*`` over the
generic ``RSDL_SLO_*``); ``RSDL_HEALTH=0`` disarms the plane.

Stdlib only.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

_FALSE_WORDS = frozenset({"0", "false", "no", "off"})


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in _FALSE_WORDS


def _parse_tristate(raw: str):
    """``"auto"`` stays the string sentinel; anything else parses as bool."""
    word = raw.strip().lower()
    if word == "auto":
        return "auto"
    return _parse_bool(word)


#: The device binding's and the retry policies' keys: key -> (library
#: default, parser for env-var strings).
_KEYS: Dict[str, "tuple[Any, Callable[[str], Any]]"] = {
    # Bulk device re-batching: "auto" / True / False.
    "device_rebatch": ("auto", _parse_tristate),
    # Deadline watchdog over the bulk copy and carve.
    "watchdog": (True, _parse_bool),
    # Seconds one bulk chunk's copy or first carve may run before the
    # watchdog declares a stall: meant to catch a wedged copy, not a
    # slow one.
    "bulk_transfer_deadline_s": (30.0, float),
    # What a stall does: "degrade" (per-batch copies from then on),
    # "warn" (record only), "raise" (fail the producer).
    "stall_action": ("degrade", str),
    # The watchdog monitor thread's poll interval.
    "watchdog_poll_interval_s": (0.05, float),
    # Per-batch copies overlap the next batch's conversion (see
    # device_dataset's docstring).
    "device_double_buffer": (True, _parse_bool),
    # RetryPolicy defaults (runtime/retry.py): total attempts, the
    # decorrelated-jitter backoff bounds, and a wall-clock deadline for
    # the call and its retries (<= 0: none).
    "retry_max_attempts": (3, int),
    "retry_initial_backoff_s": (0.05, float),
    "retry_max_backoff_s": (2.0, float),
    "retry_deadline_s": (0.0, float),
}

#: The shuffle engine's keys: resolved one at a time (:func:`resolve`),
#: never part of the device binding's :func:`resolve_all`.
_ENGINE_KEYS: Dict[str, "tuple[Any, Callable[[str], Any]]"] = {
    # How long an epoch launch waits for consumers to release tables when
    # over max_inflight_bytes, before it proceeds with a warning.
    "budget_wait_timeout_s": (30.0, float),
    # Upper bound between predicate re-checks in release-event waits: a
    # safety heartbeat, not a polling cadence.
    "release_heartbeat_s": (0.25, float),
    # Free-list trim cooldown under sustained budget pressure (spill.py).
    "trim_cooldown_s": (1.0, float),
    # Executor backend: "thread", "process" or "auto" (the process pool
    # where the host has more than one core, the pool more than one
    # worker, a writable shared-memory dir, transforms that unpickle in
    # a worker, no programmatically installed chaos and no storage source
    # installed with storage.set_source; else threads).
    "executor_backend": ("auto", str),
    # The process pool's width (0: one worker per host core).
    "executor_workers": (0, int),
    # Where the pool's segments live ("": /dev/shm where writable, else
    # the system temp dir).
    "executor_shm_dir": ("", str),
    # Byte budget of the decoded-table segments the pool keeps across
    # epochs (0: half the free bytes of the segment filesystem).
    "executor_shm_bytes": (0, int),
    # Storage plane (storage/): the source dataset reads resolve to when
    # none is installed with storage.set_source ("local" or "sim").
    "storage_backend": ("local", str),
    # Idle-lane prefetch of the next epoch's files into a tiered cache.
    "storage_prefetch": (True, _parse_bool),
    # SimulatedObjectStore: first-byte latency (ms), bandwidth (MB/s),
    # multiplicative jitter (+/- per cent), transient error rate and the
    # seed of its draws (each a pure function of seed, path and attempt).
    "storage_sim_first_byte_ms": (2.0, float),
    "storage_sim_mb_per_s": (512.0, float),
    "storage_sim_jitter_pct": (10.0, float),
    "storage_sim_error_rate": (0.0, float),
    "storage_sim_seed": (0, int),
    # Streaming map (decode -> partition -> gather fused over record
    # batches): "auto"/True where it keeps the cache and bit-identity
    # contracts, False for the read-then-plan map everywhere. The
    # partition stream is the same either way.
    "shuffle_fused_pipeline": ("auto", _parse_tristate),
    # What the map does with a corrupt or unreadable input file after its
    # read retries: "raise" (lineage recovery retries the map; only an
    # exhausted recovery fails the run) or "skip" (quarantine the file into
    # a QuarantinedFile report and shuffle the others).
    "on_bad_file": ("raise", str),
    # Plan scheduler: speculative re-execution of stragglers (off by
    # default), its threshold (max(min_s, multiplier x the stage's rolling
    # median)) and check cadence, and work stealing between lanes.
    "plan_speculation": (False, _parse_bool),
    "plan_speculation_multiplier": (4.0, float),
    "plan_speculation_min_s": (1.0, float),
    "plan_speculation_check_s": (0.05, float),
    "plan_stealing": (True, _parse_bool),
    # Telemetry spine (runtime/telemetry.py): the flight recorder on or
    # off, its ring capacity (events), and where on-demand, escalation
    # and SIGUSR1 dumps land ("": the trace dir, else the temp dir).
    "telemetry": (True, _parse_bool),
    "telemetry_capacity": (4096, int),
    "telemetry_dump_dir": ("", str),
    # Causal tracing (runtime/trace.py): when set, every process dumps
    # its flight recorder into this directory at exit (and dump()
    # defaults there); the pool's workers inherit it through the
    # environment.
    "trace_dir": ("", str),
    # Batch-wait share of an epoch's wall clock above which the verdict
    # names a producer stage instead of train_step.
    "bottleneck_stall_threshold_pct": (10.0, float),
    # Metrics exposition (runtime/metrics.py): Prometheus text file path
    # ("": off), loopback HTTP port (0: off), file rewrite cadence.
    "metrics_file": ("", str),
    "metrics_port": (0, int),
    "metrics_interval_s": (5.0, float),
    # Multi-process federation: when set, every process (the driver and
    # the pool's workers) periodically writes a per-pid exposition shard
    # into this directory, and the exporters merge the shards.
    "telemetry_dir": ("", str),
    "metrics_shard_interval_s": (2.0, float),
    # Elastic membership (membership/): the failure detector's probe
    # cadence (heartbeats also ride every data frame; the prober covers
    # idle links), the silence after which a quiet rank is declared down,
    # and the phi-style suspicion threshold (silence in smoothed
    # inter-arrival units; crossing it marks the rank suspect before the
    # suspect_s deadline downs it).
    "member_heartbeat_s": (0.5, float),
    "member_suspect_s": (3.0, float),
    "member_phi": (8.0, float),
    # Queue service (multiqueue_service.py): the receive timeout of both
    # ends' sockets (0: none; a timed-out response is reconnected and
    # replayed, never lost) and TCP_NODELAY on both ends.
    "queue_timeout_s": (300.0, float),
    "queue_nodelay": (True, _parse_bool),
    # Per-queue replay buffer byte budget: unacked frames kept for a
    # reconnect's replay. At the budget the server stops popping new
    # items (backpressure, at least one frame per request), never drops.
    "queue_replay_bytes": (256 << 20, int),
    # Seconds without a heartbeat or a request before a consumer's lease
    # expires (clients beat at a third of it), and what the server does
    # then: "fail_fast" (close the server), "drain" (free the dead rank's
    # queues) or "redistribute" (reroute its undelivered tables to a
    # surviving consumer).
    "queue_lease_timeout_s": (30.0, float),
    "on_dead_consumer": ("fail_fast", str),
    # Weighted-fair tenancy (tenancy/fairshare.py): the round-robin
    # quantum (a round gives a tenant quantum * weight bytes of credit),
    # the seconds after which a quiet tenant's share goes to the others,
    # and the pace of the one-frame-per-GET floor while the scheduler
    # denies a tenant (0: unpaced; on loopback the floor alone then
    # out-delivers the grants).
    "tenant_drr_quantum_bytes": (1 << 20, int),
    "tenant_active_window_s": (1.0, float),
    "tenant_floor_pace_s": (0.002, float),
    # Table delivery: "auto" (a consumer dialling a loopback address
    # offers shared-memory handles, and the server then sends segment
    # handles instead of table bytes), "handle" (offer them whatever the
    # address: hosts sharing an shm mount) or "stream" (always stream).
    "queue_delivery": ("auto", str),
    # Compression of streamed tables (handle frames are never
    # compressed): "off", "zlib", "zstd" or "lz4"; zstd and lz4 fall back
    # to zlib with a warning where their module is missing. The CRC is
    # over the uncompressed payload. Tables below the minimum size skip
    # it.
    "queue_compression": ("off", str),
    "queue_compression_min_bytes": (4096, int),
    # The shard count of the serve helpers when the caller gives none (1:
    # one server).
    "queue_shards": (1, int),
    # Threads that compress frames off the serving thread, shared by a
    # server's connections (0: compress inline).
    "queue_codec_threads": (1, int),
    # One scatter-gather sendmsg per response instead of a sendall per
    # header and payload (the same bytes on the wire).
    "queue_sendmsg": (True, _parse_bool),
    # Live queue rebalancing (rebalance/, RSDL_REBALANCE_*): the
    # per-tenant delivery-p99 SLO above which a breach calls for a move,
    # the window a committed move counts against, and the most committed
    # moves inside it (one hot rank cannot ping-pong between shards).
    "rebalance_slo_p99_s": (30.0, float),
    "rebalance_cooldown_s": (60.0, float),
    "rebalance_max_moves": (1, int),
    # Streaming windows (streaming/window.py, RSDL_STREAM_WINDOW_*): a
    # window seals at the first bound hit: admitted file count, admitted
    # payload bytes, or stream-time age since the window's first event.
    # 0 disables a bound (the file count falls back to 1 when every bound
    # is disabled: a window must be closable). An event whose stream
    # timestamp precedes the ingest watermark is late: "admit" rolls it
    # into the open window, "quarantine" excludes it into a report.
    "window_max_files": (4, int),
    "window_max_bytes": (0, int),
    "window_max_wait_s": (0.0, float),
    "window_late_policy": ("admit", str),
    # Sampling profiler (runtime/profiler.py): folded stacks of named
    # threads and per-thread CPU, off by default; the interval bounds
    # its cost (one stack walk per thread per sample).
    "profiler": (False, _parse_bool),
    "profiler_interval_s": (0.01, float),
    # History ring (runtime/history.py): registry snapshots in fixed
    # memory, ticked on the watchdog's monitor thread.
    "history_interval_s": (1.0, float),
    "history_capacity": (600, int),
    # Health detectors (runtime/health.py), judged at every history tick
    # with hysteresis: a breach must persist `health_fire_ticks` ticks to
    # fire, and `health_clear_ticks` clean ticks re-arm the detector.
    "health": (True, _parse_bool),
    "health_fire_ticks": (3, int),
    "health_clear_ticks": (5, int),
    # SLO thresholds (RSDL_SLO_* through the generic rung; the component
    # form, e.g. RSDL_HEALTH_SLO_*, wins over it). Each detector's
    # meaning is beside it in runtime/health.py.
    "slo_droop_pct": (60.0, float),        # rate below (100-x)% of peak
    "slo_droop_floor_eps": (2.0, float),   # least peak (events/s) judged
    "slo_droop_window_ticks": (8, int),    # smoothing window of rates
    "slo_stall_pct": (95.0, float),        # consumer batch-wait share
    "slo_creep_mb_per_min": (512.0, float),  # ledger/RSS growth slope
    "slo_queue_depth": (100000.0, float),  # items in one queue
    "slo_lease_churn_per_min": (3.0, float),
    "slo_straggler_drift_x": (4.0, float),  # straggler over its median
    "slo_delivery_p99_s": (30.0, float),   # windowed birth->delivered p99
    "slo_freshness_s": (120.0, float),     # effective freshness age
    "slo_cache_evictions_per_min": (120.0, float),
    "slo_cache_hit_pct": (10.0, float),
    "slo_watermark_lag_s": (300.0, float),  # stream seconds served late
    # Incident capsules (runtime/health.py): where they land ("": the
    # trace dir, else the telemetry dump dir, else the temp dir), the
    # profiler burst's seconds, and how long a capture waits for the
    # signalled processes' trace dumps.
    "incident_dir": ("", str),
    "incident_profile_s": (0.25, float),
    "incident_wait_s": (2.0, float),
}

_ALL_KEYS = {**_KEYS, **_ENGINE_KEYS}

_lock = threading.Lock()
#: component -> {key -> default} registered by embedding applications.
_component_defaults: Dict[str, Dict[str, Any]] = {}


def _check_key(key: str) -> None:
    if key not in _ALL_KEYS:
        raise ValueError(f"unknown policy key {key!r} "
                         f"(known: {sorted(_ALL_KEYS)})")


def register_defaults(component: str, **defaults: Any) -> None:
    """Override library defaults for one component (environment variables
    still win over these)."""
    for key in defaults:
        _check_key(key)
    with _lock:
        _component_defaults.setdefault(component, {}).update(defaults)


def _env_raw(component: str, key: str) -> Optional[str]:
    for name in (f"RSDL_{component.upper()}_{key.upper()}",
                 f"RSDL_{key.upper()}"):
        raw = os.environ.get(name)
        if raw is not None and raw.strip() != "":
            return raw
    return None


def resolve(component: str, key: str, override: Any = None,
            default: Any = None) -> Any:
    """Resolve one key for a component (the module docstring's order).
    ``override`` is the explicit-kwarg rung (``None``: not given);
    ``default`` replaces the library default, the lowest rung."""
    _check_key(key)
    library_default, parser = _ALL_KEYS[key]
    if override is not None:
        return parser(override) if isinstance(override, str) else override
    raw = _env_raw(component, key)
    if raw is not None:
        return parser(raw)
    with _lock:
        component_default = _component_defaults.get(component, {})
        if key in component_default:
            return component_default[key]
    return library_default if default is None else default


def resolve_all(component: str, **overrides: Any) -> Dict[str, Any]:
    """Resolve every device-binding and retry key for a component (the
    loader's ``runtime_policy``); ``overrides`` are explicit kwargs
    (unknown keys raise, so typos fail loudly)."""
    unknown = set(overrides) - set(_KEYS)
    if unknown:
        raise ValueError(f"unknown policy keys: {sorted(unknown)} "
                         f"(known: {sorted(_KEYS)})")
    return {key: resolve(component, key, overrides.get(key))
            for key in _KEYS}


def describe(component: str = "library") -> Dict[str, Any]:
    """Every key resolved for ``component``: the snapshot an incident
    capsule keeps."""
    return {key: resolve(component, key) for key in _ALL_KEYS}
