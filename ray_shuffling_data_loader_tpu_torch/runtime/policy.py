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
``RSDL_LINEAGE_RETRY_MAX_ATTEMPTS``, ...).

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
