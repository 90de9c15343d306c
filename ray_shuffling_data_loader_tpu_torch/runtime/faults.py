"""Deterministic fault injection (own copy of the JAX package's
``runtime/faults.py``: the spec grammar, the seeded draw and the
injector).

The parser accepts the JAX package's whole set of site names
(:data:`SITES`), so one spec string means the same in both packages. The
port's injection points:

- ``map_read`` (``shuffle.py``): once per map task, before its read, keyed
  ``(epoch, task=file_index)``; an injected fault is a lost map task,
  which the executor's ``task_retries`` or the reduce's lineage recovery
  (``shuffle.EpochLineage``) recomputes;
- ``reduce_gather`` (``shuffle.py``): once per reduce attempt, before it
  gathers its chunks, keyed ``(epoch, task=reducer)``;
- ``spill_write`` / ``spill_read`` (``spill.py``): a failed write keeps
  the table in memory; a failed read-back is recomputed from lineage;
- ``device_transfer``: each host-to-device copy of ``device_dataset``
  (per batch or per bulk chunk), before each attempt, with the loader's
  own copy sequence number as the key;
- ``transport_send`` / ``transport_recv`` (``parallel/transport.py``):
  inside the frame sender and before a receive pops its message, keyed
  ``(epoch, task=reducer)``;
- ``storage_read`` / ``storage_stall`` (``storage/__init__.py``): before
  each fetch of a dataset file by a map, keyed ``(epoch, task=file)``.

The process pool's workers (``procpool.py``) inherit the environment and
so reproduce an ``RSDL_CHAOS_SPEC`` spec at the same sites; a spec
installed programmatically lives in its process only.

The other sites come with the modules that own them. A map's
:class:`QuarantinedFile` report (``on_bad_file="skip"``) lives here too.

A chaos spec (``RSDL_CHAOS_SPEC``, or :func:`install`) is a
comma-separated list of rules::

    rule := site[@rate][:epochN][:taskN|fileN|rankN][:afterN][:xN][:delayN]

    map_read:epoch1:file3        fail the read of file 3 in epoch 1
    map_read:file5:x2            fail file 5's first two reads per epoch
    device_transfer:task3        fail copy attempt 3
    device_transfer@0.05         fail ~5% of copy attempts (seeded)
    device_transfer:delay50      slow every copy attempt by 50 ms

Rules fire per distinct ``(site, epoch, task)`` key: the first matching
call for a key raises :class:`InjectedFault`, later calls pass
(``afterN`` skips the key's first N calls, ``xN`` fails N in a row; every
device copy attempt takes a new key, so these two change nothing there,
while a transport frame's resend and a retried receive reuse theirs). Rate rules draw from a hash of ``(seed, site, epoch, task)``, so
the same seed fails the same keys on any host, in either package.

Stdlib only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

#: Every site name the JAX package registers; a spec naming anything else
#: is rejected at parse time.
SITES = frozenset({
    "map_read", "reduce_gather", "queue_put", "queue_get", "queue_fetch",
    "transport_send", "transport_recv", "spill_write", "spill_read",
    "device_transfer",
    "queue_server_crash", "conn_reset_midframe", "frame_corrupt",
    "ack_lost",
    "storage_read", "storage_stall",
    "member_crash", "member_partition", "member_flap",
    "rebalance_prepare", "rebalance_commit", "rebalance_abort",
})

_SPEC_ENVS = ("RSDL_CHAOS_SPEC", "RSDL_FAULTS_SPEC")
_SEED_ENVS = ("RSDL_CHAOS_SEED", "RSDL_FAULTS_SEED")


@dataclasses.dataclass
class QuarantinedFile:
    """Report for an input file dropped by ``on_bad_file="skip"``: the
    map returns it instead of a map shard, the reduce skips it, and it is
    recorded in ``stats.fault_stats()`` (never silent)."""

    filename: str
    epoch: int
    file_index: int
    error: str
    timestamp: float = dataclasses.field(default_factory=time.time)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class InjectedFault(RuntimeError):
    """Raised by a fault site matched by the active chaos spec."""

    def __init__(self, site: str, epoch: Optional[int],
                 task: Optional[int], rule: str):
        super().__init__(
            f"injected fault at site {site!r} "
            f"(epoch={epoch}, task={task}, rule={rule!r})")
        self.site = site
        self.epoch = epoch
        self.task = task
        self.rule = rule


@dataclasses.dataclass
class ChaosRule:
    """One parsed spec rule (see the module docstring for the grammar)."""

    site: str
    epoch: Optional[int] = None   # None = any epoch
    task: Optional[int] = None    # None = any task
    after: int = 0                # skip the key's first N matching calls
    count: int = 1                # then fail N consecutive calls per key
    rate: Optional[float] = None  # probabilistic gate per key (None = 1.0)
    delay_ms: Optional[int] = None  # slow the call instead of failing it
    text: str = ""                # original rule text, for error messages

    def matches(self, site: str, epoch: Optional[int],
                task: Optional[int]) -> bool:
        if site != self.site:
            return False
        if self.epoch is not None and epoch != self.epoch:
            return False
        if self.task is not None and task != self.task:
            return False
        return True


def _parse_rule(text: str) -> ChaosRule:
    tokens = [t.strip() for t in text.split(":") if t.strip()]
    if not tokens:
        raise ValueError(f"empty chaos rule in spec: {text!r}")
    site_token = tokens[0]
    rate = None
    if "@" in site_token:
        site_token, _, rate_token = site_token.partition("@")
        rate = float(rate_token)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"chaos rate must be in [0, 1]: {text!r}")
    if site_token not in SITES:
        raise ValueError(
            f"unknown chaos site {site_token!r} in rule {text!r} "
            f"(known: {sorted(SITES)})")
    rule = ChaosRule(site=site_token, rate=rate, text=text)
    for token in tokens[1:]:
        for prefix, field in (("epoch", "epoch"), ("file", "task"),
                              ("task", "task"), ("rank", "task"),
                              ("after", "after"),
                              ("delay", "delay_ms"), ("x", "count")):
            if token.startswith(prefix) and token[len(prefix):].isdigit():
                setattr(rule, field, int(token[len(prefix):]))
                break
        else:
            raise ValueError(
                f"bad chaos qualifier {token!r} in rule {text!r} "
                "(expected epochN, taskN/fileN, afterN, xN, or delayN)")
    if rule.count < 1:
        raise ValueError(f"xN count must be >= 1: {text!r}")
    return rule


def parse_spec(spec: str) -> List[ChaosRule]:
    """Parse a full chaos spec string; raises ValueError on any bad rule."""
    return [_parse_rule(part) for part in spec.split(",") if part.strip()]


def _stable_draw(seed: int, site: str, epoch, task) -> float:
    """Deterministic uniform [0, 1) draw keyed by (seed, site, epoch,
    task): the same seed gives the same failures on any host."""
    digest = hashlib.sha256(
        f"{seed}:{site}:{epoch}:{task}".encode()).digest()
    return int.from_bytes(digest[:8], "little") / 2.0**64


class FaultInjector:
    """Active chaos configuration: parsed rules and per-key call counts."""

    def __init__(self, rules: List[ChaosRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._lock = threading.Lock()
        # (rule_index, site, epoch, task) -> matching calls seen so far.
        self._calls: Dict[Tuple, int] = {}
        self._fired: List[dict] = []

    def check(self, site: str, epoch: Optional[int],
              task: Optional[int]) -> Optional[InjectedFault]:
        for index, rule in enumerate(self.rules):
            if not rule.matches(site, epoch, task):
                continue
            key = (index, site, epoch, task)
            with self._lock:
                seen = self._calls.get(key, 0)
                self._calls[key] = seen + 1
            if not rule.after <= seen < rule.after + rule.count:
                continue
            if rule.rate is not None and _stable_draw(
                    self.seed, site, epoch, task) >= rule.rate:
                continue
            with self._lock:
                self._fired.append({
                    "site": site, "epoch": epoch, "task": task,
                    "rule": rule.text, "call": seen,
                })
            if rule.delay_ms is not None:
                # A latency fault: slow the call instead of failing it;
                # later rules may still fail this same call.
                time.sleep(rule.delay_ms / 1e3)
                continue
            return InjectedFault(site, epoch, task, rule.text)
        return None

    def fired(self) -> List[dict]:
        with self._lock:
            return list(self._fired)


# Fast path: inject() sits on the per-copy path, so the inactive case is
# one global load.
_ACTIVE = False
_injector: Optional[FaultInjector] = None
_install_lock = threading.Lock()


def install(spec: str, seed: int = 0) -> FaultInjector:
    """Activate a chaos spec programmatically (tests, the smoke)."""
    global _ACTIVE, _injector
    injector = FaultInjector(parse_spec(spec), seed=seed)
    with _install_lock:
        _injector = injector
        _ACTIVE = bool(injector.rules)
    if injector.rules:
        logger.warning("fault injection ACTIVE: %d rule(s), seed=%d: %s",
                       len(injector.rules), seed, spec)
    return injector


def clear() -> None:
    """Deactivate fault injection (does NOT re-read the environment)."""
    global _ACTIVE, _injector
    with _install_lock:
        _injector = None
        _ACTIVE = False


def active() -> bool:
    """Whether a chaos spec is installed (from the environment or by
    :func:`install`)."""
    return _ACTIVE


def spec_from_env() -> bool:
    """Whether the environment carries a chaos spec: one that the
    process pool's workers, which inherit it, reproduce."""
    return any(os.environ.get(name, "").strip() for name in _SPEC_ENVS)


def configure_from_env() -> Optional[FaultInjector]:
    """(Re-)read ``RSDL_CHAOS_SPEC``/``RSDL_CHAOS_SEED`` (aliases:
    ``RSDL_FAULTS_*``); clears the injector when no spec is set."""
    spec = next((os.environ[name] for name in _SPEC_ENVS
                 if os.environ.get(name, "").strip()), None)
    if spec is None:
        clear()
        return None
    seed = int(next((os.environ[name] for name in _SEED_ENVS
                     if os.environ.get(name, "").strip()), "0"))
    return install(spec, seed=seed)


def inject(site: str, epoch: Optional[int] = None,
           task: Optional[int] = None) -> None:
    """Fault-site hook: raises :class:`InjectedFault` when the active
    spec matches this call; one global load when inactive."""
    if not _ACTIVE:
        return
    injector = _injector
    if injector is None:
        return
    fault = injector.check(site, epoch, task)
    if fault is not None:
        from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
        stats_mod.fault_stats().record_injected(site)
        logger.warning("%s", fault)
        raise fault


# Honour a spec present in the environment at import time, so a program
# run with RSDL_CHAOS_SPEC exported reproduces its failures with no code.
configure_from_env()
