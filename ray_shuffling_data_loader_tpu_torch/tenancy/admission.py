"""Admission control: accept / queue / reject registrations against
cluster-wide quota ledgers, with a journaled, bit-identically
replayable decision log (own copy of the JAX package's
``tenancy/admission.py``; a journal written by either package replays
in the other).

Fair-share scheduling (tenancy/fairshare.py) divides capacity among
work ALREADY admitted; this module decides whether new work gets in
at all. A registration is one dataset or stream a tenant wants served
(its estimated working-set bytes are the ask). The controller holds a
:class:`QuotaLedger` of cluster capacity and per-tenant usage and
makes a three-way decision:

``reject``  the ask can NEVER fit (exceeds the tenant's own byte
            quota or the whole cluster capacity, or duplicates a
            registration already charged/queued) — telling the tenant
            now beats queueing it forever;
``queue``   the ask fits in principle but not right now — it waits
            FIFO and is admitted automatically as releases free bytes;
``accept``  charged to the ledger immediately.

Determinism is the design constraint, not an afterthought: decisions
are pure functions of (journal history, request), with no wall clock,
no randomness, no dict-order dependence — so the journal REPLAYS:
:func:`replay` feeds the journaled requests through a fresh
controller and must re-derive byte-identical journal lines. That is
the recovery story (a restarted controller rebuilds its ledger from
the journal alone) and the audit story (any disagreement between a
journal and its replay is evidence of corruption or version skew, and
raises).

Journal format: one canonical JSON object per line (sorted keys,
compact separators, ``\\n`` terminator), append-only, fsync'd per
record — the same discipline as the queue journal's watermarks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.tenancy import (
    TenantContext, validate_tenant_id)

_ACTIONS = ("accept", "queue", "reject", "admit", "release")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """One journaled decision. ``seq`` is the journal position (the
    total order); ``action`` is one of accept/queue/reject for
    register events, admit for a queued request promoted by a release,
    release for freed capacity."""

    seq: int
    action: str
    tenant_id: str
    kind: str  # "dataset" | "stream"
    name: str
    nbytes: int
    reason: str = ""

    def to_line(self) -> bytes:
        d = dict(sorted(dataclasses.asdict(self).items()))
        return (json.dumps(d, sort_keys=True,
                           separators=(",", ":")) + "\n").encode("utf-8")

    @classmethod
    def from_line(cls, line: bytes) -> "AdmissionDecision":
        return cls(**json.loads(line.decode("utf-8")))


class QuotaLedger:
    """Cluster capacity and per-tenant charges, in bytes and
    registration slots. Pure bookkeeping — policy lives in the
    controller."""

    def __init__(self, capacity_bytes: int,
                 max_registrations: Optional[int] = None):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be > 0")
        self.capacity_bytes = capacity_bytes
        self.max_registrations = max_registrations
        self._used_bytes = 0
        self._charges: Dict[Tuple[str, str], int] = {}  # (tenant, name)
        self._tenant_bytes: Dict[str, int] = {}

    @property
    def used_bytes(self) -> int:
        return self._used_bytes

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self._used_bytes

    @property
    def registrations(self) -> int:
        return len(self._charges)

    def tenant_bytes(self, tenant_id: str) -> int:
        return self._tenant_bytes.get(tenant_id, 0)

    def charged(self, tenant_id: str, name: str) -> bool:
        return (tenant_id, name) in self._charges

    def fits(self, nbytes: int) -> bool:
        if self.max_registrations is not None \
                and len(self._charges) >= self.max_registrations:
            return False
        return self._used_bytes + nbytes <= self.capacity_bytes

    def charge(self, tenant_id: str, name: str, nbytes: int) -> None:
        key = (tenant_id, name)
        if key in self._charges:
            raise ValueError(f"{tenant_id!r}/{name!r} already charged")
        self._charges[key] = nbytes
        self._used_bytes += nbytes
        self._tenant_bytes[tenant_id] = \
            self._tenant_bytes.get(tenant_id, 0) + nbytes

    def release(self, tenant_id: str, name: str) -> int:
        nbytes = self._charges.pop((tenant_id, name), 0)
        self._used_bytes -= nbytes
        if nbytes:
            self._tenant_bytes[tenant_id] = \
                self._tenant_bytes.get(tenant_id, 0) - nbytes
        return nbytes

    def snapshot(self) -> dict:
        return {
            "capacity_bytes": self.capacity_bytes,
            "used_bytes": self._used_bytes,
            "registrations": len(self._charges),
            "per_tenant_bytes": dict(sorted(self._tenant_bytes.items())),
        }


class AdmissionController:
    """Journaled admission over one :class:`QuotaLedger`.

    ``journal_path=None`` keeps the journal in memory only (unit tests,
    ephemeral servers); with a path every decision line is appended and
    fsync'd before the decision is returned, so an accepted tenant is
    accepted across a crash.
    """

    def __init__(self, capacity_bytes: int,
                 max_registrations: Optional[int] = None,
                 journal_path: Optional[str] = None):
        self.ledger = QuotaLedger(capacity_bytes, max_registrations)
        self.journal_path = journal_path
        self._lock = threading.Lock()
        self._seq = 0
        self._lines: List[bytes] = []
        # FIFO of queued asks: (tenant_ctx_dict, kind, name, nbytes)
        self._waiting: Deque[Tuple[dict, str, str, int]] = deque()
        self._fh = None
        if journal_path is not None:
            os.makedirs(os.path.dirname(journal_path) or ".",
                        exist_ok=True)
            self._fh = open(journal_path, "ab")

    # -- journal -------------------------------------------------------

    def _journal(self, decision: AdmissionDecision) -> AdmissionDecision:
        line = decision.to_line()
        self._lines.append(line)
        if self._fh is not None:
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        rt_metrics.counter(
            "rsdl_admission_decisions_total",
            "admission decisions by action",
            action=decision.action).inc()
        rt_metrics.gauge(
            "rsdl_admission_waiting",
            "registrations queued behind the quota ledger").set(
            len(self._waiting))
        rt_metrics.gauge(
            "rsdl_admission_used_bytes",
            "bytes charged to the admission quota ledger").set(
            self.ledger.used_bytes)
        return decision

    def journal_bytes(self) -> bytes:
        """The full journal as emitted (the replay-comparison target)."""
        with self._lock:
            return b"".join(self._lines)

    # -- decisions -----------------------------------------------------

    def _decide_locked(self, tenant: TenantContext, kind: str, name: str,
                       nbytes: int) -> AdmissionDecision:
        # Caller holds _lock (the _locked suffix is the contract).
        # rsdl-lint: disable=lock-mutation
        self._seq += 1
        seq = self._seq
        tid = tenant.tenant_id
        if nbytes < 0:
            return AdmissionDecision(seq, "reject", tid, kind, name,
                                     nbytes, "negative byte ask")
        if self.ledger.charged(tid, name) or any(
                w[0]["tenant_id"] == tid and w[2] == name
                for w in self._waiting):
            # A retry of an already-accepted (or already-queued) ask is
            # the crash-recovery scenario the journal must survive: it
            # MUST become a journaled, deterministic decision here. If
            # it instead escaped to ledger.charge (which raises), the
            # seq this call already consumed would never be journaled,
            # and every subsequent replay() of an otherwise-valid
            # journal would diverge on the gap.
            return AdmissionDecision(
                seq, "reject", tid, kind, name, nbytes,
                "duplicate registration (already charged or queued)")
        if tenant.byte_quota is not None and \
                self.ledger.tenant_bytes(tid) + nbytes > tenant.byte_quota:
            return AdmissionDecision(
                seq, "reject", tid, kind, name, nbytes,
                f"tenant byte quota exceeded "
                f"({self.ledger.tenant_bytes(tid)}+{nbytes}"
                f">{tenant.byte_quota})")
        if nbytes > self.ledger.capacity_bytes:
            return AdmissionDecision(
                seq, "reject", tid, kind, name, nbytes,
                f"ask exceeds cluster capacity "
                f"({nbytes}>{self.ledger.capacity_bytes})")
        if not self.ledger.fits(nbytes):
            return AdmissionDecision(
                seq, "queue", tid, kind, name, nbytes,
                f"waiting for {nbytes - self.ledger.free_bytes} bytes")
        return AdmissionDecision(seq, "accept", tid, kind, name, nbytes)

    def register(self, tenant: TenantContext, kind: str, name: str,
                 nbytes: int) -> AdmissionDecision:
        """Ask to serve one dataset/stream of ``nbytes`` working set."""
        validate_tenant_id(tenant.tenant_id)
        if kind not in ("dataset", "stream"):
            raise ValueError(f"kind must be dataset|stream, got {kind!r}")
        with self._lock:
            decision = self._decide_locked(tenant, kind, name, nbytes)
            if decision.action == "accept":
                self.ledger.charge(tenant.tenant_id, name, nbytes)
            elif decision.action == "queue":
                self._waiting.append(
                    (tenant.to_dict(), kind, name, nbytes))
            return self._journal(decision)

    def release(self, tenant_id: str, name: str) -> List[AdmissionDecision]:
        """Free a registration's bytes and admit waiting asks FIFO.
        Returns the journaled decisions (the release plus any
        admits)."""
        with self._lock:
            freed = self.ledger.release(tenant_id, name)
            self._seq += 1
            out = [self._journal(AdmissionDecision(
                self._seq, "release", tenant_id, "dataset", name, freed))]
            # FIFO admit: head-of-line blocking is deliberate — skipping
            # over a large queued ask to admit a small one behind it
            # would starve the large tenant forever.
            while self._waiting:
                ctx_dict, kind, wname, wbytes = self._waiting[0]
                if not self.ledger.fits(wbytes):
                    break
                self._waiting.popleft()
                wtid = ctx_dict["tenant_id"]
                self.ledger.charge(wtid, wname, wbytes)
                self._seq += 1
                out.append(self._journal(AdmissionDecision(
                    self._seq, "admit", wtid, kind, wname, wbytes)))
            return out

    def waiting(self) -> int:
        with self._lock:
            return len(self._waiting)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def replay(journal_path: str, capacity_bytes: int,
           max_registrations: Optional[int] = None,
           tenants: Optional[Dict[str, TenantContext]] = None
           ) -> AdmissionController:
    """Rebuild a controller from its journal and PROVE the rebuild: the
    journaled register/release events are re-fed through a fresh
    controller, and the re-derived journal must be byte-identical to
    the file — any divergence raises ``ValueError`` (corruption or
    version skew). Returns the rebuilt controller (in-memory journal;
    callers re-attach a path for new decisions)."""
    with open(journal_path, "rb") as f:
        original = f.read()
    decisions = [AdmissionDecision.from_line(line)
                 for line in original.splitlines(keepends=False) if line]
    fresh = AdmissionController(capacity_bytes, max_registrations)
    tenants = tenants or {}
    for d in decisions:
        if d.action in ("accept", "queue", "reject"):
            ctx = tenants.get(d.tenant_id)
            if ctx is None:
                ctx = TenantContext(d.tenant_id)
            fresh.register(ctx, d.kind, d.name, d.nbytes)
        elif d.action == "release":
            fresh.release(d.tenant_id, d.name)
        # "admit" lines are DERIVED (a release replays them), never fed
    rederived = fresh.journal_bytes()
    if rederived != original:
        raise ValueError(
            "admission journal replay diverged: re-derived "
            f"{len(rederived)} bytes != journaled {len(original)} bytes "
            "(corruption, version skew, or a tenant context whose "
            "quotas changed since the journal was written)")
    return fresh


__all__ = ["AdmissionController", "AdmissionDecision", "QuotaLedger",
           "replay"]
