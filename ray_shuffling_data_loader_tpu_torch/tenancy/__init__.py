"""Multi-tenant identity: who is asking for bytes, and on what terms
(own copy of the JAX package's ``tenancy/``; host code, imports no torch,
so the queue server's process loads it).

Every plane in this repo — the sharded queue service, the tiered
storage cache, the plan-driven prefetcher, the streaming runner —
was built assuming ONE job reading ONE dataset. Nothing stops a
lagging trainer's replay from starving a live stream's watermark, or
one tenant's cold scan from thrashing another tenant's hot cache
tier. This package is the missing policy layer: a
:class:`TenantContext` names the principal and carries its priority
class, quotas and SLO targets; the context is threaded from dataset /
stream construction through the plan IR (``EpochSpec.tenant_id``),
queue leases and the wire protocol, so every byte in flight is
attributable — and therefore schedulable (:mod:`tenancy.fairshare`),
admittable (:mod:`tenancy.admission`) and cacheable under per-tenant
quotas (storage/cache.py).

Identity propagation is deliberately two-channel:

- **structural** — plan specs and server config carry ``tenant_id`` /
  a ``tenants`` table, so the server can attribute work even for
  legacy clients that never heard of tenancy;
- **ambient** — a contextvar (:func:`tenant_scope` /
  :func:`current_tenant`) so deep call sites (cache ``put``, prefetch
  ``warm``) can attribute bytes without threading a parameter through
  every signature. The default tenant makes single-tenant
  deployments behave exactly as before this package existed.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import re
from typing import Dict, Iterator, Optional

#: Priority classes and the weight each implies when the context does
#: not pin one explicitly. Weights are RATIOS (3:1 interactive:batch
#: means 3x the shared byte budget under contention), not absolutes.
PRIORITY_WEIGHTS: Dict[str, float] = {
    "batch": 1.0,
    "standard": 2.0,
    "interactive": 4.0,
}

#: Tenant ids are label values (metrics) and journal keys: lowercase,
#: bounded, no whitespace — the same shape every other bounded label
#: in runtime/metric_names.py keeps.
_TENANT_ID_RE = re.compile(r"^[a-z0-9][a-z0-9_.-]{0,63}$")


def validate_tenant_id(tenant_id: str) -> str:
    """Return ``tenant_id`` or raise ``ValueError`` — ids become metric
    labels and journal keys, so the vocabulary must stay bounded and
    shell/JSON-safe."""
    if not isinstance(tenant_id, str) or not _TENANT_ID_RE.match(tenant_id):
        raise ValueError(
            f"invalid tenant id {tenant_id!r}: want ^[a-z0-9][a-z0-9_.-]"
            "{0,63}$ (it becomes a metric label and a journal key)")
    return tenant_id


@dataclasses.dataclass(frozen=True)
class TenantContext:
    """One tenant's identity + service terms, immutable and serializable.

    ``weight`` is the fair-share ratio the queue scheduler honors under
    contention; when ``None`` it derives from ``priority`` via
    :data:`PRIORITY_WEIGHTS`. Quotas are ``None`` = unlimited, so a
    default-constructed context changes nothing for existing callers.
    """

    tenant_id: str
    priority: str = "standard"
    weight: Optional[float] = None
    #: Storage-plane quotas: resident cache bytes / prefetch bytes this
    #: tenant may pin (None = share the global budget unpartitioned).
    cache_quota_bytes: Optional[int] = None
    prefetch_quota_bytes: Optional[int] = None
    #: Admission-time byte ask (dataset/stream working set estimate).
    byte_quota: Optional[int] = None
    #: SLO targets the health plane evaluates per tenant.
    slo_p99_ms: Optional[float] = None
    slo_freshness_s: Optional[float] = None

    def __post_init__(self):
        validate_tenant_id(self.tenant_id)
        if self.priority not in PRIORITY_WEIGHTS:
            raise ValueError(
                f"unknown priority {self.priority!r}: "
                f"want one of {sorted(PRIORITY_WEIGHTS)}")
        if self.weight is not None and not self.weight > 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")

    @property
    def effective_weight(self) -> float:
        return (self.weight if self.weight is not None
                else PRIORITY_WEIGHTS[self.priority])

    def to_dict(self) -> dict:
        """Canonical dict: sorted keys, ``None`` fields omitted — the
        journal/wire form, stable across processes and releases."""
        d = {"tenant_id": self.tenant_id, "priority": self.priority}
        for field in ("weight", "cache_quota_bytes",
                      "prefetch_quota_bytes", "byte_quota",
                      "slo_p99_ms", "slo_freshness_s"):
            value = getattr(self, field)
            if value is not None:
                d[field] = value
        return dict(sorted(d.items()))

    def to_json(self) -> bytes:
        """Wire blob (OP_TENANT payload): canonical compact JSON."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_dict(cls, data: dict) -> "TenantContext":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @classmethod
    def from_json(cls, blob: bytes) -> "TenantContext":
        return cls.from_dict(json.loads(blob.decode("utf-8")))


#: The tenant every pre-tenancy caller implicitly is. Single-tenant
#: deployments never see quotas, fair-share math or per-tenant metrics
#: beyond this one label.
DEFAULT_TENANT_ID = "default"
DEFAULT_TENANT = TenantContext(DEFAULT_TENANT_ID)

_current: "contextvars.ContextVar[TenantContext]" = contextvars.ContextVar(
    "rsdl_current_tenant", default=DEFAULT_TENANT)


def current_tenant() -> TenantContext:
    """The ambient tenant for this (thread/task) context."""
    return _current.get()


@contextlib.contextmanager
def tenant_scope(ctx: TenantContext) -> Iterator[TenantContext]:
    """Run a block as ``ctx``: deep call sites (cache put, prefetch
    warm) attribute their bytes to it via :func:`current_tenant`."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def resolve(tenant=None) -> TenantContext:
    """Coerce ``tenant`` (context, id string, dict or None) into a
    :class:`TenantContext`; ``None`` means the ambient tenant."""
    if tenant is None:
        return current_tenant()
    if isinstance(tenant, TenantContext):
        return tenant
    if isinstance(tenant, str):
        return TenantContext(tenant)
    if isinstance(tenant, dict):
        return TenantContext.from_dict(tenant)
    raise TypeError(f"cannot resolve tenant from {type(tenant).__name__}")


def tenants_from_config(tenants: Optional[dict]) -> Dict[str, dict]:
    """Normalize a server-config ``tenants`` table
    (``{tenant_id: {"weight": w, "ranks": [...], ...}}``) — validates
    ids, fills weights from priority, leaves extra keys alone."""
    normalized: Dict[str, dict] = {}
    for tenant_id, spec in (tenants or {}).items():
        validate_tenant_id(tenant_id)
        spec = dict(spec or {})
        if spec.get("weight") is None:
            spec["weight"] = PRIORITY_WEIGHTS[
                spec.get("priority", "standard")]
        if not spec["weight"] > 0:
            raise ValueError(
                f"tenant {tenant_id!r}: weight must be > 0")
        normalized[tenant_id] = spec
    return normalized


__all__ = [
    "DEFAULT_TENANT", "DEFAULT_TENANT_ID", "PRIORITY_WEIGHTS",
    "TenantContext", "current_tenant", "resolve", "tenant_scope",
    "tenants_from_config", "validate_tenant_id",
]
