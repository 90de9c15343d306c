"""End-to-end delivery latency: birth stamps and cross-process clock math
(own copy of the JAX package's ``runtime/latency.py``: the same stamp
encoding, hops and metric names).

**Birth stamps.** A :class:`Stamp` is ``(pid, t_mono, t_unix)`` taken
where a reducer output is built and carried as ``rsdl.birth`` schema
metadata beside the ``rsdl.trace`` lineage key (shuffle.py), through the
process pool's shared-memory segments too. ``t_mono``
(``CLOCK_MONOTONIC``) is system-wide on Linux, so any reader on the same
host computes an exact latency as ``now_mono - t_mono``. ``t_unix`` is
the cross-host fallback: :class:`ClockAnchors` re-anchors the wall delta
per producer pid (the most negative wall delta seen from a pid bounds its
skew, since a latency is never negative), so a consumer never reports a
negative latency.

**Hops.** Each hop is a fixed ``hop`` label on the
``rsdl_delivery_latency_seconds`` sketch (fixed centroids: exact under
cross-process summing). The port observes the hops that exist without a
serving plane:

========================  ==================================================
``birth_to_delivered``    reducer output built -> the consumer took it off
                          its queue
``birth_to_device``       reducer output built -> the device copy of its
                          rows was issued
``delivered_to_device``   consumer received the table -> device copy issued
========================  ==================================================

``birth_to_queued`` and ``queued_to_delivered`` (a queue server's frame)
are kept as names and unobserved. The ``queue`` label is the trainer
rank, never a queue id or a sequence number, so the family's cardinality
stays fixed.

Stdlib-only: the process pool's workers load it without torch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics

__all__ = [
    "Stamp", "now_stamp", "encode_stamp", "parse_stamp", "ClockAnchors",
    "HOP_BIRTH_TO_QUEUED", "HOP_QUEUED_TO_DELIVERED",
    "HOP_BIRTH_TO_DELIVERED", "HOP_BIRTH_TO_DEVICE",
    "HOP_DELIVERED_TO_DEVICE", "HOPS", "DELIVERY_METRIC",
    "FRESHNESS_METRIC", "observe_hop", "set_freshness", "LatencyProbe",
]

HOP_BIRTH_TO_QUEUED = "birth_to_queued"
HOP_QUEUED_TO_DELIVERED = "queued_to_delivered"
HOP_BIRTH_TO_DELIVERED = "birth_to_delivered"
HOP_BIRTH_TO_DEVICE = "birth_to_device"
HOP_DELIVERED_TO_DEVICE = "delivered_to_device"
HOPS: Tuple[str, ...] = (
    HOP_BIRTH_TO_QUEUED, HOP_QUEUED_TO_DELIVERED, HOP_BIRTH_TO_DELIVERED,
    HOP_BIRTH_TO_DEVICE, HOP_DELIVERED_TO_DEVICE)

DELIVERY_METRIC = "rsdl_delivery_latency_seconds"
FRESHNESS_METRIC = "rsdl_delivery_freshness_seconds"

#: Mono deltas outside [0, this] are treated as cross-boot/cross-host
#: (different CLOCK_MONOTONIC epochs compare as garbage) and the wall
#: fallback takes over. Generous: no frame legitimately ages 6h.
MONO_PLAUSIBLE_HORIZON_S = 6 * 3600.0
#: A mono delta may read a hair negative when two processes race the
#: same clock tick; treat within this of zero as zero, not cross-host.
_MONO_EPS_S = 0.005

#: ``rsdl.birth`` schema-metadata key (next to ``rsdl.trace``).
BIRTH_META_KEY = b"rsdl.birth"


class Stamp(NamedTuple):
    """One birth/queued timestamp: producing pid + both clocks."""

    pid: int
    t_mono: float
    t_unix: float


def now_stamp() -> Stamp:
    # Wall + mono sampled together form this stamp's clock anchor — the
    # pairing is the point, not an interval: rsdl-lint: disable=wallclock-interval
    return Stamp(os.getpid(), time.monotonic(), time.time())


def encode_stamp(stamp: Stamp) -> bytes:
    """``b"pid:mono:unix"`` for Arrow schema metadata (survives slicing,
    IPC, spill files and the queue wire, like ``rsdl.trace``)."""
    return f"{stamp.pid}:{stamp.t_mono!r}:{stamp.t_unix!r}".encode()


def parse_stamp(raw) -> Optional[Stamp]:
    """Inverse of :func:`encode_stamp`; None for absent/corrupt input
    (observability parsing must never raise into the data path)."""
    if not raw:
        return None
    try:
        if isinstance(raw, (bytes, bytearray, memoryview)):
            raw = bytes(raw).decode()
        pid_txt, mono_txt, unix_txt = str(raw).split(":")
        return Stamp(int(pid_txt), float(mono_txt), float(unix_txt))
    except (ValueError, TypeError):
        return None


class ClockAnchors:
    """Per-producer-pid latency math that can never go negative.

    Same host (the shipped topology): ``CLOCK_MONOTONIC`` is one
    boot-wide clock shared by every process, so ``now_mono - t_mono``
    is exact whatever the wall clock does — a stepped/skewed wall clock
    cannot touch it (the skewed-anchor regression test pins this).

    Cross host / cross boot: the mono delta is garbage (different
    epochs), detected by implausibility (negative beyond jitter, or
    past :data:`MONO_PLAUSIBLE_HORIZON_S`). The wall delta is then the
    only signal, and it carries the constant inter-host skew. The
    re-anchor, per producer pid: delivery latency is non-negative by
    causality, so the minimum wall delta ever observed from that pid is
    an upper bound on its (negative) skew — track it as the pid's
    anchor floor and subtract it, clamping at zero. A pid whose clock
    runs AHEAD of ours therefore reports 0 on its fastest-ever frame
    and honest relative latencies after, instead of negatives.
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: pid -> most-negative wall delta seen (only kept when < 0).
        self._wall_floor: Dict[int, float] = {}

    def latency_s(self, stamp: Optional[Stamp],
                  now_mono: Optional[float] = None,
                  now_unix: Optional[float] = None) -> Optional[float]:
        """Seconds since ``stamp``, re-anchored; None for no stamp."""
        if stamp is None:
            return None
        if now_mono is None:
            now_mono = time.monotonic()
        if now_unix is None:
            # Paired with now_mono above — a two-clock sample, not an
            # interval: rsdl-lint: disable=wallclock-interval
            now_unix = time.time()
        lat_mono = now_mono - stamp.t_mono
        if -_MONO_EPS_S <= lat_mono <= MONO_PLAUSIBLE_HORIZON_S:
            return max(0.0, lat_mono)
        # Cross-host fallback: wall delta is the ONLY available signal
        # once mono epochs differ, and the per-pid floor below is the
        # skew correction this rule exists to demand.
        # rsdl-lint: disable=wallclock-interval
        lat_wall = now_unix - stamp.t_unix
        with self._lock:
            floor = self._wall_floor.get(stamp.pid, 0.0)
            if lat_wall < floor:
                floor = self._wall_floor[stamp.pid] = lat_wall
        return max(0.0, lat_wall - min(0.0, floor))


def observe_hop(hop: str, queue: str, latency_s: Optional[float]) -> None:
    """One sketch observation on the delivery-latency plane; None is a
    no-op so call sites never guard the stamp-parsing result."""
    if latency_s is None:
        return
    rt_metrics.sketch(
        DELIVERY_METRIC,
        "frame delivery latency per hop (queue label = trainer rank)",
        hop=hop, queue=queue).observe(latency_s)


def set_freshness(queue: str, age_s: Optional[float]) -> None:
    """Refresh a queue's freshness gauge: the birth age of the NEWEST
    payload that completed the consumer's final hop. The freshness_stall
    detector adds the gauge's own staleness on top, so a pipeline that
    stops delivering is caught even though the gauge stops moving."""
    if age_s is None:
        return
    rt_metrics.gauge(
        FRESHNESS_METRIC,
        "birth age of the newest payload at the consumer's last hop",
        queue=queue).set(age_s)


class LatencyProbe:
    """Consumer-side probe closing the loop at the device boundary.

    One per consuming dataset (``queue`` = its trainer rank). The table
    path calls :meth:`table_arrived` where a raw reducer table lands
    (parsing its ``rsdl.birth`` metadata once); the transfer path calls
    :meth:`device_done` when a device transfer completes — observing
    ``delivered_to_device`` and ``birth_to_device`` and refreshing the
    freshness gauge. Bulk paths transfer multi-batch spans of one table,
    so the probe's granularity is per-table — exactly the granularity
    the birth stamp has.
    """

    __slots__ = ("queue", "anchors", "_birth", "_arrived_mono",
                 "observe_delivered")

    def __init__(self, queue: str, anchors: Optional[ClockAnchors] = None,
                 observe_delivered: bool = False):
        self.queue = str(queue)
        self.anchors = anchors or ClockAnchors()
        self._birth: Optional[Stamp] = None
        self._arrived_mono: Optional[float] = None
        #: Also observe ``birth_to_delivered`` at arrival — for sources
        #: (in-process queues) where no wire client observed it already.
        self.observe_delivered = observe_delivered

    def table_arrived(self, table) -> None:
        meta = getattr(getattr(table, "schema", None), "metadata", None)
        self._birth = parse_stamp(meta.get(BIRTH_META_KEY)) if meta else None
        self._arrived_mono = time.monotonic()
        if self.observe_delivered and self._birth is not None:
            observe_hop(HOP_BIRTH_TO_DELIVERED, self.queue,
                        self.anchors.latency_s(self._birth))

    def device_done(self) -> None:
        now = time.monotonic()
        if self._arrived_mono is not None:
            observe_hop(HOP_DELIVERED_TO_DEVICE, self.queue,
                        max(0.0, now - self._arrived_mono))
        if self._birth is not None:
            age = self.anchors.latency_s(self._birth, now_mono=now)
            observe_hop(HOP_BIRTH_TO_DEVICE, self.queue, age)
            set_freshness(self.queue, age)
