"""Phi-style failure detection over transport heartbeats (own copy of the
JAX package's ``membership/detector.py``).

Heartbeats arrive two ways: on every data frame the generation-fenced
transport accepts (``TcpTransport.set_frame_observer`` hands each accepted
frame's ``src`` to :meth:`FailureDetector.beat`), and from a dedicated
prober (:class:`HeartbeatProber`) that sends heartbeat control frames so
idle links between epochs stay observed. The detector is a pure state
machine with an injectable clock: every verdict is a function of the beat
timeline, so tests drive it with a fake clock and no sleeps.

Suspicion is phi-style: the detector keeps a smoothed inter-arrival
interval per rank (floored at the configured heartbeat cadence) and
computes ``phi = silence / smoothed_interval``. Crossing ``member_phi``
marks the rank SUSPECT, and silence reaching the ``member_suspect_s``
deadline declares it DOWN (the membership transition that starts the
resize). A beat from a SUSPECT rank clears it back to ALIVE.

Hysteresis: one flapping link fires once. After a suspicion clears, a
re-suspicion within one ``suspect_s`` window is a flap: logged and
returned by :meth:`FailureDetector.poll` as ``"flap"``, without the
suspect callback. The state still advances, so a dying rank's DOWN
deadline is never delayed by its own flapping.

Knobs (``runtime/policy.py``, component ``member``):
``RSDL_MEMBER_HEARTBEAT_S``, ``RSDL_MEMBER_SUSPECT_S``,
``RSDL_MEMBER_PHI``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, Optional, Sequence

from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

ALIVE, SUSPECT, DOWN = "alive", "suspect", "down"

#: Inter-arrival samples kept per rank for the smoothed interval.
_WINDOW = 16


class FailureDetector:
    """Per-rank beat bookkeeping -> alive/suspect/down verdicts.

    Callbacks run on whichever thread calls :meth:`poll` (the prober, or a
    test): ``on_suspect(rank)`` once per suspicion episode (flaps left
    out), ``on_down(rank)`` once per down verdict, and ``on_alive(rank)``
    when a suspect rank's beats resume. A DOWN rank stays down until
    :meth:`revive` (the join path) re-arms it.
    """

    def __init__(self, peers: Sequence[int],
                 heartbeat_s: Optional[float] = None,
                 suspect_s: Optional[float] = None,
                 phi_threshold: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_suspect: Optional[Callable[[int], None]] = None,
                 on_down: Optional[Callable[[int], None]] = None,
                 on_alive: Optional[Callable[[int], None]] = None):
        self.heartbeat_s = rt_policy.resolve("member", "member_heartbeat_s",
                                             override=heartbeat_s)
        self.suspect_s = rt_policy.resolve("member", "member_suspect_s",
                                           override=suspect_s)
        self.phi_threshold = rt_policy.resolve("member", "member_phi",
                                               override=phi_threshold)
        self._clock = clock
        self._on_suspect = on_suspect
        self._on_down = on_down
        self._on_alive = on_alive
        self._lock = threading.Lock()
        self._state: Dict[int, str] = {}
        self._last: Dict[int, float] = {}
        self._intervals: Dict[int, Deque[float]] = {}
        # End of each rank's flap window: a suspicion that fires again
        # before this instant is a flap, not a new episode.
        self._quiet_until: Dict[int, float] = {}
        now = self._clock()
        with self._lock:
            for rank in peers:
                self._arm(int(rank), now)

    def _arm(self, rank: int, now: float) -> None:
        # Every caller (init, beat, revive) holds self._lock.
        # rsdl-lint: disable=lock-mutation
        self._state[rank] = ALIVE
        # rsdl-lint: disable=lock-mutation
        self._last[rank] = now
        self._intervals[rank] = collections.deque(maxlen=_WINDOW)
        self._quiet_until.pop(rank, None)

    # -- inputs --------------------------------------------------------------

    def beat(self, rank: int, now: Optional[float] = None) -> None:
        """One heartbeat observation (a data frame or a probe)."""
        rank = int(rank)
        now = self._clock() if now is None else now
        cleared = False
        with self._lock:
            if self._state.get(rank) == DOWN:
                return  # a down verdict is final until revive()
            if rank not in self._state:
                self._arm(rank, now)
            else:
                self._intervals[rank].append(
                    max(0.0, now - self._last[rank]))
                self._last[rank] = now
            if self._state[rank] == SUSPECT:
                self._state[rank] = ALIVE
                # A re-suspicion within one suspect_s of this clear is a
                # flap.
                self._quiet_until[rank] = now + self.suspect_s
                cleared = True
        rt_metrics.counter("rsdl_member_heartbeats_total",
                           "heartbeats observed by the failure "
                           "detector").inc()
        if cleared:
            logger.info("failure detector: rank %d suspect cleared "
                        "(beats resumed)", rank)
            if self._on_alive is not None:
                self._on_alive(rank)

    def revive(self, rank: int, now: Optional[float] = None) -> None:
        """Re-arm a DOWN rank (the member_join path)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._arm(int(rank), now)

    def forget(self, rank: int) -> None:
        """Stop tracking a rank that left the world on purpose."""
        with self._lock:
            for table in (self._state, self._last, self._intervals,
                          self._quiet_until):
                table.pop(int(rank), None)

    # -- verdicts ------------------------------------------------------------

    def phi(self, rank: int, now: Optional[float] = None) -> float:
        """Suspicion level: silence in smoothed inter-arrival units (0.0
        for a rank untracked or just armed)."""
        now = self._clock() if now is None else now
        with self._lock:
            return self._phi_locked(int(rank), now)

    def _phi_locked(self, rank: int, now: float) -> float:
        last = self._last.get(rank)
        if last is None:
            return 0.0
        intervals = self._intervals.get(rank)
        if intervals:
            smoothed = max(self.heartbeat_s,
                           sum(intervals) / len(intervals))
        else:
            smoothed = self.heartbeat_s
        return max(0.0, now - last) / smoothed

    def state(self, rank: int) -> str:
        with self._lock:
            return self._state.get(int(rank), DOWN)

    def poll(self, now: Optional[float] = None) -> Dict[int, str]:
        """Evaluate every tracked rank and run the transition callbacks.
        Returns ``{rank: transition}`` for the ranks that changed state in
        this poll (``suspect``/``down``; a suppressed suspicion shows as
        ``flap``)."""
        now = self._clock() if now is None else now
        transitions: Dict[int, str] = {}
        suspect_cbs, down_cbs, flap_cbs = [], [], []
        with self._lock:
            for rank, state in list(self._state.items()):
                if state == DOWN:
                    continue
                silence = now - self._last[rank]
                if silence >= self.suspect_s:
                    self._state[rank] = DOWN
                    transitions[rank] = DOWN
                    down_cbs.append(rank)
                    continue
                if state == ALIVE and \
                        self._phi_locked(rank, now) >= self.phi_threshold:
                    self._state[rank] = SUSPECT
                    if now < self._quiet_until.get(rank, 0.0):
                        transitions[rank] = "flap"
                        flap_cbs.append(rank)
                    else:
                        transitions[rank] = SUSPECT
                        suspect_cbs.append(rank)
        for rank in flap_cbs:
            logger.warning("failure detector: rank %d flapping "
                           "(re-suspected inside the hysteresis window; "
                           "suppressed)", rank)
        for rank in suspect_cbs:
            logger.warning("failure detector: rank %d SUSPECT "
                           "(phi >= %.1f)", rank, self.phi_threshold)
            if self._on_suspect is not None:
                self._on_suspect(rank)
        for rank in down_cbs:
            logger.error("failure detector: rank %d DOWN (silent for "
                         ">= %.1fs)", rank, self.suspect_s)
            if self._on_down is not None:
                self._on_down(rank)
        return transitions


class HeartbeatProber:
    """The prober thread: every ``interval_s`` (default: the detector's
    ``heartbeat_s``) it sends one heartbeat control frame to each peer the
    transport has dialed and polls the detector. The ``member_flap`` chaos
    site fires here: a matched ``(None, task=peer)`` key drops that peer's
    probe for the round, starving the peer's detector as a flapping link
    would."""

    def __init__(self, transport, detector: FailureDetector,
                 interval_s: Optional[float] = None):
        self._transport = transport
        self._detector = detector
        self._interval_s = (detector.heartbeat_s if interval_s is None
                            else interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatProber":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"rsdl-member-prober-{self._transport.host_id}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            for peer in self._transport.known_peers():
                try:
                    rt_faults.inject("member_flap", task=peer)
                except rt_faults.InjectedFault:
                    rt_telemetry.record("member_flap", task=peer,
                                        fault="probe_dropped")
                    continue
                self._transport.send_heartbeat(peer)
            self._detector.poll()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


__all__ = ["FailureDetector", "HeartbeatProber", "ALIVE", "SUSPECT",
           "DOWN"]
