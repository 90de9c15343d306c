"""Tagged TCP byte transport for the cross-host shuffle traffic (own copy of
the JAX package's ``parallel/transport.py``).

One listener per host, one persistent connection per peer, length-prefixed
frames tagged ``(epoch, reducer, file_index)`` and a blocking tag-matched
receive. Payloads are raw bytes (the shuffle sends Arrow IPC streams).
A payload is received into a buffer of the native buffer pool
(``native.alloc_tracked_buffer``), charged to the pipeline's ledger until
the last reference to it (the table deserialized over it included) is
gone. Payloads of ``_NATIVE_PUMP_MIN_BYTES`` (1 MB) and more go through
the native pump: one GIL-free ``writev`` per frame sent
(``native.frame_send``) and one GIL-free read loop per payload received
(``native.read_exact_into``); smaller ones through ``socket.sendall`` and
``recv_into``, which are as fast there. :meth:`TcpTransport.stats`
splits the frames and bytes by path.

Wire format of a frame (the JAX package's v2, generation-fenced),
little-endian::

    magic       u32 = 0x5244534C ("RSDL")
    src         u32   sending host id
    incarnation u32   sender's process generation (``membership/``)
    view        u32   sender's membership view id at send time
    epoch       u64   (2**64 - 1: a heartbeat control frame, no payload)
    reducer     u64
    file        u64
    length      u64   payload byte count
    payload     length bytes

A port transport and a JAX transport exchange frames, heartbeats included,
in both directions.

Generation fencing: every frame carries the sender's ``(incarnation,
view)``. The receiver keeps the highest incarnation seen per source and
drops, loudly (a warning, ``rsdl_member_fenced_frames_total`` and a
``member_fenced_frame`` record), any frame from an older incarnation (a
zombie process from before a kill, still flushing its socket) or stamped
with a view below the :meth:`TcpTransport.fence_view` floor. The fence is
decided on the header, before a ledger-tracked buffer is charged: a fenced
payload is read off the socket into a scratch buffer and discarded. A
rejoined rank announces itself (:meth:`TcpTransport.announce`): its first
frame's higher incarnation raises the fence. Heartbeat frames go to the
frame observer (:meth:`TcpTransport.set_frame_observer`, the failure
detector's feed, which also sees every accepted data frame) and never into
the inbox. The ``member_partition`` fault site drops a data frame or a
heartbeat to the matched dest silently.

Delivery: each message is consumed exactly once; a frame whose
``(src, tag)`` is already in the inbox or was already consumed (a
sender's resend after a reconnect, or a retried map's) is dropped with a
warning. A send that fails redials the peer
once and resends. A connection that dies mid-frame marks the sources it
carried dead; a ``recv`` from a dead source fails after
``reconnect_grace_s`` unless a frame from it arrives on a new connection
first, and any ``recv`` fails with :class:`TransportTimeout` after
``recv_timeout_s``. The fault sites ``transport_send`` (inside the frame
sender, so an injected fault takes the redial path) and
``transport_recv`` (before the inbox pop, so a retried ``recv`` is safe)
fire through ``runtime/faults.py``; the dial retries under
``RetryPolicy.for_component("transport")``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

_MAGIC = 0x5244534C
_HEADER = struct.Struct("<IIIIQQQQ")
#: Epoch of a heartbeat control frame (zero payload, never inboxed).
_HEARTBEAT_EPOCH = (1 << 64) - 1
_CHUNK = 1 << 20
#: Payloads at least this large move through the native pump (the JAX
#: package's threshold: below it the wrapper costs more than it saves).
_NATIVE_PUMP_MIN_BYTES = 1 << 20

Tag = Tuple[int, int, int]  # (epoch, reducer_index, file_index)


class TransportError(RuntimeError):
    pass


class TransportTimeout(TransportError):
    pass


class PeerUnreachable(TransportError):
    """One peer could not be dialed: ``peer`` (its host id), ``address``,
    ``attempts`` and the ``last_error``."""

    def __init__(self, host_id: int, peer: int, address: Tuple[str, int],
                 attempts: int, last_error: BaseException):
        super().__init__(
            f"host {host_id} could not reach peer {peer} at "
            f"{address[0]}:{address[1]} after {attempts} attempts: "
            f"{type(last_error).__name__}: {last_error}")
        self.peer = peer
        self.address = address
        self.attempts = attempts
        self.last_error = last_error


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` (header) bytes; raises :class:`TransportError`
    on EOF."""
    chunks = []
    while n:
        chunk = sock.recv(min(n, _CHUNK))
        if not chunk:
            raise TransportError("peer closed connection mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_payload(sock: socket.socket, n: int) -> memoryview:
    """Read an ``n``-byte payload into a ledger-tracked pool buffer; the
    returned memoryview keeps the buffer (and its ledger charge) alive as
    long as anything references it. From ``_NATIVE_PUMP_MIN_BYTES`` up,
    one GIL-free native read loop fills it."""
    if n == 0:
        return memoryview(b"")
    buf = native.alloc_tracked_buffer(n)
    view = memoryview(buf)
    if n >= _NATIVE_PUMP_MIN_BYTES:
        if not native.read_exact_into(sock.fileno(), buf, n):
            raise TransportError("peer closed connection mid-message")
        return view
    received = 0
    while received < n:
        got = sock.recv_into(view[received:], min(n - received, _CHUNK))
        if not got:
            raise TransportError("peer closed connection mid-message")
        received += got
    return view


def _new_connection(address: Tuple[str, int]) -> socket.socket:
    sock = socket.create_connection(address, timeout=30)
    # Blocking sends from here on: a timed-out sendall after a partial
    # write would corrupt the framed stream. The receiver's recv timeout
    # handles dead peers.
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def _discard_payload(sock: socket.socket, n: int) -> None:
    """Read and drop an ``n``-byte payload (a fenced frame's, or a
    heartbeat's) without charging the buffer ledger."""
    scratch = bytearray(min(n, _CHUNK))
    while n:
        got = sock.recv_into(scratch, min(n, len(scratch)))
        if not got:
            raise TransportError("peer closed connection mid-message")
        n -= got


class TcpTransport:
    """Point-to-point tagged message transport between shuffle hosts.

    Args:
        host_id: this host's index in ``addresses``.
        addresses: ``(hostname, port)`` per host, the same on every host.
        recv_timeout_s: how long a ``recv`` waits by default.
        reconnect_grace_s: how long a ``recv`` from a source whose
            connection died waits for it to redial.
        incarnation: this process's generation (``membership/``): a rank
            that dies and rejoins comes back one higher, so receivers
            fence the dead generation's frames.

    ``start()`` binds the listener; ``connect()`` dials every peer (on all
    hosts, after all have started: the dial retries with backoff to absorb
    the start-up skew).
    """

    def __init__(self, host_id: int, addresses: Sequence[Tuple[str, int]],
                 recv_timeout_s: float = 600.0,
                 reconnect_grace_s: float = 5.0,
                 incarnation: int = 0):
        if not 0 <= host_id < len(addresses):
            raise ValueError(
                f"host_id {host_id} out of range for {len(addresses)} hosts")
        self.host_id = host_id
        self.addresses = list(addresses)
        self.world = len(addresses)
        self.incarnation = int(incarnation)
        #: The membership view id stamped on outgoing frames.
        self.view_id = 0
        # The fence (under _inbox_cv): the lowest view accepted and the
        # highest incarnation seen per source.
        self._min_view = 0
        self._peer_incarnations: Dict[int, int] = {}
        # cb(src, incarnation, view, is_heartbeat) for every accepted frame.
        self._frame_observer = None
        self._recv_timeout_s = recv_timeout_s
        self._reconnect_grace_s = reconnect_grace_s
        # (src, tag) -> payload: a memoryview (remote) or the sender's
        # object (self-sends).
        self._inbox: Dict[Tuple[int, Tag], Any] = {}
        # (src, tag) of every message recv has returned: a resend that
        # arrives after its original was consumed is dropped too.
        self._consumed: set = set()
        self._inbox_cv = threading.Condition()
        # src -> (reason, monotonic time of death); dropped when a frame
        # from src arrives on a new connection.
        self._dead_srcs: Dict[int, Tuple[str, float]] = {}
        self._peers: Dict[int, socket.socket] = {}
        self._peer_locks: Dict[int, threading.Lock] = {}
        self._listener: Optional[socket.socket] = None
        self._closed = threading.Event()
        self._counts_lock = threading.Lock()
        self._counts = {"frames_sent": 0, "bytes_sent": 0, "send_s": 0.0,
                        "frames_received": 0, "bytes_received": 0,
                        "frames_sent_native": 0, "bytes_sent_native": 0,
                        "send_s_native": 0.0,
                        "frames_received_native": 0,
                        "bytes_received_native": 0}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Bind the listener and start accepting peer connections."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(self.addresses[self.host_id])
        listener.listen(self.world)
        self._listener = listener
        self._spawn(self._accept_loop, f"rsdl-transport-accept-{self.host_id}")

    def bound_port(self) -> int:
        """The listening port (the one chosen when configured with 0)."""
        if self._listener is None:
            raise TransportError("start() first")
        return self._listener.getsockname()[1]

    @staticmethod
    def _dial_policy(retries: int, initial_backoff_s: float):
        return rt_retry.RetryPolicy.for_component(
            "transport", retry_max_attempts=retries + 1,
            retry_initial_backoff_s=initial_backoff_s,
            retry_max_backoff_s=5.0,
            retryable=lambda e: isinstance(e, OSError))

    def connect(self, retries: int = 30, initial_backoff_s: float = 0.1,
                on_unreachable: str = "raise") -> List[int]:
        """Dial every remote peer, each under the ``transport`` component's
        ``RetryPolicy`` (decorrelated-jitter backoff capped at 5 s, OS
        errors retried).

        ``on_unreachable="raise"`` raises :class:`PeerUnreachable` naming
        the first peer that cannot be reached; ``"skip"`` records the peer
        as unreachable (a ``member_unreachable`` record) and dials the
        rest: in an elastic world a dead or not yet joined rank is a fact
        of the view, not an error. Returns the unreachable peers (always
        empty for ``"raise"``); :meth:`dial` reaches one later."""
        if on_unreachable not in ("raise", "skip"):
            raise ValueError(
                f"on_unreachable must be raise|skip, got "
                f"{on_unreachable!r}")
        policy = self._dial_policy(retries, initial_backoff_s)
        unreachable: List[int] = []
        # The address table is the dial list; membership decides liveness
        # on top of it. rsdl-lint: disable=fixed-world-assumption
        for peer in range(self.world):
            if peer == self.host_id:
                continue
            try:
                policy.call(self._dial_peer, peer,
                            describe=f"dial peer {peer}")
            except OSError as e:
                error = PeerUnreachable(self.host_id, peer,
                                        self.addresses[peer], retries + 1, e)
                if on_unreachable == "raise":
                    raise error
                unreachable.append(peer)
                logger.warning("host %d: peer %d unreachable, skipping "
                               "(%s)", self.host_id, peer, error)
                rt_telemetry.record("member_unreachable", task=peer,
                                    src=self.host_id)
        logger.info("host %d connected to %d peers", self.host_id,
                    self.world - 1 - len(unreachable))
        return unreachable

    def dial(self, peer: int, retries: int = 5,
             initial_backoff_s: float = 0.1) -> None:
        """Dial one peer (the member-join path: a grown world dials the
        new rank without dialing everyone again). Raises
        :class:`PeerUnreachable` on failure."""
        try:
            self._dial_policy(retries, initial_backoff_s).call(
                self._dial_peer, peer, describe=f"dial peer {peer}")
        except OSError as e:
            raise PeerUnreachable(self.host_id, peer, self.addresses[peer],
                                  retries + 1, e)

    def _dial_peer(self, peer: int) -> socket.socket:
        sock = _new_connection(self.addresses[peer])
        # The swap happens under the peer's lock: a heartbeat or a send on
        # another thread (the prober's) never writes to a socket that is
        # being replaced.
        lock = self._peer_locks.setdefault(peer, threading.Lock())
        with lock:
            old = self._peers.get(peer)
            self._peers[peer] = sock
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        return sock

    # -- membership hooks ----------------------------------------------------

    def known_peers(self) -> List[int]:
        """Peers with a dialed connection (the prober's probe set)."""
        return sorted(self._peers)

    def set_frame_observer(self, callback) -> None:
        """Install ``cb(src, incarnation, view, is_heartbeat)``, called on
        the receive thread for every accepted (not fenced) frame: the
        failure detector's feed."""
        self._frame_observer = callback

    def announce(self, incarnation: int,
                 view_id: Optional[int] = None) -> None:
        """Stamp a new ``(incarnation, view)`` on every outgoing frame: the
        rejoin path, which raises the fence at the receivers."""
        self.incarnation = int(incarnation)
        if view_id is not None:
            self.view_id = int(view_id)

    def set_view(self, view_id: int) -> None:
        """Adopt a membership view id for outgoing frames."""
        self.view_id = int(view_id)

    def fence_view(self, min_view: int) -> None:
        """Drop incoming frames stamped with a view below ``min_view``: the
        cut after a resize, once the new view is adopted everywhere."""
        with self._inbox_cv:
            self._min_view = int(min_view)

    def close(self) -> None:
        self._closed.set()
        with self._inbox_cv:
            self._inbox_cv.notify_all()
        for sock in list(self._peers.values()):
            try:
                sock.close()
            except OSError:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def __enter__(self) -> "TcpTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, float]:
        """Frames and payload bytes sent and received so far and the
        seconds the senders spent sending (self-sends excluded); the
        ``*_native`` keys count the part that went through the native
        pump."""
        with self._counts_lock:
            return dict(self._counts)

    def _count(self, **deltas) -> None:
        with self._counts_lock:
            for key, value in deltas.items():
                self._counts[key] += value

    @staticmethod
    def _spawn(target, name: str, *args) -> None:
        threading.Thread(target=target, args=args, daemon=True,
                         name=name).start()

    # -- receive path --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # No socket timeout: idle links between epochs are normal; the
            # loop ends when close() closes the connection, and recv()
            # enforces its own timeout on the tag.
            conn.settimeout(None)
            self._spawn(self._recv_loop, f"rsdl-transport-recv-{self.host_id}",
                        conn)

    def _recv_loop(self, conn: socket.socket) -> None:
        srcs_seen: set = set()
        try:
            while not self._closed.is_set():
                first = conn.recv(_HEADER.size)
                if not first:
                    return  # clean close at a frame boundary
                header = (first if len(first) == _HEADER.size else
                          first + _recv_exact(conn,
                                              _HEADER.size - len(first)))
                (magic, src, incarnation, view, epoch, reducer,
                 file_index, length) = _HEADER.unpack(header)
                if magic != _MAGIC:
                    raise TransportError(
                        f"bad magic {magic:#x} from peer (protocol mismatch)")
                srcs_seen.add(src)
                # The generation fence, decided on the header: a frame from
                # an older incarnation of src or below the view floor is
                # read off the socket and dropped without charging the
                # ledger.
                with self._inbox_cv:
                    known = self._peer_incarnations.get(src, 0)
                    stale = incarnation < known or view < self._min_view
                    if not stale and incarnation > known:
                        self._peer_incarnations[src] = incarnation
                    min_view = self._min_view
                if stale:
                    _discard_payload(conn, length)
                    self._fenced(src, incarnation, view, epoch, reducer,
                                 known, min_view)
                    continue
                heartbeat = epoch == _HEARTBEAT_EPOCH
                if heartbeat:
                    _discard_payload(conn, length)
                else:
                    payload = _recv_payload(conn, length)
                observer = self._frame_observer
                if observer is not None:
                    observer(src, incarnation, view, heartbeat)
                if heartbeat:
                    continue  # detector food only, never inboxed
                pumped = int(length >= _NATIVE_PUMP_MIN_BYTES)
                self._count(frames_received=1, bytes_received=length,
                            frames_received_native=pumped,
                            bytes_received_native=pumped * length)
                key = (src, (epoch, reducer, file_index))
                with self._inbox_cv:
                    if key in self._inbox or key in self._consumed:
                        # A sender whose send failed after the frame was
                        # delivered resends it on a new connection, and a
                        # retried map sends its chunks again: keep the
                        # first.
                        logger.warning(
                            "host %d: dropping duplicate message %s "
                            "(a resend)", self.host_id, key)
                    else:
                        self._inbox[key] = payload
                    # A live frame revives a src that an earlier connection
                    # declared dead (the sender redialed).
                    self._dead_srcs.pop(src, None)
                    self._inbox_cv.notify_all()
                payload = None
        except (TransportError, OSError) as e:
            if not self._closed.is_set():
                now = time.monotonic()
                with self._inbox_cv:
                    for src in srcs_seen:
                        self._dead_srcs.setdefault(src, (str(e), now))
                    self._inbox_cv.notify_all()
                logger.warning("host %d: peer connection died: %s",
                               self.host_id, e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _fenced(self, src: int, incarnation: int, view: int, epoch: int,
                reducer: int, known: int, min_view: int) -> None:
        rt_metrics.counter("rsdl_member_fenced_frames_total",
                           "frames rejected by the incarnation/view "
                           "fence").inc()
        rt_telemetry.record("member_fenced_frame", epoch=epoch,
                            task=reducer, src=src, incarnation=incarnation,
                            view=view)
        logger.warning(
            "host %d: FENCED stale frame from host %d (incarnation %d < %d "
            "or view %d < %d); dropped", self.host_id, src, incarnation,
            known, view, min_view)

    def recv(self, src: int, tag: Tag, timeout_s: Optional[float] = None):
        """Block until the message ``tag`` from host ``src`` arrives and
        return it (a ``memoryview`` over a ledger-tracked buffer, or the
        sender's object for a self-send). Each message is consumed once. Raises
        :class:`TransportTimeout` after ``timeout_s`` (default: the
        transport's ``recv_timeout_s``), and :class:`TransportError` once
        ``src``'s connection has been dead for ``reconnect_grace_s``."""
        if timeout_s is None:
            timeout_s = self._recv_timeout_s
        rt_faults.inject("transport_recv", epoch=tag[0], task=tag[1])
        key = (src, tag)
        start = time.monotonic()
        deadline = start + timeout_s
        with self._inbox_cv:
            while key not in self._inbox:
                if self._closed.is_set():
                    raise TransportError("transport closed while receiving")
                if src in self._dead_srcs:
                    reason, died_at = self._dead_srcs[src]
                    if (time.monotonic() - died_at
                            >= self._reconnect_grace_s):
                        raise TransportError(
                            f"host {self.host_id}: connection from host "
                            f"{src} died before message {tag} arrived "
                            f"(no reconnect within "
                            f"{self._reconnect_grace_s:g}s): {reason}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportTimeout(
                        f"host {self.host_id}: no message {tag} from host "
                        f"{src} within {timeout_s:g}s")
                self._inbox_cv.wait(timeout=min(remaining, 1.0))
            self._consumed.add(key)
            payload = self._inbox.pop(key)
        rt_telemetry.record("transport_recv", epoch=tag[0], task=tag[1],
                            dur_s=time.monotonic() - start, src=src)
        return payload

    # -- send path -----------------------------------------------------------

    def send(self, dest: int, tag: Tag, payload) -> None:
        """Send ``payload`` (any buffer-protocol object: bytes, a
        ``pyarrow.Buffer``) to host ``dest`` tagged ``tag``.
        Thread-safe."""
        if dest == self.host_id:
            key = (self.host_id, tag)
            with self._inbox_cv:
                if key in self._inbox:
                    raise TransportError(f"duplicate message for {key}")
                self._inbox[key] = payload
                self._inbox_cv.notify_all()
            return
        lock = self._peer_locks.get(dest)
        if lock is None:
            raise TransportError(
                f"host {self.host_id} has no connection to peer {dest} "
                "(connect() not called)")
        epoch, reducer, file_index = tag
        # A partitioned link drops the frame silently, like a blackholing
        # switch; the record keeps the drop observable.
        try:
            rt_faults.inject("member_partition", epoch=epoch, task=dest)
        except rt_faults.InjectedFault:
            rt_telemetry.record("member_partition", epoch=epoch, task=dest,
                                src=self.host_id, fault="frame_dropped")
            return
        nbytes = memoryview(payload).nbytes
        header = _HEADER.pack(_MAGIC, self.host_id, self.incarnation,
                              self.view_id, epoch, reducer, file_index,
                              nbytes)
        pumped = nbytes >= _NATIVE_PUMP_MIN_BYTES

        def send_frame(s: socket.socket) -> None:
            # Inside the frame sender: an injected fault takes the redial
            # and resend path a socket error takes.
            rt_faults.inject("transport_send", epoch=epoch, task=reducer)
            if pumped:
                native.frame_send(s.fileno(), header, payload)
            else:
                s.sendall(header)
                s.sendall(payload)

        start = time.monotonic()
        with lock:
            sock = self._peers[dest]
            try:
                send_frame(sock)
            except (OSError, rt_faults.InjectedFault) as first_err:
                # One redial and resend. A partial frame on the old
                # connection kills only that connection's receive loop;
                # the resent frame arrives whole on the new one.
                try:
                    sock.close()
                except OSError:
                    pass
                try:
                    new_sock = _new_connection(self.addresses[dest])
                    self._peers[dest] = new_sock
                    send_frame(new_sock)
                    logger.warning(
                        "host %d: send to peer %d failed (%s); redialed and "
                        "resent %s", self.host_id, dest, first_err, tag)
                except OSError as e:
                    raise TransportError(
                        f"host {self.host_id} failed sending to peer {dest} "
                        f"(redial also failed: {e}): {first_err}")
        took = time.monotonic() - start
        self._count(frames_sent=1, bytes_sent=nbytes, send_s=took,
                    frames_sent_native=int(pumped),
                    bytes_sent_native=int(pumped) * nbytes,
                    send_s_native=took if pumped else 0.0)
        # The frame's (epoch, reducer, file) tag is the cross-host trace
        # context: the receiver records transport_recv with the same key.
        rt_telemetry.record("transport_send", epoch=epoch, task=reducer,
                            dur_s=took, dest=dest, nbytes=nbytes)

    def send_heartbeat(self, dest: int) -> None:
        """Best-effort heartbeat control frame to ``dest``: no payload, the
        epoch sentinel, never inboxed at the receiver (it feeds the failure
        detector through the frame observer). Socket errors are swallowed:
        a dead link is what the detector's silence reports, and the prober
        must not die with it."""
        if dest == self.host_id:
            return
        try:
            rt_faults.inject("member_partition", task=dest)
        except rt_faults.InjectedFault:
            rt_telemetry.record("member_partition", task=dest,
                                src=self.host_id, fault="heartbeat_dropped")
            return
        lock = self._peer_locks.get(dest)
        if lock is None:
            return
        header = _HEADER.pack(_MAGIC, self.host_id, self.incarnation,
                              self.view_id, _HEARTBEAT_EPOCH, 0, 0, 0)
        with lock:
            sock = self._peers.get(dest)
            if sock is None:
                return
            try:
                sock.sendall(header)
            except OSError:
                pass


def create_local_transports(world: int, recv_timeout_s: float = 600.0,
                            reconnect_grace_s: float = 5.0,
                            incarnations: Optional[Sequence[int]] = None
                            ) -> List[TcpTransport]:
    """A fully connected ``world`` of transports on localhost ephemeral
    ports: one machine standing in for a cluster's host network (tests,
    loopback worlds). ``incarnations`` gives each host's generation."""
    transports = [
        TcpTransport(h,
                     # rsdl-lint: disable=fixed-world-assumption
                     [("127.0.0.1", 0)] * world,
                     recv_timeout_s=recv_timeout_s,
                     reconnect_grace_s=reconnect_grace_s,
                     incarnation=(0 if incarnations is None
                                  else int(incarnations[h])))
        # rsdl-lint: disable=fixed-world-assumption
        for h in range(world)
    ]
    for t in transports:
        t.start()
    addresses = [("127.0.0.1", t.bound_port()) for t in transports]
    for t in transports:
        t.addresses = addresses
        t.connect()
    return transports
