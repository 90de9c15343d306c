"""Cross-process queue service: trainer processes attach by address (own
copy of the JAX package's ``multiqueue_service.py``).

A trainer in another process than the shuffle reads its per-``(epoch,
rank)`` queue over TCP:

- :func:`serve_queue` exports a ``multiqueue.MultiQueue``. Each GET pops
  queued reducer refs, resolves each to its ``pa.Table`` and sends it as
  one Arrow IPC stream per frame, or as a shared-memory handle.
- :class:`RemoteQueue` is the consumer: ``get(queue_idx)`` returns a
  ``pa.Table``, ``None`` (the epoch's end) or a ``dataset.ShuffleFailure``,
  the items an in-process queue yields, so
  ``ShufflingDataset(batch_queue=RemoteQueue(addr), shuffle_result=None)``
  (or ``DeviceShufflingDataset``) is a trainer in another process.
- :class:`ShardedQueueServer` / :func:`serve_queue_sharded` serve one
  queue from N shards, each owning the queues of its ranks
  (``plan.ir.queue_shard``) on a port of its own; a
  :class:`plan.ir.ShardMap` takes the place of the one address, and
  :class:`ShardedRemoteQueue` routes each queue to its shard.
- :func:`serve_pipeline` builds queue, shuffle and server (one shard of
  several with ``config["num_shards"]``) from a config dict in a process
  of its own (``python -m
  ray_shuffling_data_loader_tpu_torch.multiqueue_service config.json``),
  the unit ``runtime.supervisor`` restarts after a crash.
- Live rebalancing moves a rank's queues from one shard to another while
  its consumer reads them: ``OP_REBALANCE`` (PREPARE, ADOPT, RELEASE,
  UNSEAL; :func:`rebalance_prepare` and its siblings, driven by
  ``rebalance.migrate``), the source's ``KIND_MOVED`` redirect, and the
  placement generation each data frame carries, below which the client
  drops a frame (the fence).

The wire is the JAX package's v3.3, byte for byte, little-endian, so a
port client reads a JAX server and a JAX client a port server. A request
is ``(u8 op, u8 flags, u32 a, u32 b, u32 c)``:

- ``OP_GET_BATCH`` (1): ``a`` the queue, ``b`` the most frames to send,
  ``c`` the consumer's ack watermark (the last seq it consumed;
  ``ACK_NONE`` for none). ``FLAG_RESUME`` marks the first GET of a queue
  on a new connection: the server rewinds to the watermark and replays
  the unacked frames.
- ``OP_REBALANCE`` (6): ``flags`` is the phase (``REB_*``), ``a`` the
  rank, ``b`` the placement generation, ``c`` the length of the JSON
  payload that follows; the answer is ``(u32 length)`` and a
  ``checkpoint.crc_line`` (the handoff manifest for PREPARE, an ack or
  ``{"error": ...}`` otherwise).
- ``OP_HELLO`` (2): ``a | b << 32`` is the consumer's id, its lease
  identity across reconnects; ``FLAG_HANDLES_OK`` says the consumer can
  map the server's shared-memory segments. ``OP_HEARTBEAT`` (3) beats
  the lease between GETs. ``OP_NACK`` (4): frame ``b`` of queue ``a``
  failed its CRC (``c`` = ``NACK_CRC``; the server rewinds to ``b - 1``
  and sends again from its replay buffer) or its handle could not be
  used (``c`` = ``NACK_NO_HANDLE``; the queue is streamed from then on,
  the same frames again).

A response is ``(u32 count)`` and ``count`` frames: the 14-field header
``(u8 kind | codec << 4, u32 epoch, u32 seq, u32 crc, u64 row_offset, u64
length, u32 task, f64 birth_mono, f64 birth_unix, u32 birth_pid, f64
queued_mono, f64 queued_unix, u32 queued_pid, u32 generation)`` and
``length`` payload bytes. ``kind``: 0 a table, 1 the epoch's sentinel, 2
a shuffle failure (the payload is its text), 3 a table as a
shared-memory handle (the payload is the JSON ``{"path", "offset",
"size", "crc"}`` of a segment the server wrote; the consumer maps it and
checks the segment's CRC), 4 a ``KIND_MOVED`` redirect (the JSON
``{"host", "port", "generation", "rank"}`` of the shard that adopted the
queue's rank). ``codec`` (0 none, 1 zlib, 2 zstd, 3 lz4)
compresses a streamed table's payload. ``seq`` numbers a queue's frames
and survives server restarts (the watermark journal restores it);
``crc`` is the CRC-32 of the uncompressed payload (of the blob for a
handle); ``row_offset`` counts the table rows of the queue's earlier
frames, so a resumed consumer skips rows absolutely; ``task`` is the
producing reducer (``rsdl.trace`` metadata, ``TASK_NONE`` if unknown).
The stamps are the payload's birth (its ``rsdl.birth`` metadata) and the
frame's build; zero means unknown. ``generation`` is the rank's placement
generation on this shard (0 until a move commits; failure frames always
0, so an error lands even from a fenced source).

Recovery, as in the JAX package:

- The server keeps each queue's unacked frames in a replay buffer of at
  most ``queue_replay_bytes`` (over it, a GET pops one new frame at most:
  backpressure, never a drop); a handle frame counts its segment's bytes
  and pins them in the buffer ledger (``procpool.pin_segment``) until
  its ack, a stream replay or ``close`` releases them. Acks ride on every
  GET and are journaled (``checkpoint.WatermarkJournal``), so a
  connection reset at any byte is recovered by reconnect and resume,
  exactly once.
- A killed server process is restarted by the supervisor;
  :func:`serve_pipeline` reloads the journal and re-runs the shuffle's
  deterministic lineage from the first epoch not fully consumed,
  dropping what was delivered (``plan.ir.resume_from_watermarks``). A
  shard journals, resumes and queues only its own ranks, and sweeps the
  segments its killed incarnation left. Births are journaled when a
  frame is first built, so the frames a restarted server regenerates
  carry their original births.
- Consumer leases (every request beats them, and a client thread between
  requests) expire after ``queue_lease_timeout_s``; ``on_dead_consumer``
  is ``fail_fast`` (close the server), ``drain`` (free the dead rank's
  queues) or ``redistribute`` (reroute its tables to a survivor). A
  ``MembershipManager``'s ``down`` verdict expires a rank's leases at
  once (:meth:`QueueServer.attach_membership`).
- Delivery latency: the server observes ``birth_to_queued``; the client
  ``queued_to_delivered`` and ``birth_to_delivered`` (``observes_delivery``
  tells a dataset on top not to count the last again).

A stream's frozen window schedule (``config["epochs"]`` of
:func:`serve_pipeline`, ``streaming.runner.server_config``) is served as
any epochs are, and a restarted server re-derives the same windows.

Tenancy (``tenancy/``): ``OP_TENANT`` (5; ``a | b << 32`` the consumer's
id, ``c`` the length of the canonical ``TenantContext`` JSON that follows)
binds a lease, and the ranks it then GETs, to a tenant. A server with a
``tenants`` table or a bound consumer splits its replay budget by tenant
weight (``tenancy.fairshare.FairShare``: each tenant's unacked bytes
under its weighted share, and a deficit round robin over the frames past
a GET's first), paces the one-frame floor of a denied tenant
(``tenant_floor_pace_s``) and keeps per-tenant delivered and replay
bytes. Each frame keeps the tenant charged at its pop, so its ack, a
drain or a live move credits that account.

A frame of a kind the client does not know raises
:class:`UnreadableFrame`; it is never skipped.

Host code: imports no torch, so the server's process never touches a
card.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures as cf
import json
import itertools
import os
import shutil
import signal
import socket
import struct
import sys
import tempfile
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import pyarrow as pa

from ray_shuffling_data_loader_tpu_torch import multiqueue as mq
from ray_shuffling_data_loader_tpu_torch import procpool as pp
from ray_shuffling_data_loader_tpu_torch import tenancy as rt_tenancy
from ray_shuffling_data_loader_tpu_torch.dataset import ShuffleFailure
from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
from ray_shuffling_data_loader_tpu_torch.runtime import faults as rt_faults
from ray_shuffling_data_loader_tpu_torch.runtime import latency as rt_lat
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.tenancy import (
    fairshare as rt_fairshare)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

_REQUEST = struct.Struct("<BBIII")
_BATCH_HEADER = struct.Struct("<I")
#: The v3.3 frame header: (kind | codec << 4, epoch, seq, crc,
#: row_offset, length, task), the birth stamp (t_mono, t_unix, pid), the
#: queued stamp (t_mono, t_unix, pid) and the placement generation.
_FRAME = struct.Struct("<BIIIQQIddIddII")

#: Frame ``task`` of a payload with no lineage (sentinels, failures).
TASK_NONE = 0xFFFFFFFF

OP_GET_BATCH = 1
OP_HELLO = 2
OP_HEARTBEAT = 3
OP_NACK = 4
#: Bind a consumer's lease to a tenant (``c`` the length of the
#: ``TenantContext`` JSON that follows the request).
OP_TENANT = 5
#: The live-migration admin request (``flags`` the phase).
OP_REBALANCE = 6

#: OP_REBALANCE phases: PREPARE seals the rank and exports the CRC'd
#: handoff manifest; ADOPT installs it on the target at the new
#: generation; RELEASE drops the rank on the source and arms MOVED
#: redirects; UNSEAL is the abort (the source serves on).
REB_PREPARE = 1
REB_ADOPT = 2
REB_RELEASE = 3
REB_UNSEAL = 4

FLAG_RESUME = 1
#: HELLO flag: the consumer can map paths on the server's host (loopback,
#: or a shared shm mount), so table frames may come as segment handles.
FLAG_HANDLES_OK = 2

KIND_TABLE = 0
KIND_SENTINEL = 1
KIND_FAILURE = 2
#: A table as a shared-memory segment handle: the payload is the JSON
#: blob ``{"path", "offset", "size", "crc"}``, the header CRC covers it.
KIND_TABLE_HANDLE = 3
#: A redirect: the queue's rank moved to another shard. The payload is
#: the JSON ``{"host", "port", "generation", "rank"}``, the header CRC
#: covers it and the header generation repeats it, so the consumer raises
#: its fence before it dials the new shard.
KIND_MOVED = 4

#: The frame kind byte's low nibble; the high one is the payload codec.
_KIND_MASK = 0x0F
CODEC_NONE, CODEC_ZLIB, CODEC_ZSTD, CODEC_LZ4 = 0, 1, 2, 3
_CODEC_IDS = {"zlib": CODEC_ZLIB, "zstd": CODEC_ZSTD, "lz4": CODEC_LZ4}

#: OP_NACK ``c``: 0 a CRC failure (rewind and send again); 1 an unusable
#: handle (stream the queue from then on).
NACK_CRC = 0
NACK_NO_HANDLE = 1

#: "No watermark" on the wire (seqs are u32; -1 here).
ACK_NONE = 0xFFFFFFFF

DEFAULT_MAX_BATCH = 8

_LOOPBACK_HOSTS = frozenset({"127.0.0.1", "localhost", "::1"})


class UnreadableFrame(RuntimeError):
    """A frame of a kind this client does not know. Raised, never
    skipped."""


def _crc(payload) -> int:
    """``zlib.crc32`` of a bytes-like payload, by the native kernel."""
    from ray_shuffling_data_loader_tpu_torch import native
    return native.crc32(memoryview(payload)) & 0xFFFFFFFF


_codec_warned: set = set()


def _resolve_compression() -> Optional[Tuple[int, Callable]]:
    """``(codec_id, compress)`` for the ``queue_compression`` policy, or
    None when it is off. zstd and lz4 fall back to zlib, with a warning
    once per name, where their module is not installed."""
    name = str(rt_policy.resolve("queue", "queue_compression")).strip()
    name = name.lower()
    if name in ("", "off", "0", "none", "false"):
        return None
    if name not in _CODEC_IDS:
        raise ValueError(
            f"RSDL_QUEUE_COMPRESSION must be off, zlib, zstd or lz4; "
            f"got {name!r}")
    if name == "zstd":
        try:
            import zstandard
            return CODEC_ZSTD, zstandard.ZstdCompressor().compress
        except ImportError:
            pass
    elif name == "lz4":
        try:
            import lz4.frame
            return CODEC_LZ4, lz4.frame.compress
        except ImportError:
            pass
    if name != "zlib" and name not in _codec_warned:
        _codec_warned.add(name)
        logger.warning("queue compression codec %r is not installed; "
                       "falling back to zlib", name)
    # Level 1: the wire's gain is latency, not ratio. zlib reads any
    # buffer, so a pa.Buffer compresses without a bytes copy.
    return CODEC_ZLIB, lambda data: zlib.compress(data, 1)


def _decompress(codec: int, payload) -> bytes:
    if codec == CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec == CODEC_ZSTD:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(bytes(payload))
    if codec == CODEC_LZ4:
        import lz4.frame
        return lz4.frame.decompress(bytes(payload))
    raise ValueError(f"unknown frame codec {codec}")


def _pack_stamp(stamp) -> tuple:
    """A latency Stamp (or None) as its 3 header fields."""
    if stamp is None:
        return (0.0, 0.0, 0)
    return (stamp.t_mono, stamp.t_unix, stamp.pid)


def _unpack_stamp(t_mono: float, t_unix: float, pid: int):
    if not t_mono and not t_unix:
        return None
    return rt_lat.Stamp(pid, t_mono, t_unix)


try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:
        _IOV_MAX = 1024
except (AttributeError, ValueError, OSError):
    _IOV_MAX = 1024


def _sendmsg_all(sock: socket.socket, buffers) -> None:
    """Write every buffer with scatter-gather ``sendmsg`` (a whole GET
    response in about one syscall), resuming partial sends, in groups of
    at most IOV_MAX; the bytes equal the sequential ``sendall``s'."""
    views = [m for m in (memoryview(b).cast("B") for b in buffers)
             if m.nbytes]
    idx = 0
    while idx < len(views):
        sent = sock.sendmsg(views[idx:idx + _IOV_MAX])
        while sent > 0:
            view = views[idx]
            if sent >= view.nbytes:
                sent -= view.nbytes
                idx += 1
            else:
                views[idx] = view[sent:]
                sent = 0


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed connection mid-message")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


def _recv_payload(sock: socket.socket, n: int) -> memoryview:
    """Exactly ``n`` payload bytes into one buffer (``recv_into``): the
    CRC and the Arrow decode read it in place."""
    view = memoryview(bytearray(n))
    received = 0
    while received < n:
        got = sock.recv_into(view[received:], n - received)
        if not got:
            raise ConnectionError("peer closed connection mid-message")
        received += got
    return view


def _serialize(table: pa.Table) -> pa.Buffer:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue()


def _producer_task(table: pa.Table) -> int:
    """The producing reducer, from the ``rsdl.trace`` metadata
    (``"seed:epoch:task"``); TASK_NONE when absent."""
    meta = table.schema.metadata
    raw = meta.get(b"rsdl.trace") if meta else None
    if not raw:
        return TASK_NONE
    try:
        return int(raw.rsplit(b":", 1)[-1])
    except ValueError:
        return TASK_NONE


def _materialize(item) -> Tuple[int, object, int, int]:
    """One queued item as ``(kind, data, num_rows, task)``: ``data`` is the
    ``pa.Table`` of a table frame (a spilled output mapped back) and the
    payload bytes of a sentinel or failure frame. A ref whose task failed
    becomes a failure frame with the cause, not a dead socket."""
    if item is None:
        return KIND_SENTINEL, b"", 0, TASK_NONE
    if isinstance(item, ShuffleFailure):
        return KIND_FAILURE, repr(item.error).encode(), 0, TASK_NONE
    try:
        from ray_shuffling_data_loader_tpu_torch import spill
        table = spill.unwrap(item.result() if hasattr(item, "result")
                             else item)
        return KIND_TABLE, table, table.num_rows, _producer_task(table)
    except Exception as e:  # noqa: BLE001 - forwarded to the consumer
        return KIND_FAILURE, repr(e).encode(), 0, TASK_NONE


class _Frame:
    """One frame in a queue's replay buffer.

    ``wire`` is its payload as sent (the serialized table's ``pa.Buffer``
    held once, which the socket and the replay buffer share; compressed
    bytes; or a handle's blob); ``crc`` the CRC of the uncompressed
    payload (of the blob for a handle frame, whose segment CRC is inside
    it); ``data_crc`` that of the serialized table, so a handle frame
    streams again without a second CRC pass; ``payload_bytes`` the
    table's serialized size, which a handle frame pins in the buffer
    ledger (``ledger_id``) until it is acked. The stamps are the ones it
    was built with, which a replay sends again. ``pending_codec`` is
    ``(future, codec)`` while the codec pool compresses it. ``tenant`` is
    the tenant its bytes were charged to when it was popped: its ack, a
    reset or a drain credits that same account, even if the rank's
    tenant binding changed in between."""

    __slots__ = ("seq", "kind", "epoch", "wire", "crc", "row_offset",
                 "nrows", "task", "codec", "payload_bytes", "data_crc",
                 "handle_path", "ledger_id", "birth", "queued",
                 "pending_codec", "tenant")

    def __init__(self, seq, kind, epoch, wire, crc, row_offset, nrows,
                 task=TASK_NONE, codec=CODEC_NONE, payload_bytes=None,
                 data_crc=None, handle_path=None, ledger_id=None,
                 birth=None, queued=None):
        self.seq = seq
        self.kind = kind
        self.epoch = epoch
        self.wire = wire
        self.crc = crc
        self.row_offset = row_offset
        self.nrows = nrows
        self.task = task
        self.codec = codec
        self.payload_bytes = (payload_bytes if payload_bytes is not None
                              else self.wire_len)
        self.data_crc = data_crc if data_crc is not None else crc
        self.handle_path = handle_path
        self.ledger_id = ledger_id
        self.birth = birth
        self.queued = queued
        self.pending_codec = None
        self.tenant = None

    def resolve_codec(self) -> int:
        """Land a codec-pool compression: the compressed bytes become the
        wire payload if they are smaller (the inline rule). Returns the
        change in resident bytes (<= 0) for the replay accounting."""
        fut, codec_id = self.pending_codec
        self.pending_codec = None
        old = self.wire_len
        compressed = fut.result()
        if len(compressed) < self.payload_bytes:
            self.wire = compressed
            self.codec = codec_id
        return self.wire_len - old

    @property
    def wire_len(self) -> int:
        wire = self.wire
        return wire.size if isinstance(wire, pa.Buffer) else len(wire)

    @property
    def size(self) -> int:
        """The bytes this unacked frame holds: its segment for a handle
        frame, its (possibly compressed) payload otherwise."""
        if self.kind == KIND_TABLE_HANDLE:
            return self.payload_bytes
        return self.wire_len


class _QueueState:
    """One queue's sequencing and replay state (one consumer per queue:
    ``queue = epoch * num_trainers + rank``)."""

    __slots__ = ("next_seq", "sent_seq", "acked_seq", "acked_rows",
                 "rows_total", "replay", "replay_bytes", "done", "lock",
                 "no_handles", "births")

    def __init__(self, next_seq: int = 0, rows: int = 0,
                 done: bool = False, births=None):
        self.next_seq = next_seq       # seq of the next popped item
        self.sent_seq = next_seq - 1   # last seq sent on the connection
        self.acked_seq = next_seq - 1  # last seq the consumer acked
        self.acked_rows = rows         # rows delivered through acked_seq
        self.rows_total = rows         # rows assigned through next_seq-1
        self.replay: collections.deque = collections.deque()  # unacked
        self.replay_bytes = 0
        self.done = done               # the sentinel was acked
        # Held while other locks are taken, edges the static pass cannot
        # see (the server reaches this lock through a local ``state``):
        # QueueServer._tenant_lock (a pop, an ack, a rank's release or a
        # drain charges the frame's tenant: _charge_tenant,
        # _tenant_may_pop), QueueServer._lease_lock (a GET parked in
        # _pop beats its lease) and, while a frame is built, the popped
        # reducer table's finalizer (procpool.ProcTaskRef._final_lock),
        # the buffer ledger's peak lock and telemetry's locks. No section
        # under those locks takes a queue's state lock: they update the
        # tenant and lease tables, the FairShare (whose lock is a leaf),
        # gauges, the ledger and the recorder. So the order cannot
        # invert.
        # rsdl-lint: disable=inconsistent-lock-order
        self.lock = threading.Lock()
        self.no_handles = False        # NACK_NO_HANDLE: streamed from now
        #: seq -> original birth Stamp from the journal, given back to
        #: the frames a restarted server regenerates.
        self.births: Dict[int, rt_lat.Stamp] = births or {}


class _Lease:
    __slots__ = ("consumer_id", "last_beat", "queues", "expired",
                 "tenant")

    def __init__(self, consumer_id: int):
        self.consumer_id = consumer_id
        self.last_beat = time.monotonic()
        self.queues: set = set()
        self.expired = False
        #: The tenant ``OP_TENANT`` bound (None: unbound, attributed by
        #: the server's ``tenants`` table).
        self.tenant: Optional[str] = None


class QueueMoved(Exception):
    """A GET found its queue's rank moved to another shard (a
    ``KIND_MOVED`` redirect): the new shard's ``address`` and the
    committed placement ``generation`` (the client's fence is raised
    before this is raised). :class:`ShardedRemoteQueue` follows it; a bare
    :class:`RemoteQueue` raises it."""

    def __init__(self, queue_index: int, rank: int,
                 address: Tuple[str, int], generation: int):
        super().__init__(
            f"queue {queue_index} (rank {rank}) moved to "
            f"{address[0]}:{address[1]} at placement generation "
            f"{generation}")
        self.queue_index = queue_index
        self.rank = rank
        self.address = (str(address[0]), int(address[1]))
        self.generation = generation


_POP_CLOSED = object()
_POP_EMPTY = object()


def _put_quiet(queue: mq.MultiQueue, queue_idx: int, item) -> bool:
    """A redistribution put: a full or shut-down target drops the item
    (the drain policy) instead of wedging the lease drainer."""
    try:
        queue.put(queue_idx, item)
        return True
    except (mq.Full, RuntimeError):
        return False


def _resolve_delivery(override: Optional[str] = None) -> str:
    delivery = rt_policy.resolve("queue", "queue_delivery",
                                 override=override)
    if delivery not in ("auto", "stream", "handle"):
        raise ValueError(f"RSDL_QUEUE_DELIVERY must be auto, stream or "
                         f"handle, got {delivery!r}")
    return delivery


class QueueServer:
    """Exports a ``MultiQueue`` over TCP (the v3.3 wire).

    One thread per consumer connection. A GET's first pop blocks until
    the queue yields (so the consumer's backpressure holds); the rest of
    the batch is a non-blocking drain that stops after a sentinel or a
    failure. ``journal`` (a ``checkpoint.WatermarkJournal``) keeps the
    ack watermarks and frame births; ``initial_state`` (its loaded map)
    restores seqs, row offsets and births, so a frame keeps its identity
    across a restart. ``exit_on_crash_site=True`` (the server's own
    process) turns an injected ``queue_server_crash`` into ``os._exit``,
    a real death for the supervisor to recover.

    ``shard_index`` of ``num_shards``: this server owns the queues of its
    ranks (``plan.ir.queue_shard``) and answers a GET for another with a
    failure frame. ``handle_dir`` is where handle frames' segments go (a
    directory of its own under the shm root by default, removed at
    ``close``). ``tenants`` is the table ``{tenant_id: {"weight": w (or
    "priority"), "ranks": [...]}}`` (``tenancy.tenants_from_config``): the
    replay budget is split by weight over the tenants asking.

    ``placement`` is the state a live move leaves (``{"generation": G,
    "overrides": {rank: shard}, "rank_generations": {rank: gen},
    "addresses": [[host, port], ...]}``): a rank overridden onto this
    shard is adopted (``_extra_ranks``), one overridden away from its
    static home here answers its GETs with a ``KIND_MOVED`` redirect
    (``_moved``), and each data frame carries its rank's generation
    (``_rank_gen``). ``OP_REBALANCE`` changes all three while the server
    runs.
    """

    def __init__(self, queue: mq.MultiQueue, address: Tuple[str, int],
                 num_trainers: int = 1, journal=None,
                 initial_state: Optional[Dict[int, object]] = None,
                 exit_on_crash_site: bool = False,
                 shard_index: int = 0, num_shards: int = 1,
                 handle_dir: Optional[str] = None,
                 tenants: Optional[dict] = None,
                 placement: Optional[dict] = None):
        self._queue = queue
        self._num_trainers = max(1, num_trainers)
        self._journal = journal
        self._exit_on_crash_site = exit_on_crash_site
        self._shard_index = shard_index
        self._num_shards = max(1, num_shards)
        placement = placement or {}
        self._placement_gen = int(placement.get("generation", 0))
        self._rank_gen: Dict[int, int] = {
            int(r): int(g)
            for r, g in dict(placement.get("rank_generations", {})).items()}
        self._sealed_ranks: set = set()
        self._extra_ranks: set = set()
        self._moved: Dict[int, Tuple[int, Tuple[str, int]]] = {}
        addresses = [tuple(a) for a in placement.get("addresses", ())]
        for r, s in dict(placement.get("overrides", {})).items():
            rank, shard_for_rank = int(r), int(s)
            static = rank % self._num_shards
            if shard_for_rank == static:
                continue
            if shard_for_rank == self._shard_index:
                self._extra_ranks.add(rank)
            elif static == self._shard_index:
                if shard_for_rank >= len(addresses):
                    raise ValueError(
                        f"placement override routes rank {rank} to shard "
                        f"{shard_for_rank} but only {len(addresses)} "
                        f"addresses were supplied")
                self._moved[rank] = (
                    self._rank_gen.get(rank, self._placement_gen),
                    (str(addresses[shard_for_rank][0]),
                     int(addresses[shard_for_rank][1])))
        self._timeout_s = rt_policy.resolve("queue", "queue_timeout_s")
        self._nodelay = rt_policy.resolve("queue", "queue_nodelay")
        self._replay_budget = rt_policy.resolve("queue",
                                                "queue_replay_bytes")
        # Tenancy: the replay budget split by tenant weight. With no
        # table and no OP_TENANT bind ``_fair`` stays None and the server
        # serves as a single tenant would.
        self._tenants = rt_tenancy.tenants_from_config(tenants)
        self._tenant_lock = threading.Lock()
        self._rank_tenant: Dict[int, str] = {}
        for tenant_id, spec in self._tenants.items():
            for rank in spec.get("ranks", ()):
                self._rank_tenant[int(rank)] = tenant_id
        self._fair: Optional[rt_fairshare.FairShare] = None
        if self._tenants:
            self._fair = self._new_fair_share()
        self._floor_pace_s = float(rt_policy.resolve(
            "queue", "tenant_floor_pace_s"))
        self._tenant_replay: Dict[str, int] = {}
        self._lease_timeout_s = rt_policy.resolve("queue",
                                                  "queue_lease_timeout_s")
        self._on_dead_consumer = rt_policy.resolve("queue",
                                                   "on_dead_consumer")
        if self._on_dead_consumer not in ("fail_fast", "drain",
                                          "redistribute"):
            raise ValueError(
                f"RSDL_QUEUE_ON_DEAD_CONSUMER must be fail_fast, drain, or "
                f"redistribute, got {self._on_dead_consumer!r}")
        self._delivery = _resolve_delivery()
        self._compression = _resolve_compression()
        self._compression_min = rt_policy.resolve(
            "queue", "queue_compression_min_bytes")
        self._sendmsg = bool(rt_policy.resolve("queue", "queue_sendmsg"))
        codec_threads = int(rt_policy.resolve("queue",
                                              "queue_codec_threads"))
        # The bounded codec pool: frames compress on these threads while
        # the serving thread pops and serializes the next one, at most
        # codec_threads cores over every connection (0: inline).
        self._codec_pool = (
            cf.ThreadPoolExecutor(
                max_workers=codec_threads,
                thread_name_prefix=f"rsdl-codec-s{shard_index}")
            if self._compression and codec_threads > 0 else None)
        self._handle_dir = handle_dir
        self._own_handle_dir = False
        self._handle_names = itertools.count()
        shard = str(shard_index)
        self._payload_bytes = rt_metrics.counter(
            "rsdl_queue_payload_bytes_total",
            "logical (uncompressed) table-payload bytes served", shard=shard)
        self._wire_bytes = rt_metrics.counter(
            "rsdl_queue_bytes_on_wire_total",
            "payload bytes actually written to consumer sockets",
            shard=shard)
        self._handle_hits = rt_metrics.counter(
            "rsdl_queue_handle_hits_total",
            "table frames delivered as shm segment handles", shard=shard)
        self._handle_misses = rt_metrics.counter(
            "rsdl_queue_handle_misses_total",
            "table frames streamed as bytes (no handle possible)",
            shard=shard)
        self._compression_saved = rt_metrics.counter(
            "rsdl_queue_compression_saved_bytes_total",
            "payload bytes saved by frame compression", shard=shard)
        self._shard_depth = rt_metrics.gauge(
            "rsdl_queue_shard_depth",
            "items resident across this shard's served queues", shard=shard)
        self._replayed = rt_metrics.counter(
            "rsdl_queue_frames_replayed_total",
            "frames re-sent from the server replay buffer")
        self._nacked = rt_metrics.counter(
            "rsdl_queue_frames_nacked_total",
            "frames NACK'd by consumers (CRC mismatch)")
        self._lease_expiries = rt_metrics.counter(
            "rsdl_queue_lease_expiries_total",
            "consumer leases that expired without a heartbeat")
        self._consumers_alive = rt_metrics.gauge(
            "rsdl_queue_consumers_alive",
            "consumers with a live (unexpired) lease")
        self._anchors = rt_lat.ClockAnchors()
        self._states: Dict[int, _QueueState] = {}
        self._states_lock = threading.Lock()
        for q, entry in (initial_state or {}).items():
            births = {seq: rt_lat.Stamp(int(pid), float(tm), float(tu))
                      for seq, (pid, tm, tu)
                      in getattr(entry, "births", {}).items()}
            self._states[q] = _QueueState(next_seq=entry.seq + 1,
                                          rows=entry.rows, done=entry.done,
                                          births=births)
        self._leases: Dict[int, _Lease] = {}
        self._lease_lock = threading.Lock()
        self._lease_thread: Optional[threading.Thread] = None
        self._drained_ranks: set = set()
        self._conn_threads: set = set()
        self._conn_lock = threading.Lock()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(address)
        listener.listen(16)
        # A finite accept timeout: the loop ticks, so close() stops it.
        listener.settimeout(1.0)
        self._listener = listener
        self._closed = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rsdl-qserve-accept")
        self._accept_thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()

    # -- connection plumbing ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self._nodelay:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # A finite receive timeout (0: none), so a wedged peer cannot
            # pin its handler.
            conn.settimeout(self._timeout_s or None)
            thread = threading.Thread(target=self._serve_conn, args=(conn,),
                                      daemon=True, name="rsdl-qserve-conn")
            with self._conn_lock:
                self._conn_threads.add(thread)
            thread.start()

    def _state(self, queue_idx: int) -> _QueueState:
        with self._states_lock:
            state = self._states.get(queue_idx)
            if state is None:
                state = self._states[queue_idx] = _QueueState()
            return state

    def _pop(self, queue_idx: int, blocking: bool, consumer_id):
        """One pop. A blocking pop ticks every 0.25 s so that close() and
        the consumer's lease stay live while the queue is idle; the
        queue's own ``ShutdownError`` propagates (a failure frame)."""
        rank = plan_ir.queue_rank(queue_idx, self._num_trainers)
        while not self._closed.is_set():
            try:
                return self._queue.get(queue_idx, block=blocking,
                                       timeout=0.25 if blocking else None)
            except mq.Empty:
                if not blocking:
                    return _POP_EMPTY
                if rank in self._sealed_ranks:
                    # PREPARE sealed the rank under this parked GET, and
                    # its export needs the queue's state lock the caller
                    # holds: answer with an empty batch (the consumer
                    # asks again and meets the seal or the redirect).
                    return _POP_EMPTY
                # A consumer blocked in a GET here is alive.
                self._lease_beat(consumer_id, None)
        return _POP_CLOSED

    # -- frame building and serving -----------------------------------------

    def _epoch_of(self, queue_idx: int) -> int:
        return plan_ir.queue_epoch(queue_idx, self._num_trainers)

    def _owns_queue(self, queue_idx: int) -> bool:
        rank = plan_ir.queue_rank(queue_idx, self._num_trainers)
        if rank in self._moved:
            return False
        if rank in self._extra_ranks:
            return True
        return (self._num_shards <= 1
                or plan_ir.queue_shard(queue_idx, self._num_trainers,
                                       self._num_shards)
                == self._shard_index)

    # -- tenancy --------------------------------------------------------

    def _new_fair_share(self) -> rt_fairshare.FairShare:
        return rt_fairshare.FairShare(
            {t: spec["weight"] for t, spec in self._tenants.items()},
            int(self._replay_budget),
            quantum_bytes=int(rt_policy.resolve(
                "queue", "tenant_drr_quantum_bytes")),
            active_window_s=float(rt_policy.resolve(
                "queue", "tenant_active_window_s")))

    def _tenant_of_queue(self, queue_idx: int) -> str:
        """The tenant a queue's bytes belong to: its rank's entry in the
        table (or the wire-bound tenant that claimed the rank), else the
        default tenant."""
        rank = plan_ir.queue_rank(queue_idx, self._num_trainers)
        with self._tenant_lock:
            return self._rank_tenant.get(rank,
                                         rt_tenancy.DEFAULT_TENANT_ID)

    @staticmethod
    def _tenant_counters(tenant_id: str) -> tuple:
        """(delivered bytes, replay bytes, budget) metrics of a tenant."""
        return (rt_metrics.counter("rsdl_tenant_bytes_delivered_total",
                                   "payload bytes delivered per tenant",
                                   tenant=tenant_id),
                rt_metrics.gauge("rsdl_tenant_replay_bytes",
                                 "unacked (in-flight) bytes held per tenant",
                                 tenant=tenant_id),
                rt_metrics.gauge("rsdl_tenant_budget_bytes",
                                 "weighted-fair share of the replay budget",
                                 tenant=tenant_id))

    def _charge_tenant(self, queue_idx: int, delta: int,
                       tenant_id: Optional[str] = None) -> str:
        """Add ``delta`` replay bytes to a tenant's ledger (a positive one
        also to its round-robin deficit) and return the tenant. A pop
        pins the returned tenant on its frame; an ack, reset or drain
        passes the pinned tenant back, so the credit lands where the debit
        did even if an ``OP_TENANT`` rebound the rank in between."""
        if tenant_id is None:
            tenant_id = self._tenant_of_queue(queue_idx)
        with self._tenant_lock:
            self._tenant_replay[tenant_id] = \
                self._tenant_replay.get(tenant_id, 0) + delta
            replay = self._tenant_replay[tenant_id]
        self._tenant_counters(tenant_id)[1].set(replay)
        if delta > 0 and self._fair is not None:
            self._fair.charge(tenant_id, delta)
        return tenant_id

    def _tenant_may_pop(self, tenant_id: str) -> bool:
        """May a GET pop a frame past its first: the tenant's unacked
        bytes are under its weighted share of the replay budget and the
        round robin grants it another frame."""
        fair = self._fair
        if fair is None:
            return True
        budget = fair.budget(tenant_id)
        self._tenant_counters(tenant_id)[2].set(budget)
        with self._tenant_lock:
            replay = self._tenant_replay.get(tenant_id, 0)
        if replay >= budget:
            return False
        return fair.grant(tenant_id)

    def _bind_wire_tenant(self, consumer_id: Optional[int],
                          blob: bytes) -> None:
        """``OP_TENANT``: bind a consumer's lease (and the ranks it then
        GETs) to the announced ``TenantContext``. A malformed blob is
        logged and ignored: tenancy never kills a connection."""
        try:
            ctx = rt_tenancy.TenantContext.from_json(blob)
        except (ValueError, KeyError, TypeError,
                UnicodeDecodeError) as e:
            logger.warning("ignoring malformed OP_TENANT blob: %s", e)
            return
        # One critical section, so two binds cannot build rival
        # schedulers. FairShare's lock is a leaf: taking it here (inside
        # the constructor or set_weight) cannot invert an order.
        with self._tenant_lock:
            known = ctx.tenant_id in self._tenants
            if not known:
                self._tenants[ctx.tenant_id] = \
                    {"weight": ctx.effective_weight}
            if self._fair is None:
                self._fair = self._new_fair_share()
            elif not known:
                # The server's table wins over a wire-announced weight
                # for the tenants it names.
                self._fair.set_weight(ctx.tenant_id,
                                      ctx.effective_weight)
        with self._lease_lock:
            if consumer_id is not None:
                lease = self._leases.get(consumer_id)
                if lease is not None:
                    lease.tenant = ctx.tenant_id
        logger.info("consumer %s bound to tenant %r (weight %.1f)",
                    f"{consumer_id:x}" if consumer_id is not None
                    else "?", ctx.tenant_id, ctx.effective_weight)

    def _ensure_handle_dir(self) -> str:
        """The directory of handle frames' segments: made at first use
        under the shm root, or the one the caller pinned (a supervised
        shard's, so its restarts reuse it)."""
        if self._handle_dir is None:
            self._handle_dir = tempfile.mkdtemp(
                prefix=f"rsdl-qhandles-s{self._shard_index}-",
                dir=pp.shm_base_dir())
            self._own_handle_dir = True
        else:
            os.makedirs(self._handle_dir, exist_ok=True)
        return self._handle_dir

    def _release_frame(self, frame: _Frame) -> None:
        """Unpin and unlink a handle frame's segment (a consumer that
        mapped it keeps its mapping); nothing for other frames."""
        pp.release_segment(frame.ledger_id, frame.handle_path, unlink=True)
        frame.ledger_id = None

    def _make_frame(self, queue_idx: int, seq: int, kind: int, data,
                    nrows: int, task: int, row_offset: int,
                    want_handle: bool = False,
                    restored_birth=None) -> _Frame:
        """Build one frame, serializing a table once. With
        ``want_handle`` (and delivery not ``"stream"``) the serialized
        buffer becomes a shm segment, pinned in the buffer ledger, and the
        wire carries only its handle; otherwise the buffer is the wire
        payload (compressed under ``queue_compression``, inline or by the
        codec pool; the CRC is taken first, over the uncompressed bytes).

        Its birth is the journal's for this seq where this server
        regenerates it after a restart (the regenerated table's own stamp
        is fresh, and would hide the crash from the latency record), else
        the table's ``rsdl.birth``, journaled here. Observes
        ``birth_to_queued``."""
        epoch = self._epoch_of(queue_idx)
        queued = rt_lat.now_stamp()
        if kind != KIND_TABLE:
            return _Frame(seq, kind, epoch, data, _crc(data), row_offset,
                          nrows, task, queued=queued)
        birth = restored_birth
        if birth is None:
            meta = data.schema.metadata
            birth = rt_lat.parse_stamp(
                meta.get(rt_lat.BIRTH_META_KEY) if meta else None)
            if birth is not None and self._journal is not None:
                self._journal.record_birth(queue_idx, seq, *birth)
        if birth is not None:
            rt_lat.observe_hop(
                rt_lat.HOP_BIRTH_TO_QUEUED,
                str(plan_ir.queue_rank(queue_idx, self._num_trainers)),
                self._anchors.latency_s(birth, now_mono=queued.t_mono,
                                        now_unix=queued.t_unix))
        buf = _serialize(data)
        logical = buf.size
        data_crc = _crc(buf)
        if want_handle and self._delivery != "stream":
            path = os.path.join(
                self._ensure_handle_dir(),
                f"h{os.getpid()}_{next(self._handle_names)}.arrow")
            pp.write_buffer_segment(buf, path)
            ledger_id = pp.pin_segment(logical)
            blob = json.dumps({"path": path, "offset": 0, "size": logical,
                               "crc": data_crc}).encode()
            self._handle_hits.inc()
            return _Frame(seq, KIND_TABLE_HANDLE, epoch, blob, _crc(blob),
                          row_offset, nrows, task, payload_bytes=logical,
                          data_crc=data_crc, handle_path=path,
                          ledger_id=ledger_id, birth=birth, queued=queued)
        self._handle_misses.inc()
        wire: object = buf
        codec = CODEC_NONE
        pending = None
        if self._compression and logical >= self._compression_min:
            codec_id, compress = self._compression
            if self._codec_pool is not None:
                # _collect_frames lands it before the batch leaves the
                # queue's lock.
                pending = (self._codec_pool.submit(compress, buf), codec_id)
            else:
                compressed = compress(buf)
                if len(compressed) < logical:
                    wire, codec = compressed, codec_id
                    self._compression_saved.inc(logical - len(compressed))
        frame = _Frame(seq, KIND_TABLE, epoch, wire, data_crc, row_offset,
                       nrows, task, codec=codec, payload_bytes=logical,
                       data_crc=data_crc, birth=birth, queued=queued)
        frame.pending_codec = pending
        return frame

    def _downgrade_frame(self, frame: _Frame) -> _Frame:
        """A handle frame as a streamed one (after NACK_NO_HANDLE): the
        segment this server wrote, mapped, is the wire payload. Seq, rows
        and the segment's pin carry over (no second pin), so its ack
        releases it once; the CRC is the stored segment CRC, and the
        tenant charged at its pop stays the one its ack credits."""
        buf = pp.read_segment_buffer(frame.handle_path)
        downgraded = _Frame(frame.seq, KIND_TABLE, frame.epoch, buf,
                            frame.data_crc, frame.row_offset, frame.nrows,
                            frame.task, payload_bytes=frame.payload_bytes,
                            data_crc=frame.data_crc,
                            handle_path=frame.handle_path,
                            ledger_id=frame.ledger_id, birth=frame.birth,
                            queued=frame.queued)
        downgraded.tenant = frame.tenant
        return downgraded

    def _note_shard_depth(self) -> None:
        if rt_telemetry.stamp():
            with self._states_lock:
                queues = list(self._states)
            self._shard_depth.set(sum(self._queue.sizes(queues)))

    def _apply_ack(self, queue_idx: int, state: _QueueState,
                   ack: int) -> None:
        state.acked_seq = ack
        done = state.done
        while state.replay and state.replay[0].seq <= ack:
            frame = state.replay.popleft()
            state.replay_bytes -= frame.size
            self._charge_tenant(queue_idx, -frame.size, frame.tenant)
            self._release_frame(frame)
            state.acked_rows = frame.row_offset + frame.nrows
            if frame.kind == KIND_SENTINEL:
                done = True
        state.done = done
        if self._journal is not None:
            self._journal.record(queue_idx, ack, state.acked_rows,
                                 done=done)

    def _collect_frames(self, queue_idx: int, max_items: int,
                        ack: Optional[int], resume: bool,
                        consumer_id, handles_ok: bool = False
                        ) -> Optional[List[_Frame]]:
        """One response: the unacked frames past the send cursor first,
        then new pops. None when the server closed under the blocking
        pop. ``handles_ok`` is the connection's HELLO offer; a queue
        NACK'd with NACK_NO_HANDLE streams whatever it offers."""
        # The whole server process dying mid-epoch (the supervisor's
        # unit of recovery): in its own process a real exit, here a
        # closed server.
        try:
            rt_faults.inject("queue_server_crash",
                             epoch=self._epoch_of(queue_idx),
                             task=queue_idx)
        except rt_faults.InjectedFault:
            if self._exit_on_crash_site:
                os._exit(137)
            self.close()
            raise
        tenant_id = self._tenant_of_queue(queue_idx)
        if self._fair is not None:
            # Every GET marks its tenant active (the budget is split over
            # the tenants asking).
            self._fair.touch(tenant_id)
            if not sum(self._queue.sizes([queue_idx])):
                # Nothing queued for it now (a live stream between
                # frames): its unspent credit must not gate tenants that
                # have work. It rejoins with a fresh quantum.
                self._fair.idle(tenant_id)
            elif self._floor_pace_s > 0 and not self._tenant_may_pop(
                    tenant_id):
                # A tenant the scheduler denies still gets its one frame
                # per GET, but paced: on loopback an unpaced floor alone
                # out-delivers the grants and the weights shape nothing.
                # The probe spends no credit. The sleep comes before the
                # queue's state lock, which a live move's PREPARE takes.
                time.sleep(self._floor_pace_s)
        state = self._state(queue_idx)
        sealed = (plan_ir.queue_rank(queue_idx, self._num_trainers)
                  in self._sealed_ranks)
        with state.lock:
            want_handle = handles_ok and not state.no_handles
            if ack is not None and ack > state.acked_seq:
                self._apply_ack(queue_idx, state, ack)
            if resume:
                # A reconnect: rewind to the watermark so the frames a
                # reset ate are sent again.
                state.sent_seq = state.acked_seq
            if not want_handle and any(
                    f.kind == KIND_TABLE_HANDLE and f.seq > state.sent_seq
                    for f in state.replay):
                # Handles withdrawn (a NACK_NO_HANDLE, or a connection
                # that offers none): the unsent handle frames stream in
                # place, same seqs, bytes and CRCs.
                state.replay = collections.deque(
                    self._downgrade_frame(f)
                    if f.kind == KIND_TABLE_HANDLE
                    and f.seq > state.sent_seq else f
                    for f in state.replay)
            frames: List[_Frame] = [f for f in state.replay
                                    if f.seq > state.sent_seq][:max_items]
            if frames:
                self._replayed.inc(len(frames))
                rt_telemetry.record("frame_replay", epoch=frames[0].epoch,
                                    task=queue_idx, count=len(frames))
            try:
                # A sealed rank serves only its replay suffix: the manifest
                # holds everything past the watermark, and a new pop here
                # would fork the stream the target adopts.
                while (not sealed and len(frames) < max_items
                       and (not frames
                            or frames[-1].kind in (KIND_TABLE,
                                                   KIND_TABLE_HANDLE))):
                    if frames and state.replay_bytes > self._replay_budget:
                        # Backpressure: the unacked bytes are at the
                        # budget. At least one frame per GET, so acks can
                        # progress.
                        break
                    if frames and not self._tenant_may_pop(tenant_id):
                        # Weighted-fair backpressure: the tenant's unacked
                        # bytes reached its share of the budget, or the
                        # round robin owes the next frames to another
                        # tenant. The same one-frame floor.
                        break
                    item = self._pop(queue_idx, blocking=not frames,
                                     consumer_id=consumer_id)
                    if item is _POP_CLOSED:
                        return frames or None
                    if item is _POP_EMPTY:
                        break
                    kind, data, nrows, task = _materialize(item)
                    seq = state.next_seq
                    state.next_seq += 1
                    row_offset = state.rows_total
                    state.rows_total += nrows
                    if seq <= state.acked_seq:
                        # Regenerated after a restart and already consumed
                        # (the ack outran the journal): dropped, its rows
                        # counted.
                        state.acked_rows = row_offset + nrows
                        state.births.pop(seq, None)
                        continue
                    frame = self._make_frame(
                        queue_idx, seq, kind, data, nrows, task, row_offset,
                        want_handle,
                        restored_birth=state.births.pop(seq, None))
                    state.replay.append(frame)
                    state.replay_bytes += frame.size
                    frame.tenant = self._charge_tenant(queue_idx,
                                                       frame.size)
                    frames.append(frame)
            finally:
                # Every pending compression lands before the batch leaves
                # the lock, on every exit: the replay buffer and the wire
                # serve the same bytes.
                for f in frames:
                    if f.pending_codec is not None:
                        delta = f.resolve_codec()
                        state.replay_bytes += delta
                        if delta:
                            self._charge_tenant(queue_idx, delta,
                                                f.tenant)
                        if delta < 0:
                            self._compression_saved.inc(-delta)
            if frames:
                state.sent_seq = frames[-1].seq
        if sealed and not frames:
            # An empty batch is an answer (the client asks again); paced,
            # so a consumer polling a sealed, drained queue does not spin
            # until the redirect or the unseal.
            time.sleep(0.05)
        self._note_shard_depth()
        return frames

    def _send_frames(self, conn: socket.socket, queue_idx: int,
                     frames: List[_Frame]) -> None:
        """Write one GET response: with ``queue_sendmsg`` one
        scatter-gather ``sendmsg`` of the batch header and every frame's
        header and payload, else a ``sendall`` per piece; the same bytes
        either way, chaos sites included (a torn header flushes what the
        sequential writes would have sent before the reset)."""
        gather = self._sendmsg and hasattr(conn, "sendmsg")
        gen = self._rank_gen.get(
            plan_ir.queue_rank(queue_idx, self._num_trainers), 0)
        vecs: List = [_BATCH_HEADER.pack(len(frames))]
        if not gather:
            conn.sendall(vecs[0])
            vecs.clear()
        for frame in frames:
            size = frame.wire_len
            header = _FRAME.pack(frame.kind | (frame.codec << 4),
                                 frame.epoch, frame.seq, frame.crc,
                                 frame.row_offset, size, frame.task,
                                 *_pack_stamp(frame.birth),
                                 *_pack_stamp(frame.queued), gen)
            try:
                rt_faults.inject("conn_reset_midframe", epoch=frame.epoch,
                                 task=queue_idx)
            except rt_faults.InjectedFault as e:
                # Half a header, then a hard close: the consumer sees the
                # bytes stop mid-frame.
                if gather:
                    vecs.append(header[:_FRAME.size // 2])
                    _sendmsg_all(conn, vecs)
                else:
                    # rsdl-lint: disable=sendall-in-loop
                    conn.sendall(header[:_FRAME.size // 2])
                raise ConnectionError(
                    f"injected connection reset mid-frame: {e}") from e
            payload = None
            if size:
                payload = frame.wire
                # Only a frame with a payload can be corrupted (a
                # sentinel's injection would damage nothing).
                try:
                    rt_faults.inject("frame_corrupt", epoch=frame.epoch,
                                     task=queue_idx)
                except rt_faults.InjectedFault:
                    # One byte flipped on the wire only: the replay
                    # buffer keeps the good copy the NACK asks for.
                    payload = bytearray(memoryview(frame.wire))
                    payload[-1] ^= 0xFF
            if gather:
                vecs.append(header)
                if payload is not None:
                    vecs.append(payload)
            else:
                # The sequential arm, the reference the gather path's
                # bytes are held against: per frame by design.
                # rsdl-lint: disable=sendall-in-loop
                conn.sendall(header)
                if payload is not None:
                    # rsdl-lint: disable=sendall-in-loop
                    conn.sendall(payload)
            if frame.kind in (KIND_TABLE, KIND_TABLE_HANDLE):
                self._wire_bytes.inc(size)
                self._payload_bytes.inc(frame.payload_bytes)
                self._tenant_counters(self._tenant_of_queue(queue_idx))[
                    0].inc(frame.payload_bytes)
        if gather:
            _sendmsg_all(conn, vecs)

    @staticmethod
    def _fail_frame(text: bytes) -> bytes:
        """A one-frame failure response (generation 0: past any fence)."""
        return (_BATCH_HEADER.pack(1)
                + _FRAME.pack(KIND_FAILURE, 0, ACK_NONE, _crc(text), 0,
                              len(text), TASK_NONE, 0.0, 0.0, 0,
                              0.0, 0.0, 0, 0) + text)

    def _moved_frame(self, queue_idx: int, rank: int) -> bytes:
        """A one-frame ``KIND_MOVED`` redirect to the shard that adopted
        ``rank``; the header's generation repeats the payload's, so the
        consumer raises its fence before it dials the new address."""
        generation, (host, port) = self._moved[rank]
        blob = json.dumps({"host": host, "port": port,
                           "generation": generation, "rank": rank},
                          sort_keys=True).encode()
        return (_BATCH_HEADER.pack(1)
                + _FRAME.pack(KIND_MOVED, 0, ACK_NONE, _crc(blob), 0,
                              len(blob), TASK_NONE, 0.0, 0.0, 0,
                              0.0, 0.0, 0, generation) + blob)

    def _serve_conn(self, conn: socket.socket) -> None:
        consumer_id: Optional[int] = None
        handles_ok = False
        try:
            while not self._closed.is_set():
                try:
                    raw = conn.recv(_REQUEST.size)
                except socket.timeout:
                    continue  # an idle tick; leases expire on their own
                if not raw:
                    return  # the consumer is done
                if len(raw) < _REQUEST.size:
                    raw += _recv_exact(conn, _REQUEST.size - len(raw))
                op, flags, a, b, c = _REQUEST.unpack(raw)
                if op == OP_HELLO:
                    consumer_id = a | (b << 32)
                    handles_ok = bool(flags & FLAG_HANDLES_OK)
                    self._lease_beat(consumer_id, None)
                    continue
                if op == OP_HEARTBEAT:
                    self._lease_beat(consumer_id, None)
                    continue
                if op == OP_NACK:
                    self._handle_nack(a, b, c)
                    self._lease_beat(consumer_id, a)
                    continue
                if op == OP_TENANT:
                    blob = _recv_exact(conn, c) if c else b""
                    self._lease_beat(consumer_id, None)
                    self._bind_wire_tenant(consumer_id, blob)
                    continue
                if op == OP_REBALANCE:
                    blob = _recv_exact(conn, c) if c else b""
                    reply = self._rebalance_admin(flags, a, b, blob)
                    conn.sendall(_BATCH_HEADER.pack(len(reply)) + reply)
                    continue
                if op != OP_GET_BATCH:
                    raise ConnectionError(f"unknown request op {op}")
                queue_idx, max_items = a, b
                moved_rank = plan_ir.queue_rank(queue_idx,
                                                self._num_trainers)
                if moved_rank in self._moved:
                    # The rank moved away under a committed decision: a
                    # redirect, never a stream this shard no longer owns.
                    conn.sendall(self._moved_frame(queue_idx, moved_rank))
                    continue
                if not self._owns_queue(queue_idx):
                    # A consumer dialling the wrong shard fails loudly; a
                    # foreign rank's stream is never served.
                    conn.sendall(self._fail_frame(
                        f"queue {queue_idx} is not served by shard "
                        f"{self._shard_index}/{self._num_shards} "
                        f"(plan query queue_shard)".encode()))
                    continue
                if not 0 <= queue_idx < self._queue.num_queues:
                    # Past the served epochs (a stream's consumer
                    # prefetching the epoch after a frozen schedule's
                    # last window): a failure frame, not a dead
                    # connection the client would redial.
                    conn.sendall(self._fail_frame(
                        f"queue {queue_idx} is past the "
                        f"{self._queue.num_queues} queues this server "
                        "serves".encode()))
                    continue
                ack = None if c == ACK_NONE else c
                self._lease_beat(consumer_id, queue_idx)
                try:
                    frames = self._collect_frames(
                        queue_idx, max(1, max_items), ack,
                        bool(flags & FLAG_RESUME), consumer_id,
                        handles_ok=handles_ok)
                except mq.ShutdownError as e:
                    # The queue shut down under a blocked GET: fail loudly.
                    conn.sendall(self._fail_frame(repr(e).encode()))
                    return
                if frames is None:
                    return  # the server is closing
                self._send_frames(conn, queue_idx, frames)
        except rt_faults.InjectedFault as e:
            logger.error("queue server down at an injected crash: %s", e)
        except (ConnectionError, OSError) as e:
            if not self._closed.is_set():
                logger.warning("queue server connection dropped: %s", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                self._conn_threads.discard(threading.current_thread())

    def _handle_nack(self, queue_idx: int, bad_seq: int,
                     mode: int = NACK_CRC) -> None:
        state = self._state(queue_idx)
        with state.lock:
            state.sent_seq = min(state.sent_seq, bad_seq - 1)
            if mode == NACK_NO_HANDLE:
                # The consumer cannot map this queue's segments: streamed
                # from now on, the rewound frames downgraded at the next
                # GET.
                state.no_handles = True
        self._nacked.inc()
        if mode == NACK_NO_HANDLE:
            rt_telemetry.record("handle_downgrade",
                                epoch=self._epoch_of(queue_idx),
                                task=queue_idx, seq=bad_seq)
            logger.warning(
                "queue %d: consumer cannot use the shm handle of frame %d; "
                "streaming the queue from now on", queue_idx, bad_seq)
            return
        rt_telemetry.record("frame_nack", epoch=self._epoch_of(queue_idx),
                            task=queue_idx, seq=bad_seq)
        logger.warning("queue %d: consumer NACK'd frame %d (CRC mismatch); "
                       "re-sending from replay", queue_idx, bad_seq)

    # -- live queue migration (rebalance/) ----------------------------------

    def _rank_queues(self, rank: int) -> List[int]:
        """The queues of ``rank`` this server holds state for."""
        with self._states_lock:
            return sorted(q for q in self._states
                          if plan_ir.queue_rank(q, self._num_trainers)
                          == rank)

    def _crash_site(self, site: str, generation: int, rank: int) -> None:
        """A migration phase's chaos site: the whole server dying there
        (the unit of ``queue_server_crash``)."""
        try:
            rt_faults.inject(site, epoch=generation, task=rank)
        except rt_faults.InjectedFault:
            if self._exit_on_crash_site:
                os._exit(137)
            self.close()
            raise

    def _rebalance_admin(self, phase: int, rank: int, generation: int,
                         payload: bytes) -> bytes:
        """One OP_REBALANCE phase. Every answer is a
        ``checkpoint.crc_line``; an error comes back as ``{"error": ...}``
        so the driver aborts cleanly instead of meeting a reset."""
        from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
        try:
            if phase == REB_PREPARE:
                self._crash_site("rebalance_prepare", generation, rank)
                line = self._export_rank(rank, generation)
                rt_telemetry.record("rebalance_prepare", epoch=generation,
                                    task=rank, shard=self._shard_index)
                return line
            if phase == REB_ADOPT:
                self._crash_site("rebalance_commit", generation, rank)
                # The manifest's CRC is checked here, on the target: the
                # driver forwards the source's line as it came.
                manifest = ckpt.parse_crc_line(
                    payload.decode("utf-8"))["manifest"]
                self._import_rank(manifest)
                rt_telemetry.record("rebalance_commit", epoch=generation,
                                    task=rank, shard=self._shard_index)
                return ckpt.crc_line({"adopted": rank,
                                      "generation": generation}).encode()
            if phase == REB_RELEASE:
                target = json.loads(payload.decode("utf-8"))
                self._release_rank(rank, generation,
                                   (str(target["host"]),
                                    int(target["port"])))
                rt_telemetry.record("rebalance_release", epoch=generation,
                                    task=rank, shard=self._shard_index)
                return ckpt.crc_line({"released": rank,
                                      "generation": generation}).encode()
            if phase == REB_UNSEAL:
                self._sealed_ranks.discard(rank)
                rt_telemetry.record("rebalance_unseal", epoch=generation,
                                    task=rank, shard=self._shard_index)
                return ckpt.crc_line({"unsealed": rank}).encode()
            return ckpt.crc_line(
                {"error": f"unknown rebalance phase {phase}"}).encode()
        except rt_faults.InjectedFault:
            raise
        except Exception as e:  # noqa: BLE001 - reported to the driver
            logger.warning("rebalance phase %d for rank %d failed: %s",
                           phase, rank, e)
            return ckpt.crc_line({"error": repr(e)}).encode()

    def _export_rank(self, rank: int, generation: int) -> bytes:
        """PREPARE: seal ``rank`` and export what a target needs to go on
        with its streams exactly once: per queue the seq cursor, the row
        accounting, the journaled births and every unacked frame as base64
        bytes (a pending compression landed first; a handle frame
        downgraded to its segment's bytes, since another shard cannot map
        this one's segments; its pin stays with the frame here until the
        RELEASE). One ``checkpoint.crc_line`` carries it all."""
        from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
        self._sealed_ranks.add(rank)
        queues: Dict[str, dict] = {}
        for q in self._rank_queues(rank):
            state = self._state(q)
            with state.lock:
                frames = []
                for frame in state.replay:
                    if frame.pending_codec is not None:
                        state.replay_bytes += frame.resolve_codec()
                    if frame.kind == KIND_TABLE_HANDLE:
                        frame = self._downgrade_frame(frame)
                    frames.append({
                        "seq": frame.seq, "kind": frame.kind,
                        "epoch": frame.epoch, "crc": frame.crc,
                        "data_crc": frame.data_crc,
                        "row_offset": frame.row_offset,
                        "nrows": frame.nrows, "task": frame.task,
                        "codec": frame.codec,
                        "payload_bytes": frame.payload_bytes,
                        "wire": base64.b64encode(
                            memoryview(frame.wire)).decode("ascii"),
                        "birth": list(frame.birth) if frame.birth else None,
                        "queued": (list(frame.queued)
                                   if frame.queued else None),
                    })
                queues[str(q)] = {
                    "next_seq": state.next_seq,
                    "acked_seq": state.acked_seq,
                    "acked_rows": state.acked_rows,
                    "rows_total": state.rows_total,
                    "done": state.done,
                    "births": {str(seq): list(stamp)
                               for seq, stamp in state.births.items()},
                    "frames": frames,
                }
        manifest = {"rank": rank, "generation": generation,
                    "num_trainers": self._num_trainers,
                    "source_shard": self._shard_index,
                    "queues": queues}
        return ckpt.crc_line({"manifest": manifest}).encode()

    def _import_rank(self, manifest: dict) -> None:
        """ADOPT: install an exported rank's queue states (adopting the
        same generation again is a no-op) and merge its births and
        watermarks into this shard's journal, so a restart of the target
        after the adoption regenerates the undelivered remainder."""
        rank = int(manifest["rank"])
        generation = int(manifest["generation"])
        if int(manifest["num_trainers"]) != self._num_trainers:
            raise ValueError(
                f"manifest num_trainers {manifest['num_trainers']} != "
                f"server num_trainers {self._num_trainers}")
        if self._rank_gen.get(rank, 0) >= generation > 0:
            logger.warning("rank %d already adopted at generation >= %d; "
                           "treating re-adopt as a no-op", rank, generation)
            return
        for q_str, entry in manifest["queues"].items():
            q = int(q_str)
            births = {
                int(seq): rt_lat.Stamp(int(pid), float(tm), float(tu))
                for seq, (pid, tm, tu) in entry["births"].items()}
            state = _QueueState(next_seq=int(entry["next_seq"]),
                                done=bool(entry["done"]), births=births)
            state.acked_seq = int(entry["acked_seq"])
            state.sent_seq = state.acked_seq
            state.acked_rows = int(entry["acked_rows"])
            state.rows_total = int(entry["rows_total"])
            for f in entry["frames"]:
                birth = (rt_lat.Stamp(int(f["birth"][0]),
                                      float(f["birth"][1]),
                                      float(f["birth"][2]))
                         if f["birth"] else None)
                queued = (rt_lat.Stamp(int(f["queued"][0]),
                                       float(f["queued"][1]),
                                       float(f["queued"][2]))
                          if f["queued"] else None)
                frame = _Frame(int(f["seq"]), int(f["kind"]),
                               int(f["epoch"]),
                               base64.b64decode(f["wire"]),
                               int(f["crc"]), int(f["row_offset"]),
                               int(f["nrows"]), int(f["task"]),
                               codec=int(f["codec"]),
                               payload_bytes=int(f["payload_bytes"]),
                               data_crc=int(f["data_crc"]),
                               birth=birth, queued=queued)
                state.replay.append(frame)
                state.replay_bytes += frame.size
                frame.tenant = self._charge_tenant(q, frame.size)
            with self._states_lock:
                self._states[q] = state
            if self._journal is not None:
                for seq, stamp in births.items():
                    self._journal.record_birth(q, seq, stamp.pid,
                                               stamp.t_mono, stamp.t_unix)
                for frame in state.replay:
                    if frame.birth is not None:
                        self._journal.record_birth(
                            q, frame.seq, frame.birth.pid,
                            frame.birth.t_mono, frame.birth.t_unix)
                if state.acked_seq >= 0:
                    self._journal.record(q, state.acked_seq,
                                         state.acked_rows,
                                         done=state.done)
        self._rank_gen[rank] = generation
        self._extra_ranks.add(rank)
        self._moved.pop(rank, None)
        self._sealed_ranks.discard(rank)
        logger.warning("shard %d adopted rank %d at placement generation "
                       "%d (%d queue(s))", self._shard_index, rank,
                       generation, len(manifest["queues"]))

    def _release_rank(self, rank: int, generation: int,
                      target: Tuple[str, int]) -> None:
        """After the commit: drop the source's copy of a moved rank (its
        frames' pins released, its segments unlinked) and answer the
        rank's GETs with ``KIND_MOVED`` redirects. The ``MultiQueue`` is
        not drained: a committed move happens where both shards pop one
        shared queue (in-process shards), so the undelivered items flow
        to the target as they are."""
        for q in self._rank_queues(rank):
            state = self._state(q)
            with state.lock:
                while state.replay:
                    frame = state.replay.popleft()
                    state.replay_bytes -= frame.size
                    self._charge_tenant(q, -frame.size, frame.tenant)
                    self._release_frame(frame)
            with self._states_lock:
                self._states.pop(q, None)
        self._sealed_ranks.discard(rank)
        self._extra_ranks.discard(rank)
        self._moved[rank] = (generation, (str(target[0]), int(target[1])))
        logger.warning("shard %d released rank %d to %s:%d at placement "
                       "generation %d", self._shard_index, rank,
                       target[0], target[1], generation)

    # -- consumer leases ----------------------------------------------------

    def _lease_beat(self, consumer_id: Optional[int],
                    queue_idx: Optional[int]) -> None:
        if consumer_id is None:
            return
        with self._lease_lock:
            lease = self._leases.get(consumer_id)
            if lease is None:
                lease = self._leases[consumer_id] = _Lease(consumer_id)
                logger.info("consumer %x: lease granted", consumer_id)
            lease.last_beat = time.monotonic()
            lease.expired = False
            if queue_idx is not None:
                lease.queues.add(queue_idx)
                if lease.tenant is not None:
                    # A wire-bound tenant claims the ranks it GETs, so
                    # attribution needs no server-side table.
                    rank = plan_ir.queue_rank(queue_idx,
                                              self._num_trainers)
                    with self._tenant_lock:
                        self._rank_tenant.setdefault(rank, lease.tenant)
            self._consumers_alive.set(
                sum(1 for le in self._leases.values() if not le.expired))
            if (self._lease_thread is None
                    or not self._lease_thread.is_alive()):
                self._lease_thread = threading.Thread(
                    target=self._lease_sweeper, daemon=True,
                    name="rsdl-qserve-lease")
                self._lease_thread.start()

    def _lease_sweeper(self) -> None:
        interval = max(0.05, self._lease_timeout_s / 4.0)
        while not self._closed.wait(interval):
            now = time.monotonic()
            newly_dead: List[_Lease] = []
            with self._lease_lock:
                for lease in self._leases.values():
                    if (not lease.expired
                            and now - lease.last_beat
                            > self._lease_timeout_s):
                        lease.expired = True
                        newly_dead.append(lease)
                self._consumers_alive.set(
                    sum(1 for le in self._leases.values()
                        if not le.expired))
            for lease in newly_dead:
                self._on_lease_expired(lease)

    def _on_lease_expired(self, lease: _Lease) -> None:
        self._lease_expiries.inc()
        rt_telemetry.record("lease_expired", consumer=lease.consumer_id,
                            queues=sorted(lease.queues),
                            policy=self._on_dead_consumer)
        logger.error(
            "consumer %x: lease expired after %.1fs without a heartbeat "
            "(queues %s); policy=%s", lease.consumer_id,
            self._lease_timeout_s, sorted(lease.queues),
            self._on_dead_consumer)
        if self._on_dead_consumer == "fail_fast":
            # A dead trainer downs the pipeline loudly.
            self.close()
            return
        ranks = {plan_ir.queue_rank(q, self._num_trainers)
                 for q in lease.queues}
        with self._lease_lock:
            ranks -= self._drained_ranks
            self._drained_ranks |= ranks
        if not ranks:
            return
        threading.Thread(
            target=self._drain_dead_ranks,
            args=(ranks, self._on_dead_consumer == "redistribute"),
            daemon=True, name="rsdl-qserve-lease-drain").start()

    def notify_member_down(self, rank: int) -> None:
        """A membership ``down`` verdict for ``rank``: every live lease
        holding one of its queues expires now, without waiting out the
        lease clock, and the ``on_dead_consumer`` policy runs."""
        rank = int(rank)
        victims: List[_Lease] = []
        with self._lease_lock:
            for lease in self._leases.values():
                if lease.expired:
                    continue
                if any(plan_ir.queue_rank(q, self._num_trainers) == rank
                       for q in lease.queues):
                    lease.expired = True
                    victims.append(lease)
            self._consumers_alive.set(
                sum(1 for le in self._leases.values() if not le.expired))
        rt_telemetry.record("member_lease_sweep", task=rank,
                            leases=[le.consumer_id for le in victims])
        for lease in victims:
            logger.warning("consumer %x: lease force-expired (membership "
                           "declared rank %d down)", lease.consumer_id,
                           rank)
            self._on_lease_expired(lease)

    def attach_membership(self, manager) -> None:
        """Subscribe to a ``membership.MembershipManager``: each ``down``
        transition calls :meth:`notify_member_down` for its rank."""

        def _listener(event, view) -> None:
            if event.kind == "down":
                self.notify_member_down(event.rank)

        manager.add_listener(_listener)

    def _survivor_rank(self) -> Optional[int]:
        with self._lease_lock:
            ranks = sorted(
                plan_ir.queue_rank(q, self._num_trainers)
                for lease in self._leases.values() if not lease.expired
                for q in lease.queues)
        for rank in ranks:
            if rank not in self._drained_ranks:
                return rank
        return None

    def _drain_dead_ranks(self, ranks: set, redistribute: bool) -> None:
        """Free (or reroute) a dead consumer's queues, so producers are
        not held and its tables are not kept until the process ends."""
        dead_queues = [
            q for q in range(self._queue.num_queues)
            if plan_ir.queue_rank(q, self._num_trainers) in ranks]
        for q in dead_queues:
            state = self._state(q)
            with state.lock:
                for frame in state.replay:
                    self._release_frame(frame)
                    # The tenant charged at the pop, not the rank's now.
                    self._charge_tenant(q, -frame.size, frame.tenant)
                state.replay.clear()
                state.replay_bytes = 0
        while not self._closed.wait(0.2):
            moved = 0
            for q in dead_queues:
                while True:
                    try:
                        item = self._queue.get_nowait(q)
                    except (mq.Empty, RuntimeError):
                        break
                    moved += 1
                    if not redistribute or item is None or isinstance(
                            item, ShuffleFailure):
                        continue  # drained and dropped
                    survivor = self._survivor_rank()
                    if survivor is None:
                        continue  # nobody left: the drain policy
                    target = plan_ir.queue_index(
                        self._epoch_of(q), survivor, self._num_trainers)
                    if _put_quiet(self._queue, target, item):
                        rt_telemetry.record(
                            "frame_redistributed", epoch=self._epoch_of(q),
                            task=target, source_queue=q)
            if moved:
                logger.info("dead-consumer policy %s: moved %d items off "
                            "ranks %s",
                            "redistribute" if redistribute else "drain",
                            moved, sorted(ranks))

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop accepting and join every handler: each finishes the frame
        it is writing, sees the flag at its next tick (blocking pops tick
        every 0.25 s) and ends without logging."""
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            # Wakes the accept blocked in its tick at once.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            threads = list(self._conn_threads)
        for thread in threads:
            if thread is threading.current_thread():
                continue  # a handler closing its own server
            thread.join(timeout=5.0)
            if thread.is_alive():
                logger.warning("queue server handler %s did not drain "
                               "within 5s", thread.name)
        self._accept_thread.join(timeout=2.0)
        # The pins the replay buffers still hold (a consumer that mapped
        # a segment keeps its mapping), and the segment directory if this
        # server made it.
        with self._states_lock:
            states = list(self._states.values())
        for state in states:
            with state.lock:
                for frame in state.replay:
                    self._release_frame(frame)
        if self._own_handle_dir and self._handle_dir:
            shutil.rmtree(self._handle_dir, ignore_errors=True)
        elif self._handle_dir:
            try:
                os.rmdir(self._handle_dir)  # a pinned one, if now empty
            except OSError:
                pass
        if self._codec_pool is not None:
            self._codec_pool.shutdown(wait=True)

    def __enter__(self) -> "QueueServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_queue(queue: mq.MultiQueue,
                address: Tuple[str, int] = ("127.0.0.1", 0),
                num_trainers: int = 1, journal=None,
                initial_state: Optional[Dict[int, object]] = None,
                exit_on_crash_site: bool = False,
                shard_index: int = 0, num_shards: int = 1,
                handle_dir: Optional[str] = None,
                tenants: Optional[dict] = None,
                placement: Optional[dict] = None) -> QueueServer:
    """Start serving ``queue`` on ``address`` (port 0: an ephemeral one)."""
    return QueueServer(queue, address, num_trainers=num_trainers,
                       journal=journal, initial_state=initial_state,
                       exit_on_crash_site=exit_on_crash_site,
                       shard_index=shard_index, num_shards=num_shards,
                       handle_dir=handle_dir, tenants=tenants,
                       placement=placement)


def _rebalance_call(address: Tuple[str, int], phase: int, rank: int,
                    generation: int, payload: bytes = b"",
                    timeout_s: float = 30.0) -> str:
    """One OP_REBALANCE round trip on a connection of its own. Returns the
    answer's ``checkpoint.crc_line`` (its CRC checked); an ``{"error":
    ...}`` answer raises ``RuntimeError``."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    with socket.create_connection(tuple(address),
                                  timeout=timeout_s) as sock:
        sock.sendall(_REQUEST.pack(OP_REBALANCE, phase, rank, generation,
                                   len(payload)) + payload)
        (length,) = _BATCH_HEADER.unpack(
            _recv_exact(sock, _BATCH_HEADER.size))
        line = _recv_exact(sock, length).decode("utf-8")
    entry = ckpt.parse_crc_line(line)
    if "error" in entry:
        raise RuntimeError(
            f"rebalance phase {phase} for rank {rank} failed on "
            f"{address[0]}:{address[1]}: {entry['error']}")
    return line


def rebalance_prepare(address: Tuple[str, int], rank: int,
                      generation: int, timeout_s: float = 30.0) -> str:
    """PREPARE on the source shard: seal ``rank`` and return its CRC'd
    handoff manifest line, to give :func:`rebalance_adopt` as it is (the
    target checks the CRC the source computed)."""
    return _rebalance_call(address, REB_PREPARE, rank, generation,
                           timeout_s=timeout_s)


def rebalance_adopt(address: Tuple[str, int], manifest_line: str,
                    timeout_s: float = 30.0) -> str:
    """ADOPT on the target shard: install the manifest's queue states and
    merge its watermarks into the target's journal."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    manifest = ckpt.parse_crc_line(manifest_line)["manifest"]
    return _rebalance_call(address, REB_ADOPT, int(manifest["rank"]),
                           int(manifest["generation"]),
                           payload=manifest_line.encode("utf-8"),
                           timeout_s=timeout_s)


def rebalance_release(address: Tuple[str, int], rank: int,
                      generation: int, target: Tuple[str, int],
                      timeout_s: float = 30.0) -> str:
    """RELEASE on the source shard, after the commit: drop the moved
    rank's state and redirect its consumers to ``target``."""
    payload = json.dumps({"host": str(target[0]),
                          "port": int(target[1])}).encode("utf-8")
    return _rebalance_call(address, REB_RELEASE, rank, generation,
                           payload=payload, timeout_s=timeout_s)


def rebalance_unseal(address: Tuple[str, int], rank: int,
                     timeout_s: float = 30.0) -> str:
    """UNSEAL on the source shard, after an abort: lift the PREPARE seal
    so the still-authoritative source serves new frames again."""
    return _rebalance_call(address, REB_UNSEAL, rank, 0,
                           timeout_s=timeout_s)


class ShardedQueueServer:
    """N in-process :class:`QueueServer` shards over one ``MultiQueue``.

    Each shard owns the queues of its ranks (``plan.ir.queue_shard``),
    listens on a port of its own and keeps its own replay, lease and
    journal state and its own metrics. ``shard_map`` is the
    :class:`plan.ir.ShardMap` consumers route by (give it to
    :class:`ShardedRemoteQueue`). One process per shard is
    ``runtime.supervisor.launch_supervised_queue_shards``. ``placement``
    goes to every shard (``QueueServer``'s); a move between the shards
    while they serve is ``rebalance.migrate`` over ``shard_map``.
    """

    def __init__(self, queue: mq.MultiQueue, num_shards: int,
                 num_trainers: int = 1, host: str = "127.0.0.1",
                 journals: Optional[List] = None,
                 initial_states: Optional[List] = None,
                 handle_dir: Optional[str] = None,
                 tenants: Optional[dict] = None,
                 placement: Optional[dict] = None):
        num_shards = max(1, num_shards)
        self.servers: List[QueueServer] = []
        try:
            for shard in range(num_shards):
                self.servers.append(QueueServer(
                    queue, (host, 0), num_trainers=num_trainers,
                    journal=journals[shard] if journals else None,
                    initial_state=(initial_states[shard]
                                   if initial_states else None),
                    shard_index=shard, num_shards=num_shards,
                    handle_dir=(os.path.join(handle_dir, f"s{shard}")
                                if handle_dir else None),
                    tenants=tenants, placement=placement))
        except BaseException:
            self.close()
            raise
        self.shard_map = plan_ir.ShardMap(
            num_trainers=max(1, num_trainers),
            addresses=[s.address for s in self.servers])
        rt_metrics.gauge(
            "rsdl_queue_serve_shards",
            "shard count of the live queue serving plane").set(num_shards)

    @property
    def num_shards(self) -> int:
        return len(self.servers)

    def close(self) -> None:
        for server in self.servers:
            server.close()

    def __enter__(self) -> "ShardedQueueServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_queue_sharded(queue: mq.MultiQueue,
                        num_shards: Optional[int] = None,
                        num_trainers: int = 1,
                        host: str = "127.0.0.1",
                        **kwargs) -> ShardedQueueServer:
    """Serve ``queue`` from ``num_shards`` shards (the ``queue_shards``
    policy by default; 1 is the one-server topology)."""
    if num_shards is None:
        num_shards = rt_policy.resolve("queue", "queue_shards")
    return ShardedQueueServer(queue, num_shards, num_trainers=num_trainers,
                              host=host, **kwargs)


class RemoteQueue:
    """The consumer's handle on a served queue.

    ``get`` returns a ``pa.Table``, ``None`` (the epoch's end) or a
    ``ShuffleFailure``. It connects with ``retries`` further attempts
    (jittered doubling backoff from ``initial_backoff_s``,
    ``runtime.retry.RetryPolicy``) and raises ``ConnectionError`` ("could
    not reach ...") when they are spent. ``max_batch`` frames ride each
    round trip; with ``prefetch`` a thread keeps the next request in
    flight while the consumer drains the last batch.

    Recovery: each frame's CRC is checked and a bad frame NACK'd (the
    server sends it again from its replay buffer); a connection that dies
    at any point is redialled through the same retry policy and every
    queue's next GET resumes from the watermark, the frames already
    delivered dropped by seq: exactly once. ``ack_mode="delivered"`` acks
    each frame as ``get`` returns it; ``"manual"`` acks only what
    :meth:`commit` committed (``checkpoint.resume_iterator`` commits at
    each save through ``ShufflingDataset.commit_consumed``), so a trainer
    that dies and resumes finds its uncommitted frames replayed. A
    heartbeat thread keeps the server's lease alive between GETs.

    ``delivery`` (``queue_delivery``): ``"auto"`` offers shared-memory
    handles when the server's address is loopback, ``"handle"`` offers
    them regardless, ``"stream"`` never. A handle frame's segment is
    mapped and its CRC checked; a handle that cannot be used is NACK'd
    with ``NACK_NO_HANDLE`` and the queue streams from then on (slower,
    still exactly once). A compressed frame is decompressed before its
    CRC is checked. ``num_trainers`` makes the latency label the rank.

    ``tenant`` (a ``tenancy.TenantContext``, an id or a dict) binds the
    consumer: ``OP_TENANT`` follows every HELLO, reconnects included, so
    the server's weighted-fair scheduler and per-tenant ledgers count its
    bytes, and the client observes ``rsdl_tenant_delivery_latency_seconds``
    by hop. A server that cannot parse the blob logs and ignores it.

    Live moves: a ``KIND_MOVED`` answer raises the rank's fence to its
    generation, then :class:`QueueMoved`; a data frame whose generation is
    below its rank's fence (a source that serves on after the move) is
    dropped and counted (``rsdl_rebalance_fenced_frames_total``).
    :meth:`export_positions` and :meth:`adopt_positions` carry a rank's
    positions to the new shard's client.
    """

    #: This client observes ``birth_to_delivered`` from the frame stamps;
    #: a dataset on top must not observe it again.
    observes_delivery = True

    def __init__(self, address: Tuple[str, int],
                 retries: int = mq.CONNECT_RETRIES,
                 initial_backoff_s: float = mq.CONNECT_INITIAL_BACKOFF_S,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 prefetch: bool = True,
                 ack_mode: str = "delivered",
                 consumer_id: Optional[int] = None,
                 delivery: Optional[str] = None,
                 num_trainers: int = 1,
                 tenant=None):
        if ack_mode not in ("delivered", "manual"):
            raise ValueError(
                f"ack_mode must be 'delivered' or 'manual', got {ack_mode!r}")
        self._tenant = (rt_tenancy.resolve(tenant)
                        if tenant is not None else None)
        self._delivery = _resolve_delivery(delivery)
        self._address = (str(address[0]), int(address[1]))
        host = self._address[0]
        self._offer_handles = (
            self._delivery == "handle"
            or (self._delivery == "auto"
                and (host in _LOOPBACK_HOSTS or host.startswith("127."))))
        self._ack_mode = ack_mode
        self._num_trainers = max(1, int(num_trainers))
        self._lat_anchors = rt_lat.ClockAnchors()
        self._consumer_id = (consumer_id if consumer_id is not None
                             else int.from_bytes(os.urandom(8), "little"))
        self._timeout_s = rt_policy.resolve("queue", "queue_timeout_s")
        self._nodelay = rt_policy.resolve("queue", "queue_nodelay")
        self._lease_timeout_s = rt_policy.resolve("queue",
                                                  "queue_lease_timeout_s")
        # One policy for the connect and every refetch's redial.
        self._retry = rt_retry.RetryPolicy.for_component(
            "queue", retry_max_attempts=retries + 1,
            retry_initial_backoff_s=initial_backoff_s,
            retryable=rt_retry.transient_retryable)
        # Keeps round trips whole. A round trip's first telemetry event
        # in a process builds the flight recorder under telemetry's
        # module lock (an edge the static pass cannot see); that lock's
        # sections take only the policy registry's and the recorder's
        # locks, never a client's, so the order cannot invert.
        # rsdl-lint: disable=inconsistent-lock-order
        self._io_lock = threading.Lock()
        self._state_lock = threading.Lock()   # buffers, done, pending
        self._closed = threading.Event()
        #: queue -> deque of (seq, row_offset or None, item)
        self._buffers: Dict[int, collections.deque] = \
            collections.defaultdict(collections.deque)
        self._done: set = set()
        self._pending: Dict[int, cf.Future] = {}
        #: The last seq handed out per queue (-1: none).
        self._delivered: Dict[int, int] = collections.defaultdict(lambda: -1)
        #: The manual-mode ack watermark (advanced by commit()).
        self._committed: Dict[int, int] = collections.defaultdict(lambda: -1)
        #: Queues fetched on the current connection; a queue's first GET
        #: on a connection carries FLAG_RESUME.
        self._fetched_since_connect: set = set()
        self._sock: Optional[socket.socket] = None
        self._reconnects = rt_metrics.counter(
            "rsdl_queue_client_reconnects_total",
            "RemoteQueue reconnect-and-resume cycles")
        self._corrupt = rt_metrics.counter(
            "rsdl_queue_frames_corrupt_total",
            "frames rejected client-side on CRC mismatch")
        #: rank -> placement-generation fence (0: none), raised by a
        #: KIND_MOVED redirect, a newer data frame or adopt_positions.
        self._gen_floor: Dict[int, int] = {}
        self._fenced = rt_metrics.counter(
            "rsdl_rebalance_fenced_frames_total",
            "frames dropped below the placement-generation fence")
        try:
            self._retry.call(self._reconnect, describe=f"connect {address}")
        except OSError as e:
            raise ConnectionError(
                f"could not reach queue server at {address} after "
                f"{retries + 1} attempts: {e}") from e
        self._max_batch = max(1, max_batch)
        self._prefetch = prefetch
        self._io = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rsdl-rqueue-prefetch")
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="rsdl-rqueue-heartbeat")
        self._heartbeat_thread.start()

    def _reconnect(self) -> None:
        """(Re)dial the server, closing the old socket first, send the
        lease HELLO (with the handle offer) and arm every queue's
        resume."""
        with self._io_lock:
            old = self._sock
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
                self._reconnects.inc()
            sock = socket.create_connection(self._address, timeout=30)
            # A finite receive timeout (0: none): a timed-out response is
            # reconnected and replayed, never lost.
            sock.settimeout(self._timeout_s or None)
            if self._nodelay:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(_REQUEST.pack(
                OP_HELLO, FLAG_HANDLES_OK if self._offer_handles else 0,
                self._consumer_id & 0xFFFFFFFF,
                (self._consumer_id >> 32) & 0xFFFFFFFF, 0))
            if self._tenant is not None:
                blob = self._tenant.to_json()
                sock.sendall(_REQUEST.pack(
                    OP_TENANT, 0, self._consumer_id & 0xFFFFFFFF,
                    (self._consumer_id >> 32) & 0xFFFFFFFF,
                    len(blob)) + blob)
            self._sock = sock
            self._fetched_since_connect = set()

    def _heartbeat_loop(self) -> None:
        """Beat the lease while the trainer is busy between GETs; a beat
        is skipped while a round trip is in flight (that is one)."""
        interval = max(0.2, self._lease_timeout_s / 3.0)
        while not self._closed.wait(interval):
            if not self._io_lock.acquire(timeout=interval / 2):
                continue
            try:
                self._sock.sendall(_REQUEST.pack(OP_HEARTBEAT, 0, 0, 0, 0))
            except OSError:
                pass  # the next fetch reconnects
            finally:
                self._io_lock.release()

    def _ack_for(self, queue_index: int) -> int:
        watermark = (self._committed[queue_index]
                     if self._ack_mode == "manual"
                     else self._delivered[queue_index])
        return ACK_NONE if watermark < 0 else watermark

    def commit(self, queue_index: Optional[int] = None) -> None:
        """Advance the manual-ack watermark to everything delivered so far
        (one queue, or all), after its consumption was made durable."""
        with self._state_lock:
            indices = ([queue_index] if queue_index is not None
                       else list(self._delivered))
            for q in indices:
                self._committed[q] = max(self._committed[q],
                                         self._delivered[q])

    def export_positions(self, rank: int) -> Dict[int, Tuple[int, int]]:
        """``{queue: (delivered, committed)}`` of every queue of ``rank``
        this client touched; its buffers and pending request are dropped
        (the adopting shard replays them). For :meth:`adopt_positions` on
        the new shard's client."""
        positions: Dict[int, Tuple[int, int]] = {}
        with self._state_lock:
            for q in set(self._delivered) | set(self._committed):
                if plan_ir.queue_rank(q, self._num_trainers) != rank:
                    continue
                positions[q] = (self._delivered[q], self._committed[q])
                self._buffers.pop(q, None)
                self._pending.pop(q, None)
        return positions

    def adopt_positions(self, positions: Dict[int, Tuple[int, int]],
                        generation: int = 0,
                        rank: Optional[int] = None) -> None:
        """Merge another client's positions (the larger wins) and raise
        ``rank``'s fence to ``generation``: this client's first GET resumes
        at the frame the old shard's stream stopped at."""
        with self._state_lock:
            for q, (delivered, committed) in positions.items():
                self._delivered[q] = max(self._delivered[q], delivered)
                self._committed[q] = max(self._committed[q], committed)
            if rank is not None and generation > self._gen_floor.get(rank, 0):
                self._gen_floor[rank] = generation

    def _read_frames(self, queue_index: int, count: int, parsed: list
                     ) -> Optional[Tuple[int, int]]:
        """Read ``count`` frames of a response into ``parsed``; returns
        ``(seq, NACK mode)`` of the first frame that failed its CRC or
        whose handle could not be used (None if none). Framing stays
        aligned past a bad frame: its payload and the rest are read and
        dropped (delivery is in order)."""
        bad = None
        rank = plan_ir.queue_rank(queue_index, self._num_trainers)
        for _ in range(count):
            (kind_byte, epoch, seq, crc, row_offset, length, src_task,
             b_mono, b_unix, b_pid, q_mono, q_unix, q_pid,
             generation) = _FRAME.unpack(_recv_exact(self._sock,
                                                      _FRAME.size))
            kind, codec = kind_byte & _KIND_MASK, kind_byte >> 4
            payload = _recv_payload(self._sock, length) if length else b""
            if bad is not None:
                continue
            if kind == KIND_MOVED:
                # The rank moved: the fence rises first (a source serving
                # on can never slip a frame in after the redirect), then
                # the router learns the new address.
                blob = bytes(payload)
                if _crc(blob) != crc:
                    raise ConnectionError(
                        "MOVED redirect failed CRC; refetching")
                info = json.loads(blob.decode())
                moved_gen = int(info["generation"])
                if moved_gen > self._gen_floor.get(rank, 0):
                    # Held: the only caller (_fetch_batch) reads frames
                    # under _io_lock. rsdl-lint: disable=lock-mutation
                    self._gen_floor[rank] = moved_gen
                raise QueueMoved(queue_index, int(info["rank"]),
                                 (info["host"], info["port"]), moved_gen)
            if kind not in (KIND_TABLE, KIND_SENTINEL, KIND_FAILURE,
                            KIND_TABLE_HANDLE):
                raise UnreadableFrame(
                    f"queue {queue_index}: frame {seq} has unknown kind "
                    f"{kind}")
            if kind != KIND_FAILURE:
                # The fence: a data frame below the rank's floor comes
                # from a source still serving a moved rank. Failure frames
                # carry 0 and always land.
                floor = self._gen_floor.get(rank, 0)
                if generation < floor:
                    self._fenced.inc()
                    rt_telemetry.record(
                        "rebalance_fence", epoch=epoch, task=queue_index,
                        seq=seq, generation=generation, floor=floor)
                    logger.warning(
                        "queue %d: fenced frame %d from a moved source "
                        "(generation %d < floor %d)", queue_index, seq,
                        generation, floor)
                    continue
                if generation > floor:
                    # Held: the only caller (_fetch_batch) reads frames
                    # under _io_lock. rsdl-lint: disable=lock-mutation
                    self._gen_floor[rank] = generation
            try:
                # The CRC is over the uncompressed bytes: a torn
                # compressed payload fails here and is NACK'd like any.
                raw = (_decompress(codec, payload) if codec != CODEC_NONE
                       else payload)
            except Exception:  # noqa: BLE001 - NACK'd below
                raw = None
            if raw is None or _crc(raw) != crc:
                # Rejected with everything after it; NACK'd by the caller
                # so the server sends the good copy again.
                bad = (seq, NACK_CRC)
                self._corrupt.inc()
                rt_telemetry.record("frame_corrupt", epoch=epoch,
                                    task=queue_index, seq=seq)
                logger.warning("queue %d: frame %d failed CRC; NACKing",
                               queue_index, seq)
                continue
            if kind == KIND_TABLE_HANDLE:
                # Map the segment the server serialized and check its CRC
                # off the mapped pages; any failure asks for the queue to
                # be streamed.
                try:
                    handle = json.loads(bytes(raw).decode())
                    buf = pp.read_segment_buffer(handle["path"])
                    if _crc(buf) != handle["crc"]:
                        raise ValueError("segment CRC mismatch")
                except (OSError, ValueError, KeyError, TypeError) as e:
                    bad = (seq, NACK_NO_HANDLE)
                    rt_telemetry.record("handle_downgrade", epoch=epoch,
                                        task=queue_index, seq=seq)
                    logger.warning(
                        "queue %d: the shm handle of frame %d is unusable "
                        "(%s); asking for streamed delivery", queue_index,
                        seq, e)
                    continue
                kind, raw = KIND_TABLE, buf
            if kind == KIND_TABLE and src_task != TASK_NONE:
                # The cross-process causal link: this payload came from
                # reducer src_task in the server's process.
                rt_telemetry.record("frame_recv", epoch=epoch,
                                    task=src_task, seq=seq)
            parsed.append((kind, seq, row_offset, raw,
                           _unpack_stamp(b_mono, b_unix, b_pid),
                           _unpack_stamp(q_mono, q_unix, q_pid), epoch))
        return bad

    def _fetch_batch(self, queue_index: int) -> Tuple[List, bool]:
        """One round trip: request up to ``max_batch`` frames, read and
        check them. Runs on the caller's thread or the prefetcher. Any
        death of the round trip, before or after response bytes,
        redials and resumes through the retry policy; the server replays
        from the ack watermark and frames already delivered are dropped
        by seq, so a reset neither loses nor repeats an item."""

        def _round_trip() -> Tuple[List[Tuple], bool]:
            response_started = False
            parsed: List[Tuple] = []
            try:
                with self._io_lock:
                    rt_faults.inject("queue_fetch", task=queue_index)
                    resume = queue_index not in self._fetched_since_connect
                    ack = self._ack_for(queue_index)
                    try:
                        rt_faults.inject("ack_lost", task=queue_index)
                    except rt_faults.InjectedFault:
                        # Harmless by design: acks are cumulative and the
                        # next GET's watermark covers this one.
                        rt_telemetry.record("ack_lost", task=queue_index,
                                            suppressed_ack=ack)
                        ack = ACK_NONE
                    self._sock.sendall(_REQUEST.pack(
                        OP_GET_BATCH, FLAG_RESUME if resume else 0,
                        queue_index, self._max_batch, ack))
                    (count,) = _BATCH_HEADER.unpack(
                        _recv_exact(self._sock, _BATCH_HEADER.size))
                    response_started = True
                    bad = self._read_frames(queue_index, count, parsed)
                    if bad is not None:
                        self._sock.sendall(_REQUEST.pack(
                            OP_NACK, 0, queue_index, *bad))
                    self._fetched_since_connect.add(queue_index)
                return parsed, resume
            except (ConnectionError, OSError) as e:
                if response_started:
                    # Joins an injected conn_reset_midframe fault by
                    # (kind, epoch, task).
                    rt_telemetry.record(
                        "conn_reset_midframe",
                        epoch=parsed[-1][6] if parsed else None,
                        task=queue_index, error=str(e))
                    logger.warning(
                        "queue %d: connection died mid-response (%s); "
                        "reconnecting and replaying the unacked suffix",
                        queue_index, e)
                raise

        def _redial(error: BaseException) -> None:
            if not isinstance(error, (ConnectionError, OSError)):
                return
            try:
                self._reconnect()
            except OSError as e:
                # A restarting server may not listen yet: the next
                # attempt fails fast on the closed socket and this runs
                # again after its backoff, within the retry budget.
                logger.info("queue redial to %s not up yet (%s); will "
                            "retry", self._address, e)

        with rt_telemetry.span("queue_fetch", task=queue_index):
            frames, resumed = self._retry.call(
                _round_trip, describe=f"fetch queue {queue_index}",
                on_retry=_redial)
        items: List[Tuple] = []
        for kind, seq, row_offset, payload, birth, queued, _ in frames:
            if kind == KIND_SENTINEL:
                items.append((seq, None, None, None, None))
                break  # the epoch is over; nothing valid follows
            if kind == KIND_FAILURE:
                items.append((seq, None, ShuffleFailure(
                    RuntimeError(bytes(payload).decode())), None, None))
                break
            # The table's Arrow buffers alias the mapped segment, the
            # receive buffer or the decompressed bytes.
            source = (payload if isinstance(payload, pa.Buffer)
                      else pa.py_buffer(payload))
            with pa.ipc.open_stream(pa.BufferReader(source)) as reader:
                items.append((seq, row_offset, reader.read_all(), birth,
                              queued))
        return items, resumed

    def _observe_tenant(self, hop: str, seconds: float) -> None:
        rt_metrics.sketch(
            "rsdl_tenant_delivery_latency_seconds",
            "per-tenant delivery latency by hop",
            hop=hop, tenant=self._tenant.tenant_id).observe(seconds)

    def _ingest(self, queue_index: int, items: List[Tuple],
                resumed: bool) -> None:
        """Buffer a fetched batch (``_state_lock`` held by the caller)."""
        buf = self._buffers[queue_index]
        if resumed:
            # The server replayed from the watermark: frames buffered and
            # not yet handed out come again (same seqs).
            buf.clear()
        delivered = self._delivered[queue_index]
        rank = str(plan_ir.queue_rank(queue_index, self._num_trainers))
        fresh = []
        for seq, row_offset, item, birth, queued in items:
            if seq <= delivered or (buf and seq <= buf[-1][0]):
                continue  # a replayed frame already held: exactly once
            # Observed once per frame entering the stream, with the
            # stamps it was built with (a replay's are the originals).
            queued_lat = self._lat_anchors.latency_s(queued)
            rt_lat.observe_hop(rt_lat.HOP_QUEUED_TO_DELIVERED, rank,
                               queued_lat)
            if self._tenant is not None and queued_lat is not None:
                self._observe_tenant(rt_lat.HOP_QUEUED_TO_DELIVERED,
                                     queued_lat)
            if birth is not None:
                age = self._lat_anchors.latency_s(birth)
                rt_lat.observe_hop(rt_lat.HOP_BIRTH_TO_DELIVERED, rank, age)
                if self._tenant is not None and age is not None:
                    self._observe_tenant(rt_lat.HOP_BIRTH_TO_DELIVERED, age)
                rt_lat.set_freshness(rank, age)
            fresh.append((seq, row_offset, item))
        buf.extend(fresh)
        if fresh and (fresh[-1][2] is None
                      or isinstance(fresh[-1][2], ShuffleFailure)):
            self._done.add(queue_index)
        elif self._prefetch and queue_index not in self._pending:
            # The next request goes out as this batch lands, so its
            # round trip overlaps the consumption of the whole batch.
            # The caller holds _state_lock:
            # rsdl-lint: disable=lock-mutation
            self._pending[queue_index] = self._io.submit(
                self._fetch_batch, queue_index)

    def get_positioned(self, queue_index: int):
        """Blocking get of ``(item, row_offset)``: the item and the
        absolute position of its first row in the queue's stream (None for
        a sentinel or a failure), which keeps a resumed dataset's skip
        exact against a replaying server."""
        with self._state_lock:
            buf = self._buffers[queue_index]
            while not buf:
                if queue_index in self._done:
                    raise RuntimeError(
                        f"remote queue {queue_index} already yielded its "
                        f"epoch-end sentinel")
                # One request in flight per queue: a second getter waits
                # on the same future, so batches land in request order;
                # whoever finds it still registered ingests it, once.
                fut = self._pending.get(queue_index)
                if fut is None:
                    fut = self._pending[queue_index] = self._io.submit(
                        self._fetch_batch, queue_index)
                # The wire wait runs with _state_lock released (the
                # release/acquire bracket), so a get on another queue can
                # drain its buffer meanwhile:
                self._state_lock.release()
                try:
                    # rsdl-lint: disable=lock-blocking-call
                    items, resumed = fut.result()
                finally:
                    self._state_lock.acquire()
                    mine = self._pending.get(queue_index) is fut
                    if mine:
                        del self._pending[queue_index]
                if mine:
                    self._ingest(queue_index, items, resumed)
            seq, row_offset, item = buf.popleft()
            if seq != ACK_NONE:  # an out-of-band failure carries no seq
                self._delivered[queue_index] = max(
                    self._delivered[queue_index], seq)
        return item, row_offset

    def get(self, queue_index: int, block: bool = True):
        if not block:
            raise ValueError("RemoteQueue only supports blocking gets")
        item, _ = self.get_positioned(queue_index)
        return item

    def close(self) -> None:
        self._closed.set()
        self._io.shutdown(wait=False, cancel_futures=True)
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "RemoteQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardedRemoteQueue:
    """The consumer's handle on the sharded serving plane.

    Routes each queue to its shard by the placement the servers use
    (:meth:`plan.ir.ShardMap.shard_for_queue`) and keeps one
    :class:`RemoteQueue` per shard it touches (a trainer rank touches
    one). It has the ``RemoteQueue`` surface (``get``,
    ``get_positioned``, ``commit``, ``close``), so
    ``ShufflingDataset(batch_queue=ShardedRemoteQueue(shard_map))`` is the
    same remote trainer; each shard's client keeps its own lease,
    watermarks and prefetch, so one dead shard never stalls a stream its
    siblings serve. A ``KIND_MOVED`` redirect is followed: the map's
    override and generation are rewritten, the old client's positions go
    to the new shard's client and its fence rises (at most 4 redirects
    per call).
    """

    #: See RemoteQueue.observes_delivery (every shard's client observes).
    observes_delivery = True

    def __init__(self, shard_map: Union[plan_ir.ShardMap, dict, str],
                 **remote_kwargs):
        if isinstance(shard_map, str):
            shard_map = plan_ir.ShardMap.from_json(shard_map)
        elif isinstance(shard_map, dict):
            shard_map = plan_ir.ShardMap.from_dict(shard_map)
        shard_map.validate()
        self._shard_map = shard_map
        # The map knows the trainer width: each shard's client labels its
        # latency by the real rank.
        remote_kwargs.setdefault("num_trainers", shard_map.num_trainers)
        self._remote_kwargs = remote_kwargs
        self._clients: Dict[int, RemoteQueue] = {}
        # _client() builds a RemoteQueue (whose connect takes its own
        # _io_lock) under this lock; no other thread reaches that client
        # before it is published, so the order cannot invert.
        # rsdl-lint: disable=inconsistent-lock-order
        self._clients_lock = threading.Lock()

    @property
    def shard_map(self) -> plan_ir.ShardMap:
        return self._shard_map

    def _client(self, shard: int) -> RemoteQueue:
        with self._clients_lock:
            client = self._clients.get(shard)
            if client is None:
                client = self._clients[shard] = RemoteQueue(
                    tuple(self._shard_map.addresses[shard]),
                    **self._remote_kwargs)
            return client

    def client_for_queue(self, queue_index: int) -> RemoteQueue:
        return self._client(self._shard_map.shard_for_queue(queue_index))

    def _apply_move(self, moved: QueueMoved) -> None:
        """Follow a redirect: the map's override for the moved rank, the
        old client's delivered and committed positions to the new shard's
        client (the larger wins: exactly once across the handoff) and its
        fence raised, so the old source's late frames are dropped."""
        target_shard = None
        for shard, addr in enumerate(self._shard_map.addresses):
            if (str(addr[0]), int(addr[1])) == moved.address:
                target_shard = shard
                break
        if target_shard is None:
            raise RuntimeError(
                f"MOVED redirect names {moved.address[0]}:"
                f"{moved.address[1]}, which is not in this consumer's "
                f"shard map — the placement decision and the map "
                f"disagree") from moved
        with self._clients_lock:
            old_shard = self._shard_map.shard_for_rank(moved.rank)
            self._shard_map.overrides[moved.rank] = target_shard
            self._shard_map.generation = max(self._shard_map.generation,
                                             moved.generation)
            old_client = self._clients.get(old_shard)
        positions = (old_client.export_positions(moved.rank)
                     if old_client is not None else {})
        self._client(target_shard).adopt_positions(
            positions, generation=moved.generation, rank=moved.rank)
        logger.warning(
            "following MOVED redirect: rank %d shard %d -> %d at "
            "placement generation %d (%d queue position(s) carried)",
            moved.rank, old_shard, target_shard, moved.generation,
            len(positions))

    def _route(self, queue_index: int, op: Callable):
        """Run ``op`` on the owning shard's client, following up to 4
        redirects (a settled placement needs one; the bound stops a loop
        of a misconfigured plane)."""
        for _ in range(4):
            try:
                return op(self.client_for_queue(queue_index))
            except QueueMoved as moved:
                self._apply_move(moved)
        raise RuntimeError(
            f"queue {queue_index} still redirecting after 4 MOVED "
            f"hops; placement plane is unstable or misconfigured")

    def get_positioned(self, queue_index: int):
        return self._route(
            queue_index,
            lambda client: client.get_positioned(queue_index))

    def get(self, queue_index: int, block: bool = True):
        return self._route(
            queue_index,
            lambda client: client.get(queue_index, block=block))

    def commit(self, queue_index: Optional[int] = None) -> None:
        if queue_index is not None:
            self.client_for_queue(queue_index).commit(queue_index)
            return
        with self._clients_lock:
            clients = list(self._clients.values())
        for client in clients:
            client.commit()

    def close(self) -> None:
        with self._clients_lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for client in clients:
            client.close()

    def __enter__(self) -> "ShardedRemoteQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# The server's own process: queue + deterministic shuffle + server from a
# config dict, resumed from the watermark journal (the unit
# runtime.supervisor restarts).
# ---------------------------------------------------------------------------


def _resume_plan(state: Dict[int, object], num_epochs: int,
                 num_trainers: int, ranks: Optional[List[int]] = None
                 ) -> Tuple[int, Dict[int, int]]:
    """``(start_epoch, skip_items)`` from a loaded journal
    (``plan.ir.resume_from_watermarks``)."""
    return plan_ir.resume_from_watermarks(state, num_epochs, num_trainers,
                                          ranks=ranks)


def _resuming_batch_consumer(queue: mq.MultiQueue, num_trainers: int,
                             skip_items: Dict[int, int],
                             owned_ranks: Optional[List[int]] = None):
    """A ``batch_consumer`` for the re-run lineage that queues only the
    undelivered remainder: the first ``skip_items[q]`` items of each
    queue's deterministic stream (tables, then the sentinel) are
    journaled as delivered and dropped. A shard passes ``owned_ranks``:
    the other ranks' outputs, which the lineage recomputes all the same,
    are dropped before the queue."""
    remaining = dict(skip_items)
    owned = set(owned_ranks) if owned_ranks is not None else None
    lock = threading.Lock()

    def consumer(rank, epoch, refs):
        if owned is not None and rank not in owned:
            return
        queue_idx = plan_ir.queue_index(epoch, rank, num_trainers)
        with lock:
            to_skip = remaining.get(queue_idx, 0)
            if refs is None:
                if to_skip > 0:
                    remaining[queue_idx] = to_skip - 1
                    return
            else:
                refs = list(refs)
                dropped = min(to_skip, len(refs))
                remaining[queue_idx] = to_skip - dropped
                refs = refs[dropped:]
                if not refs:
                    return
        if refs is None:
            queue.put(queue_idx, None)
        else:
            queue.put_batch(queue_idx, refs)

    return consumer


def serve_pipeline(config: dict):
    """Queue, shuffle and server from ``config``, resumed from the journal
    at ``config["journal_path"]``.

    Keys (the JAX package's): ``filenames``, ``num_epochs``,
    ``num_trainers``, ``num_reducers``, ``journal_path``, ``port`` and
    optionally ``host``, ``seed``, ``max_concurrent_epochs``,
    ``num_workers``, ``file_cache``, ``num_shards`` with ``shard_index``
    and ``handle_dir``; the port adds ``cast`` (``{column: dtype}``: the
    map-time cast of ``transforms.CastTransform``, so the server ships
    the narrow dtypes a ``DeviceShufflingDataset`` spec casts to).
    ``placement`` is ``QueueServer``'s (the state a live move left), and
    a shard owns the ranks its overrides give it. ``tenants`` is
    ``QueueServer``'s table (``{tenant_id: {"weight" or "priority",
    "ranks"}}``).

    ``epochs`` replaces ``filenames`` and ``num_epochs`` with a stream's
    frozen window schedule (``streaming.window.specs_to_dicts``: one
    ``{"epoch", "filenames", "window"}`` record per sealed window, as
    ``streaming.runner.server_config`` builds it): ``num_epochs`` is its
    length, the windows from the resume's start epoch on go through
    ``shuffle.shuffle_epochs``, and each drained window sets
    ``rsdl_stream_serve_watermark`` to its ingest watermark. The
    schedule is data in the config, so a restarted server re-derives the
    same epochs. A record's ``tenant_id`` is kept as data.

    A shard (``num_shards`` > 1) serves and journals only the ranks
    ``plan.ir.shard_ranks`` gives it: its resume scan covers them alone
    and the other ranks' regenerated outputs are dropped before the
    queue. Handle segments go to ``handle_dir``, else to a directory
    under the shm root named by the journal's path, so that a restarted
    incarnation finds the segments a killed one left and sweeps them (a
    consumer that mapped one keeps its mapping).

    Seqs and row offsets restore to their journaled watermarks, the
    shuffle re-runs from the first epoch not fully consumed (the ``(seed,
    epoch, task)`` lineage makes the re-run bit-identical), and delivered
    items are dropped before the queue: the restarted server serves the
    undelivered remainder. Returns ``(server, shuffle_result, queue)``.
    """
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    from ray_shuffling_data_loader_tpu_torch import dataset as ds
    from ray_shuffling_data_loader_tpu_torch import shuffle as sh

    stream_epochs = config.get("epochs")
    num_epochs = (len(stream_epochs) if stream_epochs is not None
                  else int(config["num_epochs"]))
    num_trainers = int(config["num_trainers"])
    num_shards = int(config.get("num_shards", 1))
    shard_index = int(config.get("shard_index", 0))
    # A shard restarted after a committed move owns the ranks the move
    # left it (the adoption merged their watermarks into its journal).
    placement = config.get("placement") or {}
    overrides = {int(r): int(s)
                 for r, s in dict(placement.get("overrides", {})).items()}
    owned_ranks = ([r for r in range(num_trainers)
                    if overrides.get(r, r % num_shards) == shard_index]
                   if num_shards > 1 else None)
    journal_path = config["journal_path"]
    handle_dir = config.get("handle_dir")
    if not handle_dir:
        digest = zlib.crc32(os.path.abspath(journal_path).encode())
        handle_dir = os.path.join(pp.shm_base_dir(),
                                  f"rsdl-qhandles-{digest:08x}")
    if os.path.isdir(handle_dir):
        # The segments of a killed incarnation, which could not clean up.
        for name in os.listdir(handle_dir):
            try:
                os.unlink(os.path.join(handle_dir, name))
            except OSError:
                pass
    state = ckpt.WatermarkJournal.load(journal_path)
    start_epoch, skip_items = _resume_plan(state, num_epochs, num_trainers,
                                           ranks=owned_ranks)
    if state:
        logger.warning(
            "queue server (shard %d/%d) resuming from journal %s: "
            "start_epoch=%d, skipping %s already-delivered items",
            shard_index, num_shards, journal_path, start_epoch,
            {q: n for q, n in skip_items.items() if n})
    journal = ckpt.WatermarkJournal(journal_path)
    journal.compact()
    queue = mq.MultiQueue(num_epochs * num_trainers)
    consumer = _resuming_batch_consumer(queue, num_trainers, skip_items,
                                        owned_ranks=owned_ranks)
    map_transform = None
    if config.get("cast"):
        from ray_shuffling_data_loader_tpu_torch import transforms
        map_transform = transforms.CastTransform(config["cast"])
    if stream_epochs is not None:
        specs = [plan_ir.EpochSpec(
                     epoch=int(e["epoch"]),
                     filenames=tuple(str(f) for f in e["filenames"]),
                     window=(dict(e["window"])
                             if e.get("window") is not None else None),
                     tenant_id=e.get("tenant_id"))
                 for e in stream_epochs]
        specs = [s for s in specs if s.epoch >= start_epoch]
        serve_gauge = rt_metrics.gauge(
            "rsdl_stream_serve_watermark",
            "stream time fully handed to the serving plane")
        by_epoch = {s.epoch: s for s in specs}

        def on_epoch_done(epoch: int) -> None:
            spec = by_epoch.get(epoch)
            watermark = ((spec.window or {}).get("ingest_watermark")
                         if spec is not None else None)
            if watermark is not None:
                serve_gauge.set(float(watermark))

        shuffle_result = sh.run_shuffle_epochs_in_background(
            specs, consumer, int(config["num_reducers"]), num_trainers,
            int(config.get("max_concurrent_epochs", 2)),
            seed=int(config.get("seed", 0)),
            on_failure=ds.make_failure_broadcaster(queue),
            num_workers=config.get("num_workers"),
            file_cache=config.get("file_cache", "auto"),
            epochs_hint=len(specs), on_epoch_done=on_epoch_done,
            map_transform=map_transform)
    else:
        shuffle_result = sh.run_shuffle_in_background(
            list(config["filenames"]), consumer, num_epochs,
            int(config["num_reducers"]), num_trainers,
            int(config.get("max_concurrent_epochs", 2)),
            seed=int(config.get("seed", 0)),
            on_failure=ds.make_failure_broadcaster(queue),
            num_workers=config.get("num_workers"), collect_stats=False,
            start_epoch=start_epoch,
            file_cache=config.get("file_cache", "auto"),
            map_transform=map_transform)
    server = QueueServer(
        queue, (config.get("host", "127.0.0.1"), int(config["port"])),
        num_trainers=num_trainers, journal=journal, initial_state=state,
        exit_on_crash_site=True, shard_index=shard_index,
        num_shards=num_shards, handle_dir=handle_dir,
        tenants=config.get("tenants"), placement=config.get("placement"))
    rt_metrics.gauge("rsdl_queue_serve_shards",
                     "shard count of the live queue serving plane").set(
                         num_shards)
    return server, shuffle_result, queue


def _serve_main(argv: List[str]) -> int:
    """``python -m ray_shuffling_data_loader_tpu_torch.multiqueue_service
    <config.json>``: the supervised server process. Prints ``READY
    <port>`` once it listens, and serves until SIGTERM."""
    if len(argv) != 2:
        print("usage: python -m ray_shuffling_data_loader_tpu_torch."
              "multiqueue_service <config.json>", file=sys.stderr)
        return 2
    with open(argv[1]) as f:
        config = json.load(f)

    # The supervisor stops the process with SIGTERM: unwind normally, so
    # the finally below and the telemetry's exit dump run.
    def _on_sigterm(_signum, _frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_sigterm)
    # The federated exposition and SIGUSR1 dumps (RSDL_TELEMETRY_DIR and
    # RSDL_TRACE_DIR come through the environment).
    rt_telemetry.install_signal_dump()
    rt_metrics.maybe_start_shard_writer()

    server, shuffle_result, queue = serve_pipeline(config)
    print(f"READY {server.address[1]}", flush=True)
    try:
        shuffle_result.result()
        # Consumers may still be draining and refetching replays: serve
        # until the supervisor stops the process.
        threading.Event().wait()
    finally:
        server.close()
        queue.shutdown()
        # What the buffer ledger still holds once the server released its
        # handle frames' pins: the exit flush of the metrics shard
        # carries it (0 for a process whose every pin was released).
        from ray_shuffling_data_loader_tpu_torch import native
        rt_metrics.gauge("rsdl_ledger_bytes_in_use",
                         "bytes the buffer ledger holds").set(
                             native.buffer_ledger().bytes_in_use())
    return 0


if __name__ == "__main__":
    sys.exit(_serve_main(sys.argv))
