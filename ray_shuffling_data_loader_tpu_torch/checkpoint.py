"""Loader-state and train-state checkpoints, for a mid-epoch resume on the
same batch stream (counterpart of the JAX package's ``checkpoint.py``).

The shuffle is keyed by ``(seed, epoch, task)``, so every epoch's batch
stream is a pure function of ``(seed, epoch)``: resuming re-runs the
shuffle from the checkpoint's epoch (``start_epoch``) and skips the
batches already consumed (``set_epoch(epoch, skip_batches=)``).

- :class:`LoaderCheckpoint` is that position, as JSON in the JAX
  package's format (``FORMAT_VERSION``): a file written by either package
  loads in the other. Saves are atomic (temporary file, fsync, rename,
  directory fsync).
- :func:`resume_iterator` iterates a dataset from a checkpoint and keeps
  it current, at least once.
- :class:`TrainStateCheckpointer` saves the other half, the model's and
  the optimizer's ``state_dict`` and the state of the generators the next
  step reads (BERT's mask generator), with the loader checkpoint beside
  them, one directory per step. A trainer over a mesh saves the global
  state (a tensor-parallel one gathers its shards, as Orbax saves global
  arrays), written by rank 0 alone, and restores it cut by its own
  ``param_specs``, so a step saved at one layout restores into another.
- :func:`crc_line` / :func:`parse_crc_line`: the crc'd JSON line every
  append-only journal shares (the membership journal,
  ``membership.MembershipJournal``, and the watermark journal), byte for
  byte the JAX package's.
- :class:`WatermarkJournal`: the queue server's journal of per-queue
  delivered watermarks and frame births
  (``multiqueue_service.QueueServer``), in the JAX package's line format,
  so either package loads the other's; a restarted server process
  resumes from it (``plan.ir.resume_from_watermarks``);
  :func:`shard_journal_path` names each serving shard's own journal.
- :class:`StreamJournal`: a stream's ingest journal (a directory tail's
  manifest and the window assembler's ingest watermarks,
  ``streaming/``), in the same line format.

torch is imported where a train state is saved or restored, not at import:
the queue server's child process loads this module for its journal and
no torch.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import tempfile
import threading
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Sequence

if TYPE_CHECKING:
    import torch

from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

FORMAT_VERSION = 1


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _canonical(entry: dict) -> str:
    return json.dumps(entry, sort_keys=True, separators=(",", ":"))


def crc_line(entry: dict) -> str:
    """Encode one journal record in the crc'd-line discipline of the JAX
    package's append-only journals (membership views here): the ``crc``
    field covers the canonical encoding (sorted keys, compact separators)
    of ``entry``, so a torn tail, written by a process that died
    mid-write, is detected on load and never misread. The bytes equal the
    JAX package's ``checkpoint.crc_line``, so either package replays a
    journal the other wrote."""
    from ray_shuffling_data_loader_tpu_torch import native
    crc = native.crc32(_canonical(entry).encode()) & 0xFFFFFFFF
    return _canonical({"crc": crc, "entry": entry})


def parse_crc_line(line: str) -> dict:
    """Decode one :func:`crc_line` record; raises ``ValueError`` on a
    missing or mismatched CRC (the torn-tail shape loaders skip)."""
    from ray_shuffling_data_loader_tpu_torch import native
    record = json.loads(line)
    entry = record["entry"]
    if (native.crc32(_canonical(entry).encode()) & 0xFFFFFFFF
            != record["crc"]):
        raise ValueError("crc mismatch")
    return entry


def _atomic_write(path: str, text: str) -> None:
    """Replace ``path`` by ``text`` durably: temporary file, fsync,
    rename, directory fsync."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, path)
        _fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise


@dataclasses.dataclass
class LoaderCheckpoint:
    """Everything needed to resume the input pipeline deterministically."""

    seed: int
    epoch: int
    batches_consumed: int  # within the current epoch
    num_epochs: int
    num_trainers: int
    rank: int
    batch_size: int
    version: int = FORMAT_VERSION

    def save(self, path: str) -> None:
        """Atomic durable write: tmp file + fsync + rename + dir fsync."""
        _atomic_write(path, json.dumps(dataclasses.asdict(self), indent=2))

    @classmethod
    def load(cls, path: str) -> "LoaderCheckpoint":
        with open(path) as f:
            data = json.load(f)
        version = data.get("version", 0)
        if version != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format version {version} != {FORMAT_VERSION}")
        return cls(**data)


@dataclasses.dataclass
class WatermarkEntry:
    """The latest journaled state of one queue index: the last acked
    frame seq, the table rows delivered through it, whether the epoch-end
    sentinel itself was acked, and the births of frames not yet acked
    (``seq -> (pid, t_mono, t_unix)``, each journaled when its frame was
    first built). A queue with births but no watermark reads
    ``seq == -1``: nothing delivered."""

    seq: int
    rows: int
    done: bool = False
    births: Dict[int, tuple] = dataclasses.field(default_factory=dict)


def shard_journal_path(path: str, shard_index: int, num_shards: int) -> str:
    """The watermark journal of one serving-plane shard. A shard journals
    only the queues of its own ranks (``plan.ir.queue_shard``), so a
    restarted shard resumes from its own journal alone. One shard keeps
    the single server's name."""
    if num_shards <= 1:
        return path
    return f"{path}.shard{shard_index}"


class _CrcJournal:
    """An append-only file of :func:`crc_line` records, opened on the
    first append."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        self._file = None

    @property
    def path(self) -> str:
        return self._path

    def _append(self, entry: dict, durable: bool) -> None:
        line = crc_line(entry) + "\n"
        with self._lock:
            if self._file is None:
                directory = os.path.dirname(os.path.abspath(self._path))
                os.makedirs(directory, exist_ok=True)
                self._file = open(self._path, "a", encoding="utf-8")
            self._file.write(line)
            self._file.flush()
            if durable:
                os.fsync(self._file.fileno())

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class WatermarkJournal(_CrcJournal):
    """Crc'd append-only journal of per-queue delivered watermarks (the
    JAX package's ``checkpoint.WatermarkJournal``, line for line).

    The queue server appends a record each time a consumer's ack
    watermark advances (flushed and fsync'd) and one per frame birth
    when the frame is first built (flushed, not fsync'd: a lost birth
    only under-reports that frame's latency). A restarted server loads
    the journal and regenerates only the undelivered remainder. Each line
    is a :func:`crc_line`, so a torn tail (the server died mid-write) is
    skipped on :meth:`load`, never misread; :meth:`compact` rewrites the
    latest state per queue atomically.
    """

    def record(self, queue_index: int, seq: int, rows: int,
               done: bool = False) -> None:
        """Append one watermark advance, flushed and fsync'd: a ``kill
        -9`` loses at most acks the consumer will see again (it drops
        replays by seq)."""
        self._append({"q": int(queue_index), "seq": int(seq),
                      "rows": int(rows), "done": bool(done)}, durable=True)

    def record_birth(self, queue_index: int, seq: int, pid: int,
                     t_mono: float, t_unix: float) -> None:
        """Journal a frame's original payload birth as it is first built,
        so a restarted server gives the frames it regenerates their true
        births (a replay after a crash reports its real latency)."""
        self._append({"q": int(queue_index), "bseq": int(seq),
                      "pid": int(pid), "tm": float(t_mono),
                      "tu": float(t_unix)}, durable=False)

    @classmethod
    def load(cls, path: str) -> Dict[int, WatermarkEntry]:
        """The latest watermark per queue index with the births past it;
        a line with a bad or missing CRC (a torn tail) is skipped with a
        warning."""
        state: Dict[int, WatermarkEntry] = {}
        births: Dict[int, Dict[int, tuple]] = collections.defaultdict(dict)
        if not os.path.exists(path):
            return state
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = parse_crc_line(line)
                    queue_index = int(entry["q"])
                    if "bseq" in entry:
                        births[queue_index][int(entry["bseq"])] = (
                            int(entry["pid"]), float(entry["tm"]),
                            float(entry["tu"]))
                        continue
                except (ValueError, KeyError, TypeError) as e:
                    logger.warning(
                        "watermark journal %s line %d unreadable (%s); "
                        "skipping (a torn tail from a crash is expected)",
                        path, lineno, e)
                    continue
                previous = state.get(queue_index)
                if previous is None or entry["seq"] >= previous.seq:
                    state[queue_index] = WatermarkEntry(
                        seq=int(entry["seq"]), rows=int(entry["rows"]),
                        done=bool(entry["done"]))
        for queue_index, stamps in births.items():
            entry = state.get(queue_index)
            if entry is None:
                entry = state[queue_index] = WatermarkEntry(seq=-1, rows=0)
            entry.births = {seq: stamp for seq, stamp in stamps.items()
                            if seq > entry.seq}
        return state

    def resume_plan(self, num_epochs: int, num_trainers: int
                    ) -> "tuple[int, Dict[int, int]]":
        """``(start_epoch, skip_items)`` for a producer resuming against
        this journal (``plan.ir.resume_from_watermarks``)."""
        from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
        return plan_ir.resume_from_watermarks(self.load(self._path),
                                              num_epochs, num_trainers)

    def compact(self) -> None:
        """Rewrite the journal as the latest record per queue and the
        births past it, atomically; a restarted server runs it so the
        file cannot grow across crash and recovery cycles."""
        state = self.load(self._path)
        lines = []
        for queue_index in sorted(state):
            entry = state[queue_index]
            if entry.seq >= 0:
                lines.append(crc_line(
                    {"q": queue_index, "seq": entry.seq,
                     "rows": entry.rows, "done": entry.done}) + "\n")
            for seq in sorted(entry.births):
                pid, t_mono, t_unix = entry.births[seq]
                lines.append(crc_line(
                    {"q": queue_index, "bseq": seq, "pid": pid,
                     "tm": t_mono, "tu": t_unix}) + "\n")
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            _atomic_write(self._path, "".join(lines))


class StreamJournal(_CrcJournal):
    """Crc'd append-only journal of a stream's ingest side (the JAX
    package's ``checkpoint.StreamJournal``, line for line; either package
    loads the other's). Where the watermark journal records what
    consumers have durably seen, this records what the stream has durably
    admitted:

    - ``streaming.DirectoryTailSource``'s manifest (``{"kind": "file",
      "n", "path", "ts", "size"}``): the discovery order of arriving
      files, so a recovered tail re-yields the same sequence whatever the
      directory lists today;
    - the window assembler's ingest watermarks (``{"kind": "watermark",
      "window", "events", "watermark", "late", "files"}``): how many
      events are sealed into closed windows.

    Records are flushed and fsync'd by default: a ``kill -9`` between a
    window's seal and its record re-seals the same window, which is
    idempotent because assembly is deterministic in the event order.
    """

    def append(self, entry: dict, durable: bool = True) -> None:
        self._append(dict(entry), durable=durable)

    @classmethod
    def load(cls, path: str) -> List[dict]:
        """Every intact record in append order; a line with a bad or
        missing CRC (a torn tail) is skipped with a warning."""
        entries: List[dict] = []
        if not os.path.exists(path):
            return entries
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    entries.append(parse_crc_line(line))
                except (ValueError, KeyError, TypeError) as e:
                    logger.warning(
                        "stream journal %s line %d unreadable (%s); "
                        "skipping (a torn tail from a crash is expected)",
                        path, lineno, e)
        return entries


def resume_iterator(dataset, checkpoint: LoaderCheckpoint,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 0) -> Iterator:
    """Iterate ``dataset`` from ``checkpoint``, optionally persisting it.

    The caller builds ``dataset`` with the checkpoint's seed, batch size
    and epoch count (validated here) and ``start_epoch=checkpoint.epoch``.
    The current epoch is re-shuffled and its first ``batches_consumed``
    batches are dropped by ``set_epoch(epoch, skip_batches=)``; the rest
    and every later epoch are yielded.

    With ``checkpoint_path``, the checkpoint is saved after every
    ``checkpoint_every`` batches (0: only at epoch ends), and after each
    save the dataset's ``commit_consumed`` (where it has one) commits a
    manual-ack remote queue up to the saved position; at least once: a
    batch counts as consumed only when the caller asks for the next one,
    so a crash while batch N is processed replays it. After the last epoch
    the checkpoint reads ``(epoch=num_epochs, batches_consumed=0)``, and
    resuming a finished run yields nothing.
    """
    for field in ("batch_size", "seed", "num_epochs"):
        have = getattr(dataset, field, None)
        want = getattr(checkpoint, field)
        if have is not None and have != want:
            raise ValueError(
                f"dataset {field} {have} != checkpoint {field} {want}")

    def maybe_save():
        if checkpoint_path is not None:
            checkpoint.save(checkpoint_path)
            # Once the position is durable, a dataset over a manual-ack
            # remote queue commits its consumption (the server drops its
            # replay buffer up to here); what came after the previous
            # save stays replayable for a trainer that dies and resumes.
            commit = getattr(dataset, "commit_consumed", None)
            if commit is not None:
                commit()

    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    for epoch in plan_ir.epoch_range(checkpoint.epoch,
                                     checkpoint.num_epochs):
        skip = checkpoint.batches_consumed if epoch == checkpoint.epoch else 0
        checkpoint.epoch = epoch
        dataset.set_epoch(epoch, skip_batches=skip)
        index = skip
        for batch in dataset:
            index += 1
            checkpoint.batches_consumed = index
            yield batch
            if checkpoint_every and index % checkpoint_every == 0:
                maybe_save()
        checkpoint.batches_consumed = 0
        checkpoint.epoch = epoch + 1
        maybe_save()


_STATE_FILE = "state.pt"
_LOADER_FILE = "loader.json"


def _in_world(trainer) -> bool:
    import torch.distributed as dist
    return (getattr(trainer, "mesh", None) is not None
            and dist.is_available() and dist.is_initialized())


def _global_model_state(trainer) -> dict:
    specs = getattr(trainer, "param_specs", None)
    if specs is None:
        return trainer.model.state_dict()
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    return tp.full_state_dict(trainer.model, specs, trainer.mesh)


def _global_optimizer_state(trainer) -> dict:
    specs = getattr(trainer, "param_specs", None)
    if specs is None:
        return trainer.optimizer.state_dict()
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    return tp.full_optimizer_state_dict(trainer.model, trainer.optimizer,
                                        specs, trainer.mesh)


class TrainStateCheckpointer:
    """Model, optimizer and generator state with the loader position, one
    directory per step under ``directory``.

    A ``trainer`` is a ``parallel.trainer.SpmdTrainer`` or any object with
    ``.model`` and ``.optimizer``. Each step's directory is written under
    a temporary name and renamed into place; the oldest steps past
    ``max_to_keep`` are removed. :meth:`restore` reads the tensors back
    (``torch.load(weights_only=True)``) onto the model's device.

    With a trainer over a mesh in an initialised process group, every rank
    calls :meth:`save` and :meth:`restore`: a save gathers the sharded
    parameters and their optimizer moments (``param_specs``) into global
    tensors, rank 0 writes them and every rank waits for the write and
    raises if it failed; a restore reads the global state and keeps this
    rank's blocks.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer,
             loader_checkpoint: Optional[LoaderCheckpoint] = None,
             generators: Sequence[torch.Generator] = ()) -> None:
        """Save ``trainer``'s model and optimizer, the state of each of
        ``generators`` and, if given, ``loader_checkpoint`` as step
        ``step``; raises if that step exists. In a process group, a write
        that fails on rank 0 raises on every rank (``RuntimeError`` with
        rank 0's error on the others)."""
        final = self._step_dir(step)
        if os.path.exists(final):
            raise ValueError(f"step {step} already exists in "
                             f"{self.directory}")
        state = {"model": _global_model_state(trainer),
                 "optimizer": _global_optimizer_state(trainer),
                 "generators": [g.get_state() for g in generators]}
        if not _in_world(trainer):
            self._write(step, final, state, loader_checkpoint)
            return
        import torch.distributed as dist
        # Every rank saw the step missing before rank 0 writes it.
        dist.barrier()
        error, failure = None, [None]
        if dist.get_rank() == 0:
            try:
                self._write(step, final, state, loader_checkpoint)
            except Exception as e:  # raised below, after the others learn it
                error, failure = e, [f"{type(e).__name__}: {e}"]
        # Every rank waits for the write and learns how it ended.
        dist.broadcast_object_list(failure, src=0)
        if error is not None:
            raise error
        if failure[0] is not None:
            raise RuntimeError(f"rank 0 could not save step {step}: "
                               f"{failure[0]}")

    def _write(self, step: int, final: str, state: dict,
               loader_checkpoint: Optional[LoaderCheckpoint]) -> None:
        import torch
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=f".{step}-",
                               suffix=".tmp")
        try:
            path = os.path.join(tmp, _STATE_FILE)
            with open(path, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            if loader_checkpoint is not None:
                loader_checkpoint.save(os.path.join(tmp, _LOADER_FILE))
            _fsync_dir(tmp)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old))

    def restore(self, trainer, step: Optional[int] = None,
                generators: Sequence[torch.Generator] = ()
                ) -> Optional[LoaderCheckpoint]:
        """Load step ``step`` (default: the latest) into ``trainer`` and
        ``generators`` in place; returns its :class:`LoaderCheckpoint`, or
        None where it was saved without one."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise ValueError("no checkpoint found to restore")
        import torch
        directory = self._step_dir(step)
        device = next(trainer.model.parameters()).device
        with open(os.path.join(directory, _STATE_FILE), "rb") as f:
            state = torch.load(f, map_location=device, weights_only=True)
        saved = state["generators"]
        if len(saved) != len(generators):
            raise ValueError(f"step {step} holds {len(saved)} generator "
                             f"states; {len(generators)} generators given")
        specs = getattr(trainer, "param_specs", None)
        if specs is None:
            trainer.model.load_state_dict(state["model"])
            trainer.optimizer.load_state_dict(state["optimizer"])
        else:
            from ray_shuffling_data_loader_tpu_torch.parallel import tp
            trainer.model.load_state_dict(tp.shard_state_dict(
                trainer.model, state["model"], specs, trainer.mesh))
            trainer.optimizer.load_state_dict(tp.shard_optimizer_state_dict(
                trainer.model, trainer.optimizer, state["optimizer"], specs,
                trainer.mesh))
        for generator, generator_state in zip(generators, saved):
            generator.set_state(generator_state.cpu())
        loader = os.path.join(directory, _LOADER_FILE)
        if not os.path.exists(loader):
            return None
        return LoaderCheckpoint.load(loader)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX package's
        surface."""

    def __enter__(self) -> "TrainStateCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
