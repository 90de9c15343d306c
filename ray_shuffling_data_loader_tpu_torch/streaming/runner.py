"""The streaming driver: windows in, pipelined epochs out (own copy of the
JAX package's ``streaming/runner.py``).

:class:`StreamingShuffleRunner` feeds a ``streaming.source`` through the
window assembler into ``shuffle.shuffle_epochs``: window N+1 is assembled
and shuffled while window N is served, which is the
``max_concurrent_epochs`` throttle, since a window is an epoch. The runner
adds the stream's bookkeeping:

- the serve watermark (stream time fully handed to the consumers),
  advanced by the driver's ``on_epoch_done`` hook, and the
  ``rsdl_stream_watermark_lag_seconds`` gauge;
- the ingest journal (``checkpoint.StreamJournal``), so that a restarted
  runner resumes the window and epoch numbering and skips the sealed
  prefix of the source's events;
- the window-boundary resize of an elastic world (``membership=``);
- :func:`server_config`: the frozen window schedule a supervised queue
  server (``multiqueue_service.serve_pipeline``) re-derives on every
  restart;
- the stream's tenant (``tenant=``, ``server_config(tenant_id=)``):
  every window spec carries its id, and :meth:`StreamingShuffleRunner.run`
  drives the shuffle under its ``tenancy.tenant_scope``.

A trainer reads the served stream as it reads epochs: a
``DeviceShufflingDataset(num_epochs=None)`` over the runner's queue, or
a remote queue client.

Host code: imports no torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import timeit
from typing import Any, Callable, Dict, Optional

from ray_shuffling_data_loader_tpu_torch import executor as ex
from ray_shuffling_data_loader_tpu_torch import tenancy as rt_tenancy
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.streaming import window as win
from ray_shuffling_data_loader_tpu_torch.streaming.source import StreamSource
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)


class StreamingShuffleRunner:
    """Drive a stream (bounded or not) through the shuffle.

    ``batch_consumer`` has the shuffle driver's contract
    (``batch_consumer(rank, epoch, refs_or_None)``); window ``i`` is epoch
    ``first_epoch + i``, so a consumer reading queue
    ``plan.ir.queue_index(epoch, rank, num_trainers)`` works unchanged.

    ``journal_path`` journals the ingest side and resumes from it: a
    runner over the same journal starts at the next unsealed window and
    skips the source's sealed prefix (the source re-yields the same
    sequence), so the epochs go on with no event missed or sealed twice.

    ``membership`` (a ``membership.MembershipManager``) re-reads the world
    at every window seal, after ``member_crash`` chaos had its chance:
    each window's reducer count follows the live view
    (``membership.reducers_for_view``) and its meta carries the view.

    ``tenant`` (a ``tenancy.TenantContext``, an id or a dict; None: the
    ambient tenant) owns the stream: each window spec without a
    ``tenant_id`` gets its id, and :meth:`run` runs under its
    ``tenant_scope`` (a ``ContextVar``: it reaches what runs on the
    calling thread, not the shuffle's worker threads or processes).
    """

    def __init__(self, source: StreamSource, batch_consumer,
                 num_reducers: int, num_trainers: int, seed: int = 0,
                 max_concurrent_epochs: int = 2,
                 policy: Optional[win.WindowPolicy] = None,
                 journal_path: Optional[str] = None,
                 first_epoch: int = 0,
                 num_workers: Optional[int] = None,
                 max_windows: Optional[int] = None,
                 clock_step_s: Optional[float] = None,
                 on_window_served: Optional[Callable[[int], None]] = None,
                 tenant=None, membership=None):
        from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
        self.tenant = (rt_tenancy.resolve(tenant)
                       if tenant is not None else None)
        self.source = source
        self.batch_consumer = batch_consumer
        self.num_reducers = num_reducers
        self.num_trainers = num_trainers
        self.seed = seed
        self.max_concurrent_epochs = max_concurrent_epochs
        self.num_workers = num_workers
        self.max_windows = max_windows
        self.clock_step_s = clock_step_s
        self._on_window_served = on_window_served
        # The base world, read once, so each window's reducer count is a
        # pure function of its view.
        self.membership = membership
        self._base_world = (len(membership.current_view().ranks)
                            if membership is not None else 0)
        journal = None
        resumed = {"next_window": 0, "events_sealed": 0,
                   "ingest_watermark": float("-inf")}
        if journal_path:
            resumed = win.resume_state(journal_path)
            journal = ckpt.StreamJournal(journal_path)
        self.resume_skip_events = resumed["events_sealed"]
        self.assembler = win.WindowAssembler(
            policy=policy, journal=journal, first_epoch=first_epoch,
            first_window=resumed["next_window"])
        if resumed["ingest_watermark"] != float("-inf"):
            self.assembler.ingest_watermark = resumed["ingest_watermark"]
        self.serve_watermark = float("-inf")
        self._window_meta: Dict[int, Dict[str, Any]] = {}
        self.windows_served = 0
        self._gauge_serve = rt_metrics.gauge(
            "rsdl_stream_serve_watermark",
            "stream time fully handed to the serving plane")
        self._gauge_lag = rt_metrics.gauge(
            "rsdl_stream_watermark_lag_seconds",
            "ingest watermark minus serve watermark, stream seconds")

    # -- watermarks ------------------------------------------------------

    def _observe_lag(self) -> None:
        ingest = self.assembler.ingest_watermark
        serve = self.serve_watermark
        if ingest == float("-inf"):
            return
        if serve == float("-inf"):
            # Nothing served yet: everything sealed is lag.
            lag = max(0.0, ingest - min(
                m["ingest_watermark"] for m in self._window_meta.values()
            )) if self._window_meta else 0.0
        else:
            lag = max(0.0, ingest - serve)
        self._gauge_lag.set(lag)

    def _on_epoch_done(self, epoch: int) -> None:
        meta = self._window_meta.pop(epoch, None)
        if meta is None:
            return
        self.windows_served += 1
        watermark = meta.get("ingest_watermark")
        if watermark is not None:
            self.serve_watermark = max(self.serve_watermark,
                                       float(watermark))
            self._gauge_serve.set(self.serve_watermark)
        self._observe_lag()
        if self._on_window_served is not None:
            self._on_window_served(int(meta["index"]))

    def _apply_view(self, spec):
        """The window-boundary resize: let ``member_crash`` chaos act at
        this boundary, read the view and give the sealed window the live
        world's reducer count. A row is delivered once whatever the
        reducer count, so a resize loses and doubles nothing."""
        from ray_shuffling_data_loader_tpu_torch import membership as mem
        manager = self.membership
        for rank in list(manager.current_view().ranks):
            manager.maybe_crash(spec.epoch, rank)
        view = manager.current_view()
        reducers = mem.reducers_for_view(self.num_reducers,
                                         self._base_world, view)
        window = spec.window
        if window is not None:
            window = dict(window)
            window["view_id"] = view.view_id
            window["view_ranks"] = list(view.ranks)
        if reducers != self.num_reducers:
            logger.warning(
                "window %s (epoch %d): world resized to %d rank(s) "
                "(view %d); %d reducers", (window or {}).get("index"),
                spec.epoch, len(view.ranks), view.view_id, reducers)
        return dataclasses.replace(spec, num_reducers=reducers,
                                   window=window)

    def _specs(self):
        for spec in self.assembler.specs(self.source,
                                         max_windows=self.max_windows,
                                         clock_step_s=self.clock_step_s):
            if self.tenant is not None and spec.tenant_id is None:
                spec = dataclasses.replace(
                    spec, tenant_id=self.tenant.tenant_id)
            if self.membership is not None:
                spec = self._apply_view(spec)
            if spec.window is not None:
                self._window_meta[spec.epoch] = dict(spec.window)
            self._observe_lag()
            yield spec
        if self.resume_skip_events:
            logger.info("stream resume: %d sealed events were skipped "
                        "before window %d", self.resume_skip_events,
                        self.assembler.window_index)

    def _skip_sealed_prefix(self) -> None:
        """Drop the source's first ``resume_skip_events`` events, the
        prefix the journal says is sealed. The source re-yields the same
        sequence, so dropping by count drops by identity."""
        remaining = self.resume_skip_events
        while remaining > 0:
            events = self.source.poll()
            if not events:
                if self.source.exhausted:
                    break
                continue
            if len(events) > remaining:
                # The poll's tail goes into the assembler.
                for event in events[remaining:]:
                    self.assembler.admit(event)
                break
            remaining -= len(events)

    # -- driving ---------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        """Run the stream to its end (a bounded source or ``max_windows``)
        and return its summary."""
        sh = importlib.import_module(
            "ray_shuffling_data_loader_tpu_torch.shuffle")
        start = timeit.default_timer()
        self._skip_sealed_prefix()
        scope = (rt_tenancy.tenant_scope(self.tenant)
                 if self.tenant is not None else contextlib.nullcontext())
        with scope:
            duration = sh.shuffle_epochs(
                self._specs(), self.batch_consumer, self.num_reducers,
                self.num_trainers,
                max_concurrent_epochs=self.max_concurrent_epochs,
                seed=self.seed, num_workers=self.num_workers,
                file_cache=None, epochs_hint=None,
                on_epoch_done=self._on_epoch_done)
        return {
            "duration_s": timeit.default_timer() - start,
            "shuffle_s": duration,
            "windows_closed": self.assembler.window_index,
            "windows_served": self.windows_served,
            "events_sealed": self.assembler.events_sealed,
            "late_events": self.assembler.late_events,
            "quarantined": len(self.assembler.quarantined),
            "ingest_watermark": self.assembler.ingest_watermark,
            "serve_watermark": self.serve_watermark,
        }

    def run_in_background(self) -> ex.TaskRef:
        """:meth:`run` on a driver thread of its own; the ref resolves to
        the summary or raises the run's error."""
        driver_pool = ex.Executor(num_workers=1,
                                  thread_name_prefix="rsdl-stream")

        def _run():
            try:
                return self.run()
            finally:
                driver_pool.shutdown(wait_for_tasks=False)

        return driver_pool.submit(_run)

    def close(self) -> None:
        self.source.close()


def server_config(source: StreamSource, num_trainers: int,
                  num_reducers: int, journal_path: str, seed: int = 0,
                  policy: Optional[win.WindowPolicy] = None,
                  max_windows: Optional[int] = None,
                  max_concurrent_epochs: int = 2,
                  ingest_journal_path: Optional[str] = None,
                  tenant_id: Optional[str] = None,
                  **extra: Any) -> Dict[str, Any]:
    """The supervised queue server's config for a bounded stream: drain
    ``source`` into a frozen window schedule (journaling the ingest
    watermarks to ``ingest_journal_path``) and put it in the
    ``serve_pipeline`` config as ``epochs``. The schedule is data, so
    every restarted server re-derives the same epochs. ``tenant_id``
    stamps each window spec that has none. ``extra`` goes into the config
    as given (``cast``, ``num_workers``, ``file_cache``, ``handle_dir``,
    ``child_env``, ``tenants``, ...)."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    journal = (ckpt.StreamJournal(ingest_journal_path)
               if ingest_journal_path else None)
    specs = win.freeze_schedule(source, policy=policy,
                                max_windows=max_windows, journal=journal)
    if journal is not None:
        journal.close()
    if tenant_id is not None:
        specs = [dataclasses.replace(s, tenant_id=tenant_id)
                 if s.tenant_id is None else s for s in specs]
    config = {
        "epochs": win.specs_to_dicts(specs),
        "num_trainers": int(num_trainers),
        "num_reducers": int(num_reducers),
        "seed": int(seed),
        "max_concurrent_epochs": int(max_concurrent_epochs),
        "journal_path": journal_path,
    }
    config.update(extra)
    return config
