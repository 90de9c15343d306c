#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's DLRM, BERT-MLM and ResNet-50 train paths, the sequence-
and data-parallel entry points at world size 1, the distributed shuffle
and its training entry point in a world of two processes, elastic
membership (failure detection across processes, the generation fence,
a shrink and a grow under the DLRM step), the queue service (a
supervised server process feeding the DLRM step, killed once mid-epoch;
two supervised shard processes, one killed, feeding it through shared
memory), a stream's windows (in process, and served by supervised
shards, one killed at a window boundary), two tenants sharing a serving
plane (the weighted-fair split, the hot tenant's step beside a cold
replay, a live move fired by its delivery SLO, its shard killed,
admission and cache quotas), the ops plane (health detectors over a
history ring, incident capsules, the sampling profiler), save, restore and
resume mid-epoch, and Megatron tensor parallelism over a ``("data", "model")``
mesh (DLRM, BERT-base and ResNet-50 in two processes, the multi-rank dry
run), end to end at full width, and checks its
hand-written kernels against their plain PyTorch versions. Phases, each
printing one JSON line:

1. ``env``: torch/CUDA versions, the card's name and power limit, PIL's
   version, ``g++`` and the codec headers the native image decoder needs,
   and the decoder the ``resnet`` phase uses (``"native"`` where it can be
   built, else ``"pil"``); the host's cores, the process pool's segment
   dir, its free bytes and whether it is writable, and the backend
   ``"auto"`` resolves to for the DLRM spec (the process pool on a host
   of several cores).
2. ``build``: builds ``kernels/gather.cu`` and ``kernels/flash_attention.cu``
   for sm_90a from the sources, one ``nvcc`` each, started together, and
   reports ``ptxas``'s registers and spills for every kernel instantiation.
3. ``kernels``: the gather kernel against its plain version on the card,
   bit for bit. One table (a group of one) at the ``mlperf`` shapes
   (V=945195, E=128, B in {2048, 131072}, int32 indices including
   out-of-range ones, f32 and bf16 outputs; table gradient within 1e-6
   relative). The DLRM step's group: the 8 ``mlperf`` tables above 2048
   rows in one launch, B=2048, bf16, int32 (gradient within 1e-6
   relative, on ids in range). The group's gradient at clamped ids
   (int8..int64 ids up to 1,000 past each end, about 1,000 cotangent rows
   piled onto rows 0 and V-1) against the f64 sum of the same cotangents,
   within the bound of any f32 summation order. A mixed group:
   int8/16/32/64 indices in one launch, f32 and bf16, E=128 and E=37,
   written straight into a (B, G, E) tensor. Times (CUDA graphs and events) for the kernel, the
   plain version, 8 one-table launches and 8 ``torch.index_select`` calls,
   beside the bound.
4. ``train``: 2,000,000 generated rows in 8 Parquet files -> seeded
   shuffle (8 reducers) -> ``DeviceShufflingDataset`` (1 trainer, batch
   131072, 2 epochs, seed 0) -> DLRM ``mlperf`` (all 19 tables, embed 128,
   top MLP 1024-1024-512-256, bf16 compute, random weights from seed 0)
   -> Adam, one micro-step per 2048 rows. Checks rows per epoch, finite
   losses, the first staged batch against a host-side shuffle, the kernel
   path's loss against the ``take`` path's, and exactly one gather launch
   per micro-step. The shuffle runs the engine's defaults (``"auto"``,
   which must resolve to the process pool here: the phase fails
   otherwise; its segments are the file cache) with ``collect_stats``:
   the line carries the backend, the pool's width and worker pids, the
   segment cache's hits and bytes, each epoch's map, reduce and consume
   seconds (``TrialStats``) and the buffer ledger's peak bytes. The
   phase runs armed as the JAX bench arms its train phase:
   ``runtime.health.arm(component="smoke")`` over ``throughput_droop``,
   ``stall_breach``, ``ledger_creep``, ``queue_saturation``,
   ``lease_churn`` and ``straggler_drift`` (the history ring on the
   watchdog at the default 1 s), inside ``runtime.profiler.maybe_sample()``
   (folded stacks into a temporary ``RSDL_PROFILE_FOLDED``); the line's
   ``health`` carries the ring's ticks, its longest gap between
   snapshots and each gap over 1.5 intervals, and each detector's fires (a
   fire's detail and capsule are evidence, not a failure) and its
   ``profiler`` the samples, the top stages billed and CPU seconds by
   thread. Fails if the ring ticked fewer times than the phase's seconds
   allow, less 2.
5. ``torch_binding``: the port's Torch binding (``torch_dataset.
   TorchShufflingDataset``) as a reference-style trainer uses it, over the
   ``train`` phase's files with its epochs, batch, reducers and seed and
   the ``mlperf`` column spec (int32 features, f32 labels, cast per batch
   on the host; ``train`` casts at map time): each CPU batch goes
   ``.to("cuda")`` into a fresh DLRM ``mlperf`` (weights from seed 0),
   one micro-step per 2048 rows. Fails unless every batch's digest equals
   ``train``'s at its position, the rows per epoch equal ``train``'s, the
   losses are finite, there is one gather launch per micro-step and the
   first loss is within ``ENGINE_LOSS_RTOL`` of ``train``'s. Prints
   rows/s, ``stall_pct``, the fill, the step ms, the host-to-device copy
   ms per loader batch and its rows/s over ``train``'s (what the host
   binding costs against the bulk device binding).
6. ``telemetry``: the ``train`` phase's DLRM run (its files, the process
   pool of 8, the bulk binding, 2 epochs, Adam) in two turns in this call:
   (a) ``RSDL_TELEMETRY=0``, (b) the default (recording on) with
   ``RSDL_TELEMETRY_DIR`` and ``RSDL_TRACE_DIR`` in a temporary directory.
   Prints each turn's step ms, rows/s and ``stall_pct`` and (b)'s rows/s
   over (a)'s; each epoch's verdict (bottleneck stage, the batch-wait
   share, p50/p95/p99 per stage); the recorder's events and drops;
   ``measure_record_overhead`` and ``measure_disabled_overhead`` on this
   host; the federated exposition (its families, one shard per process:
   the driver and the 8 workers); ``birth_to_delivered`` and
   ``birth_to_device`` p50/p99 from the latency sketch; each epoch's
   critical path (top three stages, what-if) over the merged dumps of
   the driver and the workers; the device-memory sampler against
   ``torch.cuda.memory_allocated()``; and a ``torch.profiler`` capture
   of every thread over a fresh loader's fill and 5 micro-steps (the
   loader's ranges by stage name, ``train#N`` per step, the gather kernel
   on the same timeline). Fails unless both turns' digests equal the
   ``train`` stream, one gather launch per micro-step, ``map_read`` for
   each file and epoch and ``reduce_gather`` for each reducer and epoch
   in the workers' dumps, ``batch_wait`` for each batch, a shard from
   every worker and a verdict for each epoch. Every loader phase also
   prints its epochs' verdicts (``"verdicts"``).
7. ``ops``: the JAX dry run's ops scene on the card. A process pool of 2
   (``RSDL_EXECUTOR_BACKEND=process``, ``RSDL_TRACE_DIR`` and
   ``RSDL_TELEMETRY_DIR`` in a temporary directory) shuffles the first 2
   ``train`` files (500,000 rows) for 3 epochs into a fresh DLRM
   ``mlperf`` that trains every micro-step (batch 4096) through
   ``DeviceShufflingDataset``; ``throughput_droop`` is armed with the
   ring at 0.1 s, a window of 8 ticks, ``fire_ticks=2``,
   ``clear_ticks=50`` and no capture cooldown. The workers' environment
   carries ``RSDL_CHAOS_SPEC=reduce_gather:epoch2:delay4000``, and epoch
   2 is handed to the shuffle only once the ring holds 11 ticks of
   undelayed activity, so the baseline is long enough whatever the
   host's speed. Checks exactly one fire, after epoch 2 started; one
   auto-captured capsule whose ``traces/`` hold the driver's dump and a
   SIGUSR1'd worker's; ``tools/rsdl_incident.py`` on it exits 0; its
   merged exposition carries ``rsdl_worker_tasks_total``, which only the
   workers register; rows and keys once per epoch; one gather launch
   per micro-step; finite losses. Prints the gate's wait, the fire's
   tick and detail, the capsule's pids and files and the phase's
   seconds.
8. ``attention``: the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions on the card, in bf16, within 2e-2 (atol and
   rtol; the kernels round P and dS to bf16 for the tensor cores): B=32,
   H=12, S=512, D=64 with and without a key-side bias that masks keys; a
   ragged S=500, D=32; a ragged Sq=100, Sk=40, D=64; one query row against
   Sk=200 keys at D=128; and dq, dk/dv given a global lse over twice as
   many keys. Device times (CUDA graphs) of each
   kernel and its plain version at the main shape without bias, beside the
   bound (and the share of it reached) and, as a yardstick,
   ``scaled_dot_product_attention``'s forward and backward (and each
   kernel's time over it).
9. ``bert``: 8,192 generated sequences of 512 tokens (vocab 30,522) in 8
   Parquet files -> seeded shuffle (8 reducers) -> ``DeviceShufflingDataset``
   (1 trainer, batch 256, 2 epochs, seed 0) -> on-device MLM masking ->
   ``bert_base()`` (bf16 compute, random weights from seed 0) with the flash
   kernels -> Adam (lr 1e-4), one micro-step per 32 sequences. Checks rows
   per epoch, finite losses, the first staged batch against a host-side
   shuffle, the flash path's loss against the inline path's (within 1e-2
   relative: bf16 compute, the two round the scores at different places),
   and exactly 12 launches of each flash kernel per micro-step.
10. ``rebatch``: the two device bindings of ``DeviceShufflingDataset`` in
   turns within this call (per-batch, then bulk), each a fresh
   DLRM ``mlperf`` trained on the ``train`` phase's data for 2 epochs (bulk
   through ``device_rebatch="auto"``, the default on the card). Every
   batch is digested on the device (exact int64 sums of each column,
   weighted by row position) and the digests must be equal in every turn;
   each loader batch's mean loss within 1e-2 relative of the first turn's
   (whether bit for bit is reported); one gather launch per micro-step.
   Per turn: rows/s, ``stall_pct``, step ms, the wait for epoch 1's first
   batch, copies per epoch and chunk sizes in batches, the input
   pipeline's peak device bytes against the chunk cap, peak pinned host
   bytes. Then, loader only: (b) a bulk epoch under a 1e-4 s watchdog
   deadline must degrade to per-batch copies with the same digests; (c) a
   bulk epoch under the chaos spec ``device_transfer@0.05`` (seed 0) must
   recover at least one copy with the same digests; (d) the ``bert``
   phase's tokens (4 batches per reducer table) in both bindings, digests
   equal, copies per epoch.
11. ``engine``: the shuffle engine on the ``train`` phase's files in five
   turns, each a fresh DLRM ``mlperf`` from the same seed taking one
   micro-step on the first 2,048 rows of every loader batch (bulk
   binding, the key column loaded, the last partial batch kept). On the
   thread backend: (1) no file cache and the read-then-plan map; (2) the
   defaults under a memory budget of a quarter of the ``train`` phase's
   peak ledger bytes with a spill directory, so reducer outputs spill and
   are mapped back; (3) the streaming map with both executor attempts of
   map 3's read failing in each epoch (``task_retries=1``), so a reduce
   recomputes it from its lineage. (4) ``pool_kill``: the process pool
   of 4 workers; the first map call holds until a thread of this script
   has SIGKILLed its worker, which it does as soon as the task has
   written its pid (no sleep decides when); the task is recomputed from
   lineage on a respawned pool. (5) ``tiered``: ``file_cache="tiered"``
   (a RAM LRU over a CRC'd disk tier) over a ``SimulatedObjectStore``
   source (2 ms first byte, 512 MB/s, seed 0) with the idle-lane
   prefetch, on threads (the file cache is the thread plane's). Each
   turn: every key once per epoch, each full batch's digest equal to the
   ``train`` phase's, the first loss within 1e-6 relative of the
   ``train`` phase's first micro-step, one gather launch per micro-step;
   its ``TrialStats``, cache, storage tiers (hot and disk hits, prefetch
   tasks run and canceled, bytes written to disk), pool (segment-cache
   hits, respawns), spill (files, bytes, read-back seconds), ledger,
   retry and recovery counts, rows/s and wait per batch.
12. ``ring``: (a) the flash ring's per-hop step (``ops.ring_attention``,
   the code the process-group ring runs) walks n = 2 and n = 4 K/V chunks
   of B=32, H=12, S=512, D=64 bf16 in one process, with and without a
   masking bias: output, dq, dk, dv and dbias against whole-sequence
   ``flash_attention`` within 2e-2 absolute plus 2e-2 relative, n
   launches of each flash kernel per ring pass, and device times of the
   ring pass (forward and backward) beside whole-sequence flash; the
   causal einsum ring, walked per rank, against plain attention with the
   causal mask. (b) The sequence-parallel entry point at world size 1
   over NCCL (``init_process_group`` with a ``file://`` rendezvous, a
   ``("data", "seq")`` mesh of (1, 1)): ``bert_base()`` at S=512 fed from
   2,048 generated sequences through ``DeviceShufflingDataset`` (the data
   coordinate as rank), ``train.make_bert_spmd_micro_step`` with ring
   attention, one epoch, 12 launches of each flash kernel per micro-step;
   its first losses (ring, and one Ulysses step) against the ``bert``
   phase's micro-step from the same weights and masks, within that
   phase's 1e-2 relative. (c) Three DLRM ``mlperf`` steps through
   ``SpmdTrainer`` on a (1, 1) ``("data", "model")`` mesh over NCCL, the
   gather kernel launched once per step, the losses against
   ``train.make_micro_step``'s from the same weights within 1e-5
   relative.
13. ``distributed``: a world of two processes on the one card, started by
   the port's launcher (``launch_slice --local``, ``RSDL_HOSTS`` on two
   free loopback ports), each a ``train_shuffle --distributed`` rank with
   its process group over gloo on CUDA tensors (NCCL refuses two ranks on
   one device) and ``--record-dir``. (a) The loader alone
   (``--mock-train-step-time 0``) on the ``train`` phase's files: 8
   reducers, batch 131,072, 2 epochs, seed 0, each rank a
   ``DeviceShufflingDataset`` in the bulk binding over
   ``parallel.distributed.create_distributed_batch_queue_and_shuffle``,
   the map->reduce chunks that cross ranks sent over the port's TCP
   transport. Every key arrives exactly once per epoch across the ranks,
   and each rank's batch digests (``device_dataset.batch_digest``) equal
   those of the one-process shuffle with ``num_trainers=2`` for that rank.
   Per rank: rows/s, ``stall_pct``, the shuffle's ``TrialStats`` (file
   cache on), the file cache's and the ledger's counters, frames and
   bytes sent and received and the send rate, overall and through the
   native pump. (c) A world of two hosts as threads of this process over
   loopback transports, with a ``map_read`` fault on host 1's file 5 in
   each epoch and ``task_retries=1``: the digests equal (a)'s. (b) DLRM ``mlperf`` (weights from seed 0) through
   ``SpmdTrainer`` on 18,432 rows in 8 files that the ranks generate,
   2,048 rows per rank and step, about 4 steps per epoch, 2 epochs:
   finite losses, one gather launch per step in each rank, the first
   loss within 1e-5 relative of ``train.make_micro_step`` on the two
   ranks' batches concatenated from the same weights, the later ones
   within 1e-3 (the all-reduce sums the gradients in another order);
   step ms and the all-reduce's share of it.
14. ``elastic``: the port's elastic membership (``membership/``, the
   generation-fenced transport). (a) This process's transport (host 0)
   feeds a ``FailureDetector`` (heartbeat 0.05 s, suspect 0.4 s) through
   its frame observer while a peer process (host 1, a port transport, no
   torch) probes it every 0.05 s; after 5 beats the peer is SIGKILLed and
   the time from the kill to the DOWN verdict is
   ``member_down_detect_ms`` (the verdict downs rank 1 in a
   ``MembershipManager``). The peer restarts at the incarnation the
   manager's join assigns (1) and announces it; a frame stamped
   incarnation 0 from a socket of its own (the zombie) must be fenced
   (``rsdl_member_fenced_frames_total`` up by exactly 1, never in the
   inbox) while the rejoined peer's frame is delivered; after
   ``fence_view(1)`` a frame of view 0 must be fenced too. (b) On the
   ``train`` phase's files (8 reducers, seed 0) an ``ElasticShuffleRunner``
   over ranks 0-3, fixed, for 2 epochs, and one under
   ``member_crash:rank1:epoch0`` whose rank 1 rejoins and rank 4 joins at
   the boundary (5 ranks): every reducer table equals the fixed run's,
   ``rows_lost`` 0; the recomputed reducers, ``resize_stall_ms``, rows/s,
   the shrunk and grown world. (c) Trainer 0's stream of each epoch, cut
   into 2,048-row micro-batches by ``dataset.slice_batches``, copied to the
   card, 32 micro-steps per epoch of a fresh DLRM ``mlperf`` (weights from
   seed 0), for the elastic and the fixed run under
   ``torch.use_deterministic_algorithms``: digests and losses equal bit
   for bit, one gather launch per micro-step.
15. ``serving``: the queue service (``multiqueue_service``,
   ``runtime.supervisor``). The ``train`` phase's pipeline (its files, 8
   reducers, seed 0, 2 epochs, the process pool, the DLRM spec's map-time
   cast) runs in supervised server processes (``CUDA_VISIBLE_DEVICES=""``,
   a watermark journal each) or in this process, and
   ``DeviceShufflingDataset(batch_queue=..., shuffle_result=None,
   device=None)`` reads it. (a) One server process
   (``launch_supervised_queue_server``, 1 trainer, delivery ``"auto"``:
   shared-memory handles on loopback), fault-free; (b) the same, the
   server SIGKILLed after 5 loader batches of epoch 0 with
   ``ack_lost:after2:x3`` on the client: the supervisor restarts it, the
   journal and the lineage regenerate the undelivered remainder. (a) and
   (b) train a fresh DLRM ``mlperf`` (weights from seed 0) one micro-step
   per loader batch through the gather kernel: every batch's digest equals
   the ``train`` phase's, the first loss is within 1e-6 relative of its
   first, one gather launch per micro-step, (b) restarts the server at
   least once. (c) The loader alone over an in-process ``serve_queue``
   under ``conn_reset_midframe:after2,frame_corrupt:after3`` with
   ``delivery="stream"``: digests equal (a)'s, at least one reconnect and
   one corrupt frame. (d) Two supervised shard processes
   (``launch_supervised_queue_shards(num_shards=2)``, 2 trainers, the key
   column loaded, delivery ``"auto"``): this process trains a fresh DLRM
   ``mlperf`` (Adam, every 2,048-row micro-step of each loader batch)
   through the gather kernel on rank 0's stream from
   ``connect_remote_queue(shard_map)`` while a thread drains rank 1's from
   shard 1, which is SIGKILLed after rank 1's third loader batch of epoch
   0. Each rank's digests equal the one-process ``num_trainers=2``
   stream's (the ``distributed`` phase's reference), shard 1 restarts,
   rank 0's longest wait for a batch after the kill stays under 15 s, one
   gather launch per micro-step, handle hits with wire bytes at least 10x
   below payload bytes, no segment file under the handle root after the
   stop and each shard's buffer ledger back to 0 bytes at its exit. (e)
   The same pipeline in this process behind ``serve_queue_sharded
   (num_shards=2)``, ``delivery="stream"``, ``RSDL_QUEUE_COMPRESSION=zlib``
   and 2 codec threads, both ranks drained on threads, loader only:
   digests as in (d), bytes saved and ``wire + saved == payload``; it
   prints the codec ``zstd`` resolves to here. (f) A live move under the
   step: the same pipeline in this process behind ``serve_queue_sharded
   (num_shards=2)`` (delivery ``"auto"``), a fresh DLRM ``mlperf`` trains
   every micro-step of rank 0's stream from a ``ShardedRemoteQueue`` (2
   tables per round trip) while a thread drains rank 1's; after rank 0's
   third loader batch of epoch 0, ``rebalance.migrate(controller, 0,
   target=1)`` moves rank 0 to shard 1 (PREPARE, ADOPT, commit, RELEASE),
   and the consumer follows the ``KIND_MOVED`` redirect. Each rank's
   digests equal the one-process ``num_trainers=2`` stream's, the
   consumer's map reads ``overrides == {0: 1}`` and generation 1,
   ``rebalance.replay`` of the decision journal gives ``((0, 1),)``, one
   gather launch per micro-step and one committed move
   (``rsdl_rebalance_moves_total``); it prints each phase's ms, the
   manifest's bytes and frames, rank 0's longest wait for a batch after
   the move and its rows/s beside (e)'s. (g) The abort leg across
   processes: two supervised shard processes, one epoch, whose children
   carry ``RSDL_CHAOS_SPEC=rebalance_prepare:rank0:epoch1``; rank 0 trains
   every micro-step (one table per round trip), rank 1 is drained, and
   after rank 0's first loader batch ``migrate`` dies on the wire as shard
   0 dies at the PREPARE. The abort is journaled (``replay``: no pending
   move, generation 0, no override), shard 0 restarts and shard 1 does
   not, and both ranks' digests equal the one-process stream's epoch 0;
   it prints the seconds from the failed move to rank 0's first frame
   after the restart. Each turn prints its
   delivery, rows/s (per rank in (d) and (e)), the restart's seconds (from
   the kill to the first frame after it), frames replayed and NACK'd,
   client reconnects, payload and wire bytes, handle hits and misses, the
   compression ratio (the server processes' counters from their metric
   shards), ``birth_to_delivered`` p50/p99 and the card's name and power
   limit.
16. ``stream``: the streaming plane (``streaming/``) on a drifting click
   stream: 16 files of 131,072 rows in the ``mlperf`` schema (seed 0;
   ``workloads.dlrm_criteo.generate_drifting_stream``), 2-file windows
   (8 windows of 262,144 rows), 8 reducers, loader batch 131,072, the key
   column loaded. The reference: the stream's frozen schedule shuffled by
   ``shuffle_epochs`` on threads, read per rank with ``num_trainers`` 1
   and 2. (a) A ``SyntheticEventSource`` feeds a
   ``StreamingShuffleRunner`` (two windows in flight, the default
   backend, which must be the process pool) into a ``MultiQueue``; a
   ``DeviceShufflingDataset(num_epochs=None)`` in the bulk binding reads
   it and a fresh DLRM ``mlperf`` (Adam, weights from seed 0) trains all
   1,024 micro-steps. Checks every key once, each window's digests equal
   the reference's, finite losses, one gather launch per micro-step, the
   serve watermark at the ingest watermark and one batch wait per batch
   and window end (none for the producer's prefetch past the last
   window). Prints rows/s, ``stall_pct`` and ``step_ms_median`` beside
   the ``train`` phase's, the windows' close time
   (``rsdl_stream_window_close_seconds``), the watermark lag per served
   window in stream seconds, ``birth_to_device`` p50/p99 and the process
   pool's table segments (files and bytes) after the last window. (b)
   ``streaming.runner.server_config`` freezes the stream into a schedule
   (an ingest journal, the spec's cast); two supervised shard processes
   serve it to 2 trainers (handle frames); rank 0 trains every micro-step
   through a ``DeviceShufflingDataset(num_epochs=None)`` over
   ``connect_remote_queue(shard_map)`` while a thread drains rank 1, and
   shard 0 is SIGKILLed as rank 0 takes its first batch of window 1.
   Each rank's digests equal the two-trainer reference, shard 0 restarts
   and shard 1 does not, one gather launch per micro-step, no segment and
   no ledger byte left; it prints the restart's seconds (kill to the
   first frame after it), rank 0's longest wait after the kill and
   rows/s, and the frames replayed. (c) Loader only: a runner over an
   ingest journal for 4 windows, then a new runner over the same journal
   and a fresh source: 8 events skipped, epochs 4-7, every key once
   across the two; the online model (``run_online_training``) over the
   first 12 files twice, the same history.
17. ``tenancy``: two tenants on one serving plane (``tenancy/``):
   ``hot`` (interactive, weight 3, rank 0) and ``cold`` (batch, weight
   1, rank 1), after the JAX bench's tenancy leg. (a) The ``train``
   phase's first 2 files shuffled to 128 reducers for 3 epochs and
   pre-filled into one in-process ``serve_queue(tenants=)``, the round
   robin's quantum pinned to 16 frame estimates; both tenants drain
   greedily through ``RemoteQueue(tenant=, max_batch=128)``: hot's rows
   over cold's when hot finishes beside the weight ratio and the JAX
   band (35 %, reported), each tenant's delivered bytes and its replay
   ledger back at 0 after the last acks. (b) The ``train`` files
   shuffled for 2 trainers (8 reducers, 3 epochs, the key column); a
   DLRM ``mlperf`` (Adam) trains every micro-step of rank 0's epoch 0
   through ``connect_remote_queue(addr, tenant=hot)`` on an in-process
   server, first alone, then while a host thread replays rank 1's 3
   epochs greedily as ``cold``: rows/s, ``stall_pct``,
   ``step_ms_median``, hot's ``queued_to_delivered`` p99 from the
   client's sketch, cold's rows/s; digests equal the one-process
   ``num_trainers=2`` stream's, keys once, one gather launch per
   micro-step; hot's ``birth_to_delivered`` p99 too. (e) The rebalance
   trigger, after (b): the same rank 0 and rank 1 tables behind
   ``serve_queue_sharded(num_shards=2, tenants=)``; a
   ``RebalanceController`` with a journal and ``rebalance_slo_p99_s`` at
   half of (b) solo's ``birth_to_delivered`` p99 (both printed); a
   ``HistoryRing`` ticking every 0.1 s on the watchdog over this
   process's registry and ``rebalance.slo_trigger`` (the
   ``tenant_delivery_slo`` detector alone, a window of 8 ticks); hot
   trains every micro-step of rank 0, and the fire migrates rank 0 to
   shard 1 under the step; cold drains rank 1 once the move committed.
   Checks exactly one fire naming hot, one committed move
   (``rsdl_rebalance_moves_total``), the journal replaying to
   ``((0, 1),)``, hot's map at generation 1, each rank's digests against
   the reference and one gather launch per micro-step; prints the fire's
   p99 and detail and the move's phase ms (intent to commit).
   (c) ``launch_supervised_queue_shards`` with
   ``config["tenants"]`` (2 shards, one epoch): hot trains through
   ``connect_remote_queue(shard_map, tenant=hot)`` and shard 0 is
   SIGKILLed after its first loader batch; then cold drains rank 1 on
   shard 1. The restart, hot's and cold's longest waits (cold's under
   15 s), each tenant's digests against the reference, no segment and
   no ledger byte left. (d) Host only: a journaled
   ``AdmissionController`` (both working sets accepted, a 64x ask
   rejected, the replay byte for byte), a ``TieredStore(tenant_quotas=)``
   where hot's 2 files still hit after cold scans 6 (every eviction
   charged to cold; the same without quotas beside it) and a cold
   ``PrefetchManager`` throttled by its one-file prefetch quota.
18. ``resnet``: 4,096 generated 224x224 RGB PNGs (1,000 classes) in 8
   Parquet files -> seeded shuffle of the encoded bytes (8 reducers, each
   decoding its rows with the ``env`` line's decoder) ->
   ``DeviceShufflingDataset`` (1 trainer, batch 512, 2 epochs, seed 0),
   uint8 ``(B, 224, 224, 3)`` on the card -> ``resnet50()`` (bf16 compute,
   f32 GroupNorm, random weights from seed 0) -> SGD (lr 1e-2), one
   micro-step per 256 images. Checks rows per epoch, finite losses, uint8
   on the device, the first staged batch against a host-side PIL decode of
   the same reducer rows, and that no port kernel is launched (the
   convolutions are cuDNN's). Reports images/s, ``stall_pct``, the
   reducers' decode rate, the peak device memory and a 5-step profile.
19. ``resume``: on ResNet-50 (the ``resnet`` phase's shards) and on
   ``bert_base()`` with the flash kernels (1,024 generated sequences): 4
   loader batches uninterrupted, against 2 batches, a save
   (``checkpoint.TrainStateCheckpointer``: model, optimizer, the mask
   generator and the mid-epoch ``LoaderCheckpoint``), a restore into a
   model built from another seed, a fresh optimizer and a fresh dataset
   (``start_epoch``), and the last 2 batches through
   ``checkpoint.resume_iterator``. Losses within 1e-3 relative and
   parameters within 1e-3 of their largest magnitude, whether they are
   equal bit for bit, the save and restore times and bytes, and 12
   launches of each flash kernel per BERT micro-step.
20. ``tp``: tensor parallelism (``parallel.tp``, ``SpmdTrainer`` with
   ``param_specs``) on a ``("data", "model")`` mesh of (1, 2): two
   processes of this script (``--tp-rank``) on the one card, gloo on CUDA
   tensors. First, here, the kernels at the shapes the ranks give them:
   the gather on the 8 ``mlperf`` tables' ``(V, 64)`` column blocks of
   both ranks, B=2048, bf16, bit for bit; the flash kernels on 6 heads
   (B=8, S=512, D=64, with and without a bias) within 2e-2; device times
   beside the bound. Then each model one process and per rank from the
   same weights (seed 0) and batch: (a) DLRM ``mlperf`` (2,048 rows,
   Adam), one gather launch per step per rank on those blocks; (b)
   ``bert_base()`` (8 sequences of 512, Adam, flash), 12 launches of each
   flash kernel per step per rank on 6 heads; (c) ``resnet50()`` (16
   images of 224x224, SGD), no port kernel. Each: the ranks' first and
   second losses (the forward, then the step after one update) within
   1e-3 relative of one process's (ResNet-50's second within 5e-3; bf16:
   the row-parallel parts are rounded before their sum), the parameters
   the specs replicate equal on both ranks after 8 steps (sha256), step ms
   beside one process's, the model axis's collectives per step (calls,
   payload bytes and ms, timed one by one in 2 more steps), the ms of the
   gradient all-reduce the trainer skips over the data axis of one rank,
   and peak device memory per rank beside one process's; BERT's MLM head
   bytes (the table's all-gather against partial logits). (d)
   ``parallel.dryrun.dryrun_multichip(2)`` and ``(4)``, both at once.

Every phase that drives ``DeviceShufflingDataset`` names the binding it
ran (``"binding"``: the bulk one, the default on the card, unless a turn
asks for per-batch copies), the executor backend its shuffle resolved
and its figures with the shuffle before the engine (``prior_shuffle``). Then the ``{"kernels": [...]}`` summary, the
``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. Needs CUDA; imports nothing of JAX. The whole run,
the kernels' builds included, took 790.9 s on an NVIDIA H100 80GB HBM3 at
700.00 W (``ops`` 20.6 s, the ``tenancy`` phase 55.1 s with its trigger
turn 10.7 s), against its limit of 1,200 s.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import gc
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import timeit
import types

import numpy as np
import torch

# Peak HBM bandwidth (bytes/s) by card name, from NVIDIA's data sheets.
# Longest match first: "H100 NVL" and "H100 PCIe" before plain "H100"
# (the SXM part, "NVIDIA H100 80GB HBM3").
_HBM_PEAK = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12)]
# Peak dense bf16 tensor-core rate (FLOP/s) by card name, from the same
# data sheets (without sparsity).
_BF16_PEAK = [("H200", 989.4e12), ("H100 NVL", 835e12),
              ("H100 PCIe", 756e12), ("H100", 989.4e12)]

V, E = 945195, 128
BATCHES = (2048, 131072)
MICROBATCH = 2048
NUM_ROWS, NUM_FILES = 2_000_000, 8
LOADER_BATCH, NUM_REDUCERS, NUM_EPOCHS, SEED = 131072, 8, 2, 0
# Flash attention: BERT-base's attention shape at batch 32, seq 512.
ATT_B, ATT_H, ATT_S, ATT_D = 32, 12, 512, 64
ATT_TOL = 2e-2
# BERT-MLM phase.
BERT_SEQS, BERT_FILES, BERT_SEQ_LEN, BERT_VOCAB = 8192, 8, 512, 30522
BERT_BATCH, BERT_MICRO = 256, 32
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# Figures of each loader phase measured by this script with the shuffle
# before the plan-driven engine (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 5), printed beside this run's. Times vary by a few per cent
# between calls on one card, so they are context, not a comparison.
PRIOR_SHUFFLE = {
    "train": {"step_ms_median": 12.264, "rows_per_s": 161769,
              "stall_pct": 0.0120},
    "bert": {"step_ms_median": 82.96, "tokens_per_s": 195782,
             "stall_pct": 0.0070},
    "rebatch": {"step_ms_median": [12.293, 12.674],
                "stall_pct": [0.0089, 0.0105], "phase_s": 102.8},
    "distributed": {"loader_rows_per_s": [6096160, 5690049],
                    "send_MBps": [307, 371]},
    "resnet": {"step_ms_median": 199.58, "images_per_s": 1278.4,
               "stall_pct": 0.0169},
    "resume": {"resnet_save_s": 0.492, "bert_save_s": 2.739},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _peak(table, name: str, what: str) -> float:
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no peak {what} on record for {name!r}")


def hbm_peak(name: str) -> float:
    return _peak(_HBM_PEAK, name, "HBM bandwidth")


def bf16_peak(name: str) -> float:
    return _peak(_BF16_PEAK, name, "bf16 tensor-core rate")


def call_ms(fn, args_list, iters: int) -> float:
    """Mean ms per call of back-to-back calls from Python (CUDA events):
    what a caller pays, host overhead included."""
    for args in args_list[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, args_list, iters: int, replays: int = 3) -> float:
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph
    and replayed, so host overhead drops out. The calls cycle through
    ``args_list`` (enough index sets that the rows read exceed the 50 MB
    L2, as a training step's fresh indices would)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in args_list[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _index_select_rows(table, idx):
    return torch.index_select(table, 0, idx)


def _index_select_tables(tables, indices):
    for table, idx in zip(tables, indices):
        torch.index_select(table, 0, idx)


def _one_table_launches(emb, tables, indices, dtype):
    for table, idx in zip(tables, indices):
        emb.gather_rows(table, idx, dtype)


def main_path_group(emb, g):
    """The DLRM step's kernel-routed tables (the ``mlperf`` vocabularies
    above ``ONE_HOT_MAX_VOCAB``, E=128, random from ``g``) and enough sets
    of B=2048 int32 ids (out-of-range ones included) that the rows read
    exceed the 50 MB L2, as a training step's fresh indices would."""
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    vocabs = [v for v in dlrm.MLPERF.vocab_sizes
              if v > emb.ONE_HOT_MAX_VOCAB]
    tables = [torch.randn((v, E), device="cuda", generator=g) for v in vocabs]
    n_sets = max(4, math.ceil(200e6 / (MICROBATCH * E * 4 * len(vocabs))))
    idx_sets = [[torch.randint(-1000, v + 1000, (MICROBATCH,), device="cuda",
                               dtype=torch.int32, generator=g)
                 for v in vocabs] for _ in range(n_sets)]
    return tables, idx_sets


def group_bytes(tables, indices, dtype) -> int:
    """Bytes a grouped gather must move: each table row read, each output
    row written and each index read once."""
    out_bytes = torch.empty((), dtype=dtype).element_size()
    return sum(i.numel() * (t.shape[1] * (4 + out_bytes) + i.element_size())
               for t, i in zip(tables, indices))


def time_group(emb, tables, idx_sets, peak: float, iters: int = 200) -> dict:
    """Device ms of one grouped launch (bf16) at ``tables`` x ``idx_sets``,
    beside its plain version, the host's call, 8 one-table launches,
    ``torch.index_select`` per table and the bound."""
    args = [(tables, idxs, torch.bfloat16) for idxs in idx_sets]
    moved = group_bytes(tables, idx_sets[0], torch.bfloat16)
    t = {
        "ms": device_ms(emb.gather_rows_grouped, args, iters),
        "plain_ms": device_ms(emb.gather_grouped_reference, args, iters // 4),
        "call_ms": call_ms(emb.gather_rows_grouped, args, iters),
        "one_table_launches_ms": device_ms(
            lambda *a: _one_table_launches(emb, *a), args, iters),
        # f32 rows: no PyTorch call gathers and casts in one.
        "library_ms": device_ms(_index_select_tables, [
            (tables, [i.long().clamp(0, t.shape[0] - 1)
                      for t, i in zip(tables, idxs)]) for idxs in idx_sets],
            iters),
        "bound_ms": moved / peak * 1e3, "bytes": moved,
    }
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def _check_grouped(emb, name, tables, indices, dtype, out=None):
    got = emb.gather_rows_grouped(tables, indices, dtype, out=out)
    want = emb.gather_grouped_reference(tables, indices, dtype)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"grouped gather {name} differs from "
                             "gather_grouped_reference")


def _mixed_group_checks(emb, g) -> None:
    """int8/16/32/64 indices (out-of-range ones included) in one launch,
    f32 and bf16, on the vector (E=128) and scalar (E=37) paths, into a
    fresh (G, B, E) tensor and straight into a (B, G, E) one."""
    vocabs = (300, 30000, 70, 2500, 945195)
    dts = (torch.int8, torch.int16, torch.int32, torch.int64, torch.int32)
    for batch, embed in ((2048, 128), (1001, 37)):
        tables = [torch.randn((v, embed), device="cuda", generator=g)
                  for v in vocabs]
        indices = [torch.randint(max(-1000, torch.iinfo(dt).min),
                                 min(v + 1000, torch.iinfo(dt).max),
                                 (batch,), device="cuda", generator=g).to(dt)
                   for v, dt in zip(vocabs, dts)]
        for dtype in (torch.float32, torch.bfloat16):
            name = f"mixed B={batch} E={embed} {dtype}"
            _check_grouped(emb, name, tables, indices, dtype)
            interleaved = torch.empty((batch, len(vocabs), embed),
                                      dtype=dtype, device="cuda")
            _check_grouped(emb, name + " into (B, G, E)", tables, indices,
                         dtype, out=interleaved.permute(1, 0, 2))


def _clamped_gradient_check(emb, g) -> dict:
    """The grouped backward at clamped ids: int8..int64 ids up to 1,000
    past each end of the vocab pile about 1,000 cotangent rows onto rows 0
    and V-1, summed by ``index_add_`` atomics in no fixed order. Each
    table's gradient is held against the f64 sum of the same cotangents
    within the bound of any f32 summation order
    (``emb.table_grad_reference``)."""
    vocabs = (300, 30000, 70, 2500, 945195)
    dts = (torch.int8, torch.int16, torch.int32, torch.int64, torch.int32)
    leaves = [torch.randn((v, E), device="cuda", generator=g)
              .requires_grad_(True) for v in vocabs]
    indices = [torch.randint(max(-1000, torch.iinfo(dt).min),
                             min(v + 1000, torch.iinfo(dt).max),
                             (MICROBATCH,), device="cuda", generator=g).to(dt)
               for v, dt in zip(vocabs, dts)]
    weight = torch.randn((len(vocabs), MICROBATCH, E), device="cuda",
                         generator=g)
    out = emb.kernel_lookup_grouped(leaves, indices, torch.bfloat16)
    (out.float() * weight).sum().backward()
    max_err, max_share, piled = 0.0, 0.0, 0
    for leaf, idx, w in zip(leaves, indices, weight):
        # The cotangent of the bf16 rows is the weight rounded to bf16.
        want, bound = emb.table_grad_reference(leaf.shape[0], idx,
                                               w.to(torch.bfloat16))
        err = (leaf.grad.double() - want).abs()
        if bool((err > bound).any()):
            raise AssertionError(
                f"clamped-id gradient at V={leaf.shape[0]} exceeds the f32 "
                f"bound by {float((err - bound).max())}")
        max_err = max(max_err, float(err.max()))
        max_share = max(max_share, float((err / bound.clamp(min=1e-300))
                                         .max()))
        piled = max(piled, int(torch.bincount(
            idx.long().clamp(0, leaf.shape[0] - 1)).max()))
        del want, bound, err
    return {"max_abs_err": max_err, "max_err_over_bound": max_share,
            "most_rows_on_one_row": piled}


def kernels_phase(emb, peak: float) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    table = torch.randn((V, E), device="cuda", generator=g)
    results, max_err = {}, 0.0
    for batch in BATCHES:
        n_sets = max(4, math.ceil(200e6 / (batch * E * 4)))
        idx_sets = [torch.randint(-1000, V + 1000, (batch,), device="cuda",
                                  dtype=torch.int32, generator=g)
                    for _ in range(n_sets)]
        clamped = [i.long().clamp(0, V - 1) for i in idx_sets]
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16,
                                                     "bf16")):
            for idx in idx_sets[:2]:
                got = emb.gather_rows(table, idx, dtype)
                want = emb.gather_reference(table, idx, dtype)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"gather_rows B={batch} {name} differs from "
                        "gather_reference")
                max_err = max(max_err, float(
                    (got.float() - want.float()).abs().max()))
            out_bytes = 4 if dtype == torch.float32 else 2
            moved = batch * E * (4 + out_bytes) + 4 * batch
            iters = 200 if batch == 2048 else 20
            args = [(table, i, dtype) for i in idx_sets]
            results[f"B{batch}_{name}"] = {
                "ms": device_ms(emb.gather_rows, args, iters),
                "plain_ms": device_ms(emb.gather_reference, args, iters),
                "call_ms": call_ms(emb.gather_rows, args, iters),
                "plain_call_ms": call_ms(emb.gather_reference, args, iters),
                "bound_ms": moved / peak * 1e3,
                "bytes": moved,
            }
        lib_args = [(table, i) for i in clamped]
        results[f"B{batch}_f32"]["library_ms"] = device_ms(
            _index_select_rows, lib_args, iters)
        # Gradient: kernel path vs plain path, the same cotangent.
        idx = idx_sets[0]
        weight = torch.randn((batch, E), device="cuda", generator=g)
        grads = []
        for fn in (emb.kernel_lookup, emb.gather_reference):
            t = table.detach().clone().requires_grad_(True)
            (fn(t, idx, torch.bfloat16).float() * weight).sum().backward()
            grads.append(t.grad)
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
        del grads, t
    del table
    # The main path's group: the DLRM step's 8 kernel-routed tables in one
    # launch, each also alone (a group of one).
    tables, idx_sets = main_path_group(emb, g)
    for idxs in idx_sets[:2]:
        _check_grouped(emb, "main path", tables, idxs, torch.bfloat16)
        for t, i in zip(tables, idxs):
            if not torch.equal(emb.gather_rows(t, i, torch.bfloat16),
                               emb.gather_reference(t, i, torch.bfloat16)):
                raise AssertionError(f"gather_rows differs at "
                                     f"V={t.shape[0]}")
    # Gradient: ids in range, so that no row sums hundreds of clamped
    # cotangent rows (two atomic orders differ there by more than 1e-6).
    weight = torch.randn((len(tables), MICROBATCH, E), device="cuda",
                         generator=g)
    in_range = [torch.randint(0, t.shape[0], (MICROBATCH,), device="cuda",
                              dtype=torch.int32, generator=g) for t in tables]
    grads = []
    for fn in (emb.kernel_lookup_grouped, emb.gather_grouped_reference):
        leaves = [t.detach().clone().requires_grad_(True) for t in tables]
        out = fn(leaves, in_range, torch.bfloat16)
        (out.float() * weight).sum().backward()
        grads.append([t.grad for t in leaves])
        del leaves, out
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    del grads
    clamped = _clamped_gradient_check(emb, g)
    _mixed_group_checks(emb, g)
    results["group_B2048_bf16"] = {"tables": [t.shape[0] for t in tables],
                                   **time_group(emb, tables, idx_sets, peak)}
    del tables, idx_sets
    torch.cuda.empty_cache()
    return {"timings": results, "max_abs_err": max_err,
            "clamped_gradient": clamped}


def ptxas_by_kernel(info: str) -> dict:
    """``-Xptxas -v`` output as {kernel instantiation: its "Used ..."
    and "... spill ..." lines}, names demangled by ``c++filt``."""
    lines, name = {}, None
    for line in info.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            lines.setdefault(name, []).append(
                line.split("info    :")[-1].strip())
    demangled = subprocess.run(
        ["c++filt"], input="\n".join(lines), capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()
    return {_short(full).split("(")[0]: "; ".join(found)
            for full, found in zip(demangled, lines.values())}


def _short(kernel_name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::", "c10::"):
        kernel_name = kernel_name.replace(noise, "")
    return kernel_name[:160]


def profile_steps(micro_step, cols, labels, kernel_names, steps: int = 5
                  ) -> dict:
    """Device time by kernel over ``steps`` micro-steps (torch.profiler;
    GPU-side user annotations such as ``Optimizer.step#Adam.step`` span
    kernels already counted and are left out), the device's busy share of
    the same steps' wall time measured without the profiler, and the
    device ms per step of each of ``kernel_names`` (the port's kernels)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        micro_step(cols, labels)
    torch.cuda.synchronize()
    t0 = timeit.default_timer()
    for _ in range(steps):
        micro_step(cols, labels)
    torch.cuda.synchronize()
    wall_us = (timeit.default_timer() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            micro_step(cols, labels)
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    return {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": busy_us / steps / 1e3,
        "device_busy_pct": 100.0 * busy_us / wall_us,
        "top": [{"kernel": _short(key), "ms_per_step": us / steps / 1e3,
                 "launches_per_step": count / steps}
                for us, count, key in kernels[:12]],
        "port_kernels_ms_per_step": {
            name: sum(us for us, _, key in kernels if name in key) / steps
            / 1e3 for name in kernel_names},
    }


def dlrm_files(tmp: str):
    """The ``train`` and ``rebatch`` phases' Parquet files and the seconds
    their generation took."""
    from ray_shuffling_data_loader_tpu_torch import data_generation
    start = timeit.default_timer()
    files, _ = data_generation.generate_data(NUM_ROWS, NUM_FILES, tmp,
                                             seed=SEED)
    return files, timeit.default_timer() - start


def engine_lines(cache_before: dict, faults_before: dict,
                 spills_before: dict, pool_before: dict,
                 storage_before: dict) -> dict:
    """What the shuffle engine did since the snapshots: the executor
    backend it resolved, the pool's width and worker pids, the process
    pool's segment-cache hits and bytes and worker respawns, file cache
    hits and bytes, the storage tiers' hits, prefetches and bytes on
    disk, spilled files and bytes and their read-back seconds, the buffer
    ledger's peak bytes (since its last reset), retries and
    recoveries."""
    from ray_shuffling_data_loader_tpu_torch import (executor, native,
                                                     procpool, shuffle,
                                                     spill, stats, storage)
    cache = shuffle.file_cache_totals()
    spills = spill.process_spill_totals()
    faults = stats.fault_stats().snapshot()
    pool = procpool.pool_totals()
    tiers = storage.storage_totals()
    last_pool = executor.last_worker_pool()
    return {
        "executor_backend": last_pool["backend"],
        "pool_workers": last_pool["workers"],
        "pool_pids": last_pool["pids"],
        "process_pool": {k: pool[k] - pool_before[k] for k in pool},
        "storage": {k: tiers[k] - storage_before[k] for k in tiers},
        "file_cache": {k: cache[k] - cache_before[k] for k in cache},
        "spill": {k: spills[k] - spills_before[k] for k in spills},
        "ledger_peak_bytes": native.buffer_ledger().peak_bytes(),
        "injected": faults["injected"] - faults_before["injected"],
        "retries": faults["retries"] - faults_before["retries"],
        "recoveries": {
            k: v - faults_before["recomputes_by_component"].get(k, 0)
            for k, v in faults["recomputes_by_component"].items()},
    }


def loader_context(phase: str) -> dict:
    """The executor backend the phase's last shuffle resolved, and the
    phase's figures with the shuffle before the engine."""
    from ray_shuffling_data_loader_tpu_torch import executor
    return {"executor_backend": executor.last_worker_pool()["backend"],
            "prior_shuffle": PRIOR_SHUFFLE[phase]}


def fresh_telemetry() -> None:
    """A fresh flight recorder and bottleneck attributor (the policy's
    settings: recording on unless ``RSDL_TELEMETRY=0``), so the verdicts
    read after the next loader run are that run's alone (the attributor
    keys its epochs by number, and every phase starts at epoch 0)."""
    from ray_shuffling_data_loader_tpu_torch.runtime import telemetry
    telemetry.configure()


def _verdict_line(epoch: int, verdict) -> dict:
    if verdict is None:
        return {"epoch": epoch, "bottleneck_stage": None}
    return {"epoch": epoch, "bottleneck_stage": verdict["bottleneck_stage"],
            "stall_pct": verdict["stall_pct"],
            "batch_wait_s": verdict["batch_wait_s"],
            "wall_s": verdict["wall_s"],
            "stages": {stage: {k: d[k] for k in ("count", "total_s",
                                                 "p50_ms", "p95_ms",
                                                 "p99_ms")}
                       for stage, d in verdict["stages"].items()}}


def epoch_verdicts(num_epochs: int) -> list:
    """Each epoch's telemetry verdict since :func:`fresh_telemetry`: the
    bottleneck stage, the batch-wait share of the epoch's wall clock and
    each stage's count, seconds and p50/p95/p99."""
    from ray_shuffling_data_loader_tpu_torch.runtime import telemetry
    attribution = telemetry.attribution()
    return [_verdict_line(e, attribution.epoch_verdict(e))
            for e in range(num_epochs)]


def engine_snapshots():
    """The counters :func:`engine_lines` reads, and a fresh ledger peak."""
    from ray_shuffling_data_loader_tpu_torch import (native, procpool,
                                                     shuffle, spill, stats,
                                                     storage)
    native.buffer_ledger().reset_peak()
    return (shuffle.file_cache_totals(), stats.fault_stats().snapshot(),
            spill.process_spill_totals(), procpool.pool_totals(),
            storage.storage_totals())


def train_phase(emb, files, gen_s: float) -> dict:
    from ray_shuffling_data_loader_tpu_torch import (
        dataset, device_dataset, stats, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    spec = dlrm_criteo.dlrm_spec()
    config = dlrm.MLPERF
    model = dlrm.DLRM(config, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    optimizer = train.make_optimizer(model)
    micro_step = train.make_micro_step(model, optimizer)

    snapshots = engine_snapshots()
    fresh_telemetry()
    ds = device_dataset.DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, LOADER_BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, collect_stats=True, **spec)
    expected_rows = (NUM_ROWS // LOADER_BATCH) * LOADER_BATCH
    rows_per_epoch, losses, chunk_ms, first_batch = [], [], [], None
    digests = []
    emb.reset_launch_counts()
    t_start = timeit.default_timer()
    t_first = None
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        rows = 0
        for features, label in ds:
            if t_first is None:
                t_first = timeit.default_timer()
                first_batch = ([f.cpu() for f in features], label.cpu())
            digests.append(device_dataset.batch_digest(features, label))
            t0 = timeit.default_timer()
            losses.append(train.train_chunk(micro_step, features, label,
                                            MICROBATCH))
            torch.cuda.synchronize()
            chunk_ms.append((timeit.default_timer() - t0) * 1e3)
            rows += label.shape[0]
        rows_per_epoch.append(rows)
    t_end = timeit.default_timer()
    verdicts = epoch_verdicts(NUM_EPOCHS)
    launches = emb.launch_counts["gather_rows"]
    trial = ds.shuffle_result.result()
    engine = engine_lines(*snapshots)

    if rows_per_epoch != [expected_rows] * NUM_EPOCHS:
        raise AssertionError(
            f"rows per epoch {rows_per_epoch}, expected {expected_rows}")
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(
            f"{launches} gather launches in {all_losses.numel()} "
            "micro-steps; expected one per micro-step")
    # "auto" on the card's cores: the process pool, its segments the
    # cache of epoch 1.
    if engine["executor_backend"] != "process":
        raise AssertionError(f"the train phase's shuffle ran on the "
                             f"{engine['executor_backend']} backend, not "
                             "the process pool that 'auto' picks here")
    if engine["process_pool"]["segment_cache_hits"] < 1:
        raise AssertionError(f"no segment-cache hit: {engine}")

    # The first staged batch equals the host-side shuffle's.
    host = dataset.ShufflingDataset(
        files, 1, 1, LOADER_BATCH, 0, drop_last=True,
        num_reducers=NUM_REDUCERS, seed=SEED,
        map_transform=device_dataset.make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"]))
    host.set_epoch(0)
    host_batches = iter(host)
    table = next(host_batches)
    for _ in host_batches:  # drain, so the shuffle ends while files exist
        pass
    hf, hl = device_dataset.convert_to_arrays(
        table, spec["feature_columns"], [None] * len(spec["feature_types"]),
        spec["feature_types"], spec["label_column"], None,
        np.dtype(np.float32))
    for a, b in zip(first_batch[0], hf):
        if not np.array_equal(a.numpy(), b) or a.dtype != torch.int32:
            raise AssertionError("staged batch differs from the host's")
    if not np.array_equal(first_batch[1].numpy(), hl):
        raise AssertionError("staged labels differ from the host's")

    # The kernel path's loss equals the plain take path's.
    cols = [f[:MICROBATCH].cuda() for f in first_batch[0]]
    lab = first_batch[1][:MICROBATCH].cuda()
    with torch.no_grad():
        via_kernel = dlrm.loss_fn(model, None, cols, lab)
        model.config = dataclasses.replace(config, lookup_mode="take")
        via_take = dlrm.loss_fn(model, None, cols, lab)
        model.config = config
    if not torch.equal(via_kernel, via_take):
        raise AssertionError(
            f"kernel-path loss {via_kernel.item()} != take-path loss "
            f"{via_take.item()}")
    # Where a micro-step's time goes (after the main path's counts
    # were read; these steps keep training the same model).
    breakdown = profile_steps(micro_step, cols, lab, ["gather_rows"])

    waits = ds.batch_wait_stats.wait_times
    wall = t_end - t_first
    steps = int(all_losses.numel())
    return {
        "rows_per_epoch": rows_per_epoch,
        "micro_steps": steps,
        "rows_per_s": sum(rows_per_epoch) / wall,
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "batch_wait_s": ds.batch_wait_stats.summary(),
        "fill_s": t_first - t_start,
        "step_ms_median": float(np.median(chunk_ms)) / (LOADER_BATCH
                                                        // MICROBATCH),
        "chunk_ms_median": float(np.median(chunk_ms)),
        "loss_first": float(all_losses[:64].mean()),
        "loss_last": float(all_losses[-64:].mean()),
        "gather_launches": launches,
        "launches_per_micro_step": launches / steps,
        "binding": ds.binding,
        "verdicts": verdicts,
        "transfer": ds.transfer_stats(),
        "datagen_s": gen_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": breakdown,
        "shuffle_stages": stats.trial_summary(trial),
        **engine,
        "prior_shuffle": PRIOR_SHUFFLE["train"],
        # For the engine phase: the stream and the first micro-step.
        "digests": torch.stack(digests).cpu(),
        "first_loss": float(all_losses[0]),
    }


# The Pallas kernel bodies the three CUDA kernels replace.
_FLASH_REPLACES = (
    "ray_shuffling_data_loader_tpu/ops/flash_attention.py:80",
    "ray_shuffling_data_loader_tpu/ops/flash_attention.py:122",
    "ray_shuffling_data_loader_tpu/ops/flash_attention.py:155")


def _attention_inputs(g, b, h, sq, sk, d, masked):
    """bf16 q, dO ``(b, h, sq, d)``, k, v ``(b, h, sk, d)`` and, if
    ``masked``, an f32 key-side bias that masks about 20 % of the keys
    (never the first) with -1e9."""
    def randn(rows):
        return torch.randn((b, h, rows, d), device="cuda",
                           generator=g).to(torch.bfloat16)

    q, k, v, do = randn(sq), randn(sk), randn(sk), randn(sq)
    bias = None
    if masked:
        keep = torch.rand((b, 1, 1, sk), device="cuda", generator=g) >= 0.2
        keep[..., 0] = True
        bias = torch.where(keep, 0.0, -1e9).to(torch.float32)
    return q, k, v, do, bias


def _held(name: str, got, want) -> float:
    """max |got - want|; raises where it exceeds ATT_TOL * (1 + |want|)."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if bool((diff > ATT_TOL + ATT_TOL * want.float().abs()).any()):
        raise AssertionError(
            f"{name} differs from its plain version: max abs err "
            f"{float(diff.max())} (tolerance {ATT_TOL} + {ATT_TOL}*|ref|)")
    return float(diff.max())


def _backward_errs(fa, case, q, k, v, bias, do, lse, delta) -> dict:
    errs = {"dq": _held(f"{case} dq", fa.flash_dq(q, k, v, bias, do, lse,
                                                  delta),
                        fa.flash_dq_reference(q, k, v, bias, do, lse, delta))}
    got = fa.flash_dkv(q, k, v, bias, do, lse, delta)
    want = fa.flash_dkv_reference(q, k, v, bias, do, lse, delta)
    for name, a, b in zip(("dk", "dv", "dbias"), got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{case} {name}: one side is None")
        if a is not None:
            errs[name] = _held(f"{case} {name}", a, b)
    return errs


def _check_case(fa, case, q, k, v, do, bias) -> dict:
    out, lse = fa.flash_fwd(q, k, v, bias)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, bias)
    errs = {"out": _held(f"{case} out", out, want_out),
            "lse": _held(f"{case} lse", lse, want_lse)}
    delta = (do.float() * out.float()).sum(-1)
    errs.update(_backward_errs(fa, case, q, k, v, bias, do, lse, delta))
    return errs


def _sdpa(q, k, v):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def _sdpa_forward_backward(q, k, v, do):
    return torch.autograd.grad(_sdpa(q, k, v), (q, k, v), do)


def attention_phase(fa, hbm: float, flop_peak: float) -> dict:
    g = torch.Generator(device="cuda").manual_seed(2)
    b, h, s, d = ATT_B, ATT_H, ATT_S, ATT_D
    main = _attention_inputs(g, b, h, s, s, d, masked=False)
    errors = {
        "main": _check_case(fa, "main", *main),
        "main_bias": _check_case(fa, "main_bias", *_attention_inputs(
            g, b, h, s, s, d, masked=True)),
        "ragged_s500_d32_bias": _check_case(
            fa, "ragged", *_attention_inputs(g, 8, h, 500, 500, 32,
                                             masked=True)),
        "ragged_sq100_sk40_d64_bias": _check_case(
            fa, "ragged_short_keys", *_attention_inputs(g, 8, h, 100, 40, d,
                                                        masked=True)),
        # One query row (a one-row Q map) against four key tiles, the last
        # ragged.
        "q1_sk200_d128_bias": _check_case(
            fa, "q1_sk200_d128_bias", *_attention_inputs(g, 8, h, 1, 200, 128,
                                                         masked=True)),
    }
    # dq and dk/dv of the first half of the keys given the lse over all of
    # them (ring attention's per-hop backward).
    q, k, v, do, bias = _attention_inputs(g, 8, h, s, 2 * s, d, masked=True)
    _, lse = fa.flash_forward_reference(q, k, v, bias)
    k1, v1 = k[:, :, :s].contiguous(), v[:, :, :s].contiguous()
    b1 = bias[..., :s].contiguous()
    out1, _ = fa.flash_fwd(q, k1, v1, b1)
    delta = (do.float() * out1.float()).sum(-1)
    errors["global_lse"] = _backward_errs(fa, "global_lse", q, k1, v1, b1,
                                          do, lse, delta)
    del q, k, v, do, bias, k1, v1, b1, out1, lse, delta
    max_err = {
        "flash_fwd": max(e[n] for e in errors.values() for n in ("out", "lse")
                         if n in e),
        "flash_dq": max(e["dq"] for e in errors.values()),
        "flash_dkv": max(e[n] for e in errors.values()
                         for n in ("dk", "dv", "dbias") if n in e)}

    # Times at the main path's shape (no bias, as in the bert phase).
    q, k, v, do, _ = main
    out, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    bwd_args = [(q, k, v, None, do, lse, delta)]
    elems, rows = b * h * s * d, b * h * s
    # (products of 2*S*S*D FLOPs per head, bf16 tensors in + out, f32 rows)
    work = {"flash_fwd": (2, 4, 1), "flash_dq": (3, 5, 2),
            "flash_dkv": (4, 6, 2)}
    calls = {
        "flash_fwd": (fa.flash_fwd, fa.flash_forward_reference, [(q, k, v)]),
        "flash_dq": (fa.flash_dq, fa.flash_dq_reference, bwd_args),
        "flash_dkv": (fa.flash_dkv, fa.flash_dkv_reference, bwd_args)}
    # The yardstick's backward: forward + backward captured in one graph,
    # less the forward alone.
    sdpa_fwd_ms = device_ms(_sdpa, [(q, k, v)], 20)
    leaves = tuple(t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sdpa_bwd_ms = device_ms(_sdpa_forward_backward, [(*leaves, do)],
                            20) - sdpa_fwd_ms
    del leaves
    timings = {}
    for kernel, (fn, plain, args) in calls.items():
        products, tensors, f32_rows = work[kernel]
        flops = products * 2 * b * h * s * s * d
        moved = tensors * elems * 2 + f32_rows * rows * 4
        by_ops, by_bytes = flops / flop_peak, moved / hbm
        timings[kernel] = {
            "ms": device_ms(fn, args, 20),
            "plain_ms": device_ms(plain, args, 5),
            "call_ms": call_ms(fn, args, 20),
            "library_ms": sdpa_fwd_ms if kernel == "flash_fwd"
            else sdpa_bwd_ms,
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": moved,
        }
        t = timings[kernel]
        t["tflops"] = flops / t["ms"] / 1e9
        t["x_library"] = t["ms"] / t["library_ms"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
    torch.cuda.empty_cache()
    return {"shape": {"B": b, "H": h, "S": s, "D": d, "dtype": "bf16"},
            "tolerance": {"atol": ATT_TOL, "rtol": ATT_TOL},
            "max_abs_err_by_case": errors, "max_abs_err": max_err,
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(forward; its backward, timed as forward + backward "
                       "less forward, covers dq and dk/dv)",
            "timings": timings}


def bert_files(tmp: str):
    """The ``bert`` and ``rebatch`` phases' token files and the seconds
    their generation took."""
    from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm
    start = timeit.default_timer()
    files, _ = bert_mlm.generate_tokenized_parquet(
        BERT_SEQS, BERT_FILES, tmp, seq_len=BERT_SEQ_LEN,
        vocab_size=BERT_VOCAB, seed=SEED)
    return files, timeit.default_timer() - start


def bert_phase(fa, files, gen_s: float) -> dict:
    from ray_shuffling_data_loader_tpu_torch import (
        dataset, device_dataset, train)
    from ray_shuffling_data_loader_tpu_torch.models import bert
    from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm

    spec = bert_mlm.bert_mlm_spec(BERT_SEQ_LEN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = bert.bert_base()
    model = bert.Bert(config, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    optimizer = train.make_optimizer(model, lr=train.BERT_LR)
    # Passed explicitly: S=512 is below FLASH_MIN_SEQ_LEN.
    attention_fn = fa.make_flash_attention_fn()
    micro_step = train.make_bert_micro_step(
        model, optimizer,
        torch.Generator(device="cuda").manual_seed(SEED + 1),
        attention_fn)

    fresh_telemetry()
    ds = device_dataset.DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, BERT_BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, **spec)
    rows_per_epoch, losses, chunk_ms, first_batch = [], [], [], None
    fa.reset_launch_counts()
    t_start = timeit.default_timer()
    t_first = None
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        rows = 0
        for features, label in ds:
            if t_first is None:
                t_first = timeit.default_timer()
                first_batch = features[0].cpu()
            t0 = timeit.default_timer()
            losses.append(train.train_chunk(micro_step, features, label,
                                            BERT_MICRO))
            torch.cuda.synchronize()
            chunk_ms.append((timeit.default_timer() - t0) * 1e3)
            rows += label.shape[0]
        rows_per_epoch.append(rows)
    t_end = timeit.default_timer()
    verdicts = epoch_verdicts(NUM_EPOCHS)
    launches = dict(fa.launch_counts)

    if rows_per_epoch != [BERT_SEQS] * NUM_EPOCHS:
        raise AssertionError(
            f"rows per epoch {rows_per_epoch}, expected {BERT_SEQS}")
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("non-finite loss")
    steps = int(all_losses.numel())
    for kernel in FLASH_KERNELS:
        if launches[kernel] != config.num_layers * steps:
            raise AssertionError(
                f"{kernel} launched {launches[kernel]} times in "
                f"{steps} micro-steps; expected {config.num_layers} "
                "per micro-step")

    # The first staged batch equals the host-side shuffle's.
    host = dataset.ShufflingDataset(
        files, 1, 1, BERT_BATCH, 0, drop_last=True,
        num_reducers=NUM_REDUCERS, seed=SEED,
        map_transform=device_dataset.make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"]))
    host.set_epoch(0)
    host_batches = iter(host)
    table = next(host_batches)
    for _ in host_batches:  # drain, so the shuffle ends while files exist
        pass
    (host_tokens,), _ = device_dataset.convert_to_arrays(
        table, spec["feature_columns"], spec["feature_shapes"],
        [np.dtype(t) for t in spec["feature_types"]],
        spec["label_column"], None, np.dtype(spec["label_type"]))
    if (first_batch.dtype != torch.int32
            or tuple(first_batch.shape) != (BERT_BATCH, BERT_SEQ_LEN)
            or not np.array_equal(first_batch.numpy(), host_tokens)):
        raise AssertionError("staged token batch differs from the host's")

    # The flash path's loss against the inline path's, same micro-batch
    # and weights (after training).
    tokens = first_batch[:BERT_MICRO].cuda()
    inputs, targets = bert_mlm.mlm_mask(
        tokens, torch.Generator(device="cuda").manual_seed(SEED + 2),
        BERT_VOCAB)
    with torch.no_grad():
        via = {}
        for path, fn in (("flash", attention_fn), ("inline", None)):
            logits = bert.apply(model, inputs, attention_fn=fn)
            via[path] = (bert.loss_fn(model, inputs, targets,
                                      attention_fn=fn).item(),
                         logits[:, :, :1024].float().cpu())
            del logits
    loss_rel = abs(via["flash"][0] - via["inline"][0]) / abs(
        via["inline"][0])
    if loss_rel > 1e-2:
        raise AssertionError(
            f"flash-path loss {via['flash'][0]} vs inline "
            f"{via['inline'][0]}: relative difference {loss_rel}")
    logits_diff = float((via["flash"][1] - via["inline"][1]).abs().max())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Where a micro-step's time goes (after the main path's counts
    # were read; these steps keep training the same model).
    breakdown = profile_steps(
        micro_step, [tokens], torch.zeros((BERT_MICRO, 1),
                                          device="cuda"),
        list(FLASH_KERNELS))

    flash_ms = sum(breakdown["port_kernels_ms_per_step"].values())
    waits = ds.batch_wait_stats.wait_times
    wall = t_end - t_first
    seqs = sum(rows_per_epoch)
    return {
        "rows_per_epoch": rows_per_epoch,
        "micro_steps": steps,
        "sequences_per_s": seqs / wall,
        "tokens_per_s": seqs * BERT_SEQ_LEN / wall,
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "batch_wait_s": ds.batch_wait_stats.summary(),
        "fill_s": t_first - t_start,
        "step_ms_median": float(np.median(chunk_ms)) / (BERT_BATCH
                                                        // BERT_MICRO),
        "chunk_ms_median": float(np.median(chunk_ms)),
        "loss_first": float(all_losses[:8].mean()),
        "loss_last": float(all_losses[-8:].mean()),
        "flash_launches": launches,
        "launches_per_micro_step": {k: n / steps
                                    for k, n in launches.items()},
        "flash_vs_inline": {"loss_flash": via["flash"][0],
                            "loss_inline": via["inline"][0],
                            "loss_rel_diff": loss_rel, "loss_rtol": 1e-2,
                            "logits_max_abs_diff_first_1024_vocab":
                                logits_diff},
        "binding": ds.binding,
        "verdicts": verdicts,
        "transfer": ds.transfer_stats(),
        "datagen_s": gen_s,
        "peak_mem_gb": peak_gb,
        "flash_share_pct": 100.0 * flash_ms / breakdown[
            "device_ms_per_step"],
        "profile": breakdown,
    }


# Rebatch phase: the two device bindings in turns on the train phase's
# data, in one call (the DLRM step varies 11.9-14.9 ms between calls).
# Two turns: the sharded serving turns of the serving phase pay for the
# repeat (bulk, per-batch) the phase ran until PR 16.
REBATCH_TURNS = ("per_batch", "bulk")
REBATCH_EPOCHS = 2
REBATCH_BUDGET_S = 150.0
# Mean loss per loader batch (64 micro-steps) of a turn against the first
# turn's: the embedding backward's index_add_ adds in no fixed order, so
# two turns need not agree bit for bit.
REBATCH_LOSS_RTOL = 1e-2
REBATCH_DEADLINE_S = 1e-4
REBATCH_CHAOS = "device_transfer@0.05"


def _loader_pass(files, batch: int, spec: dict, **kw):
    """One epoch through ``DeviceShufflingDataset`` with no training;
    returns the dataset and its batches' digests."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset
    ds = device_dataset.DeviceShufflingDataset(
        files, 1, 1, batch, 0, num_reducers=NUM_REDUCERS, seed=SEED,
        **kw, **spec)
    ds.set_epoch(0)
    digests = [device_dataset.batch_digest(features, label)
               for features, label in ds]
    return ds, torch.stack(digests).cpu()


def _same_digests(name: str, got, want) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: batch digests differ from the "
                             "first turn's")


def _rebatch_turn(emb, files, binding: str, epochs: int, **ds_kw):
    """DLRM ``mlperf`` trained over ``epochs`` under one binding (the bulk
    one through ``device_rebatch="auto"``, the default on the card);
    ``ds_kw`` go to the dataset. Returns the turn's line, its batch
    digests and its losses."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset, train
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    kw = {} if binding == "bulk" else {"device_rebatch": False}
    fresh_telemetry()
    ds = device_dataset.DeviceShufflingDataset(
        files, epochs, 1, LOADER_BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, **kw, **ds_kw, **dlrm_criteo.dlrm_spec())
    if ds.binding != binding:
        raise AssertionError(f"{kw or 'auto'} resolved to {ds.binding}")
    waits = ds.batch_wait_stats.wait_times
    losses, chunk_ms, digests, epoch1_wait = [], [], [], None
    emb.reset_launch_counts()
    t_start = timeit.default_timer()
    t_first = None
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        n0 = len(waits)
        for features, label in ds:
            if t_first is None:
                t_first = timeit.default_timer()
            if epoch == 1 and epoch1_wait is None:
                epoch1_wait = waits[n0]
            digests.append(device_dataset.batch_digest(features, label))
            t0 = timeit.default_timer()
            losses.append(train.train_chunk(micro_step, features, label,
                                            MICROBATCH))
            torch.cuda.synchronize()
            chunk_ms.append((timeit.default_timer() - t0) * 1e3)
    t_end = timeit.default_timer()
    verdicts = epoch_verdicts(epochs)
    launches = emb.launch_counts["gather_rows"]
    all_losses = torch.cat(losses).cpu()
    steps = int(all_losses.numel())
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError(f"{binding}: non-finite loss")
    if launches != steps:
        raise AssertionError(f"{binding}: {launches} gather launches in "
                             f"{steps} micro-steps")
    wall = t_end - t_first
    transfer = ds.transfer_stats()
    del model, micro_step
    return {
        "binding": binding,
        "verdicts": verdicts,
        "rows_per_s": steps * MICROBATCH / wall,
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "step_ms_median": float(np.median(chunk_ms)) / (LOADER_BATCH
                                                        // MICROBATCH),
        "fill_s": t_first - t_start,
        "epoch1_first_batch_wait_ms": (None if epoch1_wait is None
                                       else epoch1_wait * 1e3),
        "batch_wait_s": ds.batch_wait_stats.summary(),
        "micro_steps": steps,
        "gather_launches": launches,
        "launches_per_micro_step": launches / steps,
        "copies_by_epoch": transfer["copies_by_epoch"],
        "peak_device_input_bytes": transfer["peak_device_bytes"],
        "peak_chunk_bytes": transfer["peak_chunk_bytes"],
        "chunk_cap_bytes": transfer["max_table_bytes"],
        "peak_pinned_bytes": transfer["peak_pinned_bytes"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, torch.stack(digests).cpu(), all_losses


def _spread(turns, binding: str, key: str) -> list:
    values = [t[key] for t in turns if t["binding"] == binding]
    return [min(values), max(values)]


def rebatch_phase(emb, dlrm_paths, token_paths) -> dict:
    """The per-batch and bulk bindings in turns (per-batch, then bulk) on
    the ``train`` phase's data, then on the card: (b) the
    watchdog degrading a bulk epoch, (c) copies retried under injected
    faults, (d) a loader-only pass over the ``bert`` phase's tokens."""
    import logging

    from ray_shuffling_data_loader_tpu_torch import stats
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.workloads import (
        bert_mlm, dlrm_criteo)

    start = timeit.default_timer()
    turns, digests, losses = [], [], []
    for binding in REBATCH_TURNS:
        line, digest, loss = _rebatch_turn(emb, dlrm_paths, binding,
                                           REBATCH_EPOCHS)
        turns.append(line)
        digests.append(digest)
        losses.append(loss)
    loss_rel = []
    for i in range(1, len(turns)):
        _same_digests(f"turn {i} ({turns[i]['binding']})", digests[i],
                      digests[0])
        got = losses[i].view(-1, LOADER_BATCH // MICROBATCH).mean(1)
        want = losses[0].view(-1, LOADER_BATCH // MICROBATCH).mean(1)
        rel = float(((got - want).abs() / want.abs()).max())
        loss_rel.append(rel)
        if rel > REBATCH_LOSS_RTOL:
            raise AssertionError(f"turn {i}: batch-mean losses differ from "
                                 f"turn 0's by {rel} relative")
    epoch0 = digests[0][:len(digests[0]) // REBATCH_EPOCHS]
    spec = dlrm_criteo.dlrm_spec()

    # (b) The watchdog on the card: a deadline no chunk copy can meet.
    before = stats.watchdog_stats().snapshot()
    wd_logger = logging.getLogger(
        "ray_shuffling_data_loader_tpu_torch.runtime.watchdog")
    level = wd_logger.level
    wd_logger.setLevel(logging.CRITICAL)  # one line per escalation
    try:
        ds, got = _loader_pass(dlrm_paths, LOADER_BATCH, spec,
                               runtime_policy={"bulk_transfer_deadline_s":
                                               REBATCH_DEADLINE_S})
    finally:
        wd_logger.setLevel(level)
    after = stats.watchdog_stats().snapshot()
    transfer = ds.transfer_stats()
    _same_digests("watchdog epoch", got, epoch0)
    watchdog_run = {
        "deadline_s": REBATCH_DEADLINE_S,
        "watchdog_events": after["watchdog_events"]
        - before["watchdog_events"],
        "stall_escalations": after["stall_escalations"]
        - before["stall_escalations"],
        "fallbacks": after["fallbacks_engaged"] - before["fallbacks_engaged"],
        "fallback_engaged": transfer["fallback_engaged"],
        "copies": transfer["copies_by_epoch"], "digests_equal": True}
    if watchdog_run["watchdog_events"] < 1 or not transfer[
            "fallback_engaged"]:
        raise AssertionError(f"the watchdog did not degrade: {watchdog_run}")

    # (c) Retry on the card: seeded faults before copy attempts.
    before = stats.fault_stats().snapshot()
    faults.install(REBATCH_CHAOS, seed=0)
    try:
        ds, got = _loader_pass(dlrm_paths, LOADER_BATCH, spec)
    finally:
        faults.clear()
    after = stats.fault_stats().snapshot()
    _same_digests("chaos epoch", got, epoch0)
    chaos_run = {
        "spec": REBATCH_CHAOS, "seed": 0,
        "injected": after["injected"] - before["injected"],
        "retries": after["retries"] - before["retries"],
        "recoveries": after["recomputes"] - before["recomputes"],
        "recovery_latency_max_s": after["recovery_latency_max_s"],
        "copies": ds.transfer_stats()["copies_by_epoch"],
        "digests_equal": True}
    if chaos_run["recoveries"] < 1:
        raise AssertionError(f"no copy recovered: {chaos_run}")

    # (d) The bert phase's tokens, loader only: 4 batches per reducer
    # table, so a chunk holds several batches.
    token_spec = bert_mlm.bert_mlm_spec(BERT_SEQ_LEN)
    tokens = {}
    for binding, kw in (("per_batch", {"device_rebatch": False}),
                        ("bulk", {})):
        t0 = timeit.default_timer()
        ds, got = _loader_pass(token_paths, BERT_BATCH, token_spec, **kw)
        elapsed = timeit.default_timer() - t0
        transfer = ds.transfer_stats()
        tokens[binding] = {"binding": ds.binding, "digests": got,
                           "epoch_s": elapsed,
                           "copies": transfer["copies_by_epoch"],
                           "peak_pinned_bytes":
                               transfer["peak_pinned_bytes"],
                           "peak_device_input_bytes":
                               transfer["peak_device_bytes"]}
    _same_digests("bulk token epoch", tokens["bulk"].pop("digests"),
                  tokens["per_batch"].pop("digests"))
    phase_s = timeit.default_timer() - start
    return {
        "turns": turns,
        "epochs_per_turn": REBATCH_EPOCHS,
        "phase_s": phase_s,
        "over_budget": phase_s > REBATCH_BUDGET_S,
        "digests_equal": True,
        "digest_batches": int(digests[0].shape[0]),
        "loss_rtol": REBATCH_LOSS_RTOL,
        "loss_max_rel_diff_by_turn": loss_rel,
        "losses_bit_equal_by_turn": [bool(torch.equal(x, losses[0]))
                                     for x in losses[1:]],
        "spread": {b: {k: _spread(turns, b, k)
                       for k in ("step_ms_median", "stall_pct",
                                 "rows_per_s")}
                   for b in ("per_batch", "bulk")},
        "max_device_input_bytes": 1 << 30,
        "watchdog": watchdog_run,
        "chaos": chaos_run,
        "tokens": tokens,
        "gather_launches": sum(t["gather_launches"] for t in turns),
    }


# Telemetry phase: the train phase's DLRM run with recording off, then on
# (the default), in one call; then a profiler capture of a fresh loader's
# fill and the first micro-steps.
TELEMETRY_PROFILE_STEPS = 5
# The loader's profiler ranges (utils/tracing.py trace_span names).
LOADER_RANGES = ("table_convert", "table_transfer", "batch_convert",
                 "batch_transfer")


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block (the pool's workers take
    the environment at their pool's start)."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _latency_between(before: dict, after: dict, hop: str) -> dict:
    """Per queue: count, p50 and p99 (ms) of the delivery-latency sketch's
    ``hop`` over what this process observed between two parsed
    expositions of its registry."""
    from ray_shuffling_data_loader_tpu_torch.runtime import latency, metrics
    name = f"{latency.DELIVERY_METRIC}_centroid"
    earlier = before.get(name, {})
    diff = {labels: value - earlier.get(labels, 0.0)
            for labels, value in after.get(name, {}).items()
            if value > earlier.get(labels, 0.0)}
    quantiles = metrics.sketch_quantiles({name: diff},
                                         latency.DELIVERY_METRIC,
                                         qs=(0.5, 0.99), hop=hop)
    return {dict(labels).get("queue"): {"count": int(q["count"]),
                                        "p50_ms": q["p50"] * 1e3,
                                        "p99_ms": q["p99"] * 1e3}
            for labels, q in quantiles.items()}


def _critical_paths(merged: dict, epochs: int) -> list:
    """Each epoch's critical path over the merged dumps: the top three
    stages (ms and share) and what halving each would save."""
    from ray_shuffling_data_loader_tpu_torch.runtime import trace
    out = []
    for epoch in range(epochs):
        analysis = trace.analyze(merged["events"], epoch=epoch)
        top = analysis["critical_path"][:3]
        out.append({"epoch": epoch, "wall_ms": analysis["wall_ms"],
                    "critical_path": top,
                    "whatif": {c["stage"]: analysis["whatif"].get(c["stage"])
                               for c in top}})
    return out


def _profile_capture(emb, files, tmp: str) -> dict:
    """``utils.tracing.profile_trace`` (``torch.profiler`` over every
    thread, exported as Chrome-trace JSON) around a fresh loader's fill
    and ``TELEMETRY_PROFILE_STEPS`` DLRM micro-steps, each one
    ``tracing.step_span``: the loader's ranges by stage name and the
    gather kernel on one timeline."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset, train
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.utils import tracing
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    ds = device_dataset.DeviceShufflingDataset(
        files[:2], 1, 1, LOADER_BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, **dlrm_criteo.dlrm_spec())
    ds.set_epoch(0)
    log_dir = os.path.join(tmp, "profile")
    emb.reset_launch_counts()
    try:
        with tracing.profile_trace(log_dir) as prof:
            batches = iter(ds)
            features, label = next(batches)
            for i in range(TELEMETRY_PROFILE_STEPS):
                lo = i * MICROBATCH
                with tracing.step_span(i):
                    micro_step([f[lo:lo + MICROBATCH] for f in features],
                               label[lo:lo + MICROBATCH])
            torch.cuda.synchronize()
        launches = emb.launch_counts["gather_rows"]
        for _ in batches:
            pass
    finally:
        ds.close()
    ranges, kernel = {}, {"launches": 0, "device_ms": 0.0}
    for evt in prof.key_averages():
        if evt.key in LOADER_RANGES or evt.key.startswith("train#"):
            ranges[evt.key] = {"count": evt.count,
                               "cpu_ms": evt.cpu_time_total / 1e3}
        elif (evt.device_type == torch.autograd.DeviceType.CUDA
              and "gather_rows" in evt.key):
            us = getattr(evt, "self_device_time_total", None)
            kernel["launches"] += evt.count
            kernel["device_ms"] += (us if us is not None
                                    else evt.self_cuda_time_total) / 1e3
    # One timeline: each range's and the kernel's first start and last
    # end, in ms from the capture's first event.
    spans = {}
    events = prof.events()
    t0 = min(e.time_range.start for e in events)
    for e in events:
        name = ("gather_rows" if "gather_rows" in e.name
                and e.device_type == torch.autograd.DeviceType.CUDA
                else e.name)
        if name in LOADER_RANGES or name.startswith("train#") \
                or name == "gather_rows":
            lo, hi = spans.get(name, (math.inf, -math.inf))
            spans[name] = (min(lo, (e.time_range.start - t0) / 1e3),
                           max(hi, (e.time_range.end - t0) / 1e3))
    steps = [f"train#{i}" for i in range(TELEMETRY_PROFILE_STEPS)]
    if any(ranges.get(k, {}).get("count") != 1 for k in steps):
        raise AssertionError(f"profile: step ranges {ranges}")
    if launches != TELEMETRY_PROFILE_STEPS or \
            kernel["launches"] != TELEMETRY_PROFILE_STEPS:
        raise AssertionError(f"profile: {launches} gather launches "
                             f"({kernel['launches']} in the capture) in "
                             f"{TELEMETRY_PROFILE_STEPS} micro-steps")
    del model, micro_step
    return {"steps": TELEMETRY_PROFILE_STEPS, "ranges": ranges,
            "gather_kernel": kernel,
            "timeline_ms": {k: list(v) for k, v in sorted(spans.items())},
            "loader_ranges_seen": sorted(set(ranges) & set(LOADER_RANGES)),
            "trace_files": sorted(os.listdir(log_dir))}


def telemetry_phase(emb, files, trained: dict, tmp: str) -> dict:
    """The ``train`` phase's DLRM run (its files, the pool of 8, the bulk
    binding, 2 epochs) in two turns: (a) ``RSDL_TELEMETRY=0``, (b) the
    default with ``RSDL_TELEMETRY_DIR`` and ``RSDL_TRACE_DIR`` set; then
    what the recording saw, and a profiler capture. Fails unless (b)'s
    digests equal the ``train`` stream, every stage kind appears
    (``map_read`` per file and epoch, ``reduce_gather`` per reducer and
    epoch from the workers' dumps, ``batch_wait`` per batch), every pool
    worker wrote a metrics shard and each epoch has a verdict."""
    from ray_shuffling_data_loader_tpu_torch import executor, stats
    from ray_shuffling_data_loader_tpu_torch.runtime import (
        metrics, telemetry, trace)

    start = timeit.default_timer()
    # (a) Recording off, here and (through the environment) in the pool.
    with _env(RSDL_TELEMETRY="0"):
        off, off_digests, _ = _rebatch_turn(emb, files, "bulk", NUM_EPOCHS)
        off_events = telemetry.recorder().total_recorded
    # (b) The default: recording on, shards and dumps into tmp.
    tel_dir = os.path.join(tmp, "metrics")
    trace_dir = os.path.join(tmp, "traces")
    with _env(RSDL_TELEMETRY_DIR=tel_dir, RSDL_TRACE_DIR=trace_dir):
        metrics.maybe_start_shard_writer()
        before = metrics.parse_exposition(metrics.render())
        on, on_digests, _ = _rebatch_turn(emb, files, "bulk", NUM_EPOCHS)
        worker_pids = executor.last_worker_pool()["pids"]
        after = metrics.parse_exposition(metrics.render())
        rec = telemetry.recorder()
        events, total = rec.events(), rec.total_recorded
        summary = telemetry.attribution().run_summary()
        telemetry.dump(reason="chip_smoke telemetry phase")
        metrics.write_shard()
        shards = metrics.read_shards(tel_dir)
        _samples, types, fed_pids = metrics.federated_series()
    fresh_telemetry()
    hbm = {"sampler_bytes": stats.get_memory_stats(sample_hbm=True)
           .hbm_bytes, "memory_allocated": torch.cuda.memory_allocated()}
    merged = trace.merge_dumps(
        sorted(glob.glob(os.path.join(trace_dir, "rsdl-telemetry-*.jsonl"))))

    _same_digests("telemetry (a)", off_digests, trained["digests"])
    _same_digests("telemetry (b)", on_digests, trained["digests"])
    batches = NUM_ROWS // LOADER_BATCH
    keys = {kind: sorted({(e.get("epoch"), e.get("task"))
                          for e in merged["events"] if e["kind"] == kind})
            for kind in ("map_read", "reduce_gather")}
    want = {"map_read": [(e, f) for e in range(NUM_EPOCHS)
                         for f in range(NUM_FILES)],
            "reduce_gather": [(e, r) for e in range(NUM_EPOCHS)
                              for r in range(NUM_REDUCERS)]}
    waits = [sum(1 for e in events if e["kind"] == "batch_wait"
                 and e.get("epoch") == epoch) for epoch in range(NUM_EPOCHS)]
    problems = [f"{k} keys {keys[k]}" for k in want if keys[k] != want[k]]
    if min(waits) < batches:
        problems.append(f"batch_wait events by epoch {waits}")
    missing = sorted(set(worker_pids) - set(shards))
    if missing or os.getpid() not in shards:
        problems.append(f"no metrics shard from {missing or 'the driver'}")
    if any(v["bottleneck_stage"] is None for v in on["verdicts"]):
        problems.append(f"an epoch has no verdict: {on['verdicts']}")
    if off_events:
        problems.append(f"{off_events} events recorded with recording off")
    if hbm["sampler_bytes"] <= 0:
        problems.append(f"the device-memory sampler read {hbm}")
    if problems:
        raise AssertionError("telemetry: " + "; ".join(problems))
    profile = _profile_capture(emb, files, tmp)
    turn_keys = ("step_ms_median", "rows_per_s", "stall_pct", "fill_s",
                 "micro_steps", "gather_launches", "binding")
    return {
        "turns": {"off": {k: off[k] for k in turn_keys},
                  "on": {k: on[k] for k in turn_keys}},
        "rows_per_s_on_over_off": on["rows_per_s"] / off["rows_per_s"],
        "verdicts": on["verdicts"],
        "run_bottleneck": (summary or {}).get("bottleneck_stage"),
        "recorder": {"events": total, "capacity": rec.capacity,
                     "retained": min(total, rec.capacity),
                     "dropped": max(0, total - rec.capacity),
                     "off_turn_events": off_events},
        "record_overhead_us": telemetry.measure_record_overhead() * 1e6,
        "disabled_overhead_us": telemetry.measure_disabled_overhead() * 1e6,
        "exposition": {"families": len(types), "processes": len(fed_pids),
                       "driver_pid": os.getpid(),
                       "worker_pids": sorted(worker_pids),
                       "shard_pids": sorted(shards)},
        "latency": {hop: _latency_between(before, after, hop)
                    for hop in ("birth_to_delivered", "birth_to_device")},
        "stage_events": {"map_read": len(keys["map_read"]),
                         "reduce_gather": len(keys["reduce_gather"]),
                         "batch_wait_by_epoch": waits},
        "dumps": len(merged["processes"]),
        "critical_path": _critical_paths(merged, NUM_EPOCHS),
        "hbm": hbm,
        "profile": profile,
        "gather_launches": off["gather_launches"] + on["gather_launches"],
        "digests_equal": True,
        "phase_s": timeit.default_timer() - start,
    }


# Ops plane (runtime/{history,health,profiler}.py). (a) The ``train``
# phase runs armed as the JAX bench arms its train phase: these six
# detectors on a fresh ring, inside the sampling profiler.
ARMED_DETECTORS = ("throughput_droop", "stall_breach", "ledger_creep",
                   "queue_saturation", "lease_churn", "straggler_drift")
# (b) ``ops``: the card's twin of the JAX dry run's ops scene. A process
# pool of 2 shuffles OPS_FILES of the ``train`` files for OPS_EPOCHS
# epochs into a fresh DLRM ``mlperf`` (one micro-step per OPS_BATCH /
# MICROBATCH), the ring ticking every OPS_INTERVAL_S with the droop
# window of OPS_WINDOW ticks; the last epoch's reducers each sleep
# OPS_DELAY_MS in the workers, and that epoch starts only after the ring
# holds OPS_WINDOW + 3 ticks of undelayed activity.
OPS_FILES, OPS_WORKERS, OPS_EPOCHS, OPS_BATCH = 2, 2, 3, 4096
OPS_INTERVAL_S, OPS_WINDOW, OPS_DELAY_MS = 0.1, 8, 4000
OPS_CHAOS = f"reduce_gather:epoch{OPS_EPOCHS - 1}:delay{OPS_DELAY_MS}"


def activity_ticks(ring) -> int:
    """The ring's ticks since its activity counters (the droop detector's
    series) first moved."""
    from ray_shuffling_data_loader_tpu_torch.runtime import health
    pts = health._combined_series(ring, health._ACTIVITY_SERIES)
    moved = next((i for i in range(1, len(pts)) if pts[i][1] > pts[0][1]),
                 None)
    return 0 if moved is None else len(pts) - moved


def armed_train_phase(emb, files, gen_s: float, tmp: str) -> dict:
    """(a) :func:`train_phase` with ``health.arm(component="smoke")`` over
    the six detectors and inside ``profiler.maybe_sample()`` (folded
    stacks, and the recorder dumps a capture asks of this process and
    the pool's workers, into ``tmp``); then ``disarm`` and
    ``wait_captures``. Fails if
    the ring ticked fewer times than the phase's seconds over
    ``history_interval_s`` allow, less 2; the gaps between snapshots
    over 1.5 intervals say where it ran late. A fire is reported with
    its capsule and detail, as evidence."""
    from ray_shuffling_data_loader_tpu_torch.runtime import health, profiler

    incidents = os.path.join(tmp, "incidents")
    folded = os.path.join(tmp, "train.folded")
    monitor = health.arm(component="smoke", detectors=ARMED_DETECTORS,
                         incident_dir=incidents)
    if monitor is None:
        raise AssertionError("train: the health plane refused to arm "
                             "(RSDL_HEALTH=0?)")
    start = timeit.default_timer()
    armed_at = time.monotonic()
    try:
        with _env(RSDL_PROFILE_FOLDED=folded,
                  RSDL_TELEMETRY_DUMP_DIR=tmp), \
                profiler.maybe_sample() as prof:
            trained = train_phase(emb, files, gen_s)
        wall = timeit.default_timer() - start
    finally:
        finished = health.disarm()
        capsules = finished.wait_captures(timeout_s=15.0)
    summary = finished.summary()
    ticks = finished.ring.ticks
    interval = finished.ring.interval_s
    # Where the ring ran late: each gap between snapshots over 1.5
    # intervals, as (seconds after the phase's start, gap).
    stamps = [snap["t"] for snap in finished.ring.snapshots()]
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    late = [(round(b - armed_at, 3), round(b - a, 3))
            for a, b in zip(stamps, stamps[1:]) if b - a > 1.5 * interval]
    floor = int(wall / interval) - 2
    if ticks < floor:
        raise AssertionError(f"train: the history ring took {ticks} ticks "
                             f"in {wall:.1f} s at {interval} s, fewer than "
                             f"{floor}; late ticks (s after start, gap s): "
                             f"{late}")
    prof_summary = prof.summary()
    trained["health"] = {
        "detectors": list(ARMED_DETECTORS), "ticks": ticks,
        "interval_s": interval, "armed_s": wall,
        "max_tick_gap_s": max(gaps, default=None), "late_ticks": late,
        "fires": {name: d["fires"]
                  for name, d in summary["detectors"].items()},
        "fired": {name: d["last"]["detail"]
                  for name, d in summary["detectors"].items()
                  if d["fires"]},
        "capsules": capsules}
    trained["profiler"] = {
        "samples": prof_summary["samples"],
        "interval_s": prof_summary["interval_s"],
        "folded_lines": len(prof.folded()),
        "top_stages": dict(sorted(prof_summary["by_stage"].items(),
                                  key=lambda kv: -kv[1])[:5]),
        "threads_by_samples": prof_summary["threads_by_samples"],
        "cpu_s_by_thread": prof_summary["cpu_s_by_thread"]}
    return trained


def _torch_binding_turn(emb, files, epochs: int):
    """DLRM ``mlperf`` (a fresh model, seed 0) trained over ``epochs``
    through the Torch binding as a reference-style trainer uses it: CPU
    ``(List[Tensor], Tensor)`` batches from ``TorchShufflingDataset``
    (int32 features and f32 labels cast per batch; the last partial
    batch dropped, as the device binding drops it), each moved with
    ``.to("cuda")``, one micro-step per ``MICROBATCH`` rows; one gather
    launch per micro-step (the count set to 0 just before, read just
    after). Returns the turn's line, its batch digests and its losses."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset, train
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.torch_dataset import (
        TorchShufflingDataset)
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    torch.cuda.empty_cache()
    spec = dlrm_criteo.dlrm_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    fresh_telemetry()
    digests, losses, chunk_ms, copy_ms, waits = [], [], [], [], []
    rows_per_epoch = []
    emb.reset_launch_counts()
    t_start = timeit.default_timer()
    ds = TorchShufflingDataset(
        files, epochs, 1, LOADER_BATCH, 0,
        feature_columns=spec["feature_columns"],
        feature_types=[torch.int32] * len(spec["feature_columns"]),
        label_column=spec["label_column"], label_type=torch.float32,
        drop_last=True, num_reducers=NUM_REDUCERS, seed=SEED,
        queue_name="smoke-torch-binding")
    t_first = None
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        rows = 0
        batches = iter(ds)
        while True:
            t_ask = timeit.default_timer()
            try:
                features, label = next(batches)
            except StopIteration:
                break
            t_got = timeit.default_timer()
            if t_first is None:
                t_first = t_got
            else:
                waits.append(t_got - t_ask)
            features = [f.to("cuda") for f in features]
            label = label.to("cuda")
            torch.cuda.synchronize()
            copy_ms.append((timeit.default_timer() - t_got) * 1e3)
            digests.append(device_dataset.batch_digest(features, label))
            t0 = timeit.default_timer()
            losses.append(train.train_chunk(micro_step, features, label,
                                            MICROBATCH))
            torch.cuda.synchronize()
            chunk_ms.append((timeit.default_timer() - t0) * 1e3)
            rows += label.shape[0]
        rows_per_epoch.append(rows)
    t_end = timeit.default_timer()
    launches = emb.launch_counts["gather_rows"]
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("torch binding: non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(f"torch binding: {launches} gather launches "
                             f"in {all_losses.numel()} micro-steps")
    wall = t_end - t_first
    del model, micro_step
    return {
        "binding": "torch (host batches, .to('cuda'))",
        "verdicts": epoch_verdicts(epochs),
        "rows_per_epoch": rows_per_epoch,
        "rows_per_s": sum(rows_per_epoch) / wall,
        "stall_pct": 100.0 * sum(waits) / wall,
        "step_ms_median": float(np.median(chunk_ms)) / (LOADER_BATCH
                                                        // MICROBATCH),
        "fill_s": t_first - t_start,
        "h2d_copy_ms_per_batch": {
            "median": float(np.median(copy_ms)),
            "max": float(np.max(copy_ms)),
            "bytes": sum(f.numel() * f.element_size() for f in features)
            + label.numel() * label.element_size()},
        "batches": len(digests),
        "micro_steps": int(all_losses.numel()),
        "gather_launches": launches,
        "wall_s": t_end - t_start,
    }, torch.stack(digests).cpu(), all_losses


def torch_binding_phase(emb, files, trained: dict) -> dict:
    """:func:`_torch_binding_turn` over the ``train`` files for
    ``NUM_EPOCHS``, held against ``trained``: each batch's digest, the
    rows per epoch and the first loss (within ``ENGINE_LOSS_RTOL``); its
    rows/s over ``train``'s is what host batches cost against the bulk
    device binding (with the step's drift between the two runs)."""
    line, digests, losses = _torch_binding_turn(emb, files, NUM_EPOCHS)
    _same_digests("torch_binding", digests, trained["digests"])
    if line["rows_per_epoch"] != trained["rows_per_epoch"]:
        raise AssertionError(f"torch_binding: rows per epoch "
                             f"{line['rows_per_epoch']}, train's "
                             f"{trained['rows_per_epoch']}")
    first = float(losses[0])
    rel = abs(first - trained["first_loss"]) / abs(trained["first_loss"])
    if rel > ENGINE_LOSS_RTOL:
        raise AssertionError(f"torch_binding: first loss {first} vs the "
                             f"train phase's {trained['first_loss']}")
    return {**line,
            "rows_per_s_over_train": line["rows_per_s"]
            / trained["rows_per_s"],
            "train_step_ms_median": trained["step_ms_median"],
            "first_loss": first, "first_loss_rel_diff": rel,
            "digests_equal": True}


def _ops_specs(files, ring, gate: dict):
    """The ``ops`` phase's epochs: the undelayed ones, then the chaos
    epoch once the ring holds ``OPS_WINDOW + 3`` ticks of activity (the
    droop baseline, however fast the host)."""
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    for epoch in range(OPS_EPOCHS - 1):
        yield plan_ir.EpochSpec(epoch, list(files))
    t0 = timeit.default_timer()
    while activity_ticks(ring) < OPS_WINDOW + 3:
        time.sleep(OPS_INTERVAL_S / 4)
    gate.update(wait_s=timeit.default_timer() - t0,
                activity_ticks=activity_ticks(ring), t_unix=time.time())
    yield plan_ir.EpochSpec(OPS_EPOCHS - 1, list(files))


def ops_phase(emb, files, tmp: str) -> dict:
    """(b) A process pool of ``OPS_WORKERS`` (``RSDL_EXECUTOR_BACKEND=
    process``, ``RSDL_TRACE_DIR`` and ``RSDL_TELEMETRY_DIR`` in ``tmp``,
    the workers' ``RSDL_CHAOS_SPEC`` delaying the last epoch's reducers)
    shuffles the first ``OPS_FILES`` ``train`` files into a fresh DLRM
    ``mlperf`` that trains every micro-step through
    ``DeviceShufflingDataset``, with ``throughput_droop`` armed
    (``fire_ticks=2``, ``clear_ticks=50``, ``capture_cooldown_s=0``).
    Checks one fire, after the chaos epoch's start; one auto-captured
    capsule whose ``traces/`` hold dumps of the driver and a SIGUSR1'd
    pool worker, accepted by ``tools/rsdl_incident.py``; a worker-only
    sample in the capsule's merged exposition; rows and keys once per
    epoch; one gather launch per micro-step; finite losses."""
    from ray_shuffling_data_loader_tpu_torch import (
        dataset, device_dataset, executor, multiqueue, shuffle, train,
        transforms)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.runtime import (
        health, metrics, telemetry)

    start = timeit.default_timer()
    files = sorted(files)[:OPS_FILES]
    rows = sum(_parquet_rows(f) for f in files)
    dirs = {name: os.path.join(tmp, name)
            for name in ("trace", "shards", "incidents")}
    for d in dirs.values():
        os.makedirs(d)
    spec, cast = _sharded_spec()
    torch.cuda.empty_cache()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    losses, keys, rows_per_epoch, gate = [], [], [], {}
    monitor = ds = result = None
    telemetry.configure()
    with _env(RSDL_TRACE_DIR=dirs["trace"],
              RSDL_TELEMETRY_DIR=dirs["shards"],
              RSDL_EXECUTOR_BACKEND="process",
              RSDL_EXECUTOR_WORKERS=str(OPS_WORKERS),
              RSDL_CHAOS_SPEC=OPS_CHAOS, RSDL_CHAOS_SEED="0"):
        monitor = health.arm(
            interval_s=OPS_INTERVAL_S, capacity=600,
            detectors=("throughput_droop",), incident_dir=dirs["incidents"],
            fire_ticks=2, clear_ticks=50, capture_cooldown_s=0.0,
            slo_droop_window_ticks=OPS_WINDOW, slo_droop_floor_eps=2.0)
        if monitor is None:
            raise AssertionError("ops: the health plane refused to arm")
        queue = multiqueue.MultiQueue(OPS_EPOCHS)
        try:
            result = shuffle.run_shuffle_epochs_in_background(
                _ops_specs(files, monitor.ring, gate),
                functools.partial(dataset.batch_consumer, queue, 1),
                NUM_REDUCERS, 1, seed=SEED,
                on_failure=dataset.make_failure_broadcaster(queue),
                executor_backend="process", num_workers=OPS_WORKERS,
                map_transform=transforms.CastTransform(cast),
                epochs_hint=OPS_EPOCHS)
            ds = device_dataset.DeviceShufflingDataset(
                files, OPS_EPOCHS, 1, OPS_BATCH, 0, batch_queue=queue,
                shuffle_result=None, seed=SEED, drop_last=False,
                device=None, **spec)
            emb.reset_launch_counts()
            t_first = None
            for epoch in range(OPS_EPOCHS):
                ds.set_epoch(epoch)
                epoch_rows = 0
                for features, label in ds:
                    if t_first is None:
                        t_first = timeit.default_timer()
                    keys.append(features[-1].reshape(-1).clone())
                    n = label.shape[0] // MICROBATCH * MICROBATCH
                    if n:  # a batch's tail of fewer rows is not trained
                        losses.append(train.train_chunk(
                            micro_step, [f[:n] for f in features[:-1]],
                            label[:n], MICROBATCH))
                    epoch_rows += label.shape[0]
                rows_per_epoch.append(epoch_rows)
            torch.cuda.synchronize()
            launches = emb.launch_counts["gather_rows"]
            result.result()
            pool = executor.last_worker_pool()
            capsules = monitor.wait_captures(timeout_s=30.0)
        finally:
            if ds is not None:
                ds.close()
            health.disarm()
            queue.shutdown()
        train_s = timeit.default_timer() - t_first
        driver = metrics.parse_exposition(metrics.render())
    fires = monitor.total_fires
    summary = monitor.summary()
    ring = monitor.ring
    if fires != 1 or len(capsules) != 1:
        raise AssertionError(f"ops: {fires} fires and capsules {capsules}, "
                             f"expected one of each: {summary}")
    capsule = capsules[0]
    with open(os.path.join(capsule, "capsule.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    verdict = manifest["verdict"]
    fire_tick = sum(1 for s in ring.snapshots()
                    if s["t_unix"] <= verdict["t_unix"])
    if verdict["t_unix"] <= gate["t_unix"]:
        raise AssertionError(f"ops: the droop fired before the chaos epoch "
                             f"started: {verdict}, gate {gate}")
    pids = manifest["pids"]
    workers = [p for p in pids if p in pool["pids"]]
    if os.getpid() not in pids or not workers or len(pids) < 2:
        raise AssertionError(f"ops: the capsule's dumps are from {pids}; "
                             f"driver {os.getpid()}, pool {pool['pids']}")
    tool = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "rsdl_incident.py"),
         capsule, "--json"], capture_output=True, text=True, timeout=120,
        cwd=tmp, env={k: v for k, v in os.environ.items()
                      if k != "PYTHONPATH"})
    if tool.returncode != 0:
        raise AssertionError(f"ops: rsdl_incident.py rc {tool.returncode}: "
                             f"{tool.stderr[-2000:]}")
    incident = json.loads(tool.stdout)
    with open(os.path.join(capsule, "metrics.prom"), encoding="utf-8") as f:
        merged = metrics.parse_exposition(f.read())
    worker_only = sorted(set(merged) - set(driver))
    if "rsdl_worker_tasks_total" not in worker_only:
        raise AssertionError(f"ops: the merged exposition lacks the "
                             f"workers' rsdl_worker_tasks_total: "
                             f"{worker_only}")
    expected = [rows] * OPS_EPOCHS
    if rows_per_epoch != expected:
        raise AssertionError(f"ops: rows per epoch {rows_per_epoch}, "
                             f"expected {expected}")
    all_keys = torch.cat(keys).cpu().numpy().reshape(OPS_EPOCHS, rows)
    for epoch, epoch_keys in enumerate(all_keys):
        if len(np.unique(epoch_keys)) != rows:
            raise AssertionError(f"ops: a key came twice in epoch {epoch}")
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("ops: non-finite loss")
    steps = int(all_losses.numel())
    if launches != steps:
        raise AssertionError(f"ops: {launches} gather launches in {steps} "
                             "micro-steps")
    rates = [r for _, r in ring.rate("rsdl_events_total")]
    del model, micro_step
    return {
        "files": len(files), "rows_per_epoch": rows_per_epoch,
        "epochs": OPS_EPOCHS, "loader_batch": OPS_BATCH,
        "pool_workers": pool["workers"], "chaos": OPS_CHAOS,
        "interval_s": OPS_INTERVAL_S, "window_ticks": OPS_WINDOW,
        "gate": {k: v for k, v in gate.items() if k != "t_unix"},
        "ticks": ring.ticks, "fires": fires, "fire_tick": fire_tick,
        "fire_after_gate_s": verdict["t_unix"] - gate["t_unix"],
        "detail": verdict["detail"], "value": verdict["value"],
        "threshold": verdict["threshold"],
        "capsule": os.path.basename(capsule),
        "capsule_files": manifest["files"], "capsule_pids": pids,
        "pids_signaled": manifest["pids_signaled"],
        "worker_pids_in_capsule": workers,
        "incident_tool_rc": tool.returncode,
        "incident_pids": incident["pids"],
        "worker_only_series": worker_only,
        "events_per_s_per_tick": {"min": min(rates), "max": max(rates)},
        "micro_steps": steps, "train_s": train_s,
        "rows_per_s": sum(rows_per_epoch) / train_s,
        "loss_first": float(all_losses[0]),
        "loss_last": float(all_losses[-1]),
        "gather_launches": launches,
        "launches_per_micro_step": launches / steps,
        "phase_s": timeit.default_timer() - start,
    }


# Engine phase: the shuffle engine's configurations on the train phase's
# files, each turn a fresh DLRM mlperf (weights from SEED) taking one
# micro-step on the first MICROBATCH rows of every loader batch.
ENGINE_LOSS_RTOL = 1e-6
# Both executor attempts (task_retries=1) of map 3's read fail in each
# epoch, so a reduce recomputes the map from its lineage.
ENGINE_CHAOS = "map_read:file3:x2"
# The pool_kill turn's pool width.
POOL_KILL_WORKERS = 4


def _engine_turn(emb, name: str, files, want_digests, first_loss: float,
                 fused: bool, chaos=None, launch=None, **engine_kw) -> dict:
    """One turn: the bulk binding over ``DeviceShufflingDataset`` with the
    key column loaded and the last partial batch kept; checks every
    key once per epoch, each full batch's digest (model columns) against
    the train phase's, the first micro-step's loss against the train
    phase's first and one gather launch per micro-step (the count set to
    0 just before the turn and read just after). ``launch(spec)``, where
    given, starts the shuffle itself and returns ``(queue, result)`` for
    the dataset to consume."""
    from ray_shuffling_data_loader_tpu_torch import (
        data_generation, device_dataset, stats, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    torch.cuda.empty_cache()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    spec = dlrm_criteo.dlrm_spec()
    spec["feature_columns"].append(data_generation.KEY_COLUMN)
    spec["feature_types"].append(np.dtype(np.int64))
    full = NUM_ROWS // LOADER_BATCH
    saved_env = os.environ.get("RSDL_SHUFFLE_FUSED_PIPELINE")
    os.environ["RSDL_SHUFFLE_FUSED_PIPELINE"] = "1" if fused else "0"
    # The budget's baseline is the process-wide ledger at launch: collect
    # what earlier turns left in reference cycles first, or its release
    # during the turn would read as negative growth.
    gc.collect()
    snapshots = engine_snapshots()
    if chaos is not None:
        faults.install(chaos)
    digests, losses, rows = [], [], 0
    emb.reset_launch_counts()
    fresh_telemetry()
    try:
        if launch is not None:
            queue, result = launch(spec)
            ds = device_dataset.DeviceShufflingDataset(
                files, NUM_EPOCHS, 1, LOADER_BATCH, 0,
                num_reducers=NUM_REDUCERS, seed=SEED, drop_last=False,
                batch_queue=queue, shuffle_result=result, **spec)
        else:
            ds = device_dataset.DeviceShufflingDataset(
                files, NUM_EPOCHS, 1, LOADER_BATCH, 0,
                num_reducers=NUM_REDUCERS, seed=SEED, drop_last=False,
                collect_stats=True, **engine_kw, **spec)
        t_first = None
        for epoch in range(NUM_EPOCHS):
            ds.set_epoch(epoch)
            keys = []
            for i, (features, label) in enumerate(ds):
                if t_first is None:
                    t_first = timeit.default_timer()
                if i < full:
                    digests.append(device_dataset.batch_digest(
                        features[:-1], label))
                keys.append(features[-1].reshape(-1).cpu())
                losses.append(train.train_chunk(
                    micro_step, [f[:MICROBATCH] for f in features[:-1]],
                    label[:MICROBATCH], MICROBATCH))
                rows += label.shape[0]
            got = np.sort(torch.cat(keys).numpy())
            if not np.array_equal(got, np.arange(NUM_ROWS)):
                raise AssertionError(f"{name}: epoch {epoch}'s keys lost or "
                                     "repeated")
        torch.cuda.synchronize()
        wall = timeit.default_timer() - t_first
        verdicts = epoch_verdicts(NUM_EPOCHS)
        launches = emb.launch_counts["gather_rows"]
        trial = ds.shuffle_result.result()
    finally:
        faults.clear()
        if saved_env is None:
            os.environ.pop("RSDL_SHUFFLE_FUSED_PIPELINE", None)
        else:
            os.environ["RSDL_SHUFFLE_FUSED_PIPELINE"] = saved_env
    lines = engine_lines(*snapshots)
    _same_digests(f"engine turn {name}", torch.stack(digests).cpu(),
                  want_digests)
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError(f"{name}: non-finite loss")
    rel = abs(float(all_losses[0]) - first_loss) / abs(first_loss)
    if rel > ENGINE_LOSS_RTOL:
        raise AssertionError(f"{name}: first loss {float(all_losses[0])} vs "
                             f"the train phase's {first_loss}")
    if launches != len(losses):
        raise AssertionError(f"{name}: {launches} gather launches in "
                             f"{len(losses)} micro-steps")
    wait = ds.batch_wait_stats.summary()
    del model, micro_step
    return {
        "turn": name, "fused_map": fused, "chaos": chaos,
        **{k: v for k, v in engine_kw.items() if k != "spill_dir"},
        "binding": ds.binding, "batches": len(losses),
        "verdicts": verdicts,
        "gather_launches": launches,
        "rows_per_s": rows / wall, "wall_s": wall,
        "batch_wait_mean_ms": wait["mean"] * 1e3,
        "batch_wait_max_ms": wait["max"] * 1e3,
        "first_loss": float(all_losses[0]), "first_loss_rel_diff": rel,
        "keys_exactly_once": True, "digests_equal": True,
        "shuffle_stages": stats.trial_summary(trial), **lines}


def _pool_kill_launch(files, marker: str, killed: dict):
    """``launch`` of the pool_kill turn: the shuffle on a process pool of
    ``POOL_KILL_WORKERS`` workers, its first map call held
    (``procpool.HoldOnFirstCall`` around the dataset's own cast) until a
    thread has SIGKILLed the worker holding it, which it does as soon as
    the task has written its pid. No sleep decides when."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     executor, procpool)

    def launch(spec):
        cast = device_dataset.make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"])
        queue, result = dataset.create_batch_queue_and_shuffle(
            files, NUM_EPOCHS, 1, num_reducers=NUM_REDUCERS, seed=SEED,
            map_transform=procpool.HoldOnFirstCall(marker, 300.0, cast),
            executor_backend="process", num_workers=POOL_KILL_WORKERS,
            collect_stats=True)

        def kill():
            try:
                deadline = timeit.default_timer() + 300.0
                text = ""
                while not text and timeit.default_timer() < deadline:
                    if os.path.exists(marker):
                        with open(marker) as f:
                            text = f.read()
                    if not text:
                        threading.Event().wait(0.01)
                if not text:
                    raise AssertionError("no map task reported its start")
                pid = int(text)
                pids = executor.last_worker_pool()["pids"]
                if pid not in pids:
                    raise AssertionError(f"pid {pid} is not a pool worker "
                                         f"({pids})")
                os.kill(pid, signal.SIGKILL)
                killed["pid"] = pid
            except BaseException as e:  # noqa: BLE001 - raised by the turn
                killed["error"] = e
            finally:
                open(marker + ".go", "w").close()

        killed["thread"] = threading.Thread(target=kill, daemon=True)
        killed["thread"].start()
        return queue, result

    return launch


def engine_phase(emb, files, trained: dict, tmp: str) -> dict:
    """Five turns of the engine on the train phase's data, the first
    three on the thread backend: (1) no file cache and the read-then-plan
    map; (2) the defaults under a memory budget of a quarter of the train
    phase's peak ledger bytes with a spill directory, so reducer outputs
    spill; (3) the streaming map with ``ENGINE_CHAOS`` and
    ``task_retries=1``, so the lost map is recomputed from its lineage in
    each epoch (no cache: with it, epoch 1 would serve the file from the
    cache and never read it); (4) ``pool_kill``: the process pool of 4
    workers with one worker SIGKILLed inside a map task, whose task is
    resubmitted from lineage and the worker respawned; (5) ``tiered``:
    ``file_cache="tiered"`` (threads: the file cache is the thread plane's)
    over a ``SimulatedObjectStore`` source with the idle-lane prefetch,
    so epoch 1 reads the hot tier."""
    from ray_shuffling_data_loader_tpu_torch import storage

    start = timeit.default_timer()
    want, first = trained["digests"], trained["first_loss"]
    budget = trained["ledger_peak_bytes"] // 4
    turns = [
        _engine_turn(emb, "uncached", files, want, first, fused=False,
                     file_cache=None, executor_backend="thread"),
        _engine_turn(emb, "spill", files, want, first, fused=True,
                     max_inflight_bytes=budget,
                     spill_dir=os.path.join(tmp, "spill"),
                     executor_backend="thread"),
        _engine_turn(emb, "lineage", files, want, first, fused=True,
                     chaos=ENGINE_CHAOS, file_cache=None, task_retries=1,
                     executor_backend="thread"),
    ]
    killed: dict = {}
    turns.append(_engine_turn(
        emb, "pool_kill", files, want, first, fused=True,
        launch=_pool_kill_launch(files, os.path.join(tmp, "started"),
                                 killed)))
    killed["thread"].join(timeout=60)
    if "error" in killed:
        raise killed["error"]
    turns[-1]["killed_pid"] = killed["pid"]
    sim = storage.SimulatedObjectStore(seed=SEED)
    previous = storage.set_source(sim)
    try:
        turns.append(_engine_turn(emb, "tiered", files, want, first,
                                  fused=True, file_cache="tiered",
                                  executor_backend="thread"))
    finally:
        storage.set_source(previous)
    turns[-1]["source"] = {
        "name": sim.name, "first_byte_ms": sim.first_byte_ms,
        "mb_per_s": sim.mb_per_s, "jitter_pct": sim.jitter_pct,
        "seed": sim.seed, "fetches": sim.fetches,
        "bytes_read": sim.bytes_read}
    steps = sum(t["batches"] for t in turns)
    launches = sum(t["gather_launches"] for t in turns)
    if turns[1]["spill"]["spills"] < 1:
        raise AssertionError(f"nothing spilled under {budget} bytes")
    if (turns[2]["recoveries"].get("lineage") != NUM_EPOCHS
            or turns[2]["injected"] != 2 * NUM_EPOCHS):
        raise AssertionError(f"the lost maps were not recomputed once per "
                             f"epoch: {turns[2]}")
    kill = turns[3]
    if (kill["executor_backend"] != "process"
            or kill["recoveries"].get("lineage", 0) < 1
            or kill["process_pool"]["respawns"] < 1
            or kill["killed_pid"] in kill["pool_pids"]):
        raise AssertionError(f"the killed worker's task was not recomputed "
                             f"on a respawned pool: {kill}")
    tiers = turns[4]["storage"]
    if tiers["hot_hits"] + tiers["disk_hits"] < 1:
        raise AssertionError(f"no tiered hit: {tiers}")
    return {"turns": turns, "budget_bytes": budget,
            "gather_launches": launches,
            "launches_by_turn": {t["turn"]: t["gather_launches"]
                                 for t in turns},
            "launches_per_micro_step": launches / steps,
            "phase_s": timeit.default_timer() - start}


# Ring phase: K/V chunk counts walked in one process, the sequences of the
# world-1 entry point run, and the steps held against the one-card paths.
RING_NS = (2, 4)
RING_SEQS, RING_FILES = 2048, 4
RING_COMPARE_STEPS = 4
SPMD_DLRM_STEPS = 3


def _flash_whole(fa, q, k, v, bias, do):
    """Whole-sequence flash forward and backward: ``(out, dq, dk, dv,
    dbias)``."""
    out, lse = fa.flash_forward(q, k, v, bias)
    return (out, *fa.flash_backward(q, k, v, bias, out, lse, do))


def _flash_ring_walk(ra, q, k_chunks, v_chunks, bias_chunks, do):
    return ra.ring_walk(q, k_chunks, v_chunks, bias_chunks, do,
                        use_flash=True)


def _chunks(t, n: int, dim: int):
    return None if t is None else [c.contiguous() for c in t.chunk(n, dim)]


def ring_walk_checks(fa, ra, g) -> dict:
    """(a): the flash ring over n chunks against whole-sequence flash, and
    the causal einsum ring per rank against plain causal attention."""
    b, h, s, d = ATT_B, ATT_H, ATT_S, ATT_D
    errors, timings, launches = {}, {}, {}
    for masked in (False, True):
        q, k, v, do, bias = _attention_inputs(g, b, h, s, s, d, masked)
        want = dict(zip(("out", "dq", "dk", "dv", "dbias"),
                        _flash_whole(fa, q, k, v, bias, do)))
        for n in RING_NS:
            args = (q, _chunks(k, n, 2), _chunks(v, n, 2),
                    _chunks(bias, n, 3), do)
            fa.reset_launch_counts()
            out, dq, dk, dv, dbias = _flash_ring_walk(ra, *args)
            torch.cuda.synchronize()
            if fa.launch_counts != {name: n for name in FLASH_KERNELS}:
                raise AssertionError(f"a ring pass over {n} chunks launched "
                                     f"{fa.launch_counts}; expected {n} "
                                     "of each flash kernel")
            got = {"out": out, "dq": dq, "dk": torch.cat(dk, 2),
                   "dv": torch.cat(dv, 2)}
            if masked:
                got["dbias"] = torch.cat(dbias, 3)
            case = f"n{n}_bias" if masked else f"n{n}"
            launches[case] = dict(fa.launch_counts)
            errors[case] = {name: _held(f"ring {case} {name}", t, want[name])
                            for name, t in got.items()}
            if not masked:
                timings[f"ring_n{n}_ms"] = device_ms(
                    lambda *a: _flash_ring_walk(ra, *a), [args], 10)
                # Where a ring pass's time goes.
                profile = profile_steps(
                    lambda c, _: _flash_ring_walk(ra, *c), args, None,
                    list(FLASH_KERNELS))
        if not masked:
            timings["whole_flash_ms"] = device_ms(
                lambda *a: _flash_whole(fa, *a), [(q, k, v, None, do)], 10)
    for n in RING_NS:
        timings[f"ring_n{n}_over_whole"] = (timings[f"ring_n{n}_ms"]
                                            / timings["whole_flash_ms"])
    # The causal einsum ring: each rank's walk with its own query chunk.
    n = RING_NS[-1]
    q, k, v, do, bias = _attention_inputs(g, b, h, s, s, d, masked=True)
    outs, dqs = [], []
    dks = [torch.zeros_like(c, dtype=torch.float32) for c in k.chunk(n, 2)]
    for r in range(n):
        out, dq, dk, _, _ = ra.ring_walk(
            q.chunk(n, 2)[r], _chunks(k, n, 2), _chunks(v, n, 2),
            _chunks(bias, n, 3), do.chunk(n, 2)[r], index=r, causal=True)
        outs.append(out)
        dqs.append(dq)
        dks = [a + c.float() for a, c in zip(dks, dk)]
    pos = torch.arange(s, device="cuda")
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k)]
    want = ra._full_attention(*leaves, v, bias + ra.causal_bias(pos, pos))
    want.backward(do)
    errors["causal_einsum_n4_bias"] = {
        name: _held(f"causal ring {name}", got, ref) for name, got, ref in (
            ("out", torch.cat(outs, 2), want.detach()),
            ("dq", torch.cat(dqs, 2), leaves[0].grad),
            ("dk", torch.cat(dks, 2), leaves[1].grad))}
    torch.cuda.empty_cache()
    return {"errors": errors, "launches_per_pass": launches,
            "timings": timings, f"profile_n{RING_NS[-1]}": profile}


def _first_bert_losses(make_step, tokens) -> list:
    """The first ``RING_COMPARE_STEPS`` micro-step losses of a fresh
    ``bert_base()`` (weights from SEED, masks from SEED + 1) on ``tokens``,
    through ``make_step(model, optimizer, generator)``."""
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.models import bert
    model = bert.Bert(bert.bert_base(), device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    step = make_step(model, train.make_optimizer(model, lr=train.BERT_LR),
                     torch.Generator(device="cuda").manual_seed(SEED + 1))
    losses = [float(step([tokens[i * BERT_MICRO:(i + 1) * BERT_MICRO]], None))
              for i in range(RING_COMPARE_STEPS)]
    del model, step
    torch.cuda.empty_cache()
    return losses


def spmd_bert_run(fa, pmesh, tmp: str) -> dict:
    """(b): the sequence-parallel BERT entry point on a (1, 1) ``("data",
    "seq")`` mesh over the NCCL world of 1."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset, train
    from ray_shuffling_data_loader_tpu_torch.models import bert
    from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm

    mesh = pmesh.named_mesh((1, 1), (pmesh.DATA_AXIS, pmesh.SEQ_AXIS))
    data_rank, data_size = pmesh.local_data_shard_info(mesh)
    files, _ = bert_mlm.generate_tokenized_parquet(
        RING_SEQS, RING_FILES, tmp, seq_len=BERT_SEQ_LEN,
        vocab_size=BERT_VOCAB, seed=SEED)
    config = bert.bert_base()
    model = bert.Bert(config, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_bert_spmd_micro_step(
        mesh, model, train.make_optimizer(model, lr=train.BERT_LR),
        torch.Generator(device="cuda").manual_seed(SEED + 1), "ring")
    fresh_telemetry()
    ds = device_dataset.DeviceShufflingDataset(
        files, 1, data_size, BERT_BATCH, data_rank,
        num_reducers=NUM_REDUCERS, seed=SEED,
        **bert_mlm.bert_mlm_spec(BERT_SEQ_LEN))
    ds.set_epoch(0)
    losses, chunk_ms, first = [], [], None
    fa.reset_launch_counts()
    t_start = timeit.default_timer()
    for features, label in ds:
        if first is None:
            t_first = timeit.default_timer()
            first = features[0]
        t0 = timeit.default_timer()
        losses.append(train.train_chunk(micro_step, features, label,
                                        BERT_MICRO))
        torch.cuda.synchronize()
        chunk_ms.append((timeit.default_timer() - t0) * 1e3)
    t_end = timeit.default_timer()
    verdicts = epoch_verdicts(1)
    launches = dict(fa.launch_counts)
    # Where a micro-step's time goes (after the main path's counts were
    # read; these steps keep training the same model).
    breakdown = profile_steps(micro_step, [first[:BERT_MICRO]], None,
                              list(FLASH_KERNELS))
    all_losses = torch.cat(losses).cpu()
    steps = int(all_losses.numel())
    if steps != RING_SEQS // BERT_MICRO:
        raise AssertionError(f"{steps} micro-steps, expected "
                             f"{RING_SEQS // BERT_MICRO}")
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("non-finite sequence-parallel loss")
    for kernel in FLASH_KERNELS:
        if launches[kernel] != config.num_layers * steps:
            raise AssertionError(
                f"{kernel} launched {launches[kernel]} times in {steps} "
                f"ring micro-steps; expected {config.num_layers} per step")
    del model, micro_step
    torch.cuda.empty_cache()

    # The same first micro-steps through the bert phase's path, the ring
    # and Ulysses entry point, each from the same weights and masks.
    via = {
        "bert_path": _first_bert_losses(
            lambda m, o, g: train.make_bert_micro_step(
                m, o, g, fa.make_flash_attention_fn()), first),
        "ring": _first_bert_losses(
            lambda m, o, g: train.make_bert_spmd_micro_step(
                mesh, m, o, g, "ring"), first),
        "ulysses": _first_bert_losses(
            lambda m, o, g: train.make_bert_spmd_micro_step(
                mesh, m, o, g, "ulysses"), first)[:1]}
    rel = {}
    for path in ("ring", "ulysses"):
        ref = via["bert_path"][:len(via[path])]
        rel[path] = max(abs(a - b) / abs(b) for a, b in zip(via[path], ref))
        if not rel[path] <= 1e-2:
            raise AssertionError(f"{path} losses {via[path]} vs the bert "
                                 f"path's {ref}: relative {rel[path]}")
    waits = ds.batch_wait_stats.wait_times
    wall = t_end - t_first
    return {
        "mesh": {"names": list(mesh.mesh_dim_names), "shape": [1, 1]},
        "micro_steps": steps,
        "sequences_per_s": RING_SEQS / wall,
        "tokens_per_s": RING_SEQS * BERT_SEQ_LEN / wall,
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "fill_s": t_first - t_start,
        "step_ms_median": float(np.median(chunk_ms)) / (BERT_BATCH
                                                        // BERT_MICRO),
        "loss_first": float(all_losses[:8].mean()),
        "loss_last": float(all_losses[-8:].mean()),
        "flash_launches": launches,
        "launches_per_micro_step": {k: c / steps
                                    for k, c in launches.items()},
        "binding": ds.binding,
        "verdicts": verdicts,
        "vs_bert_path": {"losses": via, "max_rel_diff": rel,
                         "rtol": 1e-2},
        "profile": breakdown,
    }


def spmd_dlrm_steps(emb, pmesh) -> dict:
    """(c): DLRM ``mlperf`` through ``SpmdTrainer`` on a (1, 1) ``("data",
    "model")`` mesh against ``train.make_micro_step``."""
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr

    mesh = pmesh.make_mesh()
    _, data_size = pmesh.local_data_shard_info(mesh)
    g = torch.Generator(device="cuda").manual_seed(4)
    cols = [torch.randint(-1000, v + 1000, (MICROBATCH,), device="cuda",
                          dtype=torch.int32, generator=g)
            for v in dlrm.MLPERF.vocab_sizes]
    labels = (torch.rand((MICROBATCH, 1), device="cuda", generator=g)
              < 0.25).float()
    losses = {}
    for path in ("spmd", "micro_step"):
        model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(SEED))
        optimizer = train.make_optimizer(model)
        if path == "spmd":
            trainer = ptr.SpmdTrainer(
                mesh, lambda m, *b: dlrm.loss_fn(m, None, list(b[:-1]),
                                                 b[-1]) / data_size,
                model, optimizer)
            emb.reset_launch_counts()
            out = [trainer.train_step(*cols, labels)
                   for _ in range(SPMD_DLRM_STEPS)]
            trainer.block_until_ready()
            launches = emb.launch_counts["gather_rows"]
        else:
            step = train.make_micro_step(model, optimizer)
            out = [step(cols, labels) for _ in range(SPMD_DLRM_STEPS)]
        losses[path] = [float(x) for x in out]
        del model, optimizer, out
        torch.cuda.empty_cache()
    if launches != SPMD_DLRM_STEPS:
        raise AssertionError(f"{launches} gather launches in "
                             f"{SPMD_DLRM_STEPS} SpmdTrainer steps")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["spmd"],
                                                   losses["micro_step"]))
    if not rel <= 1e-5:
        raise AssertionError(f"SpmdTrainer losses {losses['spmd']} vs "
                             f"micro-step {losses['micro_step']}")
    return {"losses": losses, "max_rel_diff": rel, "rtol": 1e-5,
            "gather_launches": launches}


def ring_phase(fa, emb) -> dict:
    import torch.distributed as dist

    from ray_shuffling_data_loader_tpu_torch.ops import ring_attention as ra
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh

    walk = ring_walk_checks(fa, ra, torch.Generator(device="cuda")
                            .manual_seed(3))
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-ring-") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1)
        try:
            bert_run = spmd_bert_run(fa, pmesh, tmp)
            dlrm_run = spmd_dlrm_steps(emb, pmesh)
        finally:
            dist.destroy_process_group()
    return {"shape": {"B": ATT_B, "H": ATT_H, "S": ATT_S, "D": ATT_D,
                      "dtype": "bf16"},
            "tolerance": {"atol": ATT_TOL, "rtol": ATT_TOL},
            "walk": walk, "spmd_bert": bert_run, "spmd_dlrm": dlrm_run}


# Distributed phase: a world of two processes on the one card, started by
# the port's launcher (--local), the process group over gloo on CUDA
# tensors (NCCL refuses two ranks on one device).
DIST_WORLD = 2
# (b): 18,432 rows in 8 files, about 9,216 per rank and epoch: 4 steps of
# 2,048 rows per rank.
DIST_TRAIN_ROWS, DIST_TRAIN_BATCH = 18432, 2048
DIST_FIRST_RTOL = 1e-5
# Later steps: gloo sums each rank's gradients in another order than one
# backward over the concatenated batch does, and the embedding backward's
# index_add_ adds in no fixed order; Adam's early updates (about lr times
# the gradient's sign) carry those f32 roundings into the loss.
DIST_LOSS_RTOL = 1e-3
DIST_TIMEOUT_S = 600
_REPO = os.path.dirname(os.path.abspath(__file__))


def _free_ports(n: int) -> list:
    import socket
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _launch_world(train_args, out: str):
    """Run ``train_shuffle`` in ``DIST_WORLD`` processes through the port's
    launcher (``--local``, ``RSDL_HOSTS`` on free loopback ports, gloo)
    with ``--record-dir``; returns each rank's ``(summary, arrays)`` and
    the world's wall seconds. The launcher and its hosts share a process
    group of their own, all killed if the world outlives
    ``DIST_TIMEOUT_S``."""
    import signal
    *shuffle_ports, master = _free_ports(DIST_WORLD + 1)
    record = os.path.join(out, "record")
    cmd = [sys.executable, "-m",
           "ray_shuffling_data_loader_tpu_torch.launch_slice", "--local",
           "--out", os.path.join(out, "stats"),
           "--coordinator-port", str(master), "--",
           "--process-group-backend", "gloo", "--record-dir", record,
           *train_args]
    env = dict(os.environ, RSDL_HOSTS=",".join(
        f"127.0.0.1:{p}" for p in shuffle_ports))
    start = timeit.default_timer()
    proc = subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"the world ran past {DIST_TIMEOUT_S} s")
    wall = timeit.default_timer() - start
    if proc.returncode:
        raise AssertionError(f"launcher exited {proc.returncode}:\n"
                             f"{log[-6000:]}")
    ranks = []
    for rank in range(DIST_WORLD):
        with open(os.path.join(record, f"rank_{rank}.json")) as f:
            summary = json.load(f)
        ranks.append((summary, dict(np.load(
            os.path.join(record, f"rank_{rank}.npz")))))
    return ranks, wall


def _one_process_stream(files, batch: int, epochs: int, keep: bool):
    """Per rank, per epoch: the digests of every batch that the one-process
    shuffle with ``num_trainers=DIST_WORLD`` gives that rank on the card
    (the key column loaded, the last partial batch kept, as the world's
    ``--record-dir`` runs load them), and with ``keep`` the batches."""
    from ray_shuffling_data_loader_tpu_torch import (
        data_generation, dataset, device_dataset)
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo
    spec = dlrm_criteo.dlrm_spec()
    spec["feature_columns"].append(data_generation.KEY_COLUMN)
    spec["feature_types"].append(np.dtype(np.int64))
    queue, result = dataset.create_batch_queue_and_shuffle(
        files, epochs, DIST_WORLD, num_reducers=NUM_REDUCERS, seed=SEED,
        map_transform=device_dataset.make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"]))
    digests, batches = [], []
    for rank in range(DIST_WORLD):
        ds = device_dataset.DeviceShufflingDataset(
            files, epochs, DIST_WORLD, batch, rank, batch_queue=queue,
            shuffle_result=result, drop_last=False, seed=SEED, **spec)
        digests.append([])
        batches.append([])
        for epoch in range(epochs):
            ds.set_epoch(epoch)
            got = list(ds)
            digests[rank].append([device_dataset.batch_digest(f, y)
                                  for f, y in got])
            batches[rank].append(got if keep else None)
        ds.close()
    return digests, batches


def _same_stream(name: str, rank: int, got, want_by_epoch) -> int:
    want = torch.stack([d for epoch in want_by_epoch for d in epoch]).cpu()
    got = torch.from_numpy(got)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: rank {rank}'s batch digests differ "
                             "from the one-process num_trainers="
                             f"{DIST_WORLD} stream")
    return int(want.shape[0])


def _transport_line(summary: dict) -> dict:
    """The transport's counters, with the send rate over all frames and
    over the frames the native pump sent."""
    t = summary["transport"]
    return {**t, "send_MBps": (t["bytes_sent"] / t["send_s"] / 1e6
                               if t["send_s"] else None),
            "send_MBps_native": (t["bytes_sent_native"] / t["send_s_native"]
                                 / 1e6 if t["send_s_native"] else None)}


# (c): a map_read fault on host 1 (it maps files 4-7): the first read of
# file 5 fails in each epoch, and task_retries=1 maps it again.
DIST_CHAOS = "map_read:file5"


def _in_process_world(files, spec, **engine_kw):
    """Per rank, the digests of every batch of a world of two hosts run
    as threads of this process (the port's loopback transports), each a
    ``DeviceShufflingDataset`` in the bulk binding over
    ``create_distributed_batch_queue_and_shuffle``."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset
    from ray_shuffling_data_loader_tpu_torch.parallel import (
        distributed, transport)
    transports = transport.create_local_transports(DIST_WORLD,
                                                   recv_timeout_s=120.0)
    digests = []
    try:
        sets = []
        for t in transports:
            queue, result = (
                distributed.create_distributed_batch_queue_and_shuffle(
                    files, NUM_EPOCHS, NUM_REDUCERS, t, seed=SEED,
                    map_transform=device_dataset.make_cast_transform(
                        spec["feature_columns"], spec["feature_types"],
                        spec["label_column"], spec["label_type"]),
                    **engine_kw))
            sets.append(device_dataset.DeviceShufflingDataset(
                files, NUM_EPOCHS, 1, LOADER_BATCH, 0, batch_queue=queue,
                shuffle_result=result, drop_last=False, seed=SEED, **spec))
        for ds in sets:
            got = []
            for epoch in range(NUM_EPOCHS):
                ds.set_epoch(epoch)
                got.extend(device_dataset.batch_digest(f, y) for f, y in ds)
            digests.append(torch.stack(got).cpu().numpy())
            ds.close()
    finally:
        for t in transports:
            t.close()
    return digests


def distributed_phase(dlrm_paths, tmp: str) -> dict:
    """(a) The loader at the ``train`` phase's scale in a world of two
    processes: every key once per epoch, digests equal to the
    one-process stream. (b) DLRM ``mlperf`` through ``train_shuffle`` and
    ``SpmdTrainer``: finite losses, one gather launch per step per rank,
    losses against ``train.make_micro_step`` on the ranks' batches
    concatenated."""
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.models import dlrm

    torch.cuda.empty_cache()
    files = sorted(dlrm_paths)
    common = ["--num-reducers", str(NUM_REDUCERS), "--seed", str(SEED),
              "--num-epochs", str(NUM_EPOCHS)]

    # (a) The loader alone, bulk binding, the train phase's files.
    ranks, wall_a = _launch_world(
        [*common, "--use-old-data", "--data-dir", os.path.dirname(files[0]),
         "--batch-size", str(LOADER_BATCH), "--mock-train-step-time", "0"],
        os.path.join(tmp, "loader"))
    want, _ = _one_process_stream(files, LOADER_BATCH, NUM_EPOCHS, False)
    loader_reference = want
    loader = []
    for rank, (summary, arrays) in enumerate(ranks):
        if summary["binding"] != "bulk":
            raise AssertionError(f"rank {rank} ran {summary['binding']}")
        batches = _same_stream("loader", rank, arrays["digests"], want[rank])
        loader.append({
            "rank": rank, "binding": summary["binding"], "batches": batches,
            "rows": summary["rows_delivered"],
            "rows_per_s": summary["rows_per_s"],
            "stall_pct": summary["stall_pct"],
            "executor_backend": summary["executor_backend"],
            "shuffle_stages": summary["shuffle_stages"],
            "file_cache": summary["file_cache"],
            "ledger_peak_bytes": summary["ledger_peak_bytes"],
            "transport": _transport_line(summary)})
    for epoch in range(NUM_EPOCHS):
        keys = np.sort(np.concatenate([a[f"keys_{epoch}"]
                                       for _, a in ranks]))
        if not np.array_equal(keys, np.arange(NUM_ROWS)):
            raise AssertionError(f"epoch {epoch}: keys lost or repeated "
                                 "across the ranks")

    # (c) A lost map on host 1, retried by the executor, in a world of
    # threads: the same streams as (a).
    from ray_shuffling_data_loader_tpu_torch import data_generation, stats
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo
    spec = dlrm_criteo.dlrm_spec()
    spec["feature_columns"].append(data_generation.KEY_COLUMN)
    spec["feature_types"].append(np.dtype(np.int64))
    before = stats.fault_stats().snapshot()
    faults.install(DIST_CHAOS)
    t0 = timeit.default_timer()
    try:
        chaos_digests = _in_process_world(files, spec, task_retries=1,
                                          file_cache=None)
    finally:
        faults.clear()
    after = stats.fault_stats().snapshot()
    chaos_turn = {"spec": DIST_CHAOS, "task_retries": 1,
                  "file_cache": None,
                  "wall_s": timeit.default_timer() - t0,
                  "injected": after["injected"] - before["injected"],
                  "retries": after["retries"] - before["retries"],
                  "batches": [_same_stream("chaos", rank, d, want[rank])
                              for rank, d in enumerate(chaos_digests)],
                  "digests_equal_to_a": True}
    if chaos_turn["injected"] != NUM_EPOCHS or chaos_turn["retries"] < 1:
        raise AssertionError(f"the map faults were not retried: {chaos_turn}")

    # (b) Full-width training; the ranks generate the files themselves.
    data = os.path.join(tmp, "train_data")
    ranks, wall_b = _launch_world(
        [*common, "--num-rows", str(DIST_TRAIN_ROWS), "--num-files",
         str(NUM_FILES), "--data-dir", data,
         "--batch-size", str(DIST_TRAIN_BATCH)],
        os.path.join(tmp, "train"))
    files_b = sorted(os.path.join(data, f) for f in os.listdir(data))
    want, batches = _one_process_stream(files_b, DIST_TRAIN_BATCH,
                                        NUM_EPOCHS, True)
    steps_by_epoch = ranks[0][0]["steps_by_epoch"]
    trained = []
    for rank, (summary, arrays) in enumerate(ranks):
        _same_stream("train", rank, arrays["digests"], want[rank])
        steps = sum(summary["steps_by_epoch"])
        if summary["steps_by_epoch"] != steps_by_epoch:
            raise AssertionError("the ranks took different numbers of steps")
        if not all(math.isfinite(x) for x in summary["losses"]):
            raise AssertionError(f"rank {rank}: non-finite loss")
        if summary["gather_launches"] != steps:
            raise AssertionError(
                f"rank {rank}: {summary['gather_launches']} gather launches "
                f"in {steps} steps; expected one per step")
        trained.append({
            "rank": rank, "steps": steps,
            "gather_launches": summary["gather_launches"],
            "step_ms_median": float(np.median(summary["step_ms"])),
            "allreduce_ms_median": float(np.median(
                summary["collective_ms"])),
            "allreduce_share": (sum(summary["collective_ms"])
                                / sum(summary["step_ms"])),
            "allreduce_share_median": float(np.median(
                np.divide(summary["collective_ms"], summary["step_ms"]))),
            "step_ms": summary["step_ms"],
            "transport": _transport_line(summary)})
    losses = ranks[0][0]["losses"]
    if ranks[1][0]["losses"] != losses:
        raise AssertionError("the ranks report different global losses")

    # The same steps in one process: train.make_micro_step from the same
    # weights on the two ranks' batches concatenated.
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    n_features = len(dlrm.MLPERF.vocab_sizes)
    reference = []
    for epoch, steps in enumerate(steps_by_epoch):
        for i in range(steps):
            pair = [batches[rank][epoch][i] for rank in range(DIST_WORLD)]
            cols = [torch.cat([f[j] for f, _ in pair])
                    for j in range(n_features)]
            reference.append(float(micro_step(
                cols, torch.cat([y for _, y in pair]))))
    del model, micro_step
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, reference)]
    if not rel[0] <= DIST_FIRST_RTOL:
        raise AssertionError(f"first loss {losses[0]} vs one process "
                             f"{reference[0]} ({rel[0]} relative)")
    if not max(rel) <= DIST_LOSS_RTOL:
        raise AssertionError(f"losses {losses} vs one process {reference}")
    return {
        "loader_reference": loader_reference,
        "world": DIST_WORLD, "backend": "gloo", "launcher": "--local",
        "loader": {"rows": NUM_ROWS, "files": NUM_FILES,
                   "batch": LOADER_BATCH, "epochs": NUM_EPOCHS,
                   "keys_exactly_once": True, "digests_equal": True,
                   "wall_s": wall_a, "ranks": loader},
        "chaos": chaos_turn,
        "train": {"model": "mlperf", "rows": DIST_TRAIN_ROWS,
                  "batch_per_rank": DIST_TRAIN_BATCH,
                  "steps_by_epoch": steps_by_epoch, "losses": losses,
                  "one_process_losses": reference,
                  "first_rel_diff": rel[0], "first_rtol": DIST_FIRST_RTOL,
                  "max_rel_diff": max(rel), "rtol": DIST_LOSS_RTOL,
                  "wall_s": wall_b, "ranks": trained},
        "gather_launches": sum(t["gather_launches"] for t in trained),
    }


# Elastic phase: (a) failure detection and the generation fence over
# loopback sockets between this process (host 0) and a peer process (host
# 1); (b) shrink and grow on the train phase's files; (c) DLRM micro-steps
# on the elastic stream.
ELASTIC_HEARTBEAT_S, ELASTIC_SUSPECT_S = 0.05, 0.4
ELASTIC_WARM_BEATS = 5
ELASTIC_RANKS = (0, 1, 2, 3)
ELASTIC_CHAOS = "member_crash:rank1:epoch0"
ELASTIC_STEPS = 64
ELASTIC_WAIT_S = 60.0
# The peer of (a): a port transport (host 1) that dials this process,
# announces its incarnation, probes it every heartbeat and, from its
# second incarnation on, sends one data frame tagged (0, incarnation, 0);
# it runs until killed, or until this process is gone. It loads no torch,
# so it starts in about a second.
_ELASTIC_PEER = """
import os, sys, time
from ray_shuffling_data_loader_tpu_torch.membership import detector
from ray_shuffling_data_loader_tpu_torch.parallel import transport
port, incarnation, heartbeat_s = (int(sys.argv[1]), int(sys.argv[2]),
                                  float(sys.argv[3]))
t = transport.TcpTransport(1, [("127.0.0.1", port), ("127.0.0.1", 0)],
                           incarnation=incarnation)
t.start()
t.dial(0)
t.announce(incarnation)
det = detector.FailureDetector([0], heartbeat_s=heartbeat_s,
                               suspect_s=3600.0)
detector.HeartbeatProber(t, det).start()
if incarnation:
    t.send(0, (0, incarnation, 0), b"incarnation %d" % incarnation)
parent = os.getppid()
while os.getppid() == parent:
    time.sleep(0.5)
"""


class _Beats:
    """Frames observed by the smoke's transport, counted per incarnation
    of host 1, each fed to the failure detector as a beat."""

    def __init__(self, detector):
        self._detector = detector
        self._cv = threading.Condition()
        self.by_incarnation = {}

    def observe(self, src, incarnation, view, is_heartbeat) -> None:
        self._detector.beat(src)
        with self._cv:
            self.by_incarnation[incarnation] = (
                self.by_incarnation.get(incarnation, 0) + 1)
            self._cv.notify_all()

    def wait(self, incarnation: int, n: int) -> None:
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self.by_incarnation.get(incarnation, 0) >= n,
                    timeout=ELASTIC_WAIT_S):
                raise AssertionError(
                    f"fewer than {n} frames from incarnation {incarnation} "
                    f"of the peer within {ELASTIC_WAIT_S} s: "
                    f"{self.by_incarnation}")


def _start_peer(port: int, incarnation: int, log):
    return subprocess.Popen(
        [sys.executable, "-c", _ELASTIC_PEER, str(port), str(incarnation),
         str(ELASTIC_HEARTBEAT_S)], cwd=_REPO, stdout=log,
        stderr=subprocess.STDOUT)


def _raw_frames(port: int, frames) -> None:
    """Send ``(incarnation, view, tag, payload)`` frames as host 1 over a
    socket of their own: a zombie process from before the kill, or a
    straggler of an old view."""
    import socket
    import struct
    header = struct.Struct("<IIIIQQQQ")
    wire = b"".join(
        header.pack(0x5244534C, 1, incarnation, view, epoch, reducer,
                    file_index, len(payload)) + payload
        for incarnation, view, (epoch, reducer, file_index), payload
        in frames)
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(wire)


def _detect_and_fence(tmp: str) -> dict:
    """(a): kill -> DOWN through the detector, the rejoin at the next
    incarnation, a zombie frame fenced, the rejoined peer's frame
    delivered, and an old view's frame fenced after ``fence_view``."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import membership
    from ray_shuffling_data_loader_tpu_torch.membership import detector
    from ray_shuffling_data_loader_tpu_torch.parallel import transport
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics

    manager = membership.MembershipManager([0, 1])
    down_at = []
    verdict = threading.Event()

    def on_down(rank: int) -> None:
        down_at.append(timeit.default_timer())
        manager.member_down(rank, reason="failure detector")
        det.forget(rank)  # the first beat of its next generation re-arms
        verdict.set()

    # Rank 1 is tracked from its first beat on (a peer still starting
    # is not silent).
    det = detector.FailureDetector([], heartbeat_s=ELASTIC_HEARTBEAT_S,
                                   suspect_s=ELASTIC_SUSPECT_S,
                                   on_down=on_down)
    beats = _Beats(det)
    t = transport.TcpTransport(0, [("127.0.0.1", 0)] * 2,
                               recv_timeout_s=ELASTIC_WAIT_S)
    t.start()
    port = t.bound_port()
    t.set_frame_observer(beats.observe)
    prober = detector.HeartbeatProber(t, det).start()
    fenced = metrics.counter("rsdl_member_fenced_frames_total")
    peers = []
    out = {"heartbeat_s": ELASTIC_HEARTBEAT_S,
           "suspect_s": ELASTIC_SUSPECT_S}
    with open(os.path.join(tmp, "peer.log"), "w") as log:
        try:
            t0 = timeit.default_timer()
            peers.append(_start_peer(port, 0, log))
            beats.wait(0, ELASTIC_WARM_BEATS)
            out["peer_start_s"] = timeit.default_timer() - t0
            out["beats_before_kill"] = beats.by_incarnation[0]
            kill_at = timeit.default_timer()
            peers[0].send_signal(signal.SIGKILL)
            if not verdict.wait(ELASTIC_WAIT_S):
                raise AssertionError("no DOWN verdict for the killed peer")
            out["member_down_detect_ms"] = (down_at[0] - kill_at) * 1e3
            peers[0].wait(timeout=ELASTIC_WAIT_S)
            out["view_after_kill"] = manager.current_view().to_dict()
            if manager.current_view().ranks != (0,):
                raise AssertionError(f"view after the kill: "
                                     f"{manager.current_view()}")

            # The rejoin, at the incarnation the manager assigns.
            view = manager.member_join(1, reason="rejoin")
            out["view_after_rejoin"] = view.to_dict()
            incarnation = view.incarnation(1)
            if incarnation != 1:
                raise AssertionError(f"rejoin at incarnation {incarnation}")
            peers.append(_start_peer(port, incarnation, log))
            beats.wait(incarnation, ELASTIC_WARM_BEATS)
            got = bytes(t.recv(1, (0, incarnation, 0)))
            if got != b"incarnation 1":
                raise AssertionError(f"the rejoined peer's frame: {got!r}")

            # A zombie of incarnation 0 (a socket of its own), then a frame
            # at incarnation 1 on the same socket: once that one is
            # delivered, the zombie's frame has been read and judged.
            before = fenced.value
            _raw_frames(port, [(0, 0, (0, 7, 0), b"zombie"),
                              (1, 0, (0, 8, 0), b"after the zombie")])
            if bytes(t.recv(1, (0, 8, 0))) != b"after the zombie":
                raise AssertionError("the frame after the zombie's differs")
            zombie_fenced = int(fenced.value - before)
            if zombie_fenced != 1:
                raise AssertionError(f"{zombie_fenced} frames fenced for one "
                                     "zombie frame")
            try:
                t.recv(1, (0, 7, 0), timeout_s=0.2)
                raise AssertionError("the zombie's frame reached the inbox")
            except transport.TransportTimeout:
                pass

            # The view fence: the peer (whose frames carry view 0) is
            # stopped, then frames of views 0 and 1 arrive.
            prober.stop()
            peers[1].send_signal(signal.SIGKILL)
            peers[1].wait(timeout=ELASTIC_WAIT_S)
            t.fence_view(1)
            before = fenced.value
            _raw_frames(port, [(1, 0, (0, 9, 0), b"old view"),
                              (1, 1, (0, 10, 0), b"new view")])
            if bytes(t.recv(1, (0, 10, 0))) != b"new view":
                raise AssertionError("the new view's frame differs")
            view_fenced = int(fenced.value - before)
            if view_fenced != 1:
                raise AssertionError(f"{view_fenced} frames fenced for one "
                                     "frame of the old view")
            try:
                t.recv(1, (0, 9, 0), timeout_s=0.2)
                raise AssertionError("the old view's frame reached the "
                                     "inbox")
            except transport.TransportTimeout:
                pass
        finally:
            prober.stop()
            for p in peers:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            t.close()
    out.update({
        "beats_after_rejoin": beats.by_incarnation.get(1, 0),
        "zombie_frames_fenced": zombie_fenced,
        "old_view_frames_fenced": view_fenced,
        "rejoined_frame_delivered": True,
        "journal_lines": manager.journal.journal_bytes().count(b"\n")})
    return out


def _elastic_runs(files) -> tuple:
    """(b): the fixed world and the elastic run (rank 1 killed in epoch 0,
    rank 1 back and rank 4 new at the boundary) on the same files; the
    elastic run's figures and both runs' reducer tables by epoch."""
    from ray_shuffling_data_loader_tpu_torch import membership
    from ray_shuffling_data_loader_tpu_torch.membership import elastic
    from ray_shuffling_data_loader_tpu_torch.runtime import faults

    faults.clear()
    t0 = timeit.default_timer()
    fixed = elastic.ElasticShuffleRunner(
        files, NUM_REDUCERS, seed=SEED,
        manager=membership.MembershipManager(ELASTIC_RANKS)).run(NUM_EPOCHS)
    fixed_s = timeit.default_timer() - t0
    manager = membership.MembershipManager(ELASTIC_RANKS)
    runner = elastic.ElasticShuffleRunner(files, NUM_REDUCERS, seed=SEED,
                                          manager=manager)
    faults.install(ELASTIC_CHAOS, seed=SEED)
    try:
        t0 = timeit.default_timer()
        grown = [runner.run_epoch(0)]
        first = dict(runner.last_stats)
        shrunk = manager.current_view()
        manager.member_join(1, reason="rejoin")
        manager.member_join(4, reason="grow")
        grown.append(runner.run_epoch(1))
        elastic_s = timeit.default_timer() - t0
    finally:
        faults.clear()
    if shrunk.ranks != (0, 2, 3):
        raise AssertionError(f"shrunk view {shrunk}")
    if manager.current_view().ranks != (0, 1, 2, 3, 4):
        raise AssertionError(f"grown view {manager.current_view()}")
    for epoch in range(NUM_EPOCHS):
        if not all(a.equals(b) for a, b in zip(grown[epoch], fixed[epoch])):
            raise AssertionError(f"epoch {epoch}: an elastic reducer table "
                                 "differs from the fixed world's")
    delivered = sum(elastic.total_rows(e) for e in grown)
    rows_lost = sum(elastic.total_rows(e) for e in fixed) - delivered
    if rows_lost or first["recomputed"] < 1:
        raise AssertionError(f"rows_lost {rows_lost}, epoch 0 {first}")
    return {
        "chaos": ELASTIC_CHAOS, "ranks": list(ELASTIC_RANKS),
        "reducer_tables_equal": True, "rows_lost": rows_lost,
        "recomputed": first["recomputed"],
        "duplicates_dropped": first["duplicates_dropped"],
        "resize_stall_ms": first["resize_stall_ms"],
        "epoch_s": [first["dur_s"], runner.last_stats["dur_s"]],
        "shrunk_to": len(shrunk.ranks),
        "grew_to": len(manager.current_view().ranks),
        "elastic_rows_per_s": delivered / elastic_s,
        "fixed_rows_per_s": delivered / fixed_s,
        "fixed_s": fixed_s, "elastic_s": elastic_s,
    }, fixed, grown


def _stream_steps(emb, epochs) -> tuple:
    """(c): trainer 0's stream of each epoch, sliced by the loader's
    ``dataset.slice_batches`` into micro-batches, copied to the card and
    trained by a fresh DLRM ``mlperf`` (weights from seed 0) for
    ``ELASTIC_STEPS`` micro-steps in all; each batch's digest, the losses
    and the gather launches."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     train)
    from ray_shuffling_data_loader_tpu_torch.membership import elastic
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    spec = dlrm_criteo.dlrm_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    per_epoch = ELASTIC_STEPS // len(epochs)
    digests, losses = [], []
    emb.reset_launch_counts()
    for outputs in epochs:
        stream = elastic.trainer_streams(outputs, 1)[0]
        batches = dataset.slice_batches(iter(stream), MICROBATCH, True)
        for _, table in zip(range(per_epoch), batches):
            features, label = device_dataset.convert_to_arrays(
                table, spec["feature_columns"],
                [None] * len(spec["feature_columns"]),
                spec["feature_types"], spec["label_column"], None,
                spec["label_type"])
            cols = [device_dataset._widen(torch.from_numpy(f).cuda())
                    for f in features]
            lab = torch.from_numpy(label).cuda()
            digests.append(device_dataset.batch_digest(cols, lab))
            losses.append(micro_step(cols, lab))
    losses = torch.stack(losses).cpu()
    launches = emb.launch_counts["gather_rows"]
    del model, micro_step
    torch.cuda.empty_cache()
    return torch.stack(digests).cpu(), losses, launches


def elastic_phase(emb, dlrm_paths, tmp: str) -> dict:
    """(a) detection and fencing across two processes, (b) shrink and grow
    on the ``train`` files equal to the fixed world, (c) the elastic
    stream's DLRM micro-steps equal to the fixed stream's."""
    start = timeit.default_timer()
    detect = _detect_and_fence(tmp)
    resize, fixed, grown = _elastic_runs(sorted(dlrm_paths))
    # (c) Both streams under deterministic algorithms: the embedding
    # backward's index_add_ then sums in a fixed order, so equal inputs
    # give equal losses bit for bit.
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want_digests, want_losses, fixed_launches = _stream_steps(emb, fixed)
        del fixed
        got_digests, got_losses, launches = _stream_steps(emb, grown)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    if not torch.equal(got_digests, want_digests):
        raise AssertionError("the elastic stream's batch digests differ "
                             "from the fixed stream's")
    if not torch.equal(got_losses, want_losses):
        raise AssertionError(f"losses differ: {got_losses[:4]} vs "
                             f"{want_losses[:4]}")
    if not bool(torch.isfinite(got_losses).all()):
        raise AssertionError("non-finite loss")
    if launches != ELASTIC_STEPS or fixed_launches != ELASTIC_STEPS:
        raise AssertionError(f"{launches} and {fixed_launches} gather "
                             f"launches in {ELASTIC_STEPS} micro-steps")
    return {
        "detect": detect, "resize": resize,
        "train": {"model": "mlperf", "micro_steps": ELASTIC_STEPS,
                  "microbatch": MICROBATCH, "digests_equal": True,
                  "losses_bit_equal": True,
                  "loss_first": float(got_losses[0]),
                  "loss_last": float(got_losses[-1]),
                  "deterministic_algorithms": True},
        "gather_launches": launches,
        "launches_per_micro_step": launches / ELASTIC_STEPS,
        "phase_s": timeit.default_timer() - start,
    }


# Serving phase: the train phase's pipeline in a supervised queue-server
# process, its tables over the v3.3 wire into the DLRM step.
SERVE_LOSS_RTOL = 1e-6
# Loader batches of epoch 0 consumed before turn (b)'s SIGKILL.
SERVE_KILL_AFTER = 5
# (b)'s client: GETs 3 to 5 of each queue lose their ack, so the
# journal lags what the trainer consumed.
SERVE_ACK_CHAOS = "ack_lost:after2:x3"
# (c)'s wire faults, against an in-process server: a reset mid-frame and
# a corrupted payload in each epoch's queue.
SERVE_WIRE_CHAOS = "conn_reset_midframe:after2,frame_corrupt:after3"
SERVE_SERVER_COUNTERS = ("rsdl_queue_frames_replayed_total",
                         "rsdl_queue_frames_nacked_total",
                         "rsdl_queue_payload_bytes_total",
                         "rsdl_queue_bytes_on_wire_total",
                         "rsdl_queue_handle_hits_total",
                         "rsdl_queue_handle_misses_total",
                         "rsdl_queue_compression_saved_bytes_total")
# (d): two shard processes, two trainers; shard 1 is SIGKILLed after rank
# 1's third loader batch of epoch 0.
SERVE_SHARDS = 2
SERVE_SHARD_KILL_AFTER = 3
# The surviving rank's longest wait for a batch after the kill (the JAX
# package's shard-recovery budget): a restart and redial are the dead
# shard's rank's to pay, never its sibling's.
SERVE_SURVIVOR_BUDGET_S = 15.0
# (d): handle frames must cut the wire at least this much (JAX's
# test_handle_delivery_cuts_wire_bytes_10x).
SERVE_HANDLE_WIRE_CUT = 10
# Pool workers of each shard process in (d), so two shards and their
# pools share the host's cores.
SERVE_SHARD_WORKERS = 4
# (f): rank 0 moves live from shard 0 to shard 1 after its third loader
# batch of epoch 0, frames of at most 2 tables per round trip (the unacked
# frames the manifest carries).
SERVE_MOVE_AFTER = 3
SERVE_MOVE_MAX_BATCH = 2
# (g): the supervised shards' children die at the PREPARE of rank 0's move
# to generation 1, which begins after rank 0's first loader batch; one
# epoch.
SERVE_ABORT_CHAOS = "rebalance_prepare:rank0:epoch1"
SERVE_ABORT_AFTER = 1


def _server_counters(tel_dir: str) -> dict:
    """The queue server processes' counters, summed over the metric
    shards they left (a SIGKILLed one's last periodic write), with the
    compression ratio (payload over wire bytes of streamed frames)."""
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics
    samples, _ = metrics.merge_series(metrics.read_shards(tel_dir).values())
    out = {name.replace("rsdl_queue_", "").replace("_total", ""):
           int(sum(samples.get(name, {}).values()))
           for name in SERVE_SERVER_COUNTERS}
    return _with_ratio(out)


def _with_ratio(counters: dict) -> dict:
    saved = counters["compression_saved_bytes"]
    counters["compression_ratio"] = (
        (counters["bytes_on_wire"] + saved) / counters["bytes_on_wire"]
        if saved else 1.0)
    return counters


def _exit_ledger_bytes(tel_dir: str, pids) -> dict:
    """Each process's buffer-ledger bytes as its exit flush recorded them
    (a server process sets the gauge once its server released every
    pin), by pid."""
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics
    shards = metrics.read_shards(tel_dir)
    return {pid: shards[pid][0].get("rsdl_ledger_bytes_in_use", {}).get(())
            if pid in shards else None for pid in pids}


def _log_fetches(client) -> list:
    """Log each round trip of a ``RemoteQueue`` (when it landed, whether
    it resumed on a new connection, how many frames): the restart's
    seconds are from the kill to the first frame after it."""
    fetches = []
    fetch = client._fetch_batch

    def logged(queue_index):
        items, resumed = fetch(queue_index)
        fetches.append((timeit.default_timer(), resumed, len(items)))
        return items, resumed

    client._fetch_batch = logged
    return fetches


def _client_counters() -> dict:
    from ray_shuffling_data_loader_tpu_torch import stats
    recovery = stats.process_recovery_totals()
    return {k: recovery[k] for k in ("queue_client_reconnects",
                                     "queue_frames_corrupt",
                                     "queue_frames_replayed",
                                     "queue_frames_nacked")}


def _serve_spec():
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo
    spec = dlrm_criteo.dlrm_spec()
    cast = {c: np.dtype(t).name for c, t in zip(spec["feature_columns"],
                                                  spec["feature_types"])}
    cast[spec["label_column"]] = np.dtype(spec["label_type"]).name
    return spec, cast


def _served_dlrm_turn(emb, files, trained: dict, tmp: str, name: str,
                      kill: bool) -> dict:
    """One turn over a supervised server process (process pool, 8
    reducers, seed 0, 2 epochs, delivery ``"auto"``): a fresh DLRM
    ``mlperf`` fed by ``DeviceShufflingDataset(batch_queue=RemoteQueue)``,
    one micro-step per loader batch. (b) SIGKILLs the server after
    ``SERVE_KILL_AFTER`` batches of epoch 0 with ``ack_lost`` on the
    client. Checks each batch's digest against the ``train`` phase's, the
    first loss within ``SERVE_LOSS_RTOL`` and one gather launch per
    micro-step."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import (device_dataset,
                                                     multiqueue_service, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.runtime import (faults, metrics,
                                                             supervisor)

    torch.cuda.empty_cache()
    spec, cast = _serve_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    tel_dir = os.path.join(tmp, f"{name}-metrics")
    shm_root = "/dev/shm" if os.access("/dev/shm", os.W_OK) else tmp
    shm_dir = tempfile.mkdtemp(prefix="rsdl-smoke-serve-", dir=shm_root)
    config = dict(filenames=list(files), num_epochs=NUM_EPOCHS,
                  num_trainers=1, num_reducers=NUM_REDUCERS, seed=SEED,
                  journal_path=os.path.join(tmp, f"{name}.wal"), cast=cast,
                  handle_dir=os.path.join(shm_dir, "handles"),
                  child_env={"RSDL_TELEMETRY_DIR": tel_dir,
                             "RSDL_METRICS_SHARD_INTERVAL_S": "0.5",
                             "RSDL_EXECUTOR_SHM_DIR": shm_dir})
    client_before = _client_counters()
    before = metrics.parse_exposition(metrics.render())
    t_launch = timeit.default_timer()
    sup, address = supervisor.launch_supervised_queue_server(
        config, name=f"smoke-{name}")
    remote = ds = None
    digests, losses, rows, t_kill = [], [], 0, None
    try:
        if not supervisor.wait_for_server(address, timeout_s=120):
            raise AssertionError(f"serving {name}: the server never "
                                 "listened")
        listen_s = timeit.default_timer() - t_launch
        if kill:
            faults.install(SERVE_ACK_CHAOS, seed=0)
        remote = multiqueue_service.RemoteQueue(
            address, retries=20, initial_backoff_s=0.2,
            max_batch=1 if kill else 8)
        fetches = _log_fetches(remote)
        ds = device_dataset.DeviceShufflingDataset(
            files, NUM_EPOCHS, 1, LOADER_BATCH, 0, batch_queue=remote,
            shuffle_result=None, seed=SEED, device=None, **spec)
        emb.reset_launch_counts()
        t_first = None
        for epoch in range(NUM_EPOCHS):
            ds.set_epoch(epoch)
            for i, (features, label) in enumerate(ds):
                if t_first is None:
                    t_first = timeit.default_timer()
                digests.append(device_dataset.batch_digest(features, label))
                losses.append(train.train_chunk(
                    micro_step, [f[:MICROBATCH] for f in features],
                    label[:MICROBATCH], MICROBATCH))
                rows += label.shape[0]
                if kill and epoch == 0 and i + 1 == SERVE_KILL_AFTER:
                    t_kill = timeit.default_timer()
                    os.kill(sup.pid, signal.SIGKILL)
        torch.cuda.synchronize()
        wall = timeit.default_timer() - t_first
        launches = emb.launch_counts["gather_rows"]
    finally:
        faults.clear()
        if ds is not None:
            ds.close()
        if remote is not None:
            remote.close()
        sup.stop()
        handle_files = [f for _, _, names in os.walk(config["handle_dir"])
                        for f in names]
        shutil.rmtree(shm_dir, ignore_errors=True)
    after = metrics.parse_exposition(metrics.render())
    client_after = _client_counters()
    _same_digests(f"serving {name}", torch.stack(digests).cpu(),
                  trained["digests"])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError(f"serving {name}: non-finite loss")
    rel = (abs(float(all_losses[0]) - trained["first_loss"])
           / abs(trained["first_loss"]))
    if rel > SERVE_LOSS_RTOL:
        raise AssertionError(f"serving {name}: first loss "
                             f"{float(all_losses[0])} vs the train phase's "
                             f"{trained['first_loss']}")
    if launches != all_losses.numel():
        raise AssertionError(f"serving {name}: {launches} gather launches "
                             f"in {all_losses.numel()} micro-steps")
    if kill and sup.restarts < 1:
        raise AssertionError("serving (b): the server was never restarted")
    if not kill and sup.restarts:
        raise AssertionError(f"serving (a): {sup.restarts} restarts")
    if handle_files:
        raise AssertionError(f"serving {name}: segments left after the "
                             f"stop: {handle_files[:4]}")
    line = {
        "turn": name, "binding": ds.binding, "delivery": "auto",
        "max_batch": 1 if kill else 8,
        "micro_steps": int(all_losses.numel()),
        "micro_steps_per_loader_batch": 1,
        "loader_batches": len(digests), "rows": rows,
        "rows_per_s": rows / wall, "wall_s": wall,
        "server_listen_s": listen_s,
        "server_restarts": sup.restarts,
        "first_loss": float(all_losses[0]), "first_loss_rel_diff": rel,
        "digests_equal": True, "gather_launches": launches,
        "launches_per_micro_step": launches / all_losses.numel(),
        "server": _server_counters(tel_dir),
        "client": {k: client_after[k] - client_before[k]
                   for k in client_after},
        "birth_to_delivered": _latency_between(
            before, after, "birth_to_delivered").get("0"),
    }
    if kill:
        after_kill = [t for t, resumed, n in fetches
                      if t > t_kill and resumed and n]
        if not after_kill:
            raise AssertionError("serving (b): no frame came after the "
                                 "kill")
        line["restart_s"] = min(after_kill) - t_kill
        line["ack_chaos"] = SERVE_ACK_CHAOS
        line["kill_after_batches"] = SERVE_KILL_AFTER
    del model, micro_step
    return line


def _served_loader_turn(files, want_digests, chaos: str) -> dict:
    """(c) Loader only: the pipeline in this process behind an in-process
    ``serve_queue`` under ``chaos``; every batch's digest must equal
    (a)'s."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     executor,
                                                     multiqueue_service,
                                                     stats, transforms)
    from ray_shuffling_data_loader_tpu_torch.runtime import faults, metrics

    spec, cast = _serve_spec()
    served_before = stats.queue_serve_totals()
    client_before = _client_counters()
    before = metrics.parse_exposition(metrics.render())
    injector = faults.install(chaos, seed=0)
    digests, rows = [], 0
    try:
        queue, result = dataset.create_batch_queue_and_shuffle(
            files, NUM_EPOCHS, 1, num_reducers=NUM_REDUCERS, seed=SEED,
            map_transform=transforms.CastTransform(cast))
        with multiqueue_service.serve_queue(queue) as server:
            # Streamed frames: the wire faults act on their payloads.
            with multiqueue_service.RemoteQueue(server.address,
                                                delivery="stream") as remote:
                ds = device_dataset.DeviceShufflingDataset(
                    files, NUM_EPOCHS, 1, LOADER_BATCH, 0,
                    batch_queue=remote, shuffle_result=result, seed=SEED,
                    device=None, **spec)
                t0 = timeit.default_timer()
                for epoch in range(NUM_EPOCHS):
                    ds.set_epoch(epoch)
                    for features, label in ds:
                        digests.append(device_dataset.batch_digest(
                            features, label))
                        rows += label.shape[0]
                torch.cuda.synchronize()
                wall = timeit.default_timer() - t0
                ds.close()
        queue.shutdown()
        fired = injector.fired()
    finally:
        faults.clear()
    after = metrics.parse_exposition(metrics.render())
    served = stats.queue_serve_totals()
    client_after = _client_counters()
    _same_digests("serving (c)", torch.stack(digests).cpu(), want_digests)
    client = {k: client_after[k] - client_before[k] for k in client_after}
    sites = sorted({f["site"] for f in fired})
    if sites != ["conn_reset_midframe", "frame_corrupt"]:
        raise AssertionError(f"serving (c): faults fired at {sites}")
    if client["queue_frames_corrupt"] < 1 \
            or client["queue_client_reconnects"] < 1:
        raise AssertionError(f"serving (c): no recovery seen: {client}")
    return {
        "turn": "c", "delivery": "stream", "chaos": chaos,
        "faults_fired": len(fired),
        "rows": rows, "rows_per_s": rows / wall, "wall_s": wall,
        "loader_batches": len(digests), "digests_equal_a": True,
        "executor_backend": executor.last_worker_pool()["backend"],
        "server": _with_ratio({
            k.replace("queue_", ""): served[k] - served_before[k]
            for k in ("queue_payload_bytes", "queue_bytes_on_wire",
                      "queue_handle_hits", "queue_handle_misses",
                      "queue_compression_saved_bytes")}),
        "client": client,
        "birth_to_delivered": _latency_between(
            before, after, "birth_to_delivered").get("0"),
    }


def _sharded_spec():
    """The DLRM spec with the key column loaded last (the digests of the
    one-process ``num_trainers=2`` stream cover it), and its map-time
    cast."""
    from ray_shuffling_data_loader_tpu_torch import data_generation
    spec, cast = _serve_spec()
    spec["feature_columns"].append(data_generation.KEY_COLUMN)
    spec["feature_types"].append(np.dtype(np.int64))
    cast[data_generation.KEY_COLUMN] = "int64"
    return spec, cast


def _drain_rank(ds, epochs: int, on_batch=None) -> dict:
    """Iterate one rank's device dataset: its digests, rows, the wait for
    its first batch (``fill_s``), the seconds from that batch to the end
    (``wall_s``, the span the other turns' rows/s are over) and its
    longest wait for a batch after ``on_batch`` (called with the epoch,
    the batch's index and the batch after each) first returns True."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset
    digests, rows, waits, armed = [], 0, [], False
    t0 = timeit.default_timer()
    t_first = None
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        it = iter(ds)
        i = 0
        while True:
            start = timeit.default_timer()
            got = next(it, None)
            if armed:
                waits.append(timeit.default_timer() - start)
            if got is None:
                break
            if t_first is None:
                t_first = timeit.default_timer()
            features, label = got
            digests.append(device_dataset.batch_digest(features, label))
            rows += label.shape[0]
            if on_batch is not None and on_batch(epoch, i, features, label):
                armed = True
            i += 1
    torch.cuda.synchronize()
    return {"digests": digests, "rows": rows, "fill_s": t_first - t0,
            "wall_s": timeit.default_timer() - t_first,
            "max_wait_after_s": max(waits) if waits else None}


def _served_shards_turn(emb, files, want, tmp: str) -> dict:
    """(d) Two supervised shard processes (``launch_supervised_queue_shards``,
    2 trainers, delivery ``"auto"``): a fresh DLRM ``mlperf`` here trains
    every micro-step of rank 0's stream through
    ``connect_remote_queue(shard_map)`` while a thread drains rank 1's and
    SIGKILLs shard 1 after its third loader batch of epoch 0. ``want``:
    the one-process ``num_trainers=2`` digests per rank and epoch."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics, supervisor

    torch.cuda.empty_cache()
    spec, cast = _sharded_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    tel_dir = os.path.join(tmp, "d-metrics")
    shm_root = "/dev/shm" if os.access("/dev/shm", os.W_OK) else tmp
    shm_dir = tempfile.mkdtemp(prefix="rsdl-smoke-shards-", dir=shm_root)
    handle_root = os.path.join(shm_dir, "handles")
    config = dict(filenames=list(files), num_epochs=NUM_EPOCHS,
                  num_trainers=DIST_WORLD, num_reducers=NUM_REDUCERS,
                  seed=SEED, journal_path=os.path.join(tmp, "d.wal"),
                  cast=cast, handle_dir=handle_root,
                  num_workers=SERVE_SHARD_WORKERS,
                  child_env={"RSDL_TELEMETRY_DIR": tel_dir,
                             "RSDL_METRICS_SHARD_INTERVAL_S": "0.5",
                             "RSDL_EXECUTOR_SHM_DIR": shm_dir})
    client_before = _client_counters()
    before = metrics.parse_exposition(metrics.render())
    t_launch = timeit.default_timer()
    sups, shard_map = supervisor.launch_supervised_queue_shards(
        config, SERVE_SHARDS, name="smoke-shard")
    remotes, datasets, fetches = [], [], {}
    runs, errors, losses = {}, [], []
    killed = {}
    try:
        for address in shard_map.addresses:
            if not supervisor.wait_for_server(tuple(address), timeout_s=120):
                raise AssertionError(f"serving (d): shard {address} never "
                                     "listened")
        listen_s = timeit.default_timer() - t_launch
        for rank in range(DIST_WORLD):
            remote = dataset.connect_remote_queue(
                shard_map, retries=20, initial_backoff_s=0.2,
                max_batch=1 if rank == 1 else 8)
            remotes.append(remote)
            fetches[rank] = _log_fetches(remote.client_for_queue(
                plan_ir.queue_index(0, rank, DIST_WORLD)))
            datasets.append(device_dataset.DeviceShufflingDataset(
                files, NUM_EPOCHS, DIST_WORLD, LOADER_BATCH, rank,
                batch_queue=remote, shuffle_result=None, seed=SEED,
                drop_last=False, device=None, **spec))

        def kill_shard_1(epoch, i, features, label):
            if epoch == 0 and i + 1 == SERVE_SHARD_KILL_AFTER:
                killed["t"] = timeit.default_timer()
                killed["pid"] = sups[1].pid
                os.kill(killed["pid"], signal.SIGKILL)
            return False

        def drain_rank_1():
            try:
                runs[1] = _drain_rank(datasets[1], NUM_EPOCHS, kill_shard_1)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        emb.reset_launch_counts()
        drainer = threading.Thread(target=drain_rank_1, daemon=True,
                                   name="smoke-serve-rank1")
        drainer.start()
        runs[0] = _drain_rank(datasets[0], NUM_EPOCHS,
                              _train_every_micro_step(
                                  micro_step, losses,
                                  lambda epoch, i: "t" in killed))
        launches = emb.launch_counts["gather_rows"]
        drainer.join(timeout=600)
        if drainer.is_alive():
            raise AssertionError("serving (d): rank 1's drain hung")
        if errors:
            raise errors[0]
        final_pids = [sup.pid for sup in sups]
    finally:
        for ds in datasets:
            ds.close()
        for remote in remotes:
            remote.close()
        for sup in sups:
            sup.stop()
        handle_files = [f for _, _, names in os.walk(handle_root)
                        for f in names]
        shutil.rmtree(shm_dir, ignore_errors=True)
    after = metrics.parse_exposition(metrics.render())
    client_after = _client_counters()
    for rank in range(DIST_WORLD):
        _same_stream("serving (d)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("serving (d): non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(f"serving (d): {launches} gather launches in "
                             f"{all_losses.numel()} micro-steps")
    if sups[1].restarts < 1 or sups[1].failed:
        raise AssertionError("serving (d): shard 1 was not restarted")
    if sups[0].restarts:
        raise AssertionError(f"serving (d): shard 0 restarted "
                             f"{sups[0].restarts} times")
    survivor_wait = runs[0]["max_wait_after_s"]
    if survivor_wait is None or survivor_wait >= SERVE_SURVIVOR_BUDGET_S:
        raise AssertionError(f"serving (d): rank 0 waited {survivor_wait} "
                             "s for a batch after the kill")
    server = _server_counters(tel_dir)
    if server["handle_hits"] < 1 or (server["bytes_on_wire"]
                                     * SERVE_HANDLE_WIRE_CUT
                                     > server["payload_bytes"]):
        raise AssertionError(f"serving (d): handle delivery did not cut "
                             f"the wire {SERVE_HANDLE_WIRE_CUT}x: {server}")
    if handle_files:
        raise AssertionError(f"serving (d): segments left after the stop: "
                             f"{handle_files[:4]}")
    ledger = _exit_ledger_bytes(tel_dir, final_pids)
    if any(v != 0 for v in ledger.values()):
        raise AssertionError(f"serving (d): buffer-ledger bytes at the "
                             f"shards' exit: {ledger}")
    after_kill = [t for t, resumed, n in fetches[1]
                  if t > killed["t"] and resumed and n]
    if not after_kill:
        raise AssertionError("serving (d): no frame came after the kill")
    latency = _latency_between(before, after, "birth_to_delivered")
    del model, micro_step
    return {
        "turn": "d", "delivery": "auto", "shards": SERVE_SHARDS,
        "trainers": DIST_WORLD, "shard_map": shard_map.to_dict(),
        "shard_workers": SERVE_SHARD_WORKERS,
        "ranks": [{"rank": rank, "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "rows_per_s": runs[rank]["rows"] / runs[rank]["wall_s"],
                   "wall_s": runs[rank]["wall_s"],
                   "fill_s": runs[rank]["fill_s"], "digests_equal": True,
                   "birth_to_delivered": latency.get(str(rank))}
                  for rank in range(DIST_WORLD)],
        "rank0_micro_steps": int(all_losses.numel()),
        "rank0_loss_first": float(all_losses[0]),
        "rank0_loss_last": float(all_losses[-1]),
        "rank0_max_wait_after_kill_s": survivor_wait,
        "survivor_budget_s": SERVE_SURVIVOR_BUDGET_S,
        "gather_launches": launches,
        "launches_per_micro_step": launches / all_losses.numel(),
        "shards_listen_s": listen_s,
        "shard_restarts": [sup.restarts for sup in sups],
        "kill_after_rank1_batches": SERVE_SHARD_KILL_AFTER,
        "restart_s": min(after_kill) - killed["t"],
        "server": server,
        "wire_cut": server["payload_bytes"] / max(1, server["bytes_on_wire"]),
        "segments_left": 0, "exit_ledger_bytes": list(ledger.values()),
        "client": {k: client_after[k] - client_before[k]
                   for k in client_after},
    }


def _sharded_loader_turn(files, want) -> dict:
    """(e) The pipeline in this process behind ``serve_queue_sharded
    (num_shards=2)``: streamed, zlib-compressed frames on 2 codec threads,
    both ranks drained on threads; digests as in (d), bytes saved and
    ``wire + saved == payload``."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     executor,
                                                     multiqueue_service,
                                                     stats, transforms)
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics

    spec, cast = _sharded_spec()
    with _env(RSDL_QUEUE_COMPRESSION="zstd"):
        zstd_codec = multiqueue_service._resolve_compression()[0]
    codec_names = {multiqueue_service.CODEC_ZLIB: "zlib",
                   multiqueue_service.CODEC_ZSTD: "zstd",
                   multiqueue_service.CODEC_LZ4: "lz4"}
    served_before = stats.queue_serve_totals()
    client_before = _client_counters()
    before = metrics.parse_exposition(metrics.render())
    runs, errors = {}, []
    with _env(RSDL_QUEUE_COMPRESSION="zlib", RSDL_QUEUE_CODEC_THREADS="2"):
        queue, result = dataset.create_batch_queue_and_shuffle(
            files, NUM_EPOCHS, DIST_WORLD, num_reducers=NUM_REDUCERS,
            seed=SEED, map_transform=transforms.CastTransform(cast))
        sharded = multiqueue_service.serve_queue_sharded(
            queue, num_shards=SERVE_SHARDS, num_trainers=DIST_WORLD)
    try:
        codec_pools = [s._codec_pool is not None for s in sharded.servers]

        def drain(rank):
            try:
                with dataset.connect_remote_queue(
                        sharded.shard_map, delivery="stream") as remote:
                    ds = device_dataset.DeviceShufflingDataset(
                        files, NUM_EPOCHS, DIST_WORLD, LOADER_BATCH, rank,
                        batch_queue=remote, shuffle_result=None, seed=SEED,
                        drop_last=False, device=None, **spec)
                    try:
                        runs[rank] = _drain_rank(ds, NUM_EPOCHS)
                    finally:
                        ds.close()
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=drain, args=(rank,), daemon=True,
                                    name=f"smoke-serve-e{rank}")
                   for rank in range(DIST_WORLD)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("serving (e): a rank's drain hung")
        result.result()
    finally:
        sharded.close()
        queue.shutdown()
    if errors:
        raise errors[0]
    after = metrics.parse_exposition(metrics.render())
    served = stats.queue_serve_totals()
    client_after = _client_counters()
    for rank in range(DIST_WORLD):
        _same_stream("serving (e)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank])
    server = _with_ratio({
        k.replace("queue_", ""): served[k] - served_before[k]
        for k in ("queue_payload_bytes", "queue_bytes_on_wire",
                  "queue_handle_hits", "queue_handle_misses",
                  "queue_compression_saved_bytes")})
    if codec_pools != [True] * SERVE_SHARDS:
        raise AssertionError(f"serving (e): codec pools {codec_pools}")
    if server["compression_saved_bytes"] <= 0 or (
            server["bytes_on_wire"] + server["compression_saved_bytes"]
            != server["payload_bytes"]):
        raise AssertionError(f"serving (e): compression accounting "
                             f"{server}")
    if server["handle_hits"]:
        raise AssertionError(f"serving (e): handle frames under "
                             f"delivery=stream: {server}")
    latency = _latency_between(before, after, "birth_to_delivered")
    return {
        "turn": "e", "delivery": "stream", "compression": "zlib",
        "codec_threads": 2, "shards": SERVE_SHARDS,
        "zstd_resolves_to": codec_names[zstd_codec],
        "executor_backend": executor.last_worker_pool()["backend"],
        "ranks": [{"rank": rank, "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "rows_per_s": runs[rank]["rows"] / runs[rank]["wall_s"],
                   "wall_s": runs[rank]["wall_s"],
                   "fill_s": runs[rank]["fill_s"], "digests_equal": True,
                   "birth_to_delivered": latency.get(str(rank))}
                  for rank in range(DIST_WORLD)],
        "server": server,
        "client": {k: client_after[k] - client_before[k]
                   for k in client_after},
    }


def _rebalance_counters() -> dict:
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics
    samples = metrics.parse_exposition(metrics.render())
    return {name.replace("rsdl_rebalance_", ""):
            sum(samples.get(name, {}).values())
            for name in ("rsdl_rebalance_moves_total",
                         "rsdl_rebalance_fenced_frames_total")}


def _train_every_micro_step(micro_step, losses, after=None):
    """An ``on_batch`` for ``_drain_rank``: one DLRM micro-step per 2,048
    rows of the batch (the key column left out), then ``after``."""
    from ray_shuffling_data_loader_tpu_torch import train

    def on_batch(epoch, i, features, label):
        n = label.shape[0] // MICROBATCH * MICROBATCH
        if n:  # a batch's tail of fewer rows is not trained
            losses.append(train.train_chunk(
                micro_step, [f[:n] for f in features[:-1]], label[:n],
                MICROBATCH))
        return after(epoch, i) if after is not None else False

    return on_batch


def _live_move_turn(emb, files, want, tmp: str, e_rows_per_s) -> dict:
    """(f) The ``train`` pipeline in this process behind
    ``serve_queue_sharded(num_shards=2)`` (2 trainers, delivery
    ``"auto"``): a fresh DLRM ``mlperf`` trains every micro-step of rank
    0's stream through a ``ShardedRemoteQueue`` while a thread drains rank
    1's; after rank 0's third loader batch of epoch 0,
    ``rebalance.migrate`` moves rank 0 to shard 1 under the step. Digests
    per rank and epoch as in (d); the consumer's map learns the move; the
    decision journal replays it; one gather launch per micro-step; one
    committed move."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     multiqueue_service,
                                                     native, rebalance,
                                                     transforms, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir

    torch.cuda.empty_cache()
    spec, cast = _sharded_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    journal = os.path.join(tmp, "f-rebalance.journal")
    counters_before = _rebalance_counters()
    ledger_before = native.buffer_ledger().bytes_in_use()
    runs, errors, losses, phases, moved = {}, [], [], {}, {}
    queue, result = dataset.create_batch_queue_and_shuffle(
        files, NUM_EPOCHS, DIST_WORLD, num_reducers=NUM_REDUCERS, seed=SEED,
        map_transform=transforms.CastTransform(cast))
    sharded = multiqueue_service.serve_queue_sharded(
        queue, num_shards=SERVE_SHARDS, num_trainers=DIST_WORLD)
    controller = rebalance.RebalanceController(sharded.shard_map,
                                               journal_path=journal)
    remotes, datasets = [], []
    try:
        for rank in range(DIST_WORLD):
            # Each rank's own copy of the map: rank 0's follows the move.
            remotes.append(dataset.connect_remote_queue(
                plan_ir.ShardMap.from_json(sharded.shard_map.to_json()),
                retries=20, initial_backoff_s=0.2,
                max_batch=SERVE_MOVE_MAX_BATCH if rank == 0 else 8))
            datasets.append(device_dataset.DeviceShufflingDataset(
                files, NUM_EPOCHS, DIST_WORLD, LOADER_BATCH, rank,
                batch_queue=remotes[rank], shuffle_result=None, seed=SEED,
                drop_last=False, device=None, **spec))

        def move_rank_0(epoch, i):
            if epoch == 0 and i + 1 == SERVE_MOVE_AFTER:
                t0 = timeit.default_timer()
                moved["state"] = rebalance.migrate(
                    controller, 0, target=1, reason="smoke (f)",
                    phases=phases)
                moved["s"] = timeit.default_timer() - t0
                return True
            return False

        def drain_rank_1():
            try:
                runs[1] = _drain_rank(datasets[1], NUM_EPOCHS)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        emb.reset_launch_counts()
        drainer = threading.Thread(target=drain_rank_1, daemon=True,
                                   name="smoke-serve-f-rank1")
        drainer.start()
        runs[0] = _drain_rank(datasets[0], NUM_EPOCHS,
                              _train_every_micro_step(micro_step, losses,
                                                      move_rank_0))
        launches = emb.launch_counts["gather_rows"]
        drainer.join(timeout=600)
        if drainer.is_alive():
            raise AssertionError("serving (f): rank 1's drain hung")
        if errors:
            raise errors[0]
        result.result()
        client_map = remotes[0].shard_map
    finally:
        for ds in datasets:
            ds.close()
        for remote in remotes:
            remote.close()
        controller.close()
        sharded.close()
        queue.shutdown()
    counters = {k: v - counters_before[k]
                for k, v in _rebalance_counters().items()}
    for rank in range(DIST_WORLD):
        _same_stream("serving (f)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("serving (f): non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(f"serving (f): {launches} gather launches in "
                             f"{all_losses.numel()} micro-steps")
    state = moved.get("state")
    if state is None or state.overrides != ((0, 1),):
        raise AssertionError(f"serving (f): the move did not commit: "
                             f"{state}")
    if (client_map.overrides, client_map.generation) != ({0: 1}, 1):
        raise AssertionError(f"serving (f): the consumer's map reads "
                             f"{client_map.to_dict()}")
    replayed = rebalance.replay(journal)
    if (replayed.overrides, replayed.pending) != (((0, 1),), None):
        raise AssertionError(f"serving (f): the journal replays to "
                             f"{replayed}")
    if counters["moves_total"] != 1:
        raise AssertionError(f"serving (f): {counters['moves_total']} "
                             "moves counted")
    ledger = native.buffer_ledger().bytes_in_use() - ledger_before
    if ledger:
        raise AssertionError(f"serving (f): {ledger} buffer-ledger bytes "
                             "still pinned after the shards closed")
    del model, micro_step
    return {
        "turn": "f", "delivery": "auto", "shards": SERVE_SHARDS,
        "trainers": DIST_WORLD, "move_after_rank0_batches": SERVE_MOVE_AFTER,
        "rank0_max_batch": SERVE_MOVE_MAX_BATCH,
        "shard_map_after": client_map.to_dict(),
        "journal_replay": replayed.to_dict(),
        "phase_ms": {k.replace("_s", "_ms"): v * 1e3
                     for k, v in phases.items() if k.endswith("_s")},
        "migrate_ms": moved["s"] * 1e3,
        "manifest_bytes": phases["manifest_bytes"],
        "manifest_frames": phases["manifest_frames"],
        "ranks": [{"rank": rank, "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "rows_per_s": runs[rank]["rows"] / runs[rank]["wall_s"],
                   "wall_s": runs[rank]["wall_s"],
                   "fill_s": runs[rank]["fill_s"], "digests_equal": True}
                  for rank in range(DIST_WORLD)],
        "rank0_rows_per_s_e": e_rows_per_s,
        "rank0_max_wait_after_move_s": runs[0]["max_wait_after_s"],
        "rank0_micro_steps": int(all_losses.numel()),
        "rank0_loss_first": float(all_losses[0]),
        "rank0_loss_last": float(all_losses[-1]),
        "gather_launches": launches,
        "launches_per_micro_step": launches / all_losses.numel(),
        "rebalance": counters, "ledger_bytes_left": ledger,
    }


def _abort_turn(emb, files, want, tmp: str) -> dict:
    """(g) Two supervised shard processes (one epoch, 2 trainers, delivery
    ``"auto"``) whose children carry ``RSDL_CHAOS_SPEC=rebalance_prepare:
    rank0:epoch1``: a fresh DLRM ``mlperf`` trains every micro-step of rank
    0's stream; after its first loader batch ``rebalance.migrate`` moves
    rank 0 to shard 1 and dies on the wire, shard 0 having died at the
    PREPARE. The abort is journaled, shard 0 restarts (shard 1 does not),
    and both ranks' digests equal the one-process stream's epoch 0."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     rebalance, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import supervisor

    torch.cuda.empty_cache()
    spec, cast = _sharded_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    shm_root = "/dev/shm" if os.access("/dev/shm", os.W_OK) else tmp
    shm_dir = tempfile.mkdtemp(prefix="rsdl-smoke-abort-", dir=shm_root)
    journal = os.path.join(tmp, "g-rebalance.journal")
    config = dict(filenames=list(files), num_epochs=1,
                  num_trainers=DIST_WORLD, num_reducers=NUM_REDUCERS,
                  seed=SEED, journal_path=os.path.join(tmp, "g.wal"),
                  cast=cast, handle_dir=os.path.join(shm_dir, "handles"),
                  num_workers=SERVE_SHARD_WORKERS,
                  child_env={"RSDL_CHAOS_SPEC": SERVE_ABORT_CHAOS,
                             "RSDL_CHAOS_SEED": "0",
                             "RSDL_EXECUTOR_SHM_DIR": shm_dir})
    sups, shard_map = supervisor.launch_supervised_queue_shards(
        config, SERVE_SHARDS, name="smoke-abort")
    controller = rebalance.RebalanceController(shard_map,
                                               journal_path=journal)
    remotes, datasets, runs, errors, losses = [], [], {}, [], []
    failed, fetches = {}, None
    try:
        for address in shard_map.addresses:
            if not supervisor.wait_for_server(tuple(address), timeout_s=120):
                raise AssertionError(f"serving (g): shard {address} never "
                                     "listened")
        for rank in range(DIST_WORLD):
            # Rank 0 fetches a table per round trip, so the kill cuts its
            # epoch (a batch of 8 could hold the whole epoch already).
            remotes.append(dataset.connect_remote_queue(
                plan_ir.ShardMap.from_json(shard_map.to_json()),
                retries=20, initial_backoff_s=0.2,
                max_batch=1 if rank == 0 else 8))
            datasets.append(device_dataset.DeviceShufflingDataset(
                files, 1, DIST_WORLD, LOADER_BATCH, rank,
                batch_queue=remotes[rank], shuffle_result=None, seed=SEED,
                drop_last=False, device=None, **spec))
        fetches = _log_fetches(remotes[0].client_for_queue(
            plan_ir.queue_index(0, 0, DIST_WORLD)))

        def move_rank_0(epoch, i):
            if i + 1 != SERVE_ABORT_AFTER:
                return False
            failed["t"] = timeit.default_timer()
            try:
                rebalance.migrate(controller, 0, target=1,
                                  reason="smoke (g)", timeout_s=60.0)
            except (OSError, RuntimeError) as e:
                failed["error"] = repr(e)
            return True

        def drain_rank_1():
            try:
                runs[1] = _drain_rank(datasets[1], 1)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        emb.reset_launch_counts()
        drainer = threading.Thread(target=drain_rank_1, daemon=True,
                                   name="smoke-serve-g-rank1")
        drainer.start()
        runs[0] = _drain_rank(datasets[0], 1,
                              _train_every_micro_step(micro_step, losses,
                                                      move_rank_0))
        launches = emb.launch_counts["gather_rows"]
        drainer.join(timeout=600)
        if drainer.is_alive():
            raise AssertionError("serving (g): rank 1's drain hung")
        if errors:
            raise errors[0]
    finally:
        for ds in datasets:
            ds.close()
        for remote in remotes:
            remote.close()
        controller.close()
        for sup in sups:
            sup.stop()
        shutil.rmtree(shm_dir, ignore_errors=True)
    for rank in range(DIST_WORLD):
        _same_stream("serving (g)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank][:1])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("serving (g): non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(f"serving (g): {launches} gather launches in "
                             f"{all_losses.numel()} micro-steps")
    if "error" not in failed:
        raise AssertionError("serving (g): the chaos site never fired")
    state = rebalance.replay(journal)
    if (state.pending, state.generation, state.overrides) != (None, 0, ()):
        raise AssertionError(f"serving (g): the journal replays to {state}")
    kinds = [r["decision"].kind
             for r in rebalance.RebalanceJournal.load(journal)]
    if kinds != ["bootstrap", "intent", "abort"]:
        raise AssertionError(f"serving (g): journal kinds {kinds}")
    if sups[0].restarts < 1 or sups[0].failed:
        raise AssertionError("serving (g): shard 0 was not restarted")
    if sups[1].restarts:
        raise AssertionError(f"serving (g): shard 1 restarted "
                             f"{sups[1].restarts} times")
    after = [t for t, resumed, n in fetches
             if t > failed["t"] and resumed and n]
    if not after:
        raise AssertionError("serving (g): no frame came after the abort")
    del model, micro_step
    return {
        "turn": "g", "delivery": "auto", "shards": SERVE_SHARDS,
        "trainers": DIST_WORLD, "epochs": 1, "chaos": SERVE_ABORT_CHAOS,
        "move_after_rank0_batches": SERVE_ABORT_AFTER, "rank0_max_batch": 1,
        "migrate_error": failed["error"], "journal_kinds": kinds,
        "journal_replay": state.to_dict(),
        "shard_restarts": [sup.restarts for sup in sups],
        "restart_s": min(after) - failed["t"],
        "ranks": [{"rank": rank, "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "rows_per_s": runs[rank]["rows"] / runs[rank]["wall_s"],
                   "wall_s": runs[rank]["wall_s"],
                   "fill_s": runs[rank]["fill_s"], "digests_equal": True}
                  for rank in range(DIST_WORLD)],
        "rank0_micro_steps": int(all_losses.numel()),
        "rank0_loss_first": float(all_losses[0]),
        "rank0_loss_last": float(all_losses[-1]),
        "gather_launches": launches,
        "launches_per_micro_step": launches / all_losses.numel(),
    }


def serving_phase(emb, files, trained: dict, want, tmp: str) -> dict:
    """The queue service under the DLRM step: (a) fault-free and (b) one
    SIGKILL of the server mid-epoch 0, each over a supervised server
    process; (c) the loader alone under wire faults over an in-process
    server; (d) two supervised shard processes, one SIGKILLed, feeding
    rank 0's DLRM step through shared memory; (e) in-process shards,
    streamed and compressed; (f) a live move of rank 0 between in-process
    shards under its DLRM step; (g) a move whose source dies at the
    PREPARE, aborted, over supervised shard processes. Digests equal the
    ``train`` phase's in (a) and (b), (a)'s in (c), and the one-process
    ``num_trainers=2`` stream's (``want``) in (d)-(g)."""
    start = timeit.default_timer()
    fresh_telemetry()
    a = _served_dlrm_turn(emb, files, trained, tmp, "a", kill=False)
    b = _served_dlrm_turn(emb, files, trained, tmp, "b", kill=True)
    c = _served_loader_turn(files, trained["digests"], SERVE_WIRE_CHAOS)
    d = _served_shards_turn(emb, sorted(files), want, tmp)
    e = _sharded_loader_turn(sorted(files), want)
    t_f = timeit.default_timer()
    f = _live_move_turn(emb, sorted(files), want, tmp,
                        e["ranks"][0]["rows_per_s"])
    t_g = timeit.default_timer()
    f["turn_s"] = t_g - t_f
    g = _abort_turn(emb, sorted(files), want, tmp)
    g["turn_s"] = timeit.default_timer() - t_g
    return {
        "turns": {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f, "g": g},
        "rows_per_s_served_rank0": d["ranks"][0]["rows_per_s"],
        "rows_per_s_train_in_process": trained["rows_per_s"],
        "restart_s": {"b": b["restart_s"], "d": d["restart_s"],
                      "g": g["restart_s"]},
        "gather_launches": (a["gather_launches"] + b["gather_launches"]
                            + d["gather_launches"] + f["gather_launches"]
                            + g["gather_launches"]),
        "gather_launches_by_turn": {
            turn: line["gather_launches"]
            for turn, line in (("a", a), ("b", b), ("d", d), ("f", f),
                               ("g", g))},
        "phase_s": timeit.default_timer() - start,
    }


# Stream phase: a drifting click stream (the ``mlperf`` schema, labels
# drawn at a click rate that drifts with the file's position) in 2-file
# windows through the streaming runner into the DLRM step.
STREAM_FILES, STREAM_FILE_ROWS, STREAM_WINDOW_FILES = 16, 131072, 2
STREAM_WINDOWS = STREAM_FILES // STREAM_WINDOW_FILES
# (b): two shard processes, two trainers; shard 0 (rank 0's) is
# SIGKILLed as rank 0 takes its first batch of window 1.
STREAM_KILL_WINDOW = 1
# (c): the first runner's windows, and the files of the online model.
STREAM_RESUME_WINDOWS = 4
STREAM_ONLINE_FILES, STREAM_ONLINE_REDUCERS = 12, 2


def stream_files(tmp: str):
    """The drifting stream's files and the seconds their generation
    took."""
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo
    start = timeit.default_timer()
    files = dlrm_criteo.generate_drifting_stream(
        STREAM_FILES, STREAM_FILE_ROWS, os.path.join(tmp, "clicks"),
        seed=SEED)
    return files, timeit.default_timer() - start


def _stream_policy():
    from ray_shuffling_data_loader_tpu_torch import streaming
    return streaming.WindowPolicy(max_files=STREAM_WINDOW_FILES)


def _stream_source(files):
    from ray_shuffling_data_loader_tpu_torch import streaming
    return streaming.SyntheticEventSource(files, seed=SEED,
                                          total_events=len(files))


def _stream_reference(files, trainers: int):
    """Per rank, per window: the digests of the batches the stream's
    frozen schedule gives that rank when the port's ``shuffle_epochs``
    shuffles it on the host on threads (the key column loaded)."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     multiqueue, shuffle,
                                                     streaming)
    spec, _ = _sharded_spec()
    specs = streaming.freeze_schedule(_stream_source(files),
                                      policy=_stream_policy())
    queue = multiqueue.MultiQueue(len(specs) * trainers)
    result = shuffle.run_shuffle_epochs_in_background(
        specs, functools.partial(dataset.batch_consumer, queue, trainers),
        NUM_REDUCERS, trainers, seed=SEED,
        on_failure=dataset.make_failure_broadcaster(queue),
        executor_backend="thread", file_cache=None, epochs_hint=len(specs))
    digests = []
    for rank in range(trainers):
        ds = device_dataset.DeviceShufflingDataset(
            [], len(specs), trainers, LOADER_BATCH, rank, batch_queue=queue,
            shuffle_result=None, seed=SEED, drop_last=False, **spec)
        digests.append([])
        for window in range(len(specs)):
            ds.set_epoch(window)
            digests[rank].append([device_dataset.batch_digest(f, y)
                                  for f, y in ds])
        ds.close()
    result.result()
    queue.shutdown()
    return digests


def _segments(root: str) -> dict:
    """The process pool's cross-epoch table segments under ``root``: how
    many and their bytes."""
    paths = [os.path.join(d, name) for d, _, names in os.walk(root)
             for name in names
             if name.startswith("table_") and name.endswith(".arrow")]
    return {"files": len(paths),
            "bytes": sum(os.path.getsize(p) for p in paths)}


def _hist_delta(before: dict, after: dict, name: str) -> dict:
    """Count and mean (ms) of a histogram's observations between two
    parsed expositions."""
    count = (sum(after.get(f"{name}_count", {}).values())
             - sum(before.get(f"{name}_count", {}).values()))
    total = (sum(after.get(f"{name}_sum", {}).values())
             - sum(before.get(f"{name}_sum", {}).values()))
    return {"count": int(count),
            "mean_ms": total / count * 1e3 if count else None}


def _stream_in_process(emb, files, want, trained: dict, tmp: str) -> dict:
    """(a) A ``SyntheticEventSource`` over the stream feeds a
    ``StreamingShuffleRunner`` (2-file windows, 8 reducers, two windows in
    flight, the engine's default backend: the process pool here) into a
    ``MultiQueue``; a ``DeviceShufflingDataset(num_epochs=None)`` in the
    bulk binding reads it and a fresh DLRM ``mlperf`` trains every
    micro-step. Checks every key once, each window's digests against
    ``want`` (the host's thread shuffle of the frozen schedule), finite
    losses, one gather launch per micro-step, the serve watermark at the
    ingest watermark, and one batch wait per batch and window end."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     executor, multiqueue,
                                                     procpool, streaming,
                                                     train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics

    torch.cuda.empty_cache()
    spec, _ = _sharded_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    shm_root = "/dev/shm" if os.access("/dev/shm", os.W_OK) else tmp
    shm_dir = tempfile.mkdtemp(prefix="rsdl-smoke-stream-", dir=shm_root)
    queue = multiqueue.MultiQueue(STREAM_WINDOWS)
    lags, retained, holder = [], {}, {}

    def on_window_served(index: int) -> None:
        # The lag as the JAX package's bench samples it, in stream
        # seconds, and what the pool keeps once the last window drained.
        runner = holder["runner"]
        lags.append(max(0.0, runner.assembler.ingest_watermark
                        - runner.serve_watermark))
        if index == STREAM_WINDOWS - 1:
            retained.update(_segments(shm_dir))

    runner = streaming.StreamingShuffleRunner(
        _stream_source(files),
        functools.partial(dataset.batch_consumer, queue, 1),
        num_reducers=NUM_REDUCERS, num_trainers=1, seed=SEED,
        max_concurrent_epochs=2, policy=_stream_policy(),
        on_window_served=on_window_served)
    holder["runner"] = runner
    broadcast = dataset.make_failure_broadcaster(queue)
    pool_before = procpool.pool_totals()
    before = metrics.parse_exposition(metrics.render())
    digests = [[] for _ in range(STREAM_WINDOWS)]
    keys, losses, chunk_ms = [], [], []
    ds = None
    try:
        with _env(RSDL_EXECUTOR_SHM_DIR=shm_dir):
            t_start = timeit.default_timer()
            result = runner.run_in_background()

            def wake_on_failure():
                try:
                    result.result()
                except BaseException as e:  # noqa: BLE001 - to the queue
                    broadcast(e)

            threading.Thread(target=wake_on_failure, daemon=True,
                             name="smoke-stream-watch").start()
            ds = device_dataset.DeviceShufflingDataset(
                [], None, 1, LOADER_BATCH, 0, batch_queue=queue,
                shuffle_result=None, seed=SEED, drop_last=False,
                device=None, **spec)
            emb.reset_launch_counts()
            t_first = None
            for window in range(STREAM_WINDOWS):
                ds.set_epoch(window)
                for features, label in ds:
                    if t_first is None:
                        t_first = timeit.default_timer()
                    digests[window].append(
                        device_dataset.batch_digest(features, label))
                    keys.append(features[-1].reshape(-1).clone())
                    t0 = timeit.default_timer()
                    losses.append(train.train_chunk(
                        micro_step, features[:-1], label, MICROBATCH))
                    torch.cuda.synchronize()
                    chunk_ms.append((timeit.default_timer() - t0) * 1e3)
            t_end = timeit.default_timer()
            launches = emb.launch_counts["gather_rows"]
            t_close = timeit.default_timer()
            ds.close()
            close_s = timeit.default_timer() - t_close
            summary = result.result()
            backend = executor.last_worker_pool()["backend"]
    finally:
        if ds is not None:
            ds.close()
        runner.close()
        queue.shutdown()
        shutil.rmtree(shm_dir, ignore_errors=True)
    after = metrics.parse_exposition(metrics.render())
    pool_after = procpool.pool_totals()

    if backend != "process":
        raise AssertionError(f"stream (a): the runner's shuffle ran on the "
                             f"{backend} backend, not the process pool")
    all_keys = torch.cat(keys).cpu()
    if not torch.equal(torch.sort(all_keys).values,
                       torch.arange(STREAM_FILES * STREAM_FILE_ROWS)):
        raise AssertionError("stream (a): the keys are not each key once")
    for window in range(STREAM_WINDOWS):
        got = torch.stack(digests[window]).cpu()
        if not torch.equal(got, torch.stack(want[0][window]).cpu()):
            raise AssertionError(f"stream (a): window {window}'s digests "
                                 "differ from the host's thread shuffle")
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("stream (a): non-finite loss")
    steps = int(all_losses.numel())
    if steps != STREAM_FILES * STREAM_FILE_ROWS // MICROBATCH:
        raise AssertionError(f"stream (a): {steps} micro-steps")
    if launches != steps:
        raise AssertionError(f"stream (a): {launches} gather launches in "
                             f"{steps} micro-steps")
    if (summary["windows_served"] != STREAM_WINDOWS
            or summary["serve_watermark"] != summary["ingest_watermark"]):
        raise AssertionError(f"stream (a): the serve watermark did not "
                             f"reach the ingest watermark: {summary}")
    waits = ds.batch_wait_stats.wait_times
    batches = sum(len(d) for d in digests)
    if len(waits) != batches + STREAM_WINDOWS:
        raise AssertionError(f"stream (a): {len(waits)} batch waits for "
                             f"{batches} batches and {STREAM_WINDOWS} "
                             "window ends")
    wall = t_end - t_first
    latency = _latency_between(before, after, "birth_to_device")
    del model, micro_step
    return {
        "turn": "a", "windows": STREAM_WINDOWS,
        "window_files": STREAM_WINDOW_FILES, "binding": ds.binding,
        "executor_backend": backend, "max_concurrent_epochs": 2,
        "rows": int(all_keys.numel()), "loader_batches": batches,
        "micro_steps": steps,
        "rows_per_s": int(all_keys.numel()) / wall,
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "fill_s": t_first - t_start,
        "step_ms_median": float(np.median(chunk_ms)) / (LOADER_BATCH
                                                        // MICROBATCH),
        "train": {k: trained[k] for k in ("rows_per_s", "stall_pct",
                                          "step_ms_median")},
        "loss_first": float(all_losses[0]),
        "loss_last": float(all_losses[-1]),
        "gather_launches": launches,
        "launches_per_micro_step": launches / steps,
        "digests_equal": True, "keys_once": True,
        "summary": summary,
        "window_close": _hist_delta(before, after,
                                    "rsdl_stream_window_close_seconds"),
        "watermark_lag_s": lags,
        "birth_to_device": latency.get("0"),
        "pool_segments_after_last_window": retained,
        "pool": {k: pool_after[k] - pool_before[k]
                 for k in ("pools", "segment_cache_hits",
                           "segment_cache_bytes")},
        "close_s": close_s,
    }


def _stream_served(emb, files, want, tmp: str) -> dict:
    """(b) ``streaming.runner.server_config`` freezes the stream into a
    schedule (an ingest journal, the DLRM spec's cast); two supervised
    shard processes serve it to 2 trainers over handle frames. Rank 0
    trains every micro-step through a ``DeviceShufflingDataset(
    num_epochs=None)`` over ``connect_remote_queue(shard_map)`` while a
    thread drains rank 1; shard 0 is SIGKILLed as rank 0 takes its first
    batch of window 1. Checks each rank's digests against ``want`` (the
    one-process ``num_trainers=2`` stream of the schedule), shard 0
    restarted and shard 1 not, one gather launch per micro-step, no
    segment and no ledger byte left."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import (checkpoint, dataset,
                                                     device_dataset, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import supervisor
    from ray_shuffling_data_loader_tpu_torch.streaming import runner

    torch.cuda.empty_cache()
    spec, cast = _sharded_spec()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    tel_dir = os.path.join(tmp, "b-metrics")
    shm_root = "/dev/shm" if os.access("/dev/shm", os.W_OK) else tmp
    shm_dir = tempfile.mkdtemp(prefix="rsdl-smoke-stream-b-", dir=shm_root)
    handle_root = os.path.join(shm_dir, "handles")
    ingest = os.path.join(tmp, "b-ingest.wal")
    config = runner.server_config(
        _stream_source(files), num_trainers=DIST_WORLD,
        num_reducers=NUM_REDUCERS, journal_path=os.path.join(tmp, "b.wal"),
        seed=SEED, policy=_stream_policy(), ingest_journal_path=ingest,
        cast=cast, handle_dir=handle_root, num_workers=SERVE_SHARD_WORKERS,
        child_env={"RSDL_TELEMETRY_DIR": tel_dir,
                   "RSDL_METRICS_SHARD_INTERVAL_S": "0.5",
                   "RSDL_EXECUTOR_SHM_DIR": shm_dir})
    windows = len(config["epochs"])
    sealed = [e for e in checkpoint.StreamJournal.load(ingest)
              if e.get("kind") == "watermark"]
    t_launch = timeit.default_timer()
    sups, shard_map = supervisor.launch_supervised_queue_shards(
        config, SERVE_SHARDS, name="smoke-stream-shard")
    remotes, datasets, runs, errors, losses, killed = [], [], {}, [], [], {}
    try:
        for address in shard_map.addresses:
            if not supervisor.wait_for_server(tuple(address), timeout_s=120):
                raise AssertionError(f"stream (b): shard {address} never "
                                     "listened")
        listen_s = timeit.default_timer() - t_launch
        for rank in range(DIST_WORLD):
            remote = dataset.connect_remote_queue(
                shard_map, retries=20, initial_backoff_s=0.2,
                max_batch=1 if rank == 1 else 8)
            remotes.append(remote)
            datasets.append(device_dataset.DeviceShufflingDataset(
                [], None, DIST_WORLD, LOADER_BATCH, rank,
                batch_queue=remote, shuffle_result=None, seed=SEED,
                drop_last=False, device=None, **spec))
        fetches = _log_fetches(remotes[0].client_for_queue(
            plan_ir.queue_index(0, 0, DIST_WORLD)))

        def kill_shard_0(epoch, i):
            if epoch == STREAM_KILL_WINDOW and i == 0 and not killed:
                killed["t"] = timeit.default_timer()
                os.kill(sups[0].pid, signal.SIGKILL)
            return bool(killed)

        def drain_rank_1():
            try:
                runs[1] = _drain_rank(datasets[1], windows)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        emb.reset_launch_counts()
        drainer = threading.Thread(target=drain_rank_1, daemon=True,
                                   name="smoke-stream-rank1")
        drainer.start()
        runs[0] = _drain_rank(datasets[0], windows,
                              _train_every_micro_step(micro_step, losses,
                                                      kill_shard_0))
        launches = emb.launch_counts["gather_rows"]
        drainer.join(timeout=600)
        if drainer.is_alive():
            raise AssertionError("stream (b): rank 1's drain hung")
        if errors:
            raise errors[0]
        final_pids = [sup.pid for sup in sups]
    finally:
        for ds in datasets:
            ds.close()
        for remote in remotes:
            remote.close()
        for sup in sups:
            sup.stop()
        handle_files = [f for _, _, names in os.walk(handle_root)
                        for f in names]
        shutil.rmtree(shm_dir, ignore_errors=True)
    for rank in range(DIST_WORLD):
        _same_stream("stream (b)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("stream (b): non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(f"stream (b): {launches} gather launches in "
                             f"{all_losses.numel()} micro-steps")
    if sups[0].restarts < 1 or sups[0].failed:
        raise AssertionError("stream (b): shard 0 was not restarted")
    if sups[1].restarts:
        raise AssertionError(f"stream (b): shard 1 restarted "
                             f"{sups[1].restarts} times")
    if handle_files:
        raise AssertionError(f"stream (b): segments left after the stop: "
                             f"{handle_files[:4]}")
    # Shard 1 served on: nothing may be left at its exit. The restarted
    # shard 0 holds, at its exit, the tables it regenerated for windows
    # rank 0 had already taken: a queue's last batch (the one with its
    # end sentinel) is never acked, in either package, so its journal
    # records no finished queue and the restart re-derives from window 0.
    # Reported beside its journal, not held to 0.
    ledger = _exit_ledger_bytes(tel_dir, final_pids)
    if ledger.get(final_pids[1]) != 0:
        raise AssertionError(f"stream (b): buffer-ledger bytes at shard "
                             f"1's exit: {ledger}")
    shard0_journal = checkpoint.WatermarkJournal.load(
        checkpoint.shard_journal_path(config["journal_path"], 0,
                                      SERVE_SHARDS))
    if len(sealed) != windows:
        raise AssertionError(f"stream (b): {len(sealed)} windows journaled "
                             f"for a schedule of {windows}")
    after_kill = [t for t, resumed, n in fetches
                  if t > killed["t"] and resumed and n]
    if not after_kill:
        raise AssertionError("stream (b): no frame came after the kill")
    server = _server_counters(tel_dir)
    del model, micro_step
    return {
        "turn": "b", "delivery": "auto", "shards": SERVE_SHARDS,
        "trainers": DIST_WORLD, "windows": windows,
        "shard_workers": SERVE_SHARD_WORKERS,
        "kill": f"shard 0 at rank 0's first batch of window "
                f"{STREAM_KILL_WINDOW}",
        "ranks": [{"rank": rank, "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "rows_per_s": runs[rank]["rows"] / runs[rank]["wall_s"],
                   "wall_s": runs[rank]["wall_s"],
                   "fill_s": runs[rank]["fill_s"], "digests_equal": True}
                  for rank in range(DIST_WORLD)],
        "rank0_micro_steps": int(all_losses.numel()),
        "rank0_max_wait_after_kill_s": runs[0]["max_wait_after_s"],
        "restart_s": min(after_kill) - killed["t"],
        "shard_restarts": [sup.restarts for sup in sups],
        "shards_listen_s": listen_s,
        "frames_replayed": server["frames_replayed"],
        "server": server,
        "gather_launches": launches,
        "launches_per_micro_step": launches / all_losses.numel(),
        "segments_left": 0, "exit_ledger_bytes": list(ledger.values()),
        "shard0_journal": {q: {"seq": e.seq, "rows": e.rows, "done": e.done}
                           for q, e in sorted(shard0_journal.items())},
    }


def _stream_resume(files, tmp: str) -> dict:
    """(c) Loader only: a runner over an ingest journal for 4 windows,
    dropped; a new runner over the same journal and a fresh source skips
    the 8 sealed events and goes on at epoch 4. Every key once across the
    two. Then the online model over the first 12 files, twice: the same
    history."""
    from ray_shuffling_data_loader_tpu_torch import streaming
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    journal = os.path.join(tmp, "c-ingest.wal")
    keys = {}

    def collect(rank, epoch, refs):
        if refs is None:
            return
        for ref in refs:
            keys.setdefault(epoch, []).append(
                ref.result().column("key").to_numpy())

    start = timeit.default_timer()
    first = streaming.StreamingShuffleRunner(
        _stream_source(files), collect, num_reducers=NUM_REDUCERS,
        num_trainers=1, seed=SEED, policy=_stream_policy(),
        journal_path=journal, max_windows=STREAM_RESUME_WINDOWS)
    first_summary = first.run()
    first.close()
    second = streaming.StreamingShuffleRunner(
        _stream_source(files), collect, num_reducers=NUM_REDUCERS,
        num_trainers=1, seed=SEED, policy=_stream_policy(),
        journal_path=journal)
    skip = second.resume_skip_events
    second_summary = second.run()
    second.close()
    runners_s = timeit.default_timer() - start
    if skip != STREAM_RESUME_WINDOWS * STREAM_WINDOW_FILES:
        raise AssertionError(f"stream (c): resume skipped {skip} events")
    if sorted(keys) != list(range(STREAM_WINDOWS)):
        raise AssertionError(f"stream (c): epochs {sorted(keys)}")
    flat = np.sort(np.concatenate([k for e in sorted(keys)
                                   for k in keys[e]]))
    if not np.array_equal(flat, np.arange(STREAM_FILES * STREAM_FILE_ROWS)):
        raise AssertionError("stream (c): the keys across the two runners "
                             "are not each key once")
    t0 = timeit.default_timer()
    history = dlrm_criteo.run_online_training(
        files[:STREAM_ONLINE_FILES],
        num_windows=STREAM_ONLINE_FILES // STREAM_WINDOW_FILES,
        files_per_window=STREAM_WINDOW_FILES, seed=SEED,
        num_reducers=STREAM_ONLINE_REDUCERS)
    online_s = timeit.default_timer() - t0
    again = dlrm_criteo.run_online_training(
        files[:STREAM_ONLINE_FILES],
        num_windows=STREAM_ONLINE_FILES // STREAM_WINDOW_FILES,
        files_per_window=STREAM_WINDOW_FILES, seed=SEED,
        num_reducers=STREAM_ONLINE_REDUCERS)
    if again != history:
        raise AssertionError("stream (c): the online model's history "
                             "differs between two runs")
    return {
        "turn": "c", "resume_skip_events": skip,
        "first_windows": first_summary["windows_served"],
        "second_epochs": sorted(e for e in keys
                                if e >= STREAM_RESUME_WINDOWS),
        "second_summary": {k: v for k, v in second_summary.items()
                           if k not in ("duration_s", "shuffle_s")},
        "keys_once": True, "runners_s": runners_s,
        "online_history": history, "online_s": online_s,
        "online_same_twice": True,
    }


def stream_phase(emb, trained: dict, tmp: str) -> dict:
    """The streaming plane: (a) in process under the DLRM step, (b)
    served by two supervised shard processes with one killed at a window
    boundary, (c) the runner's resume over its ingest journal and the
    online model, on the drifting click stream."""
    start = timeit.default_timer()
    fresh_telemetry()
    files, gen_s = stream_files(tmp)
    t_ref = timeit.default_timer()
    want_one = _stream_reference(files, 1)
    want_two = _stream_reference(files, DIST_WORLD)
    ref_s = timeit.default_timer() - t_ref
    a = _stream_in_process(emb, files, want_one, trained, tmp)
    b = _stream_served(emb, files, want_two, tmp)
    c = _stream_resume(files, tmp)
    return {
        "files": STREAM_FILES, "rows_per_file": STREAM_FILE_ROWS,
        "datagen_s": gen_s, "reference_s": ref_s,
        "turns": {"a": a, "b": b, "c": c},
        "rows_per_s": a["rows_per_s"], "stall_pct": a["stall_pct"],
        "step_ms_median": a["step_ms_median"],
        "restart_s": b["restart_s"],
        "gather_launches": a["gather_launches"] + b["gather_launches"],
        "gather_launches_by_turn": {"a": a["gather_launches"],
                                    "b": b["gather_launches"]},
        "phase_s": timeit.default_timer() - start,
    }


# Tenancy phase: two tenants on one serving plane, as the JAX package's
# ``bench.py`` tenancy leg sets them: ``hot`` (interactive, weight 3,
# rank 0) and ``cold`` (batch, weight 1, rank 1).
TENANT_HOT_WEIGHT, TENANT_COLD_WEIGHT = 3.0, 1.0
TENANT_TABLE = {
    "hot": {"weight": TENANT_HOT_WEIGHT, "priority": "interactive",
            "ranks": [0]},
    "cold": {"weight": TENANT_COLD_WEIGHT, "priority": "batch",
             "ranks": [1]},
}
# (a): the JAX leg's protocol: 2 files, 128 reducers, 3 pre-filled
# epochs, greedy clients of max_batch 128, the round robin's quantum
# pinned to 16 frame estimates (2.5x the files' bytes over the frames),
# and its band: hot over cold rows within 35 % of the weight ratio.
TENANT_FAIR_FILES, TENANT_FAIR_REDUCERS, TENANT_FAIR_EPOCHS = 2, 128, 3
TENANT_FAIR_MAX_BATCH, TENANT_FAIR_QUANTUM_FRAMES = 128, 16
TENANT_FAIR_BAND = 0.35
# (b): the cold tenant replays this many pre-filled epochs of rank 1.
TENANT_COLD_EPOCHS = 3
# (d): the storage turn's files per tenant and quotas, in files.
TENANT_STORE_HOT_FILES, TENANT_STORE_COLD_FILES = 2, 6
TENANT_STORE_COLD_QUOTA_FILES = 2
TENANT_LATENCY = "rsdl_tenant_delivery_latency_seconds"


def _tenant_contexts():
    from ray_shuffling_data_loader_tpu_torch import tenancy
    return {t: tenancy.TenantContext(t, priority=spec["priority"],
                                     weight=spec["weight"])
            for t, spec in TENANT_TABLE.items()}


def _tenant_latency(before: dict, after: dict, tenant: str,
                    hop: str = "queued_to_delivered") -> dict:
    """Count, p50 and p99 (ms) of a tenant's delivery latency at ``hop``
    (``queued_to_delivered`` by default: the JAX bench's reading), from
    the clients' sketch in this process between two parsed
    expositions."""
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics
    name = f"{TENANT_LATENCY}_centroid"
    earlier = before.get(name, {})
    diff = {labels: value - earlier.get(labels, 0.0)
            for labels, value in after.get(name, {}).items()
            if value > earlier.get(labels, 0.0)}
    got = metrics.sketch_quantiles({name: diff}, TENANT_LATENCY,
                                   qs=(0.5, 0.99), tenant=tenant, hop=hop)
    if not got:
        return {"count": 0, "p50_ms": None, "p99_ms": None}
    (q,) = got.values()
    return {"count": int(q["count"]), "p50_ms": q["p50"] * 1e3,
            "p99_ms": q["p99"] * 1e3}


def _tenant_bytes(samples: dict, name: str) -> dict:
    return {dict(labels)["tenant"]: value
            for labels, value in samples.get(name, {}).items()
            if "tenant" in dict(labels)}


def _ack_last_batches(server) -> None:
    """Ack what an in-process server sent. A client acks a queue's frames
    on its next GET of that queue, so the batch that ended each queue
    stays unacked (and charged to its tenant) until this."""
    with server._states_lock:
        states = dict(server._states)
    for queue_idx, state in states.items():
        with state.lock:
            if state.sent_seq > state.acked_seq:
                server._apply_ack(queue_idx, state, state.sent_seq)


def _refs_by_queue(files, epochs: int, reducers: int, trainers: int,
                   map_transform=None) -> dict:
    """One seeded shuffle, held outside any queue as ``{queue index: [ref,
    ..., None]}``, so a turn can pre-fill the queues it wants (threads, no
    file cache)."""
    from ray_shuffling_data_loader_tpu_torch import shuffle
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    refs: dict = {}

    def consumer(rank, epoch, batch):
        items = refs.setdefault(plan_ir.queue_index(epoch, rank, trainers),
                                [])
        items.extend([None] if batch is None else batch)

    shuffle.shuffle(list(files), consumer, epochs, reducers, trainers,
                    max_concurrent_epochs=epochs, seed=SEED,
                    map_transform=map_transform, file_cache=None,
                    executor_backend="thread")
    return refs


def _tenant_fairness(files) -> dict:
    """(a) One in-process ``serve_queue(tenants=)`` over 3 pre-filled
    epochs of both ranks; both tenants drain greedily through
    ``RemoteQueue(tenant=, max_batch=128)``. Hot's rows over cold's at the
    moment hot finishes, beside the weight ratio and the JAX leg's band;
    each tenant's delivered bytes, and the replay ledgers at 0 after the
    last acks."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, multiqueue,
                                                     multiqueue_service)
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics

    leg_files = sorted(files)[:TENANT_FAIR_FILES]
    trainers = DIST_WORLD
    t0 = timeit.default_timer()
    refs = _refs_by_queue(leg_files, TENANT_FAIR_EPOCHS, TENANT_FAIR_REDUCERS,
                          trainers)
    shuffle_s = timeit.default_timer() - t0
    frame_est = max(1, int(2.5 * sum(os.path.getsize(f) for f in leg_files))
                    // (trainers * TENANT_FAIR_REDUCERS))
    quantum = TENANT_FAIR_QUANTUM_FRAMES * frame_est
    queue = multiqueue.MultiQueue(TENANT_FAIR_EPOCHS * trainers)
    for queue_idx, items in refs.items():
        queue.put_batch(queue_idx, items)
    contexts = _tenant_contexts()
    counts = {"hot": 0, "cold": 0}
    fetches = {}
    errors, gate = [], threading.Event()
    hot_done = threading.Event()
    before = metrics.parse_exposition(metrics.render())

    def drain(rank: int, tenant: str, server, done=None):
        try:
            gate.wait(timeout=60)
            with multiqueue_service.RemoteQueue(
                    server.address, max_batch=TENANT_FAIR_MAX_BATCH,
                    num_trainers=trainers,
                    tenant=contexts[tenant]) as remote:
                fetches[tenant] = _log_fetches(remote)
                for epoch in range(TENANT_FAIR_EPOCHS):
                    queue_idx = plan_ir.queue_index(epoch, rank, trainers)
                    while True:
                        item = remote.get(queue_idx)
                        if item is None:
                            break
                        if isinstance(item, dataset.ShuffleFailure):
                            raise AssertionError(f"tenancy (a): {item}")
                        counts[tenant] += item.num_rows
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            if done is not None:
                done.set()

    with _env(RSDL_QUEUE_TENANT_DRR_QUANTUM_BYTES=str(quantum)):
        with multiqueue_service.serve_queue(
                queue, num_trainers=trainers,
                tenants=TENANT_TABLE) as server:
            threads = [threading.Thread(target=drain,
                                        args=(0, "hot", server, hot_done),
                                        daemon=True, name="smoke-ten-hot"),
                       threading.Thread(target=drain,
                                        args=(1, "cold", server),
                                        daemon=True, name="smoke-ten-cold")]
            for thread in threads:
                thread.start()
            t_start = timeit.default_timer()
            gate.set()
            if not hot_done.wait(timeout=300):
                raise AssertionError("tenancy (a): the hot drain hung")
            hot_s = timeit.default_timer() - t_start
            cold_at_hot_finish = counts["cold"]
            for thread in threads:
                thread.join(timeout=300)
                if thread.is_alive():
                    raise AssertionError("tenancy (a): a drain hung")
            drain_s = timeit.default_timer() - t_start
            if errors:
                raise errors[0]
            held = dict(server._tenant_replay)
            _ack_last_batches(server)
            settled = dict(server._tenant_replay)
    queue.shutdown()
    after = metrics.parse_exposition(metrics.render())
    rows = TENANT_FAIR_EPOCHS * sum(_parquet_rows(f) for f in leg_files)
    if counts["hot"] + counts["cold"] != rows:
        raise AssertionError(f"tenancy (a): {counts} rows for {rows}")
    if any(settled.get(t, 0) != 0 for t in TENANT_TABLE):
        raise AssertionError(f"tenancy (a): replay ledgers after the last "
                             f"acks: {settled}")
    delivered_before = _tenant_bytes(before,
                                     "rsdl_tenant_bytes_delivered_total")
    delivered = {t: v - delivered_before.get(t, 0.0) for t, v in
                 _tenant_bytes(after,
                               "rsdl_tenant_bytes_delivered_total").items()
                 if t in TENANT_TABLE}
    weight_ratio = TENANT_HOT_WEIGHT / TENANT_COLD_WEIGHT
    fairness = counts["hot"] / max(1, cold_at_hot_finish)
    return {
        "turn": "a", "files": len(leg_files),
        "reducers": TENANT_FAIR_REDUCERS, "epochs": TENANT_FAIR_EPOCHS,
        "max_batch": TENANT_FAIR_MAX_BATCH, "frame_estimate_bytes": frame_est,
        "drr_quantum_bytes": quantum, "shuffle_s": shuffle_s,
        "weight_ratio": weight_ratio, "fairness_ratio": fairness,
        "fairness_band": TENANT_FAIR_BAND,
        "fairness_ok": abs(fairness / weight_ratio - 1.0) <= TENANT_FAIR_BAND,
        "hot_rows": counts["hot"],
        "cold_rows_at_hot_finish": cold_at_hot_finish,
        "hot_s": hot_s, "drain_s": drain_s,
        "hot_rows_per_s": counts["hot"] / hot_s,
        "cold_rows_per_s_while_hot": cold_at_hot_finish / hot_s,
        "bytes_delivered": delivered,
        "replay_bytes_before_last_acks": held,
        "replay_bytes_after_last_acks": settled,
        "hot_latency": _tenant_latency(before, after, "hot"),
        "hot_birth_latency": _tenant_latency(before, after, "hot",
                                             "birth_to_delivered"),
        "cold_latency": _tenant_latency(before, after, "cold"),
        "gets": {t: _get_sizes(fetches[t], t_start + hot_s)
                 for t in TENANT_TABLE},
    }


def _get_sizes(fetches, t_split: float) -> dict:
    """A client's round trips (``_log_fetches``): how many, the frames
    they brought, how many brought one frame (the scheduler's floor) and
    the most in one, before and after ``t_split``."""
    def sizes(frames):
        return {"gets": len(frames), "frames": sum(frames),
                "one_frame": sum(1 for n in frames if n == 1),
                "max_frames": max(frames, default=0)}
    return {"before_hot_finish": sizes([n for t, _, n in fetches
                                        if t <= t_split]),
            "after": sizes([n for t, _, n in fetches if t > t_split])}


def _parquet_rows(path: str) -> int:
    import pyarrow.parquet as pq
    return pq.ParquetFile(path).metadata.num_rows


def _cold_replay(address, contexts, epochs: int, out: dict,
                 errors: list, gate: threading.Event) -> None:
    """The cold tenant's host thread: drain rank 1's ``epochs`` greedily
    through ``RemoteQueue(tenant=cold)``, count its rows and keep epoch 0's
    keys."""
    from ray_shuffling_data_loader_tpu_torch import (data_generation, dataset,
                                                     multiqueue_service)
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    try:
        gate.wait(timeout=60)
        rows, keys = 0, []
        t0 = timeit.default_timer()
        with multiqueue_service.RemoteQueue(
                address, num_trainers=DIST_WORLD,
                tenant=contexts["cold"]) as remote:
            for epoch in range(epochs):
                queue_idx = plan_ir.queue_index(epoch, 1, DIST_WORLD)
                while True:
                    item = remote.get(queue_idx)
                    if item is None:
                        break
                    if isinstance(item, dataset.ShuffleFailure):
                        raise AssertionError(f"tenancy (b) cold: {item}")
                    rows += item.num_rows
                    if epoch == 0:
                        keys.append(item.column(
                            data_generation.KEY_COLUMN).to_numpy())
        out.update(rows=rows, seconds=timeit.default_timer() - t0,
                   keys0=np.concatenate(keys))
    except BaseException as e:  # noqa: BLE001 - raised by the caller
        errors.append(e)


def _warm_up(files, micro_step, refs) -> float:
    """Train the first loader batch of rank 0's first table in process,
    so that (b)'s two turns both time a warm step (a fresh model's first
    micro-steps allocate Adam's state and load the kernels)."""
    from ray_shuffling_data_loader_tpu_torch import (device_dataset,
                                                     multiqueue)
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    spec, _ = _sharded_spec()
    start = timeit.default_timer()
    queue = multiqueue.MultiQueue(DIST_WORLD)
    hot_queue = plan_ir.queue_index(0, 0, DIST_WORLD)
    queue.put_batch(hot_queue, [refs[hot_queue][0], None])
    ds = device_dataset.DeviceShufflingDataset(
        files, 1, DIST_WORLD, LOADER_BATCH, 0, batch_queue=queue,
        shuffle_result=None, seed=SEED, drop_last=False, device=None,
        **spec)
    try:
        ds.set_epoch(0)
        features, label = next(iter(ds))
        _train_every_micro_step(micro_step, [])(0, 0, features, label)
        torch.cuda.synchronize()
    finally:
        ds.close()
        queue.shutdown()
    return timeit.default_timer() - start


def _hot_step_turn(emb, files, micro_step, refs, want, contended: bool
                   ) -> dict:
    """(b) One turn of the hot tenant's DLRM step on the card: an
    in-process ``serve_queue(tenants=)`` holds rank 0's epoch 0 (and, when
    ``contended``, rank 1's 3 epochs, which the cold tenant's host thread
    replays greedily meanwhile); rank 0's ``DeviceShufflingDataset`` reads
    ``connect_remote_queue(addr, tenant=hot)`` and trains every micro-step
    (Adam). Digests equal the one-process ``num_trainers=2`` stream's."""
    from ray_shuffling_data_loader_tpu_torch import (dataset, device_dataset,
                                                     multiqueue,
                                                     multiqueue_service,
                                                     train)
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics

    name = "contended" if contended else "solo"
    spec, _ = _sharded_spec()
    contexts = _tenant_contexts()
    queue = multiqueue.MultiQueue(TENANT_COLD_EPOCHS * DIST_WORLD)
    hot_queue = plan_ir.queue_index(0, 0, DIST_WORLD)
    queue.put_batch(hot_queue, refs[hot_queue])
    if contended:
        for epoch in range(TENANT_COLD_EPOCHS):
            cold_queue = plan_ir.queue_index(epoch, 1, DIST_WORLD)
            queue.put_batch(cold_queue, refs[cold_queue])
    cold, errors, gate = {}, [], threading.Event()
    digests, keys, losses, chunk_ms = [], [], [], []
    before = metrics.parse_exposition(metrics.render())
    ds = remote = None
    with multiqueue_service.serve_queue(queue, num_trainers=DIST_WORLD,
                                        tenants=TENANT_TABLE) as server:
        try:
            remote = dataset.connect_remote_queue(
                server.address, num_trainers=DIST_WORLD,
                tenant=contexts["hot"])
            fetches = _log_fetches(remote)
            ds = device_dataset.DeviceShufflingDataset(
                files, 1, DIST_WORLD, LOADER_BATCH, 0, batch_queue=remote,
                shuffle_result=None, seed=SEED, drop_last=False,
                device=None, **spec)
            thread = None
            if contended:
                thread = threading.Thread(
                    target=_cold_replay,
                    args=(server.address, contexts, TENANT_COLD_EPOCHS, cold,
                          errors, gate),
                    daemon=True, name="smoke-ten-cold-replay")
                thread.start()
            emb.reset_launch_counts()
            t_start = timeit.default_timer()
            gate.set()
            ds.set_epoch(0)
            t_first = None
            for features, label in ds:
                if t_first is None:
                    t_first = timeit.default_timer()
                digests.append(device_dataset.batch_digest(features, label))
                keys.append(features[-1].reshape(-1).clone())
                n = label.shape[0] // MICROBATCH * MICROBATCH
                if n:  # a batch's tail of fewer rows is not trained
                    t0 = timeit.default_timer()
                    losses.append(train.train_chunk(
                        micro_step, [f[:n] for f in features[:-1]],
                        label[:n], MICROBATCH))
                    torch.cuda.synchronize()
                    chunk_ms.append((timeit.default_timer() - t0) * 1e3
                                    / (n // MICROBATCH))
            t_end = timeit.default_timer()
            launches = emb.launch_counts["gather_rows"]
            if thread is not None:
                thread.join(timeout=300)
                if thread.is_alive():
                    raise AssertionError("tenancy (b): the cold replay hung")
            if errors:
                raise errors[0]
            waits = list(ds.batch_wait_stats.wait_times)
        finally:
            if ds is not None:
                ds.close()
            if remote is not None:
                remote.close()
        held = dict(server._tenant_replay)
        _ack_last_batches(server)
        settled = dict(server._tenant_replay)
        leases = sorted(lease.tenant for lease in server._leases.values())
    queue.shutdown()
    after = metrics.parse_exposition(metrics.render())
    _same_stream(f"tenancy (b) {name}", 0,
                 torch.stack(digests).cpu().numpy(), want[0][:1])
    hot_keys = torch.cat(keys).cpu().numpy()
    if len(np.unique(hot_keys)) != len(hot_keys):
        raise AssertionError(f"tenancy (b) {name}: a key came twice")
    if contended:
        every = np.sort(np.concatenate([hot_keys, cold["keys0"]]))
        if not np.array_equal(every, np.arange(NUM_ROWS)):
            raise AssertionError("tenancy (b): hot's and cold's epoch-0 "
                                 "keys are not each key once")
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError(f"tenancy (b) {name}: non-finite loss")
    steps = int(all_losses.numel())
    if launches != steps:
        raise AssertionError(f"tenancy (b) {name}: {launches} gather "
                             f"launches in {steps} micro-steps")
    if leases != (["cold", "hot"] if contended else ["hot"]):
        raise AssertionError(f"tenancy (b) {name}: leases bound to "
                             f"{leases}")
    if any(v != 0 for v in settled.values()):
        raise AssertionError(f"tenancy (b) {name}: replay ledgers after "
                             f"the last acks: {settled}")
    wall = t_end - t_first
    rows = len(hot_keys)
    line = {
        "turn": f"b_{name}", "binding": ds.binding,
        "rows": rows, "loader_batches": len(digests),
        "micro_steps": steps, "rows_per_s": rows / wall, "wall_s": wall,
        "fill_s": t_first - t_start,
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "step_ms_median": float(np.median(chunk_ms)),
        "hot_latency": _tenant_latency(before, after, "hot"),
        "hot_birth_latency": _tenant_latency(before, after, "hot",
                                             "birth_to_delivered"),
        "hot_frames_per_get": [n for _, _, n in fetches],
        "loss_first": float(all_losses[0]),
        "loss_last": float(all_losses[-1]),
        "gather_launches": launches,
        "launches_per_micro_step": launches / steps,
        "digests_equal": True, "keys_once": True, "leases": leases,
        "replay_bytes_before_last_acks": held,
    }
    if contended:
        line.update(cold_rows=cold["rows"], cold_s=cold["seconds"],
                    cold_rows_per_s=cold["rows"] / cold["seconds"])
    return line


# (e) The rebalance trigger: the ring ticks every TRIGGER_INTERVAL_S over
# this process's registry; the SLO is TRIGGER_SLO_SHARE of the hot
# tenant's birth_to_delivered p99 that (b) solo measured on the same
# tables, which this turn delivers later still.
TRIGGER_INTERVAL_S, TRIGGER_WINDOW, TRIGGER_CLEAR_TICKS = 0.1, 8, 50
TRIGGER_SLO_SHARE = 0.5


def _trigger_turn(emb, files, micro_step, refs, want, b_p99_s: float,
                  tmp: str) -> dict:
    """(e) Tenant-bound clients over ``serve_queue_sharded(num_shards=2,
    tenants=)`` holding rank 0's (hot) and rank 1's (cold) epoch 0; the
    hot tenant's DLRM step trains every micro-step of rank 0; a
    ``RebalanceController`` with a journal at ``rebalance_slo_p99_s`` below
    (b)'s p99; a live ``HistoryRing`` on the watchdog and
    ``rebalance.slo_trigger`` (``tenant_delivery_slo`` alone), whose fire
    migrates rank 0 to shard 1 under the step. Cold drains rank 1 once the
    move has committed. Checks one fire naming hot, one committed move,
    the journal's replay, the consumer's map, each rank's digests against
    the reference and one gather launch per micro-step."""
    from ray_shuffling_data_loader_tpu_torch import (
        dataset, device_dataset, multiqueue, multiqueue_service, rebalance)
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import (history,
                                                             watchdog)

    start = timeit.default_timer()
    spec, _ = _sharded_spec()
    contexts = _tenant_contexts()
    slo_s = TRIGGER_SLO_SHARE * b_p99_s
    queue = multiqueue.MultiQueue(DIST_WORLD)
    for rank in range(DIST_WORLD):
        q = plan_ir.queue_index(0, rank, DIST_WORLD)
        queue.put_batch(q, refs[q])
    journal = os.path.join(tmp, "e-rebalance.journal")
    counters_before = _rebalance_counters()
    ring = history.HistoryRing(capacity=1200, interval_s=TRIGGER_INTERVAL_S)
    wd = watchdog.get_watchdog()
    runs, errors, losses, phases = {}, [], [], {}
    remotes, datasets = [], []
    monitor = periodic = None
    sharded = multiqueue_service.serve_queue_sharded(
        queue, num_shards=SERVE_SHARDS, num_trainers=DIST_WORLD,
        tenants=TENANT_TABLE)
    controller = rebalance.RebalanceController(
        sharded.shard_map, journal_path=journal, rebalance_slo_p99_s=slo_s)

    def rank_dataset(rank: int, tenant: str, max_batch: int):
        # Each rank's own copy of the map: rank 0's follows the move.
        remotes.append(dataset.connect_remote_queue(
            plan_ir.ShardMap.from_json(sharded.shard_map.to_json()),
            retries=20, initial_backoff_s=0.2, tenant=contexts[tenant],
            max_batch=max_batch))
        datasets.append(device_dataset.DeviceShufflingDataset(
            files, 1, DIST_WORLD, LOADER_BATCH, rank,
            batch_queue=remotes[-1], shuffle_result=None, seed=SEED,
            drop_last=False, device=None, **spec))
        return datasets[-1], remotes[-1]

    try:
        ring.tick()  # the window's base: before any delivery
        monitor = rebalance.slo_trigger(
            ring, controller, 0, target=1, fire_ticks=2,
            clear_ticks=TRIGGER_CLEAR_TICKS, phases=phases,
            slo_droop_window_ticks=TRIGGER_WINDOW)
        periodic = wd.every(TRIGGER_INTERVAL_S, ring.tick,
                            name="smoke-trigger-ring")

        def drain_cold():
            # Cold's client starts once the move has committed, so that
            # the window the fire judges holds hot's frames alone.
            try:
                deadline = timeit.default_timer() + 120
                while controller.moves_total < 1 and \
                        timeit.default_timer() < deadline:
                    time.sleep(0.05)
                runs[1] = _drain_rank(rank_dataset(1, "cold", 8)[0], 1)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        hot_ds, hot_remote = rank_dataset(0, "hot", SERVE_MOVE_MAX_BATCH)
        emb.reset_launch_counts()
        drainer = threading.Thread(target=drain_cold, daemon=True,
                                   name="smoke-ten-e-cold")
        drainer.start()
        runs[0] = _drain_rank(hot_ds, 1,
                              _train_every_micro_step(micro_step, losses))
        launches = emb.launch_counts["gather_rows"]
        drainer.join(timeout=300)
        if drainer.is_alive():
            raise AssertionError("tenancy (e): cold's drain hung")
        if errors:
            raise errors[0]
        client_map = hot_remote.shard_map
    finally:
        if periodic is not None:
            wd.cancel(periodic)
        if monitor is not None:
            monitor.detach()
        for ds in datasets:
            ds.close()
        for remote in remotes:
            remote.close()
        controller.close()
        sharded.close()
        queue.shutdown()
    counters = {k: v - counters_before[k]
                for k, v in _rebalance_counters().items()}
    summary = monitor.summary()
    fired = summary["detectors"]["tenant_delivery_slo"]
    if monitor.total_fires != 1 or "tenant hot " not in \
            fired.get("last", {}).get("detail", ""):
        raise AssertionError(f"tenancy (e): expected one fire naming hot: "
                             f"{summary}")
    if counters["moves_total"] != 1 or controller.moves_total != 1:
        raise AssertionError(f"tenancy (e): {counters['moves_total']} "
                             "moves committed")
    replayed = rebalance.replay(journal)
    if (replayed.overrides, replayed.pending) != (((0, 1),), None):
        raise AssertionError(f"tenancy (e): the journal replays to "
                             f"{replayed}")
    reasons = [r["decision"].reason
               for r in rebalance.RebalanceJournal.load(journal)
               if r["decision"].kind == "commit"]
    if (client_map.overrides, client_map.generation) != ({0: 1}, 1):
        raise AssertionError(f"tenancy (e): rank 0's map reads "
                             f"{client_map.to_dict()}: the move missed "
                             "its stream")
    for rank in range(DIST_WORLD):
        _same_stream("tenancy (e)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank][:1])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("tenancy (e): non-finite loss")
    steps = int(all_losses.numel())
    if launches != steps:
        raise AssertionError(f"tenancy (e): {launches} gather launches in "
                             f"{steps} micro-steps")
    return {
        "turn": "e_trigger", "shards": SERVE_SHARDS,
        "interval_s": TRIGGER_INTERVAL_S, "window_ticks": TRIGGER_WINDOW,
        "b_solo_birth_p99_s": b_p99_s, "rebalance_slo_p99_s": slo_s,
        "fire_p99_s": fired["last"]["value"],
        "fire_detail": fired["last"]["detail"], "fires": 1,
        "ticks": ring.ticks, "commit_reason": reasons,
        "journal_replay": replayed.to_dict(),
        "shard_map_after": client_map.to_dict(),
        "phase_ms": {k.replace("_s", "_ms"): v * 1e3
                     for k, v in phases.items() if k.endswith("_s")},
        "manifest_frames": phases.get("manifest_frames"),
        "rebalance": counters,
        "ranks": [{"rank": rank, "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "wall_s": runs[rank]["wall_s"], "digests_equal": True}
                  for rank in range(DIST_WORLD)],
        "rank0_micro_steps": steps,
        "rank0_rows_per_s": runs[0]["rows"] / runs[0]["wall_s"],
        "gather_launches": launches,
        "launches_per_micro_step": launches / steps,
        "turn_s": timeit.default_timer() - start,
    }


def _tenant_shard_kill(emb, files, micro_step, want, tmp: str) -> dict:
    """(c) ``launch_supervised_queue_shards`` with ``config["tenants"]``, 2
    shards, one epoch: rank 0 (hot) trains every micro-step through
    ``connect_remote_queue(shard_map, tenant=hot)``; shard 0's process is
    SIGKILLed after rank 0's first loader batch; then a thread drains rank
    1 (cold) on the untouched shard 1. Each tenant's digests equal the
    one-process reference's (exactly once, bit for bit); no segment and
    no ledger byte left."""
    import signal

    from ray_shuffling_data_loader_tpu_torch import dataset, device_dataset
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics, supervisor

    spec, cast = _sharded_spec()
    contexts = _tenant_contexts()
    tel_dir = os.path.join(tmp, "c-metrics")
    shm_root = "/dev/shm" if os.access("/dev/shm", os.W_OK) else tmp
    shm_dir = tempfile.mkdtemp(prefix="rsdl-smoke-tenancy-", dir=shm_root)
    handle_root = os.path.join(shm_dir, "handles")
    config = dict(filenames=list(files), num_epochs=1,
                  num_trainers=DIST_WORLD, num_reducers=NUM_REDUCERS,
                  seed=SEED, journal_path=os.path.join(tmp, "c.wal"),
                  cast=cast, handle_dir=handle_root,
                  num_workers=SERVE_SHARD_WORKERS, tenants=TENANT_TABLE,
                  child_env={"RSDL_TELEMETRY_DIR": tel_dir,
                             "RSDL_METRICS_SHARD_INTERVAL_S": "0.5",
                             "RSDL_EXECUTOR_SHM_DIR": shm_dir})
    t_launch = timeit.default_timer()
    sups, shard_map = supervisor.launch_supervised_queue_shards(
        config, SERVE_SHARDS, name="smoke-tenant-shard")
    remotes, datasets, runs, errors, losses, killed = [], [], {}, [], [], {}
    try:
        for address in shard_map.addresses:
            if not supervisor.wait_for_server(tuple(address), timeout_s=120):
                raise AssertionError(f"tenancy (c): shard {address} never "
                                     "listened")
        listen_s = timeit.default_timer() - t_launch
        for rank, tenant in ((0, "hot"), (1, "cold")):
            remotes.append(dataset.connect_remote_queue(
                shard_map, retries=20, initial_backoff_s=0.2,
                max_batch=1 if rank == 0 else 8, tenant=contexts[tenant]))
            datasets.append(device_dataset.DeviceShufflingDataset(
                files, 1, DIST_WORLD, LOADER_BATCH, rank,
                batch_queue=remotes[rank], shuffle_result=None, seed=SEED,
                drop_last=False, device=None, **spec))
        fetches = _log_fetches(remotes[0].client_for_queue(
            plan_ir.queue_index(0, 0, DIST_WORLD)))

        def drain_cold():
            try:
                runs[1] = _drain_rank(datasets[1], 1,
                                      lambda epoch, i, f, y: True)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        cold = threading.Thread(target=drain_cold, daemon=True,
                                name="smoke-ten-cold-shard")

        def kill_shard_0(epoch, i):
            if "t" not in killed:
                killed["t"] = timeit.default_timer()
                killed["pid"] = sups[0].pid
                os.kill(killed["pid"], signal.SIGKILL)
                cold.start()
            return True

        emb.reset_launch_counts()
        runs[0] = _drain_rank(datasets[0], 1, _train_every_micro_step(
            micro_step, losses, kill_shard_0))
        launches = emb.launch_counts["gather_rows"]
        cold.join(timeout=600)
        if cold.is_alive():
            raise AssertionError("tenancy (c): the cold drain hung")
        if errors:
            raise errors[0]
        final_pids = [sup.pid for sup in sups]
    finally:
        for ds in datasets:
            ds.close()
        for remote in remotes:
            remote.close()
        for sup in sups:
            sup.stop()
        handle_files = [f for _, _, names in os.walk(handle_root)
                        for f in names]
        shutil.rmtree(shm_dir, ignore_errors=True)
    for rank in range(DIST_WORLD):
        _same_stream("tenancy (c)", rank,
                     torch.stack(runs[rank]["digests"]).cpu().numpy(),
                     want[rank][:1])
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("tenancy (c): non-finite loss")
    if launches != all_losses.numel():
        raise AssertionError(f"tenancy (c): {launches} gather launches in "
                             f"{all_losses.numel()} micro-steps")
    if sups[0].restarts < 1 or sups[0].failed:
        raise AssertionError("tenancy (c): shard 0 was not restarted")
    if sups[1].restarts:
        raise AssertionError(f"tenancy (c): shard 1 restarted "
                             f"{sups[1].restarts} times")
    cold_wait = max(runs[1]["fill_s"], runs[1]["max_wait_after_s"] or 0.0)
    if cold_wait >= SERVE_SURVIVOR_BUDGET_S:
        raise AssertionError(f"tenancy (c): the cold tenant waited "
                             f"{cold_wait} s for a batch")
    if handle_files:
        raise AssertionError(f"tenancy (c): segments left after the stop: "
                             f"{handle_files[:4]}")
    ledger = _exit_ledger_bytes(tel_dir, final_pids)
    if any(v != 0 for v in ledger.values()):
        raise AssertionError(f"tenancy (c): buffer-ledger bytes at the "
                             f"shards' exit: {ledger}")
    after_kill = [t for t, resumed, n in fetches
                  if t > killed["t"] and resumed and n]
    if not after_kill:
        raise AssertionError("tenancy (c): no frame came after the kill")
    samples, _ = metrics.merge_series(metrics.read_shards(tel_dir).values())
    return {
        "turn": "c", "shards": SERVE_SHARDS, "epochs": 1,
        "shard_map": shard_map.to_dict(), "shards_listen_s": listen_s,
        "restart_s": min(after_kill) - killed["t"],
        "hot_max_wait_after_kill_s": runs[0]["max_wait_after_s"],
        "cold_max_wait_s": cold_wait,
        "survivor_budget_s": SERVE_SURVIVOR_BUDGET_S,
        "ranks": [{"rank": rank, "tenant": ("hot", "cold")[rank],
                   "rows": runs[rank]["rows"],
                   "loader_batches": len(runs[rank]["digests"]),
                   "rows_per_s": runs[rank]["rows"] / runs[rank]["wall_s"],
                   "fill_s": runs[rank]["fill_s"], "digests_equal": True}
                  for rank in range(DIST_WORLD)],
        "hot_micro_steps": int(all_losses.numel()),
        "gather_launches": launches,
        "launches_per_micro_step": launches / all_losses.numel(),
        "shard_restarts": [sup.restarts for sup in sups],
        "bytes_delivered_by_shard_processes": _tenant_bytes(
            samples, "rsdl_tenant_bytes_delivered_total"),
        "segments_left": 0, "exit_ledger_bytes": list(ledger.values()),
    }


def _tenant_admission_and_storage(files, tmp: str) -> dict:
    """(d) Host only. Admission: a journaled ``AdmissionController`` sized
    to both tenants' working sets accepts both, rejects a 64x ask, and
    ``replay`` re-derives the journal byte for byte (the JAX bench's
    check). Storage: a ``TieredStore(tenant_quotas=)``; under
    ``tenant_scope`` the hot tenant warms its files, then the cold tenant
    scans more files than its quota holds; every hot file must still hit
    and every eviction be charged to cold. Beside it, the same sequence
    without quotas. Then a cold ``PrefetchManager`` whose
    ``prefetch_quota_bytes`` holds one file."""
    from ray_shuffling_data_loader_tpu_torch import storage, tenancy
    from ray_shuffling_data_loader_tpu_torch.runtime import metrics
    from ray_shuffling_data_loader_tpu_torch.tenancy import admission

    contexts = _tenant_contexts()
    leg_files = sorted(files)[:TENANT_FAIR_FILES]
    ask = sum(os.path.getsize(f) for f in leg_files) // DIST_WORLD + 1
    journal = os.path.join(tmp, "admission.jsonl")
    controller = admission.AdmissionController(
        capacity_bytes=4 * DIST_WORLD * ask, journal_path=journal)
    actions = [controller.register(contexts[t], "dataset", f"smoke-{t}",
                                   ask).action for t in ("hot", "cold")]
    greedy = controller.register(tenancy.TenantContext("greedy"), "dataset",
                                 "smoke-greedy", 64 * DIST_WORLD * ask)
    controller.close()
    replayed = admission.replay(journal, 4 * DIST_WORLD * ask,
                                tenants=contexts)
    replay_equal = replayed.journal_bytes() == open(journal, "rb").read()
    if actions != ["accept", "accept"] or greedy.action != "reject" \
            or not replay_equal:
        raise AssertionError(f"tenancy (d): admission {actions}, "
                             f"{greedy.action}, replay {replay_equal}")

    source = storage.LocalSource()
    names = sorted(files)
    hot_files = names[:TENANT_STORE_HOT_FILES]
    cold_files = names[TENANT_STORE_HOT_FILES:TENANT_STORE_HOT_FILES
                       + TENANT_STORE_COLD_FILES]
    t0 = timeit.default_timer()
    tables = {f: source.read_table(f).combine_chunks()
              for f in hot_files + cold_files}
    read_s = timeit.default_timer() - t0
    size = max(t.nbytes for t in tables.values())
    hot_quota = sum(tables[f].nbytes for f in hot_files)
    quotas = {"hot": hot_quota,
              "cold": TENANT_STORE_COLD_QUOTA_FILES * size}
    counters = ("hits", "misses", "evictions")

    def turn(tenant_quotas):
        store = storage.TieredStore(hot_quota + quotas["cold"],
                                    tenant_quotas=tenant_quotas)
        series = {t: [metrics.counter(f"rsdl_tenant_storage_{c}_total",
                                      tenant=t) for c in counters]
                  for t in TENANT_TABLE}
        before = {t: [c.value for c in cs] for t, cs in series.items()}
        try:
            with tenancy.tenant_scope(contexts["hot"]):
                for f in hot_files:
                    if store.get(f) is None:
                        store.put(f, tables[f])
                        store.release(f)
            with tenancy.tenant_scope(contexts["cold"]):
                for f in cold_files:
                    if store.get(f) is None:
                        store.put(f, tables[f])
                        store.release(f)
            with tenancy.tenant_scope(contexts["hot"]):
                hot_hits = []
                for f in hot_files:
                    got = store.get(f)
                    hot_hits.append(got is not None)
                    if got is None:
                        store.release(f)
            resident = dict(store._tenant_hot_bytes)
        finally:
            store.close()
        return {"hot_files_hit_after_scan": sum(hot_hits),
                "by_tenant": {t: dict(zip(counters, (
                    int(c.value - b) for c, b in zip(series[t], before[t]))))
                    for t in TENANT_TABLE},
                "resident_bytes": resident}

    with_quotas = turn(quotas)
    without = turn(None)
    if with_quotas["hot_files_hit_after_scan"] != len(hot_files):
        raise AssertionError(f"tenancy (d): the cold scan evicted hot's "
                             f"pages: {with_quotas}")
    if with_quotas["by_tenant"]["hot"]["evictions"] != 0 \
            or with_quotas["by_tenant"]["cold"]["evictions"] < 1:
        raise AssertionError(f"tenancy (d): evictions not charged to cold: "
                             f"{with_quotas}")

    store = storage.TieredStore(1 << 40, source=source)
    cold_prefetch = tenancy.TenantContext(
        "cold", priority="batch", weight=TENANT_COLD_WEIGHT,
        prefetch_quota_bytes=1)
    throttled = metrics.counter("rsdl_tenant_prefetch_throttled_total",
                                tenant="cold")
    throttled_before = throttled.value
    try:
        manager = storage.PrefetchManager(store, cold_files[:3],
                                          tenant=cold_prefetch)
        warmed = []
        while True:
            task = manager.next()
            if task is None:
                break
            warmed.append(task.run())
    finally:
        store.close()
    if warmed != [True, False, False]:
        raise AssertionError(f"tenancy (d): prefetch under a one-file quota "
                             f"warmed {warmed}")
    return {
        "turn": "d",
        "admission": {"ask_bytes": ask,
                      "capacity_bytes": 4 * DIST_WORLD * ask,
                      "actions": actions, "oversized": greedy.action,
                      "replay_equal": replay_equal},
        "storage": {"hot_files": len(hot_files),
                    "cold_files": len(cold_files),
                    "quota_bytes": quotas, "table_bytes_max": size,
                    "read_s": read_s, "with_quotas": with_quotas,
                    "without_quotas": without},
        "prefetch": {"quota_bytes": 1, "tasks": warmed,
                     "throttled": int(throttled.value - throttled_before)},
    }


def tenancy_phase(emb, files, want, tmp: str) -> dict:
    """Two tenants on one serving plane (the JAX bench's tenancy leg and
    ``tests/test_tenancy_recovery.py``): (a) the weighted-fair split on
    one in-process server; (b) the hot tenant's DLRM step on the card,
    solo and beside the cold tenant's greedy replay; (c) the hot tenant's
    shard SIGKILLed under its step; (d) admission and the storage quotas.
    ``want``: the one-process ``num_trainers=2`` digests per rank and
    epoch."""
    from ray_shuffling_data_loader_tpu_torch import train, transforms
    from ray_shuffling_data_loader_tpu_torch.models import dlrm

    start = timeit.default_timer()
    fresh_telemetry()
    files = sorted(files)
    a = _tenant_fairness(files)
    spec, _ = _sharded_spec()
    t_ref = timeit.default_timer()
    refs = _refs_by_queue(files, TENANT_COLD_EPOCHS, NUM_REDUCERS,
                          DIST_WORLD,
                          map_transform=transforms.make_cast_transform(
                              spec["feature_columns"], spec["feature_types"],
                              spec["label_column"], spec["label_type"]))
    refs_s = timeit.default_timer() - t_ref
    torch.cuda.empty_cache()
    model = dlrm.DLRM(dlrm.MLPERF, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    micro_step = train.make_micro_step(model, train.make_optimizer(model))
    warm_s = _warm_up(files, micro_step, refs)
    solo = _hot_step_turn(emb, files, micro_step, refs, want, False)
    contended = _hot_step_turn(emb, files, micro_step, refs, want, True)
    trigger = _trigger_turn(emb, files, micro_step, refs, want,
                            solo["hot_birth_latency"]["p99_ms"] / 1e3, tmp)
    del refs
    c = _tenant_shard_kill(emb, files, micro_step, want, tmp)
    del model, micro_step
    d = _tenant_admission_and_storage(files, tmp)
    return {
        "tenants": TENANT_TABLE,
        "turns": {"a": a, "b_solo": solo, "b_contended": contended, "c": c,
                  "d": d, "e_trigger": trigger},
        "refs_shuffle_s": refs_s, "warm_up_s": warm_s,
        "fairness_ratio": a["fairness_ratio"], "fairness_ok": a["fairness_ok"],
        "contended_over_solo_rows_per_s": (contended["rows_per_s"]
                                           / solo["rows_per_s"]),
        "restart_s": c["restart_s"],
        "trigger_slo_s": trigger["rebalance_slo_p99_s"],
        "trigger_b_solo_p99_s": trigger["b_solo_birth_p99_s"],
        "trigger_intent_to_commit_ms":
            trigger["phase_ms"].get("intent_to_commit_ms"),
        "gather_launches": (solo["gather_launches"]
                            + contended["gather_launches"]
                            + trigger["gather_launches"]
                            + c["gather_launches"]),
        "gather_launches_by_turn": {"b_solo": solo["gather_launches"],
                                    "b_contended":
                                        contended["gather_launches"],
                                    "e_trigger": trigger["gather_launches"],
                                    "c": c["gather_launches"]},
        "phase_s": timeit.default_timer() - start,
    }


# ResNet phase (BASELINE config 3): 224x224 PNG shards decoded in the
# reducers, ResNet-50 at 256 images per micro-step (the per-GPU batch of
# NVIDIA's DeepLearningExamples ResNet-50 v1.5 mixed-precision recipe).
IMG_COUNT, IMG_FILES, IMG_SIZE, IMG_CLASSES = 4096, 8, 224, 1000
IMG_BATCH, IMG_MICRO = 512, 256
# Resume phase: loader batches run uninterrupted, and the crash point.
RESUME_BATCHES, RESUME_CRASH = 4, 2
RESUME_BERT_SEQS, RESUME_BERT_FILES = 1024, 4
RESUME_RTOL = 1e-3


class TimedTransform:
    """Wraps a reduce transform and records each call's rows and span."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []
        self._lock = threading.Lock()

    def __call__(self, table):
        t0 = timeit.default_timer()
        out = self.fn(table)
        t1 = timeit.default_timer()
        with self._lock:
            self.calls.append((t0, t1, table.num_rows))
        return out

    def summary(self) -> dict:
        rows = sum(c[2] for c in self.calls)
        busy = sum(c[1] - c[0] for c in self.calls)
        span = (max(c[1] for c in self.calls)
                - min(c[0] for c in self.calls))
        return {"reducer_calls": len(self.calls), "images": rows,
                "images_per_s_per_reducer": rows / busy,
                "images_per_s_all_reducers": rows / span}


def _port_launches(fa, emb) -> dict:
    return {**fa.launch_counts, **emb.launch_counts}


def resnet_phase(fa, emb, decoder: str, tmp: str):
    """ResNet-50 on the decoded-image stream. Returns the phase's line and
    its shards (written to ``tmp``, for the resume phase)."""
    from ray_shuffling_data_loader_tpu_torch import (
        dataset, device_dataset, executor, train)
    from ray_shuffling_data_loader_tpu_torch.models import resnet
    from ray_shuffling_data_loader_tpu_torch.workloads import imagenet

    start = timeit.default_timer()
    files, nbytes = imagenet.generate_imagenet_parquet(
        IMG_COUNT, IMG_FILES, tmp, height=IMG_SIZE, width=IMG_SIZE,
        num_classes=IMG_CLASSES, seed=SEED)
    gen_s = timeit.default_timer() - start
    spec = imagenet.imagenet_spec(IMG_SIZE, IMG_SIZE, decoder=decoder)
    decode = TimedTransform(spec.pop("reduce_transform"))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = resnet.resnet50(IMG_CLASSES)
    model = resnet.ResNet(config, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(SEED))
    optimizer = train.make_sgd(model)
    micro_step = train.make_resnet_micro_step(model, optimizer)
    fresh_telemetry()
    ds = device_dataset.DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, IMG_BATCH, 0, num_reducers=NUM_REDUCERS,
        seed=SEED, reduce_transform=decode, **spec)
    rows_per_epoch, losses, chunk_ms, first_batch = [], [], [], None
    fa.reset_launch_counts()
    emb.reset_launch_counts()
    t_start = timeit.default_timer()
    t_first = t_second = None
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch)
        rows = 0
        for (images,), label in ds:
            if t_first is not None and t_second is None:
                t_second = timeit.default_timer()
            if t_first is None:
                t_first = timeit.default_timer()
                if not images.is_cuda or images.dtype != torch.uint8:
                    raise AssertionError(
                        f"images staged as {images.dtype} on "
                        f"{images.device}, not uint8 on the card")
                first_batch = (images.cpu(), label.cpu())
            t0 = timeit.default_timer()
            losses.append(train.train_chunk(micro_step, [images], label,
                                            IMG_MICRO))
            torch.cuda.synchronize()
            chunk_ms.append((timeit.default_timer() - t0) * 1e3)
            rows += label.shape[0]
        rows_per_epoch.append(rows)
    t_end = timeit.default_timer()
    verdicts = epoch_verdicts(NUM_EPOCHS)
    launches = _port_launches(fa, emb)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The decode closure keeps this loader on threads ("auto"); the host
    # check below shuffles without it, on the process pool.
    backend = executor.last_worker_pool()["backend"]

    if rows_per_epoch != [IMG_COUNT] * NUM_EPOCHS:
        raise AssertionError(
            f"rows per epoch {rows_per_epoch}, expected {IMG_COUNT}")
    all_losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError("non-finite loss")
    if any(launches.values()):
        raise AssertionError(f"the ResNet path launched {launches}; it "
                             "runs none of the port's kernels")
    if tuple(first_batch[0].shape) != (IMG_BATCH, IMG_SIZE, IMG_SIZE, 3):
        raise AssertionError(f"image batch {tuple(first_batch[0].shape)}")

    # The first staged batch equals a host-side PIL decode of the same
    # reducer rows (the host shuffle carries the encoded bytes).
    host = dataset.ShufflingDataset(
        files, 1, 1, IMG_BATCH, 0, drop_last=True,
        num_reducers=NUM_REDUCERS, seed=SEED,
        map_transform=device_dataset.make_cast_transform(
            spec["feature_columns"], spec["feature_types"],
            spec["label_column"], spec["label_type"]))
    host.set_epoch(0)
    host_batches = iter(host)
    table = next(host_batches)
    for _ in host_batches:  # drain, so the shuffle ends while files exist
        pass
    table = imagenet.decode_transform(IMG_SIZE, IMG_SIZE,
                                      decoder="pil")(table)
    (host_images,), host_labels = device_dataset.convert_to_arrays(
        table, spec["feature_columns"], spec["feature_shapes"],
        [np.dtype(t) for t in spec["feature_types"]], spec["label_column"],
        None, np.dtype(spec["label_type"]))
    if (not np.array_equal(first_batch[0].numpy(), host_images)
            or not np.array_equal(first_batch[1].numpy(), host_labels)):
        raise AssertionError("staged image batch differs from the host "
                             "decode's")

    images = first_batch[0][:IMG_MICRO].cuda()
    labels = first_batch[1][:IMG_MICRO].cuda()
    breakdown = profile_steps(micro_step, [images], labels, [])
    waits = ds.batch_wait_stats.wait_times
    wall = t_end - t_first
    steps = int(all_losses.numel())
    return {
        "executor_backend": backend,
        "decoder": decoder,
        "images": {"count": IMG_COUNT, "files": IMG_FILES, "format": "png",
                   "size": [IMG_SIZE, IMG_SIZE, 3], "classes": IMG_CLASSES,
                   "shard_bytes": nbytes},
        "rows_per_epoch": rows_per_epoch,
        "micro_steps": steps,
        "micro_batch": IMG_MICRO,
        "images_per_s": sum(rows_per_epoch) / wall,
        # Without the first loader batch's steps (cuDNN's first calls).
        "images_per_s_after_first_batch": (sum(rows_per_epoch) - IMG_BATCH)
        / (t_end - t_second),
        "first_chunk_ms": chunk_ms[0],
        "stall_pct": 100.0 * sum(waits[1:]) / wall,
        "batch_wait_s": ds.batch_wait_stats.summary(),
        "fill_s": t_first - t_start,
        "step_ms_median": float(np.median(chunk_ms)) / (IMG_BATCH
                                                        // IMG_MICRO),
        "chunk_ms_median": float(np.median(chunk_ms)),
        "loss_first": float(all_losses[:4].mean()),
        "loss_last": float(all_losses[-4:].mean()),
        "decode": decode.summary(),
        "port_kernel_launches": launches,
        "binding": ds.binding,
        "verdicts": verdicts,
        "transfer": ds.transfer_stats(),
        "staged_dtype": str(first_batch[0].dtype),
        "datagen_s": gen_s,
        "peak_mem_gb": peak_gb,
        "profile": breakdown,
    }, files


def _run_resumable(ds, loader, step, micro: int, batches: int):
    """Up to ``batches`` loader batches through ``resume_iterator``, one
    micro-step per ``micro`` rows; returns the micro-step losses. Closes
    the dataset, abandoned mid-epoch: its producer thread must not be
    left copying to the device when the interpreter exits (a daemon
    thread ended inside torch's C++ aborts the process)."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint, train
    losses = []
    it = checkpoint.resume_iterator(ds, loader)
    for n, (features, label) in enumerate(it, 1):
        losses.append(train.train_chunk(step, features, label, micro))
        if n == batches:
            break
    it.close()
    ds.close()
    return torch.cat(losses)


def _resume_check(build, make_ds, micro: int, tmp: str, batch: int
                  ) -> dict:
    """``build(seed) -> (trainer, step, generators)``. Runs
    ``RESUME_BATCHES`` loader batches uninterrupted; then
    ``RESUME_CRASH`` batches, a save, a restore into a trainer built from
    another seed and a fresh dataset, and the rest. Compares the losses
    and the parameters."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint

    def fresh_loader():
        return checkpoint.LoaderCheckpoint(
            seed=SEED, epoch=0, batches_consumed=0, num_epochs=1,
            num_trainers=1, rank=0, batch_size=batch)

    from ray_shuffling_data_loader_tpu_torch import executor
    trainer, step, _ = build(SEED)
    want = _run_resumable(make_ds(0), fresh_loader(), step, micro,
                          RESUME_BATCHES)
    backend = executor.last_worker_pool()["backend"]
    want_state = {k: v.clone() for k, v in
                  trainer.model.state_dict().items()}
    del trainer, step
    trainer, step, generators = build(SEED)
    loader = fresh_loader()
    got = [_run_resumable(make_ds(0), loader, step, micro, RESUME_CRASH)]
    if (loader.epoch, loader.batches_consumed) != (0, RESUME_CRASH):
        raise AssertionError(f"loader checkpoint at {loader}")
    saver = checkpoint.TrainStateCheckpointer(f"{tmp}/ckpt")
    torch.cuda.synchronize()
    t0 = timeit.default_timer()
    saver.save(RESUME_CRASH, trainer, loader_checkpoint=loader,
               generators=generators)
    save_s = timeit.default_timer() - t0
    step_dir = f"{tmp}/ckpt/{RESUME_CRASH}"
    save_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
    del trainer, step, generators
    trainer, step, generators = build(SEED + 99)  # a "fresh process"
    t0 = timeit.default_timer()
    restored = saver.restore(trainer, generators=generators)
    torch.cuda.synchronize()
    restore_s = timeit.default_timer() - t0
    if restored != loader:
        raise AssertionError(f"restored {restored}, saved {loader}")
    got.append(_run_resumable(make_ds(restored.epoch), restored, step,
                              micro, RESUME_BATCHES - RESUME_CRASH))
    got = torch.cat(got)
    state = trainer.model.state_dict()
    if got.shape != want.shape:
        raise AssertionError(f"{got.numel()} micro-steps resumed, "
                             f"{want.numel()} uninterrupted")
    loss_rel = float(((got - want).abs() / want.abs()).max())
    param_diff = max(float((state[k].float() - v.float()).abs().max())
                     for k, v in want_state.items())
    param_scale = max(float(v.float().abs().max())
                      for v in want_state.values())
    bit_equal = bool(torch.equal(got, want)) and all(
        torch.equal(state[k], v) for k, v in want_state.items())
    if not (torch.isfinite(got).all() and loss_rel <= RESUME_RTOL
            and param_diff <= RESUME_RTOL * param_scale):
        raise AssertionError(
            f"resumed run differs: losses {got.tolist()} vs "
            f"{want.tolist()}, parameters by {param_diff}")
    return {"micro_steps": int(want.numel()),
            "crash_after_batches": RESUME_CRASH,
            "tolerance": {"loss_rtol": RESUME_RTOL,
                          "param_atol_share_of_max": RESUME_RTOL},
            "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_diff,
            "param_max_abs": param_scale, "bit_equal": bit_equal,
            "losses": want.tolist(),
            "save_s": save_s, "save_bytes": save_bytes,
            "restore_s": restore_s, "executor_backend": backend}


def resume_phase(fa, emb, decoder: str, image_files) -> dict:
    """Save, restore and continue against an uninterrupted run, on the
    ResNet-50 path and on the BERT path with the flash kernels."""
    from ray_shuffling_data_loader_tpu_torch import device_dataset, train
    from ray_shuffling_data_loader_tpu_torch.models import bert, resnet
    from ray_shuffling_data_loader_tpu_torch.workloads import (
        bert_mlm, imagenet)

    def trainer_of(model, optimizer):
        return types.SimpleNamespace(model=model, optimizer=optimizer)

    def build_resnet(seed):
        model = resnet.ResNet(resnet.resnet50(IMG_CLASSES), device="cuda",
                              generator=torch.Generator(device="cuda")
                              .manual_seed(seed))
        optimizer = train.make_sgd(model)
        return (trainer_of(model, optimizer),
                train.make_resnet_micro_step(model, optimizer), [])

    bindings = set()

    def image_ds(start_epoch):
        ds = device_dataset.DeviceShufflingDataset(
            image_files, 1, 1, IMG_BATCH, 0, num_reducers=NUM_REDUCERS,
            seed=SEED, start_epoch=start_epoch,
            **imagenet.imagenet_spec(IMG_SIZE, IMG_SIZE, decoder=decoder))
        bindings.add(ds.binding)
        return ds

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-resume-") as tmp:
        fa.reset_launch_counts()
        emb.reset_launch_counts()
        resnet_run = _resume_check(build_resnet, image_ds, IMG_MICRO, tmp,
                                   IMG_BATCH)
        resnet_run["port_kernel_launches"] = _port_launches(fa, emb)
        if any(resnet_run["port_kernel_launches"].values()):
            raise AssertionError("the ResNet path launched a port kernel")

    attention_fn = fa.make_flash_attention_fn()

    def build_bert(seed):
        model = bert.Bert(bert.bert_base(), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(seed))
        optimizer = train.make_optimizer(model, lr=train.BERT_LR)
        mask_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        step = train.make_bert_micro_step(model, optimizer, mask_gen,
                                          attention_fn)
        return trainer_of(model, optimizer), step, [mask_gen]

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-resume-") as tmp:
        files, _ = bert_mlm.generate_tokenized_parquet(
            RESUME_BERT_SEQS, RESUME_BERT_FILES, tmp, seq_len=BERT_SEQ_LEN,
            vocab_size=BERT_VOCAB, seed=SEED)

        def token_ds(start_epoch):
            ds = device_dataset.DeviceShufflingDataset(
                files, 1, 1, BERT_BATCH, 0, num_reducers=NUM_REDUCERS,
                seed=SEED, start_epoch=start_epoch,
                **bert_mlm.bert_mlm_spec(BERT_SEQ_LEN))
            bindings.add(ds.binding)
            return ds

        fa.reset_launch_counts()
        emb.reset_launch_counts()
        bert_run = _resume_check(build_bert, token_ds, BERT_MICRO, tmp,
                                 BERT_BATCH)
        launches = dict(fa.launch_counts)
    # Micro-steps run: the uninterrupted run's, then the resumed run's.
    steps = 2 * bert_run["micro_steps"]
    for kernel in FLASH_KERNELS:
        if launches[kernel] != bert.bert_base().num_layers * steps:
            raise AssertionError(
                f"{kernel} launched {launches[kernel]} times in {steps} "
                "micro-steps of the resume runs")
    if emb.launch_counts["gather_rows"]:
        raise AssertionError("the BERT path launched the gather")
    bert_run["flash_launches"] = launches
    bert_run["launches_per_micro_step"] = {k: n / steps
                                           for k, n in launches.items()}
    (binding,) = bindings
    return {"decoder": decoder, "binding": binding, "resnet50": resnet_run,
            "bert_base": bert_run}


# Tensor-parallel phase: the port's Megatron layout (``parallel.tp``) on a
# ("data", "model") mesh of (1, 2): two processes on the one card, gloo on
# CUDA tensors (NCCL refuses two ranks on one device).
TP_WORLD = 2
# Steps per model and rank: the first losses, then timed steps, then steps
# with the model axis's collectives timed one by one.
TP_STEPS, TP_TIMED_STEPS, TP_COLLECTIVE_STEPS = 2, 4, 2
TP_BERT_MICRO, TP_RESNET_MICRO = 8, 16
# Relative bars on each rank's first loss (the forward) and second loss
# (after one update: the backward, the collectives' backward and the
# optimizer) against one process's. bf16 compute: each rank rounds its
# row-parallel product before the sum, where one process rounds the whole
# product once. Set from the readings on an H100 80GB HBM3 at 700 W (first
# / second: DLRM 1.4e-5 / 5.5e-5, BERT 1.7e-5 / 1.1e-4, ResNet-50 3.1e-5
# / 8.7e-4); ResNet's SGD step takes its loss from 8.0 to 4.3, which
# magnifies the first gradient's rounding in the second loss.
TP_LOSS_RTOL = {"dlrm": (1e-3, 1e-3), "bert": (1e-3, 1e-3),
                "resnet": (1e-3, 5e-3)}
TP_TIMEOUT_S = 300


def _tp_dlrm_batch():
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    g = torch.Generator(device="cuda").manual_seed(5)
    cols = [torch.randint(-1000, v + 1000, (MICROBATCH,), device="cuda",
                          dtype=torch.int32, generator=g)
            for v in dlrm.MLPERF.vocab_sizes]
    labels = (torch.rand((MICROBATCH, 1), device="cuda", generator=g)
              < 0.25).float()
    return cols, labels


def _tp_bert_batch():
    from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, BERT_VOCAB, (TP_BERT_MICRO, BERT_SEQ_LEN),
                           device="cuda", dtype=torch.int32, generator=g)
    return bert_mlm.mlm_mask(tokens, g, BERT_VOCAB)


def _tp_resnet_batch():
    g = torch.Generator(device="cuda").manual_seed(7)
    images = torch.randint(0, 256, (TP_RESNET_MICRO, IMG_SIZE, IMG_SIZE, 3),
                           device="cuda", dtype=torch.uint8, generator=g)
    labels = torch.randint(0, IMG_CLASSES, (TP_RESNET_MICRO,), device="cuda",
                           generator=g)
    return images.to(torch.float32) / 255.0, labels


def _tp_models():
    """name -> (build() -> model from seed ``SEED``, batch() -> the global
    batch, specs(config), loss_of(mesh, attention_fn) -> loss_fn(model,
    *batch), optimizer(model)); a ``None`` mesh is one process."""
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.models import bert, dlrm, resnet

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    return {
        "dlrm": (lambda: dlrm.DLRM(dlrm.MLPERF, device="cuda",
                                   generator=gen()),
                 _tp_dlrm_batch, dlrm.param_specs,
                 lambda mesh, fa: (lambda m, *b: dlrm.loss_fn(
                     m, None, list(b[:-1]), b[-1])),
                 train.make_optimizer),
        "bert": (lambda: bert.Bert(bert.bert_base(), device="cuda",
                                   generator=gen()),
                 _tp_bert_batch, bert.param_specs,
                 lambda mesh, fa: (lambda m, x, y: bert.loss_fn(
                     m, x, y, attention_fn=fa, mesh=mesh)),
                 lambda m: train.make_optimizer(m, lr=train.BERT_LR)),
        "resnet": (lambda: resnet.ResNet(resnet.resnet50(IMG_CLASSES),
                                         device="cuda", generator=gen()),
                   _tp_resnet_batch, resnet.param_specs,
                   lambda mesh, fa: resnet.loss_fn, train.make_sgd),
    }


def _flat_batch(batch):
    cols, labels = batch
    return (*cols, labels) if isinstance(cols, list) else (cols, labels)


def _timed_steps(step, batch, n: int) -> float:
    torch.cuda.synchronize()
    start = timeit.default_timer()
    for _ in range(n):
        step(*batch)
    torch.cuda.synchronize()
    return (timeit.default_timer() - start) * 1e3 / n


def _tp_references(fa) -> dict:
    """Each model's first losses, step ms and peak device memory in one
    process (no mesh), from the same weights and batch as the ranks."""
    out = {}
    for name, (build, batch_of, _, loss_of, optimizer_of) in \
            _tp_models().items():
        torch.cuda.empty_cache()
        model = build()
        optimizer = optimizer_of(model)
        loss_fn = loss_of(None, fa.make_flash_attention_fn())

        def step(*batch):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, *batch)
            loss.backward()
            optimizer.step()
            return loss.detach()

        batch = _flat_batch(batch_of())
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(*batch)) for _ in range(TP_STEPS)]
        out[name] = {"losses": losses,
                     "step_ms": _timed_steps(step, batch, TP_TIMED_STEPS),
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del model, optimizer, batch
    torch.cuda.empty_cache()
    return out


def _digests(model, specs) -> dict:
    """sha256 of every parameter the specs replicate."""
    import hashlib
    return {name: hashlib.sha256(p.detach().float().cpu().numpy()
                                 .tobytes()).hexdigest()[:16]
            for name, p in model.named_parameters()
            if all(a is None for a in specs[name])}


def _skipped_all_reduce_ms(model, mesh) -> list:
    """Wall ms of the gradient all-reduce that ``SpmdTrainer`` skips over
    a data axis of one rank (each of 2 runs, after the steps): every
    gradient and the loss in one flat buffer over gloo, as
    ``parallel.trainer.make_train_step`` would run it."""
    import torch.distributed as dist

    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    group = pmesh.batch_group(mesh)
    if dist.get_world_size(group) != 1:
        raise AssertionError("the tp mesh's data axis is not one rank")
    tensors = [p.grad for p in model.parameters()] + [
        torch.zeros(1, device="cuda")]
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        start = timeit.default_timer()
        pmesh.flat_collective(tensors, lambda flat: dist.all_reduce(
            flat, group=group))
        torch.cuda.synchronize()
        out.append((timeit.default_timer() - start) * 1e3)
    return out


def _tp_rank_model(name, mesh, fa, emb) -> dict:
    """One model through ``SpmdTrainer(param_specs=)`` on this rank."""
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr
    build, batch_of, specs_of, loss_of, optimizer_of = _tp_models()[name]
    torch.cuda.empty_cache()
    model = build()
    specs = specs_of(model.config)
    heads = []
    flash = fa.make_flash_attention_fn()

    def attention_fn(q, k, v, bias=None):
        heads.append(q.shape[1])
        return flash(q, k, v, bias)

    start = timeit.default_timer()
    trainer = ptr.SpmdTrainer(mesh, loss_of(mesh, attention_fn), model,
                              optimizer_of(model), param_specs=specs)
    torch.cuda.synchronize()
    build_s = timeit.default_timer() - start
    model = trainer.model
    stats = model.tp.stats
    batch = _flat_batch(batch_of())
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    emb.reset_launch_counts()
    losses = [float(trainer.train_step(*batch)) for _ in range(TP_STEPS)]
    step_ms = _timed_steps(trainer.train_step, batch, TP_TIMED_STEPS)
    stats.reset()
    stats.timed = True
    _timed_steps(trainer.train_step, batch, TP_COLLECTIVE_STEPS)
    stats.timed = False
    torch.cuda.synchronize()
    skipped_ms = _skipped_all_reduce_ms(model, mesh)
    steps = TP_STEPS + TP_TIMED_STEPS + TP_COLLECTIVE_STEPS
    per_step = {key: {op: v / TP_COLLECTIVE_STEPS for op, v in d.items()}
                for key, d in stats.snapshot().items()}
    return {
        "losses": losses, "steps": steps, "build_s": build_s,
        "step_ms": step_ms, "collectives_per_step": per_step,
        "collective_ms_per_step": sum(per_step["ms"].values()),
        "collective_bytes_per_step": sum(per_step["bytes"].values()),
        "skipped_all_reduce_ms": skipped_ms,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()),
        "launches": {**fa.launch_counts, **emb.launch_counts},
        "attention_heads": sorted(set(heads)),
        "gather_shards": sorted({tuple(p.shape) for n, p in
                                 model.named_parameters()
                                 if n.startswith("embeddings.")
                                 and p.shape[0] > emb.ONE_HOT_MAX_VOCAB}),
        "replicated_digests": _digests(model, specs),
    }


def tp_worker(rank: int, init: str, out_dir: str) -> int:
    """One rank of the ``tp`` phase's world: each model in turn on a
    ``("data", "model")`` mesh of (1, ``TP_WORLD``); writes its results."""
    import torch.distributed as dist

    from ray_shuffling_data_loader_tpu_torch.ops import embedding as emb
    from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as fa
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=TP_WORLD)
    try:
        mesh = pmesh.make_mesh(TP_WORLD)
        out = {name: _tp_rank_model(name, mesh, fa, emb)
               for name in _tp_models()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"tp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _tp_world(tmp: str) -> list:
    """Start ``TP_WORLD`` ranks of this script (``--tp-rank``) and return
    their results; a rank that fails or outlives ``TP_TIMEOUT_S`` fails
    the phase with its log."""
    import signal
    env = dict(os.environ, OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // TP_WORLD)))
    procs = []
    for rank in range(TP_WORLD):
        log = open(os.path.join(tmp, f"tp_rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank",
             str(rank), f"file://{tmp}/rendezvous", tmp], cwd=_REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
        log.close()
    deadline = timeit.default_timer() + TP_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - timeit.default_timer()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the tp world ran past {TP_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for rank, proc in enumerate(procs):
        if proc.returncode:
            with open(os.path.join(tmp, f"tp_rank{rank}.log")) as f:
                raise AssertionError(f"tp rank {rank} exited "
                                     f"{proc.returncode}:\n{f.read()[-6000:]}")
    out = []
    for rank in range(TP_WORLD):
        with open(os.path.join(tmp, f"tp_rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _tp_kernel_checks(fa, emb, hbm: float, flop_peak: float) -> dict:
    """The gather and flash kernels at the shapes the ranks give them,
    against their plain versions (these launches are not the path's),
    with device times beside the bound."""
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    g = torch.Generator(device="cuda").manual_seed(9)
    tables, idx_sets = main_path_group(emb, g)
    out = {"gather": {}, "flash": {}}
    for rank in range(TP_WORLD):
        shards = [tp.shard_tensor(t, 1, 1, TP_WORLD, rank) for t in tables]
        _check_grouped(emb, f"column block {rank}", shards, idx_sets[0],
                       torch.bfloat16)
    out["gather"] = {"shapes": [list(s.shape) for s in shards],
                     "max_abs_err": 0.0,
                     **time_group(emb, shards, idx_sets, hbm)}
    del tables, shards, idx_sets
    h = ATT_H // TP_WORLD
    case = _attention_inputs(g, TP_BERT_MICRO, h, BERT_SEQ_LEN,
                             BERT_SEQ_LEN, ATT_D, masked=False)
    errs = {"no_bias": _check_case(fa, "tp_heads", *case),
            "bias": _check_case(fa, "tp_heads_bias", *_attention_inputs(
                g, TP_BERT_MICRO, h, BERT_SEQ_LEN, BERT_SEQ_LEN, ATT_D,
                masked=True))}
    q, k, v, do, _ = case
    fwd, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * fwd.float()).sum(-1)
    bwd = [(q, k, v, None, do, lse, delta)]
    b, s, d = TP_BERT_MICRO, BERT_SEQ_LEN, ATT_D
    elems, rows = b * h * s * d, b * h * s
    for kernel, fn, args, (products, tensors, f32_rows) in (
            ("flash_fwd", fa.flash_fwd, [(q, k, v)], (2, 4, 1)),
            ("flash_dq", fa.flash_dq, bwd, (3, 5, 2)),
            ("flash_dkv", fa.flash_dkv, bwd, (4, 6, 2))):
        by_ops = products * 2 * b * h * s * s * d / flop_peak
        by_bytes = (tensors * elems * 2 + f32_rows * rows * 4) / hbm
        ms = device_ms(fn, args, 20)
        out["flash"][kernel] = {"ms": ms,
                                "bound_ms": max(by_ops, by_bytes) * 1e3}
    out["flash"]["shape"] = {"B": b, "H": h, "S": s, "D": d}
    out["flash"]["max_abs_err"] = errs
    torch.cuda.empty_cache()
    return out


def _dryruns() -> dict:
    """``parallel.dryrun.dryrun_multichip`` on 2 and 4 ranks of the card,
    both at once."""
    from ray_shuffling_data_loader_tpu_torch.parallel import dryrun
    start = timeit.default_timer()
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        runs = {n: pool.submit(dryrun.dryrun_multichip, n,
                               timeout_s=TP_TIMEOUT_S) for n in (2, 4)}
        out = {str(n): f.result() for n, f in runs.items()}
    for n, ranks in out.items():
        if len(ranks) != int(n) or not all(
                np.isfinite([r["loss"], *r["loader_losses"]]).all()
                for r in ranks):
            raise AssertionError(f"dryrun_multichip({n}): {ranks}")
    return {"ranks": out, "seconds": timeit.default_timer() - start}


def tp_phase(fa, emb, hbm: float, flop_peak: float, tmp: str) -> dict:
    kernels = _tp_kernel_checks(fa, emb, hbm, flop_peak)
    refs = _tp_references(fa)
    start = timeit.default_timer()
    ranks = _tp_world(tmp)
    world_s = timeit.default_timer() - start
    from ray_shuffling_data_loader_tpu_torch.models import bert
    layers = bert.bert_base().num_layers
    out = {"mesh": [1, TP_WORLD], "world_s": world_s, "kernels": kernels,
           "loss_rtol": {k: list(v) for k, v in TP_LOSS_RTOL.items()},
           "models": {}}
    for name, ref in refs.items():
        got = [r[name] for r in ranks]
        rel = [max(abs(r["losses"][i] - want) / abs(want) for r in got)
               for i, want in enumerate(ref["losses"])]
        for i, (diff, bar) in enumerate(zip(rel, TP_LOSS_RTOL[name])):
            if not diff <= bar:
                raise AssertionError(
                    f"tp {name}: losses {i} of the ranks "
                    f"{[r['losses'][i] for r in got]} vs one process's "
                    f"{ref['losses'][i]}: {diff} relative, bar {bar}")
        if any(r["replicated_digests"] != got[0]["replicated_digests"]
               for r in got):
            raise AssertionError(f"tp {name}: replicated parameters differ "
                                 "across the model axis")
        steps = got[0]["steps"]
        launches = [r["launches"] for r in got]
        if name == "dlrm":
            want = {"gather_rows": steps}
            if any(r["gather_shards"] != got[0]["gather_shards"]
                   or {s[1] for s in r["gather_shards"]} != {E // TP_WORLD}
                   for r in got):
                raise AssertionError(
                    f"gather shards {got[0]['gather_shards']}")
        elif name == "bert":
            want = {k: layers * steps for k in FLASH_KERNELS}
            if any(r["attention_heads"] != [ATT_H // TP_WORLD] for r in got):
                raise AssertionError("flash ran on "
                                     f"{got[0]['attention_heads']} heads")
        else:
            want = {}
        for r in launches:
            for kernel, n in r.items():
                if n != want.get(kernel, 0):
                    raise AssertionError(f"tp {name}: {kernel} launched {n} "
                                         f"times in {steps} steps, expected "
                                         f"{want.get(kernel, 0)}")
        out["models"][name] = {
            "one_process": ref, "first_loss_max_rel_diff": rel[0],
            "second_loss_max_rel_diff": rel[1],
            "launches_per_step": {k: n / steps
                                  for k, n in launches[0].items() if n},
            "replicated_params_equal": len(got[0]["replicated_digests"]),
            "ranks": [{k: v for k, v in r.items()
                       if k != "replicated_digests"} for r in got]}
    config = bert.bert_base()
    out["models"]["bert"]["mlm_head_bytes"] = {
        "table_all_gather": config.vocab_size * config.hidden_dim * 2,
        "partial_logits_all_reduce": TP_BERT_MICRO * BERT_SEQ_LEN
        * config.vocab_size * 4,
        "partial_logits_all_reduce_at_32": 32 * BERT_SEQ_LEN
        * config.vocab_size * 4}
    out["dryrun"] = _dryruns()
    return out


def image_decoder_env() -> dict:
    """PIL's version, ``g++`` and the codec headers, and the decoder the
    ``resnet`` phase uses: the native one where it can be built, PIL
    where it cannot (named, never chosen quietly)."""
    import PIL

    from ray_shuffling_data_loader_tpu_torch.native import image
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=False,
                         timeout=60).stdout.splitlines()[:1] if (
        shutil.which("g++")) else []
    missing = image.missing_prerequisites()
    return {"pil": PIL.__version__, "gxx": gxx[0] if gxx else None,
            "native_decoder_missing": missing,
            "resnet_decoder": "pil" if missing else "native"}


def pool_env() -> dict:
    """The host's cores, the process pool's segment dir, its free bytes
    and whether it is writable, and what ``"auto"`` resolves to for the
    DLRM spec (its cast transform crosses to the workers)."""
    from ray_shuffling_data_loader_tpu_torch import (executor, procpool,
                                                     transforms)
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo
    spec = dlrm_criteo.dlrm_spec()
    cast = transforms.make_cast_transform(
        spec["feature_columns"], spec["feature_types"],
        spec["label_column"], spec["label_type"])
    shm_dir = procpool.shm_base_dir()
    return {"cpu_count": os.cpu_count(), "shm_dir": shm_dir,
            "shm_free_bytes": shutil.disk_usage(shm_dir).free,
            "shm_available": procpool.shm_available(),
            "auto_backend_dlrm": executor.resolve_backend(
                transforms=(cast, None))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    from ray_shuffling_data_loader_tpu_torch.ops import embedding as emb
    from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peak = hbm_peak(name)
    decoder_env = image_decoder_env()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": name, "nvidia_smi": smi, "hbm_peak_bytes_s": peak,
          "tf32": False, **decoder_env, **pool_env()})
    decoder = decoder_env["resnet_decoder"]

    start = timeit.default_timer()
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        for lib in [pool.submit(build.gather_library),
                    pool.submit(build.flash_library)]:
            lib.result()
    emit({"phase": "build", "kernels": ["gather_rows", *FLASH_KERNELS],
          "seconds": timeit.default_timer() - start, "flags": build.CUDA_FLAGS,
          "ptxas": {name: ptxas_by_kernel(info)
                    for name, info in build.PTXAS_INFO.items()}})

    kern = kernels_phase(emb, peak)
    emit({"phase": "kernels", "card": smi, "status": {"gather_rows": "ok"},
          **kern})

    att = attention_phase(fa, peak, bf16_peak(name))
    emit({"phase": "attention", "card": smi, **att})

    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-") as dlrm_tmp, \
            tempfile.TemporaryDirectory(prefix="rsdl-smoke-bert-") as btmp:
        dlrm_paths, dlrm_gen_s = dlrm_files(dlrm_tmp)
        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-arm-") as tmp:
            trained = armed_train_phase(emb, dlrm_paths, dlrm_gen_s, tmp)
        emit({"phase": "train", "card": smi,
              **{k: v for k, v in trained.items() if k != "digests"}})

        binding_run = torch_binding_phase(emb, dlrm_paths, trained)
        emit({"phase": "torch_binding", "card": smi, **binding_run})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-tel-") as tmp:
            tel = telemetry_phase(emb, dlrm_paths, trained, tmp)
        emit({"phase": "telemetry", "card": smi, **tel})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-ops-") as tmp:
            ops_run = ops_phase(emb, dlrm_paths, tmp)
        emit({"phase": "ops", "card": smi, **ops_run})

        token_paths, token_gen_s = bert_files(btmp)
        bert_run = bert_phase(fa, token_paths, token_gen_s)
        emit({"phase": "bert", "card": smi, **loader_context("bert"),
              **bert_run})

        rebatch = rebatch_phase(emb, dlrm_paths, token_paths)
        emit({"phase": "rebatch", "card": smi,
              **loader_context("rebatch"), **rebatch})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-eng-") as tmp:
            engine = engine_phase(emb, dlrm_paths, trained, tmp)
        emit({"phase": "engine", "card": smi, **engine})

        ring_run = ring_phase(fa, emb)
        emit({"phase": "ring", "card": smi, **ring_run})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-dist-") as tmp:
            dist_run = distributed_phase(dlrm_paths, tmp)
        # The one-process num_trainers=2 digests, which serving (d) and
        # (e) are held against too.
        dist_reference = dist_run.pop("loader_reference")
        emit({"phase": "distributed", "card": smi,
              "prior_shuffle": PRIOR_SHUFFLE["distributed"], **dist_run})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-el-") as tmp:
            elastic_run = elastic_phase(emb, dlrm_paths, tmp)
        emit({"phase": "elastic", "card": smi, **elastic_run})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-serve-") as tmp:
            serving_run = serving_phase(emb, dlrm_paths, trained,
                                        dist_reference, tmp)
        emit({"phase": "serving", "card": smi, **serving_run})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-stream-") as tmp:
            stream_run = stream_phase(emb, trained, tmp)
        emit({"phase": "stream", "card": smi, **stream_run})

        with tempfile.TemporaryDirectory(prefix="rsdl-smoke-ten-") as tmp:
            tenancy_run = tenancy_phase(emb, dlrm_paths, dist_reference, tmp)
        emit({"phase": "tenancy", "card": smi, **tenancy_run})

    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-images-") as tmp:
        resnet_run, image_files = resnet_phase(fa, emb, decoder, tmp)
        emit({"phase": "resnet", "card": smi, **loader_context("resnet"),
              **resnet_run})
        resume_run = resume_phase(fa, emb, decoder, image_files)
        emit({"phase": "resume", "card": smi, **loader_context("resume"),
              **resume_run})

    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-tp-") as tmp:
        start = timeit.default_timer()
        tp_run = tp_phase(fa, emb, peak, bf16_peak(name), tmp)
        tp_run["seconds"] = timeit.default_timer() - start
    emit({"phase": "tp", "card": smi, **tp_run})
    tp_ranks = {m: tp_run["models"][m]["ranks"][0]["launches"]
                for m in ("dlrm", "bert")}

    main_path = kern["timings"][f"group_B{MICROBATCH}_bf16"]
    summary = [{
        "name": "gather_rows", "route": "cuda",
        "source": "ray_shuffling_data_loader_tpu_torch/kernels/gather.cu",
        "replaces": "ray_shuffling_data_loader_tpu/ops/embedding.py:64",
        "launches": (trained["gather_launches"]
                     + binding_run["gather_launches"]
                     + stream_run["gather_launches"]
                     + tenancy_run["gather_launches"]
                     + ops_run["gather_launches"]),
        "launches_by_path": {
            "train": trained["gather_launches"],
            "torch_binding": binding_run["gather_launches"],
            "stream": stream_run["gather_launches_by_turn"]["a"],
            "stream_served": stream_run["gather_launches_by_turn"]["b"],
            "tenancy": tenancy_run["gather_launches"],
            "tenancy_trigger":
                tenancy_run["gather_launches_by_turn"]["e_trigger"],
            "ops": ops_run["gather_launches"],
            "telemetry": tel["gather_launches"],
            "rebatch": rebatch["gather_launches"],
            "engine": engine["gather_launches"],
            "engine_pool_kill": engine["launches_by_turn"]["pool_kill"],
            "engine_tiered": engine["launches_by_turn"]["tiered"],
            "spmd_dlrm": ring_run["spmd_dlrm"]["gather_launches"],
            "distributed": dist_run["gather_launches"],
            "elastic": elastic_run["gather_launches"],
            "serving": serving_run["gather_launches"],
            "serving_move": serving_run["gather_launches_by_turn"]["f"],
            "serving_abort": serving_run["gather_launches_by_turn"]["g"],
            "resnet": resnet_run["port_kernel_launches"]["gather_rows"],
            "tp_dlrm_rank0": tp_ranks["dlrm"]["gather_rows"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"], "bound_by": "bytes",
        "library_ms": main_path["library_ms"],
    }]
    for kernel, replaces in zip(FLASH_KERNELS, _FLASH_REPLACES):
        t = att["timings"][kernel]
        summary.append({
            "name": kernel, "route": "cuda",
            "source": "ray_shuffling_data_loader_tpu_torch/kernels/"
                      "flash_attention.cu",
            "replaces": replaces,
            "launches": bert_run["flash_launches"][kernel],
            "launches_by_path": {
                "bert": bert_run["flash_launches"][kernel],
                "ring": ring_run["spmd_bert"]["flash_launches"][kernel],
                "resnet": resnet_run["port_kernel_launches"][kernel],
                "resume": resume_run["bert_base"]["flash_launches"][kernel],
                "tp_bert_rank0": tp_ranks["bert"][kernel]},
            "max_abs_err": att["max_abs_err"][kernel],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
