#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's DLRM, BERT-MLM and ResNet-50 train paths, the sequence-
and data-parallel entry points at world size 1, the distributed shuffle
and its training entry point in a world of two processes, and save,
restore and resume mid-epoch, end to end at full width, and checks its
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
   seconds (``TrialStats``) and the buffer ledger's peak bytes.
5. ``attention``: the three flash-attention kernels (forward, dq, dk/dv)
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
6. ``bert``: 8,192 generated sequences of 512 tokens (vocab 30,522) in 8
   Parquet files -> seeded shuffle (8 reducers) -> ``DeviceShufflingDataset``
   (1 trainer, batch 256, 2 epochs, seed 0) -> on-device MLM masking ->
   ``bert_base()`` (bf16 compute, random weights from seed 0) with the flash
   kernels -> Adam (lr 1e-4), one micro-step per 32 sequences. Checks rows
   per epoch, finite losses, the first staged batch against a host-side
   shuffle, the flash path's loss against the inline path's (within 1e-2
   relative: bf16 compute, the two round the scores at different places),
   and exactly 12 launches of each flash kernel per micro-step.
7. ``rebatch``: the two device bindings of ``DeviceShufflingDataset`` in
   turns within this call (per-batch, bulk, bulk, per-batch), each a fresh
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
8. ``engine``: the shuffle engine on the ``train`` phase's files in five
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
9. ``ring``: (a) the flash ring's per-hop step (``ops.ring_attention``,
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
10. ``distributed``: a world of two processes on the one card, started by
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
11. ``resnet``: 4,096 generated 224x224 RGB PNGs (1,000 classes) in 8
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
12. ``resume``: on ResNet-50 (the ``resnet`` phase's shards) and on
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

Every phase that drives ``DeviceShufflingDataset`` names the binding it
ran (``"binding"``: the bulk one, the default on the card, unless a turn
asks for per-batch copies), the executor backend its shuffle resolved
and its figures with the shuffle before the engine (``prior_shuffle``). Then the ``{"kernels": [...]}`` summary, the
``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
        "transfer": ds.transfer_stats(),
        "datagen_s": gen_s,
        "peak_mem_gb": peak_gb,
        "flash_share_pct": 100.0 * flash_ms / breakdown[
            "device_ms_per_step"],
        "profile": breakdown,
    }


# Rebatch phase: the two device bindings in turns on the train phase's
# data, in one call (the DLRM step varies 11.9-14.9 ms between calls).
REBATCH_TURNS = ("per_batch", "bulk", "bulk", "per_batch")
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
    """The per-batch and bulk bindings in turns (per-batch, bulk, bulk,
    per-batch) on the ``train`` phase's data, then on the card: (b) the
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
        trained = train_phase(emb, dlrm_paths, dlrm_gen_s)
        emit({"phase": "train", "card": smi,
              **{k: v for k, v in trained.items() if k != "digests"}})

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
        emit({"phase": "distributed", "card": smi,
              "prior_shuffle": PRIOR_SHUFFLE["distributed"], **dist_run})

    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-images-") as tmp:
        resnet_run, image_files = resnet_phase(fa, emb, decoder, tmp)
        emit({"phase": "resnet", "card": smi, **loader_context("resnet"),
              **resnet_run})
        resume_run = resume_phase(fa, emb, decoder, image_files)
        emit({"phase": "resume", "card": smi, **loader_context("resume"),
              **resume_run})

    main_path = kern["timings"][f"group_B{MICROBATCH}_bf16"]
    summary = [{
        "name": "gather_rows", "route": "cuda",
        "source": "ray_shuffling_data_loader_tpu_torch/kernels/gather.cu",
        "replaces": "ray_shuffling_data_loader_tpu/ops/embedding.py:64",
        "launches": trained["gather_launches"],
        "launches_by_path": {
            "train": trained["gather_launches"],
            "rebatch": rebatch["gather_launches"],
            "engine": engine["gather_launches"],
            "engine_pool_kill": engine["launches_by_turn"]["pool_kill"],
            "engine_tiered": engine["launches_by_turn"]["tiered"],
            "spmd_dlrm": ring_run["spmd_dlrm"]["gather_launches"],
            "distributed": dist_run["gather_launches"],
            "resnet": resnet_run["port_kernel_launches"]["gather_rows"]},
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
                "resume": resume_run["bert_base"]["flash_launches"][kernel]},
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
