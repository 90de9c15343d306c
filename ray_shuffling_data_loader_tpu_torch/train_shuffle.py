"""End-to-end DLRM training on the shuffling pipeline, one process per host
(counterpart of the JAX package's ``examples/jax_train_shuffle.py``).

One process, on the card (``--cpu`` for the host)::

    python -m ray_shuffling_data_loader_tpu_torch.train_shuffle \\
        --num-rows 200000 --num-files 8 --num-epochs 3 --batch-size 8192

A world of processes, one per host: ``--distributed`` initialises
``torch.distributed`` from ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``, the variables ``torchrun`` and
``launch_slice`` set (``LOCAL_RANK`` picks the card). With ``RSDL_HOSTS``
(``host:port`` shuffle endpoints, one per rank, in rank order) the ranks
run the global shuffle (``parallel/distributed.py``: every rank maps its
file shard and exchanges chunks with the others over TCP); without it each
rank shuffles its own files, ``i % world == rank``. The model is DLRM
``mlperf`` (``--tiny-model``: vocabularies capped at 1,000, embed 8, top
MLP (64, 32)), trained by ``parallel.trainer.SpmdTrainer`` with Adam, one
step per loader batch. A continue-vote before every step (an
``all_reduce`` MIN of a one-element flag) has every rank step or none, so
the ranks issue the same collectives when their epochs hold different
numbers of batches. ``--mock-train-step-time S`` replaces the step with a
sleep (the loader alone).

The shuffle engine's knobs are the JAX entry point's: ``--file-cache``
(``auto``: decoded files kept in RAM across epochs; ``none``: re-decoded
every epoch; ``disk`` raises until the storage tiers are ported),
``--max-inflight-bytes`` (the transient memory budget) and
``--spill-dir`` (with it, over-budget reducer outputs spill to Arrow IPC
files there).

The process group runs NCCL on cards and gloo with ``--cpu``;
``--process-group-backend gloo`` asks for gloo on CUDA tensors, which
ranks that share one card need (NCCL refuses two ranks on one device).

Prints one line per epoch and rank; ``--stats-dir`` writes each rank's
``host_{rank}_epochs.csv``. ``--record-dir`` also loads the ``key``
column and writes each rank's ``rank_{rank}.json`` (losses, step and
all-reduce milliseconds, gather launches, rows/s, ``stall_pct``,
transport counters, the shuffle's per-epoch stage seconds from its
``TrialStats``, the file cache's and the buffer ledger's counters) and ``rank_{rank}.npz`` (every key delivered per
epoch, and each batch's ``device_dataset.batch_digest``): the loader
then also keeps each epoch's last partial batch, which, like any batch
after the vote stops, is recorded but not trained on.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import time
import timeit
from typing import List, Tuple


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-rows", type=int, default=200_000)
    p.add_argument("--num-files", type=int, default=8)
    p.add_argument("--num-row-groups-per-file", type=int, default=2)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--num-reducers", type=int, default=None)
    p.add_argument("--max-concurrent-epochs", type=int, default=2)
    p.add_argument("--mock-train-step-time", type=float, default=None,
                   help="replace the train step with a sleep of this many "
                        "seconds (the loader alone)")
    p.add_argument("--data-dir", type=str, default="./example_data")
    p.add_argument("--use-old-data", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--file-cache", choices=["auto", "none", "disk"],
                   default="auto",
                   help="decoded-table cache: auto (RAM), none (re-decode "
                        "every epoch), disk (Arrow IPC files on local "
                        "scratch)")
    p.add_argument("--max-inflight-bytes", type=int, default=None,
                   help="transient pipeline memory budget (bytes)")
    p.add_argument("--spill-dir", type=str, default=None,
                   help="with --max-inflight-bytes: spill over-budget "
                        "reducer outputs to Arrow IPC files here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host instead of the card")
    p.add_argument("--tiny-model", action="store_true",
                   help="cap the vocabularies at 1,000, embed 8, top MLP "
                        "(64, 32)")
    p.add_argument("--distributed", action="store_true",
                   help="join a world of processes (MASTER_ADDR, "
                        "MASTER_PORT, WORLD_SIZE, RANK)")
    p.add_argument("--stats-dir", type=str, default=None,
                   help="write this rank's host_{rank}_epochs.csv here")
    p.add_argument("--process-group-backend", choices=("nccl", "gloo"),
                   default=None,
                   help="default: nccl on the card, gloo with --cpu")
    p.add_argument("--record-dir", type=str, default=None,
                   help="write this rank's delivered keys, batch digests, "
                        "losses and timings here")
    return p.parse_args(argv)


def _device(args):
    import torch
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run on "
                           "the host")
    device = torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", "0"))
        % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _hosts(spec: str) -> List[Tuple[str, int]]:
    addresses = []
    for entry in spec.split(","):
        host, _, port = entry.strip().rpartition(":")
        addresses.append((host, int(port)))
    return addresses


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _device(args)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_shuffling_data_loader_tpu_torch import data_generation as dg
    from ray_shuffling_data_loader_tpu_torch import (executor, native,
                                                     shuffle, train)
    from ray_shuffling_data_loader_tpu_torch import stats as stats_mod
    from ray_shuffling_data_loader_tpu_torch.device_dataset import (
        DeviceShufflingDataset, batch_digest, make_cast_transform)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.ops import embedding as emb
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    from ray_shuffling_data_loader_tpu_torch.parallel.trainer import (
        SpmdTrainer)
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir
    from ray_shuffling_data_loader_tpu_torch.stats import BatchWaitStats
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    backend = args.process_group_backend or (
        "gloo" if device.type == "cpu" else "nccl")
    if args.distributed:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    mesh = pmesh.make_mesh(device=device)
    rank, world = pmesh.local_data_shard_info(mesh)

    if args.use_old_data:
        filenames = glob.glob(os.path.join(args.data_dir, "*.parquet.snappy"))
        if not filenames:
            raise FileNotFoundError(f"no *.parquet.snappy in {args.data_dir}")
    else:
        # Every rank writes the same seeded files (no shared file system
        # needed); each file is renamed into place whole.
        filenames, _ = dg.generate_data(
            args.num_rows, args.num_files, args.data_dir, seed=args.seed,
            num_row_groups_per_file=args.num_row_groups_per_file)
    sorted_files = sorted(filenames)

    if args.tiny_model:
        # Ids past a capped vocabulary are clamped by the lookup.
        config = dlrm.DLRMConfig(
            vocab_sizes=tuple(min(v, 1000)
                              for v in dlrm.DATA_SPEC_VOCAB_SIZES),
            embed_dim=8, top_hidden=(64, 32))
    else:
        config = dlrm.MLPERF
    record = args.record_dir is not None
    trainer = None
    if args.mock_train_step_time is None:
        model = dlrm.DLRM(config, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(args.seed))
        trainer = SpmdTrainer(
            mesh, lambda m, *b: dlrm.loss_fn(m, None, list(b[:-1]),
                                             b[-1]) / world,
            model, train.make_optimizer(model, args.learning_rate),
            time_collectives=record)

    spec = dlrm_criteo.dlrm_spec()
    num_model_features = len(spec["feature_columns"])
    if record:
        spec["feature_columns"].append(dg.KEY_COLUMN)
        spec["feature_types"].append(np.dtype(np.int64))
    dataset_kwargs = dict(
        num_epochs=args.num_epochs, num_trainers=1,
        batch_size=args.batch_size, rank=0,
        max_concurrent_epochs=args.max_concurrent_epochs, seed=args.seed,
        drop_last=not record, device=device, **spec)
    engine_kwargs = dict(
        file_cache=None if args.file_cache == "none" else args.file_cache,
        max_inflight_bytes=args.max_inflight_bytes,
        spill_dir=args.spill_dir, collect_stats=record)
    native.buffer_ledger().reset_peak()
    cache_before = shuffle.file_cache_totals()
    transport = shuffle_result = None
    if world > 1 and os.environ.get("RSDL_HOSTS"):
        # The global shuffle: rows of any rank's files reach any rank.
        from ray_shuffling_data_loader_tpu_torch.parallel.distributed import (
            create_distributed_batch_queue_and_shuffle)
        from ray_shuffling_data_loader_tpu_torch.parallel.transport import (
            TcpTransport)
        addresses = _hosts(os.environ["RSDL_HOSTS"])
        if len(addresses) != world:
            raise ValueError(f"RSDL_HOSTS lists {len(addresses)} endpoints "
                             f"for a world of {world}")
        transport = TcpTransport(rank, addresses)
        transport.start()
        transport.connect()
        # The shard plan, hence every tag, depends on the reducer count, so
        # it must not depend on anything local (such as the core count);
        # the launch's world is fixed for the run.
        # rsdl-lint: disable=fixed-world-assumption
        num_reducers = args.num_reducers or 8 * world
        batch_queue, shuffle_result = (
            create_distributed_batch_queue_and_shuffle(
                sorted_files, args.num_epochs, num_reducers, transport,
                max_concurrent_epochs=args.max_concurrent_epochs,
                seed=args.seed, map_transform=make_cast_transform(
                    spec["feature_columns"], spec["feature_types"],
                    spec["label_column"], spec["label_type"]),
                **engine_kwargs))
        ds = DeviceShufflingDataset(sorted_files, batch_queue=batch_queue,
                                    shuffle_result=shuffle_result,
                                    **dataset_kwargs)
    else:
        # Each rank shuffles its own files: no exchange, weaker mixing.
        local_files = [f for i, f in enumerate(sorted_files)
                       # rsdl-lint: disable=fixed-world-assumption
                       if i % world == rank]
        ds = DeviceShufflingDataset(local_files,
                                    num_reducers=args.num_reducers,
                                    **dataset_kwargs, **engine_kwargs)

    waits = ds.batch_wait_stats.wait_times
    # A bounded run of the declared epoch count, recorded per epoch.
    # rsdl-lint: disable=static-epoch-assumption
    keys: List[List[np.ndarray]] = [[] for _ in range(args.num_epochs)]
    digests, losses, step_ms, steps_by_epoch = [], [], [], []

    def note(epoch: int, batch) -> None:
        features, label = batch
        keys[epoch].append(features[-1].reshape(-1).cpu().numpy())
        digests.append(batch_digest(features, label))

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    epoch_rows = []
    run_wait_total, run_wait_count = 0.0, 0
    emb.reset_launch_counts()
    t_first = None
    for epoch in plan_ir.epoch_range(0, args.num_epochs):
        ds.set_epoch(epoch)
        epoch_start = timeit.default_timer()
        n0 = len(waits)
        steps, last_loss = 0, float("nan")
        it = iter(ds)
        while True:
            batch = next(it, None)
            if t_first is None:
                t_first = timeit.default_timer()
            if record and batch is not None:
                note(epoch, batch)
            full = batch is not None and batch[1].shape[0] == args.batch_size
            if world > 1:
                # Continue-vote: every rank steps, or none does.
                vote = torch.tensor([int(full)], dtype=torch.int32,
                                    device=device)
                dist.all_reduce(vote, op=dist.ReduceOp.MIN)
                if not vote.item():
                    break
            elif not full:
                break
            features, label = batch
            if trainer is None:
                time.sleep(args.mock_train_step_time)
            else:
                t0 = timeit.default_timer()
                last_loss = trainer.train_step(
                    *features[:num_model_features], label)
                if record:
                    sync()
                    step_ms.append((timeit.default_timer() - t0) * 1e3)
                    losses.append(float(last_loss))
            steps += 1
        if record:
            # Delivered after the vote stopped: recorded, not trained on.
            for batch in it:
                note(epoch, batch)
        if trainer is not None:
            trainer.block_until_ready()
            last_loss = float(last_loss)
        duration = timeit.default_timer() - epoch_start
        steps_by_epoch.append(steps)
        w = BatchWaitStats(waits[n0:]).summary()
        run_wait_total += w["total"]
        run_wait_count += w["count"]
        print(f"[rank {rank}] epoch {epoch}: {steps} steps in "
              f"{duration:.2f}s ({steps * args.batch_size / duration:,.0f} "
              f"rows/s), loss={last_loss:.4f}, "
              f"batch-wait mean={w['mean'] * 1e3:.1f}ms "
              f"max={w['max'] * 1e3:.1f}ms total={w['total']:.2f}s",
              flush=True)
        epoch_rows.append({
            "rank": rank, "epoch": epoch, "steps": steps,
            "duration_s": round(duration, 4),
            "rows_per_s": round(steps * args.batch_size / duration, 1),
            "loss": round(last_loss, 6) if trainer is not None else "",
            "batch_wait_mean_ms": round(w["mean"] * 1e3, 3),
            "batch_wait_max_ms": round(w["max"] * 1e3, 3),
            "batch_wait_total_s": round(w["total"], 4),
        })
    wall = timeit.default_timer() - t_first
    print(f"[rank {rank}] DONE: {run_wait_count} batches, "
          f"total stall {run_wait_total:.2f}s "
          f"(mean {run_wait_total / max(1, run_wait_count) * 1e3:.1f}"
          "ms/batch)", flush=True)
    # Every chunk this rank sends has been sent before its transport
    # closes; with --record-dir the result is this rank's TrialStats.
    trial = ds.shuffle_result.result()
    if args.stats_dir:
        os.makedirs(args.stats_dir, exist_ok=True)
        path = os.path.join(args.stats_dir, f"host_{rank}_epochs.csv")
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(epoch_rows[0])
                                    if epoch_rows else ["rank"])
            writer.writeheader()
            writer.writerows(epoch_rows)
        print(f"[rank {rank}] stats written to {path}", flush=True)
    if record:
        os.makedirs(args.record_dir, exist_ok=True)
        rows = sum(len(k) for epoch_keys in keys for k in epoch_keys)
        summary = {
            "rank": rank, "world": world, "backend": backend,
            "device": str(device), "binding": ds.binding,
            "steps_by_epoch": steps_by_epoch, "losses": losses,
            "step_ms": step_ms,
            "collective_ms": (trainer.collective_ms if trainer is not None
                              else []),
            "gather_launches": emb.launch_counts["gather_rows"],
            "rows_delivered": rows, "wall_s": wall,
            "rows_per_s": rows / wall,
            "stall_pct": 100.0 * sum(waits[1:]) / wall,
            "transport": (transport.stats() if transport is not None
                          else None),
            "shuffle_stages": stats_mod.trial_summary(trial),
            "file_cache": {k: v - cache_before[k] for k, v in
                           shuffle.file_cache_totals().items()},
            "ledger_peak_bytes": native.buffer_ledger().peak_bytes(),
            "executor_backend": executor.last_worker_pool()["backend"],
        }
        with open(os.path.join(args.record_dir, f"rank_{rank}.json"),
                  "w") as f:
            json.dump(summary, f)
        np.savez(os.path.join(args.record_dir, f"rank_{rank}.npz"),
                 digests=torch.stack(digests).cpu().numpy(),
                 **{f"keys_{e}": np.concatenate(k) if k else
                    np.zeros(0, np.int64) for e, k in enumerate(keys)})
    ds.close()
    if transport is not None:
        transport.close()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
