#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's DLRM train path end to end at full width and checks its
hand-written kernels against their plain PyTorch versions. Phases, each
printing one JSON line:

1. ``env``: torch/CUDA versions and the card's name and power limit.
2. ``build``: builds ``kernels/gather.cu`` for sm_90a from the sources.
3. ``kernels``: the gather kernel against ``gather_reference`` on the card
   at the ``mlperf`` shapes (V=945195, E=128, B in {2048, 131072}, int32
   indices including out-of-range ones): f32 and bf16 outputs bit-identical,
   table gradient within 1e-6 relative. Times (CUDA events) for the kernel,
   the plain version and ``torch.index_select``, beside the bound.
4. ``train``: 2,000,000 generated rows in 8 Parquet files -> seeded
   shuffle (8 reducers) -> ``DeviceShufflingDataset`` (1 trainer, batch
   131072, 2 epochs, seed 0) -> DLRM ``mlperf`` (all 19 tables, embed 128,
   top MLP 1024-1024-512-256, bf16 compute, random weights from seed 0)
   -> Adam, one micro-step per 2048 rows. Checks rows per epoch, finite
   losses, the first staged batch against a host-side shuffle, the kernel
   path's loss against the ``take`` path's, and that the gather kernel ran.

Then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import timeit

import numpy as np
import torch

# Peak HBM bandwidth (bytes/s) by card name, from NVIDIA's data sheets.
# Longest match first: "H100 NVL" and "H100 PCIe" before plain "H100"
# (the SXM part, "NVIDIA H100 80GB HBM3").
_HBM_PEAK = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12)]

V, E = 945195, 128
BATCHES = (2048, 131072)
MICROBATCH = 2048
NUM_ROWS, NUM_FILES = 2_000_000, 8
LOADER_BATCH, NUM_REDUCERS, NUM_EPOCHS, SEED = 131072, 8, 2, 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def hbm_peak(name: str) -> float:
    for key, rate in _HBM_PEAK:
        if key in name:
            return rate
    raise RuntimeError(f"no peak HBM bandwidth on record for {name!r}")


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
    # Every gather shape of the main path: the 8 tables above 2048 rows.
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    for vocab in (v for v in dlrm.MLPERF.vocab_sizes
                  if v > emb.ONE_HOT_MAX_VOCAB):
        t = torch.randn((vocab, E), device="cuda", generator=g)
        idx = torch.randint(0, vocab, (MICROBATCH,), device="cuda",
                            dtype=torch.int32, generator=g)
        if not torch.equal(emb.gather_rows(t, idx, torch.bfloat16),
                           emb.gather_reference(t, idx, torch.bfloat16)):
            raise AssertionError(f"gather_rows differs at V={vocab}")
    del table
    torch.cuda.empty_cache()
    return {"timings": results, "max_abs_err": max_err}


def _short(kernel_name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::", "c10::"):
        kernel_name = kernel_name.replace(noise, "")
    return kernel_name[:160]


def profile_steps(micro_step, cols, labels, steps: int = 5) -> dict:
    """Device time by kernel over ``steps`` micro-steps (torch.profiler;
    GPU-side user annotations such as ``Optimizer.step#Adam.step`` span
    kernels already counted and are left out), and the device's busy
    share of the same steps' wall time measured without the profiler."""
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
        "gather_rows_ms_per_step": sum(
            us for us, _, key in kernels if "gather_rows" in key) / steps
        / 1e3,
    }


def train_phase(emb) -> dict:
    from ray_shuffling_data_loader_tpu_torch import (
        data_generation, dataset, device_dataset, train)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo

    spec = dlrm_criteo.dlrm_spec()
    with tempfile.TemporaryDirectory(prefix="rsdl-smoke-") as tmp:
        start = timeit.default_timer()
        files, _ = data_generation.generate_data(NUM_ROWS, NUM_FILES, tmp,
                                                 seed=SEED)
        gen_s = timeit.default_timer() - start

        config = dlrm.MLPERF
        model = dlrm.DLRM(config, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(SEED))
        optimizer = train.make_optimizer(model)
        micro_step = train.make_micro_step(model, optimizer)

        ds = device_dataset.DeviceShufflingDataset(
            files, NUM_EPOCHS, 1, LOADER_BATCH, 0, num_reducers=NUM_REDUCERS,
            seed=SEED, **spec)
        expected_rows = (NUM_ROWS // LOADER_BATCH) * LOADER_BATCH
        rows_per_epoch, losses, chunk_ms, first_batch = [], [], [], None
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
                t0 = timeit.default_timer()
                losses.append(train.train_chunk(micro_step, features, label,
                                                MICROBATCH))
                torch.cuda.synchronize()
                chunk_ms.append((timeit.default_timer() - t0) * 1e3)
                rows += label.shape[0]
            rows_per_epoch.append(rows)
        t_end = timeit.default_timer()
        launches = emb.launch_counts["gather_rows"]

        if rows_per_epoch != [expected_rows] * NUM_EPOCHS:
            raise AssertionError(
                f"rows per epoch {rows_per_epoch}, expected {expected_rows}")
        all_losses = torch.cat(losses).cpu()
        if not bool(torch.isfinite(all_losses).all()):
            raise AssertionError("non-finite loss")
        if launches <= 0:
            raise AssertionError("the gather kernel never ran in training")

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
        breakdown = profile_steps(micro_step, cols, lab)

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
        "datagen_s": gen_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": breakdown,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    from ray_shuffling_data_loader_tpu_torch.ops import embedding as emb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peak = hbm_peak(name)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": name, "nvidia_smi": smi, "hbm_peak_bytes_s": peak,
          "tf32": False})

    start = timeit.default_timer()
    build.gather_library()
    emit({"phase": "build", "kernel": "gather_rows",
          "seconds": timeit.default_timer() - start, "flags": build.CUDA_FLAGS})

    kern = kernels_phase(emb, peak)
    emit({"phase": "kernels", "card": smi, "status": {"gather_rows": "ok"},
          **kern})

    trained = train_phase(emb)
    emit({"phase": "train", "card": smi, **trained})

    main_path = kern["timings"][f"B{MICROBATCH}_bf16"]
    emit({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "ray_shuffling_data_loader_tpu_torch/kernels/gather.cu",
        "replaces": "ray_shuffling_data_loader_tpu/ops/embedding.py:64",
        "launches": trained["gather_launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"], "bound_by": "bytes",
        "library_ms": kern["timings"][f"B{MICROBATCH}_f32"]["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
