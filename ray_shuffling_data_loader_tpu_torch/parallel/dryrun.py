"""The multi-rank dry run: one tensor-parallel DLRM train step over a
``("data", "model")`` mesh, then the same step fed by the real loader
(counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

``python -m ray_shuffling_data_loader_tpu_torch.parallel.dryrun N
[--cpu]`` runs :func:`dryrun_multichip` from the command line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODULE = "ray_shuffling_data_loader_tpu_torch.parallel.dryrun"
LOADER_STEPS = 2


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 600.0) -> List[dict]:
    """Train the JAX dry run's tiny DLRM (``vocab_sizes=(32, 16, 48, 8)``,
    ``embed_dim=8 mp``, ``top_hidden=(16 mp, 8 mp)``, Adam) through
    ``SpmdTrainer`` with ``dlrm.param_specs`` on a mesh of ``n_devices``
    ranks, ``mp = 2`` on the model axis when ``n_devices`` is even (else
    1): one step on a global batch of ``4 * data`` rows from numpy seed 0
    with a finite loss, then ``LOADER_STEPS`` steps fed by a tiny Parquet
    corpus through ``DeviceShufflingDataset`` in the bulk binding
    (``device_rebatch=True``; its shuffle on threads: two files of
    ``16 * data`` rows) under the process watchdog with the ``"degrade"``
    stall action, which must not engage.

    Runs in this process when the default process group already has
    ``n_devices`` ranks (each rank calls it). Otherwise it starts
    ``n_devices`` processes (``python -m`` this module) that join one gloo
    group over a ``file://`` rendezvous in a temporary directory, on
    ``device`` (``None``: CUDA, raising without it; every rank on the card
    ``rank % device_count``), and waits up to ``timeout_s``. Returns each
    rank's summary; any failure raises here (``RuntimeError`` with the
    failing rank's output).
    """
    device = resolve_device(device)
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return [_dryrun_impl(n_devices, device)]
    return _spawn(n_devices, device, timeout_s)


def _spawn(n: int, device: torch.device, timeout_s: float) -> List[dict]:
    with tempfile.TemporaryDirectory(prefix="rsdl-dryrun-") as tmp:
        env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        # The ranks share this host's cores.
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // n)))
        logs = [os.path.join(tmp, f"rank{rank}.log") for rank in range(n)]
        procs = []
        for rank, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", _MODULE, str(n), "--rank",
                     str(rank), "--init", f"file://{tmp}/rendezvous",
                     "--out", tmp, "--device", device.type],
                    cwd=_REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        try:
            for proc in procs:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun_multichip({n}) ran past "
                               f"{timeout_s} s") from None
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode:
                with open(log) as f:
                    raise RuntimeError(
                        f"dryrun_multichip({n}): rank {rank} exited "
                        f"{proc.returncode}:\n{f.read()[-6000:]}")
        out = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                out.append(json.load(f))
        return out


def _write_corpus(directory: str, vocab_sizes, rows: int,
                  rng: np.random.Generator) -> List[str]:
    import pyarrow as pa
    import pyarrow.parquet as pq
    files = []
    for i in range(2):
        cols = {f"emb_{j}": pa.array(rng.integers(0, v, rows)
                                     .astype(np.int32))
                for j, v in enumerate(vocab_sizes)}
        cols["labels"] = pa.array(rng.random(rows).astype(np.float32))
        path = os.path.join(directory, f"part_{i}.parquet")
        pq.write_table(pa.table(cols), path)
        files.append(path)
    return files


def _dryrun_impl(n: int, device: torch.device) -> dict:
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.device_dataset import (
        DeviceShufflingDataset)
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr
    from ray_shuffling_data_loader_tpu_torch.runtime import (
        watchdog as rt_watchdog)

    mp = 2 if n % 2 == 0 else 1
    mesh = pmesh.make_mesh(model_parallel=mp, device=device)
    data_rank, data_size = pmesh.local_data_shard_info(mesh)
    config = dlrm.DLRMConfig(vocab_sizes=(32, 16, 48, 8), embed_dim=8 * mp,
                             top_hidden=(16 * mp, 8 * mp))
    model = dlrm.DLRM(config, device=device, generator=torch.Generator(
        device=device).manual_seed(0))

    def loss_fn(m, sparse, labels):
        return dlrm.loss_fn(m, None, sparse, labels) / data_size

    trainer = ptr.SpmdTrainer(mesh, loss_fn, model,
                              train.make_optimizer(model),
                              param_specs=dlrm.param_specs(config))
    batch = 4 * data_size
    rng = np.random.default_rng(0)
    sparse = np.stack([rng.integers(0, v, batch) for v in config.vocab_sizes],
                      axis=1).astype(np.int32)
    labels = rng.random((batch, 1)).astype(np.float32)
    loss = float(trainer.train_step(*ptr.batch_shardings(mesh, (
        torch.from_numpy(sparse).to(device),
        torch.from_numpy(labels).to(device)))))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    features = [f"emb_{j}" for j in range(config.num_sparse)]
    with tempfile.TemporaryDirectory(prefix="rsdl-dryrun-data-") as tmp:
        # Every rank writes the same corpus (one seed) where it can read it.
        files = _write_corpus(tmp, config.vocab_sizes, 16 * data_size, rng)
        ds = DeviceShufflingDataset(
            files, num_epochs=1, num_trainers=data_size, batch_size=4,
            rank=data_rank, feature_columns=features,
            feature_types=[np.int32] * len(features), label_column="labels",
            num_reducers=2, seed=0, device=device, stack_features=True,
            device_rebatch=True, executor_backend="thread")
        converter = ds._converter
        if converter.watchdog is not rt_watchdog.get_watchdog():
            raise RuntimeError("the bulk binding runs without the watchdog")
        if converter.stall_action != "degrade":
            raise RuntimeError(f"stall action {converter.stall_action!r}")
        loader_losses = []
        try:
            ds.set_epoch(0)
            for feats, lbls in ds:
                loader_losses.append(float(trainer.train_step(
                    feats, lbls.reshape(-1, 1))))
                if len(loader_losses) == LOADER_STEPS:
                    break
        finally:
            ds.close()
        trainer.block_until_ready()
    if len(loader_losses) < LOADER_STEPS or not np.all(
            np.isfinite(loader_losses)):
        raise RuntimeError(f"loader steps: {loader_losses}")
    if not converter.device_rebatch or converter.fallback_engaged:
        raise RuntimeError("the bulk binding degraded in a healthy run")
    return {"n_devices": n, "mesh": [data_size, mp], "rank": dist.get_rank(),
            "loss": loss, "loader_losses": loader_losses,
            "binding": "bulk", "device": str(device)}


def _main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: CUDA)")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--init", help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    parser.add_argument("--device", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is None:
        out = dryrun_multichip(args.n_devices,
                               device="cpu" if args.cpu else None)
        print(json.dumps(out))
        return 0
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.n_devices)
    try:
        summary = _dryrun_impl(args.n_devices, device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
