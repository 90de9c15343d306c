"""The port's launcher (``launch_slice``) and entry point
(``train_shuffle``): the JAX launcher's argument and exit-code rules
(``tests/test_launch_slice.py``), and a world of two processes on the CPU
that trains ``--tiny-model`` DLRM through ``SpmdTrainer`` over gloo on
the global distributed shuffle, every key delivered exactly once across
the ranks."""

import csv
import json
import os
import socket

import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu_torch import launch_slice


def test_parse_splits_train_args_at_double_dash():
    args = launch_slice.parse_args(
        ["--local", "--out", "/tmp/x", "--",
         "--cpu", "--num-rows", "4096"])
    assert args.local
    assert args.out == "/tmp/x"
    assert args.train_args == ["--cpu", "--num-rows", "4096"]


def test_parse_no_train_args():
    args = launch_slice.parse_args(["--local"])
    assert args.train_args == []


def test_requires_rsdl_hosts(monkeypatch, capsys):
    monkeypatch.delenv("RSDL_HOSTS", raising=False)
    assert launch_slice.main(["--local"]) == 2
    assert "RSDL_HOSTS is required" in capsys.readouterr().err


def test_rejects_mismatched_ssh_targets(monkeypatch, capsys):
    monkeypatch.setenv("RSDL_HOSTS", "a:1,b:2,c:3")
    rc = launch_slice.main(["--ssh", "hostA,hostB"])
    assert rc == 2
    assert "3 endpoints" in capsys.readouterr().err


def test_rejects_local_plus_ssh(monkeypatch, capsys):
    monkeypatch.setenv("RSDL_HOSTS", "a:1")
    assert launch_slice.main(["--local", "--ssh", "x"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err


def _free_ports(n: int):
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


def _world_env(monkeypatch, num_hosts: int) -> int:
    """Sets ``RSDL_HOSTS`` to ``num_hosts`` free loopback ports and one
    OpenMP thread per host (the suite's other workers share the cores);
    returns a free port for the process group's rendezvous."""
    *shuffle_ports, master = _free_ports(num_hosts + 1)
    monkeypatch.setenv("RSDL_HOSTS", ",".join(
        f"127.0.0.1:{p}" for p in shuffle_ports))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return master


def test_a_failing_host_fails_the_launch(monkeypatch, tmp_path):
    master = _world_env(monkeypatch, 2)
    empty = tmp_path / "no_data"
    empty.mkdir()
    rc = launch_slice.main([
        "--local", "--out", str(tmp_path / "out"),
        "--coordinator-port", str(master), "--",
        "--cpu", "--use-old-data", "--data-dir", str(empty)])
    assert rc != 0


def _two_process_world(monkeypatch, tmp_path, device_args):
    """``launch_slice --local`` over two ranks, one epoch of
    ``--tiny-model`` on 4,000 rows; checks each rank's CSV, that every key
    arrives exactly once across the ranks, and that the ranks stepped
    together on one global loss. Returns the ranks' summaries."""
    master = _world_env(monkeypatch, 2)
    out, record = tmp_path / "out", tmp_path / "record"
    num_rows = 4000
    rc = launch_slice.main([
        "--local", "--out", str(out), "--coordinator-port", str(master),
        "--", *device_args, "--tiny-model", "--num-rows", str(num_rows),
        "--num-files", "4", "--num-epochs", "1", "--batch-size", "500",
        "--data-dir", str(tmp_path / "data"), "--record-dir", str(record)])
    assert rc == 0
    keys, summaries = [], []
    for rank in range(2):
        with open(out / f"host_{rank}" / f"host_{rank}_epochs.csv") as f:
            rows = list(csv.DictReader(f))
        assert [int(r["epoch"]) for r in rows] == [0]
        assert int(rows[0]["steps"]) >= 1 and float(rows[0]["loss"]) > 0
        with open(record / f"rank_{rank}.json") as f:
            summaries.append(json.load(f))
        keys.append(np.load(record / f"rank_{rank}.npz")["keys_0"])
    assert sorted(np.concatenate(keys).tolist()) == list(range(num_rows))
    for s in summaries:
        assert s["world"] == 2 and s["backend"] == "gloo"
        assert s["steps_by_epoch"] == summaries[0]["steps_by_epoch"]
        assert np.isfinite(s["losses"]).all()
        # One all-reduce of the summed loss: every rank reports it.
        assert s["losses"] == summaries[0]["losses"]
        assert len(s["collective_ms"]) == len(s["losses"])
        assert s["transport"]["frames_sent"] > 0
    assert (summaries[0]["transport"]["bytes_sent"]
            == summaries[1]["transport"]["bytes_received"])
    return summaries


def test_two_process_world_trains_through_spmd_trainer(monkeypatch,
                                                       tmp_path):
    """ROADMAP item 6's acceptance: two ranks on the CPU, one epoch, gloo,
    the global shuffle, ``SpmdTrainer``."""
    summaries = _two_process_world(monkeypatch, tmp_path, ["--cpu"])
    assert all(s["device"] == "cpu" for s in summaries)
    assert os.listdir(tmp_path / "data")


@pytest.mark.cuda
def test_cuda_two_process_world_shares_one_card_over_gloo(monkeypatch,
                                                          tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    summaries = _two_process_world(monkeypatch, tmp_path,
                                   ["--process-group-backend", "gloo"])
    assert all(s["device"].startswith("cuda") for s in summaries)
    assert all(s["binding"] == "bulk" for s in summaries)
