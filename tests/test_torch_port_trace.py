"""The port's causal trace (``runtime/trace.py``) against the JAX
package's, and the process pool's share of the telemetry.

- ``trace_id``/``span_id`` give the JAX package's strings.
- On one recorded run (a port shuffle on threads, 2 epochs), the dump
  loads and merges the same in both packages, and ``analyze``,
  ``stage_table``, ``bench_fields`` and ``to_perfetto`` give equal
  results; so do they on the in-process event list.
- A shuffle on a process pool of 2 with ``RSDL_TELEMETRY_DIR`` and
  ``RSDL_TRACE_DIR`` set: every worker writes a metrics shard named by
  its own pid (``rsdl_worker_tasks_total`` exists only there) and dumps
  its recorder when it ends; the dumps hold one ``map_read`` per (epoch,
  file) and one ``reduce_gather`` per (epoch, reducer); the driver's
  attribution sees both stages (``observe_stage``) without ring events of
  its own; the reducer outputs are stamped in the worker that built
  them; the merged trace of the driver and the workers analyzes the same
  in both packages.
"""

import glob
import os

import jax  # noqa: F401  (imported before any worker thread needs it)
import pytest

from ray_shuffling_data_loader_tpu.runtime import metrics as jmetrics
from ray_shuffling_data_loader_tpu.runtime import trace as jtrace
from ray_shuffling_data_loader_tpu_torch import data_generation as tdg
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import spill as tspill
from ray_shuffling_data_loader_tpu_torch.runtime import latency as tlat
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import telemetry as ttel
from ray_shuffling_data_loader_tpu_torch.runtime import trace as ttrace

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

NUM_FILES = 4
NUM_REDUCERS = 4
NUM_EPOCHS = 2
SEED = 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tdg.generate_data(
        1600, NUM_FILES, str(tmp_path_factory.mktemp("trace")), seed=0)[0]


@pytest.fixture(autouse=True)
def fresh_recorder():
    ttel.configure(enabled_flag=True, capacity=1 << 16)
    yield
    ttel.configure()


def test_trace_ids_equal():
    for seed, epoch in ((0, 0), (7, 3), (2**31, 12)):
        assert ttrace.trace_id(seed, epoch) == jtrace.trace_id(seed, epoch)
        for kind, task in (("map_read", 0), ("reduce_gather", 5),
                           ("train_step", None)):
            assert ttrace.span_id(seed, epoch, kind, task) == \
                jtrace.span_id(seed, epoch, kind, task)


def _shuffle(files, **kwargs):
    """A port shuffle whose consumer takes every reducer output."""
    outputs = []

    def consumer(rank, epoch, refs):
        if refs is not None:
            outputs.extend((epoch, tspill.unwrap(r.result())) for r in refs)

    tsh.shuffle(files, consumer, NUM_EPOCHS, NUM_REDUCERS, 1, seed=SEED,
                **kwargs)
    return outputs


def _assert_analyses_equal(tmerged, jmerged):
    assert tmerged == jmerged
    for epoch in (None, 0, 1):
        tan = ttrace.analyze(tmerged["events"], epoch=epoch)
        jan = jtrace.analyze(jmerged["events"], epoch=epoch)
        assert tan == jan
        assert ttrace.stage_table(tan) == jtrace.stage_table(jan)
    assert ttrace.to_perfetto(tmerged, seed=SEED) == \
        jtrace.to_perfetto(jmerged, seed=SEED)
    assert ttrace.bench_fields(tmerged["events"]) == \
        jtrace.bench_fields(jmerged["events"])


def test_analyses_equal_on_a_recorded_run(files, tmp_path):
    outputs = _shuffle(files, num_workers=2)
    assert len(outputs) == NUM_EPOCHS * NUM_REDUCERS
    events = ttel.recorder().events()
    tan, jan = ttrace.analyze(events), jtrace.analyze(events)
    assert tan == jan
    assert {"map_read", "reduce"} <= {c["stage"]
                                      for c in tan["critical_path"]}
    path = ttel.dump(str(tmp_path / "rsdl-telemetry-run.jsonl"))
    _assert_analyses_equal(ttrace.merge_dumps([path]),
                           jtrace.merge_dumps([path]))
    # The lineage and birth stamps ride each output's schema.
    for epoch, table in outputs:
        meta = table.schema.metadata
        seed, ep, task = meta[b"rsdl.trace"].decode().split(":")
        assert (int(seed), int(ep)) == (SEED, epoch)
        assert tlat.parse_stamp(meta[tlat.BIRTH_META_KEY]).pid == os.getpid()


def test_process_pool_workers_shard_dump_and_stamp(files, tmp_path,
                                                   monkeypatch):
    tel_dir, trace_dir = tmp_path / "tel", tmp_path / "trace"
    monkeypatch.setenv("RSDL_TELEMETRY_DIR", str(tel_dir))
    monkeypatch.setenv("RSDL_TRACE_DIR", str(trace_dir))
    outputs = _shuffle(files, num_workers=2, executor_backend="process",
                       file_cache=None)
    assert len(outputs) == NUM_EPOCHS * NUM_REDUCERS
    # Each worker: a shard of its own pid with its tasks counted.
    shards = tmetrics.read_shards(str(tel_dir))
    worker_pids = {pid for pid, (samples, _, _) in shards.items()
                   if "rsdl_worker_tasks_total" in samples}
    assert len(worker_pids) == 2 and os.getpid() not in worker_pids
    merged, _types = tmetrics.merge_series(
        [shards[p][:2] for p in sorted(shards)])
    jmerged, _ = jmetrics.merge_series(
        [shards[p][:2] for p in sorted(shards)])
    assert merged == jmerged
    assert sum(merged["rsdl_worker_tasks_total"].values()) == \
        NUM_EPOCHS * (NUM_FILES + NUM_REDUCERS)
    # Each worker's dump holds its map_read and reduce_gather events.
    dumps = sorted(glob.glob(str(trace_dir / "rsdl-telemetry-*.jsonl")))
    loaded = [ttrace.load_dump(p) for p in dumps]
    by_pid = {d["meta"]["pid"] for d in loaded}
    assert worker_pids <= by_pid
    keys = sorted((e["kind"], e["epoch"], e["task"])
                  for d in loaded for e in d["events"]
                  if e["kind"] in ("map_read", "reduce_gather"))
    assert keys == sorted(
        [("map_read", ep, f) for ep in range(NUM_EPOCHS)
         for f in range(NUM_FILES)]
        + [("reduce_gather", ep, r) for ep in range(NUM_EPOCHS)
           for r in range(NUM_REDUCERS)])
    # The driver's attribution has both stages, its ring neither.
    for epoch in range(NUM_EPOCHS):
        stages = ttel.attribution().epoch_verdict(epoch)["stages"]
        assert stages["map_read"]["count"] == NUM_FILES
        assert stages["reduce"]["count"] == NUM_REDUCERS
    assert not [e for e in ttel.recorder().events()
                if e["kind"] in ("map_read", "reduce_gather")]
    # Born in the worker that built them.
    for _epoch, table in outputs:
        stamp = tlat.parse_stamp(table.schema.metadata[tlat.BIRTH_META_KEY])
        assert stamp.pid in worker_pids
    # Driver plus workers: one merged trace, analyzed alike.
    driver = ttel.dump(str(trace_dir / "rsdl-telemetry-driver.jsonl"))
    paths = dumps + [driver]
    tmerged, jmerged_trace = ttrace.merge_dumps(paths), \
        jtrace.merge_dumps(paths)
    assert len(tmerged["processes"]) == len(by_pid | {os.getpid()})
    _assert_analyses_equal(tmerged, jmerged_trace)
