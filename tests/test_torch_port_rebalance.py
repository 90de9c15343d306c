"""The port's live queue rebalancing (``rebalance/``,
``plan.scheduler.rebalance_queues``, the ``OP_REBALANCE`` actuator,
``KIND_MOVED`` redirects and the generation fence in
``multiqueue_service``) against the JAX package's, on the CPU.

- The decision plane: ``apply_decision`` folds, ``replay`` and
  ``rebalance_queues`` equal the JAX package's on the same decision
  sequences and move sets, errors included; the journal's bytes equal
  JAX's and each package replays the other's; torn tail, CRC tamper, a
  divergent but valid line and ``compact`` behave as JAX's; a restart
  aborts a trailing intent; the commit budget blocks a ping-pong; the
  three ``rebalance_*`` policy keys and the chaos selectors resolve as
  JAX's.
- The actuator: an in-process live move mid-stream is exactly once and
  in order (streamed, handle and zlib frames), a PREPARE does not wait
  behind a parked GET, a source serving on after the move is fenced and
  counted, a bare client raises ``QueueMoved``, and adopting one
  manifest twice is a no-op.
- The wire both ways: the port's ``migrate`` over JAX shards and JAX's
  over the port's, each followed by either package's client; every
  stream equals what was queued.
"""

import json
import threading
import time

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pytest

from ray_shuffling_data_loader_tpu import multiqueue as jmq
from ray_shuffling_data_loader_tpu import multiqueue_service as jsvc
from ray_shuffling_data_loader_tpu import rebalance as jrb
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.plan import scheduler as jsched
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu.runtime import policy as jpolicy
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq
from ray_shuffling_data_loader_tpu_torch import multiqueue_service as tsvc
from ray_shuffling_data_loader_tpu_torch import native as tnative
from ray_shuffling_data_loader_tpu_torch import rebalance as trb
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.plan import scheduler as tsched
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as tpolicy
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as ttelemetry)

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

TRAINERS = 2
PKGS = {"jax": (jrb, jir, jsvc, jmq), "port": (trb, tir, tsvc, tmq)}


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    tfaults.clear()
    jfaults.clear()


def _shard_map(ir, num_trainers=4, num_shards=2):
    return ir.ShardMap(
        num_trainers=num_trainers,
        addresses=[("127.0.0.1", 9000 + s) for s in range(num_shards)])


# ---------------------------------------------------------------------------
# The decision plane
# ---------------------------------------------------------------------------

#: Decision sequences (kind, rank, source, target) folded from bootstrap
#: over 4 trainers and 2 shards; the last may raise.
SEQUENCES = {
    "intent_commit": [("intent", 1, 1, 0), ("commit", 1, 1, 0)],
    "intent_abort": [("intent", 1, 1, 0), ("abort", 1, 1, 0)],
    "move_and_back": [("intent", 1, 1, 0), ("commit", 1, 1, 0),
                      ("intent", 1, 0, 1), ("commit", 1, 0, 1)],
    "two_moves": [("intent", 0, 0, 1), ("commit", 0, 0, 1),
                  ("intent", 3, 1, 0), ("commit", 3, 1, 0)],
    "noop_intent": [("intent", 2, 0, 0)],
    "intent_over_pending": [("intent", 1, 1, 0), ("intent", 3, 1, 0)],
    "commit_of_other_move": [("intent", 1, 1, 0), ("commit", 3, 1, 0)],
    "commit_without_intent": [("commit", 1, 1, 0)],
    "wrong_source": [("intent", 1, 0, 0)],
    "unknown_rank": [("intent", 7, 1, 0)],
    "unknown_shard": [("intent", 1, 1, 5)],
    "base_record": [("bootstrap", -1, -1, -1)],
    "unknown_kind": [("teleport", 1, 1, 0)],
}


def _fold(rb, ir, steps):
    """Each state of the fold as a dict, then the error's text (or
    None)."""
    state = rb.PlacementState.bootstrap(_shard_map(ir))
    states = []
    try:
        for kind, rank, source, target in steps:
            state = rb.apply_decision(state, rb.PlacementDecision(
                kind, rank=rank, source=source, target=target))
            states.append(state.to_dict())
    except ValueError as e:
        return states, str(e)
    return states, None


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_apply_decision_equals_jax(name):
    port = _fold(trb, tir, SEQUENCES[name])
    assert port == _fold(jrb, jir, SEQUENCES[name])
    if name == "noop_intent":
        state = trb.PlacementState.bootstrap(_shard_map(tir))
        assert trb.apply_decision(state, trb.PlacementDecision(
            "intent", rank=2, source=0, target=0)) is state


#: (overrides, generation, moves) for rebalance_queues over 4 trainers
#: and 2 shards; an out-of-range move raises PlanError.
MOVE_SETS = {
    "one_move": ({}, 0, {1: 0}),
    "two_moves": ({}, 3, {1: 0, 2: 1}),
    "all_noop": ({}, 0, {0: 0, 1: 1}),
    "back_home": ({1: 0}, 1, {1: 1}),
    "merge": ({1: 0}, 1, {3: 0}),
    "partly_noop": ({1: 0}, 2, {1: 0, 2: 1}),
    "unknown_shard": ({}, 0, {1: 4}),
    "unknown_rank": ({}, 0, {9: 0}),
}


def _rebalanced(ir, sched, overrides, generation, moves):
    shard_map = _shard_map(ir)
    shard_map.overrides.update(overrides)
    shard_map.generation = generation
    before = shard_map.to_json()
    try:
        out = sched.rebalance_queues(shard_map, moves)
    except ir.PlanError as e:
        return ("error", str(e))
    assert shard_map.to_json() == before  # the input is never changed
    return (out is shard_map, out.to_json())


@pytest.mark.parametrize("name", sorted(MOVE_SETS))
def test_rebalance_queues_equals_jax(name):
    args = MOVE_SETS[name]
    port = _rebalanced(tir, tsched, *args)
    assert port == _rebalanced(jir, jsched, *args)
    assert port[0] == ("error" if name.startswith("unknown")
                       else name == "all_noop")


def _churn(rb, ir, journal_path):
    controller = rb.RebalanceController(_shard_map(ir),
                                        journal_path=journal_path,
                                        rebalance_max_moves=8)
    controller.begin(1, target=0, reason="hot rank")
    controller.commit(1, reason="hot rank")
    controller.begin(3, target=0, reason="second thought")
    controller.abort(3, reason="second thought")
    controller.begin(2)  # pick_target: the least-loaded other shard
    controller.commit(2)
    controller.close()
    return controller


def test_journal_bytes_equal_jax_and_each_replays_the_other(tmp_path):
    paths = {pkg: str(tmp_path / f"{pkg}.journal") for pkg in PKGS}
    controllers = {pkg: _churn(PKGS[pkg][0], PKGS[pkg][1], paths[pkg])
                   for pkg in PKGS}
    data = {pkg: open(paths[pkg], "rb").read() for pkg in PKGS}
    assert data["port"] == data["jax"]
    assert controllers["port"].journal.journal_bytes() == data["port"]
    assert (controllers["port"].current_state().to_dict()
            == controllers["jax"].current_state().to_dict())
    state = trb.replay(paths["jax"])
    assert state.to_dict() == jrb.replay(paths["port"]).to_dict()
    assert state.overrides == ((1, 0), (2, 1)) and state.generation == 2
    assert controllers["port"].moves_total == 2
    assert (controllers["port"].current_map().to_json()
            == controllers["jax"].current_map().to_json())


def _tamper(lines, case):
    if case == "torn_tail":
        lines.append('{"torn":')
    elif case == "forged_interior":
        lines[1] = '{"forged": 1}'
    elif case == "crc_tamper":
        lines[1] = "X" + lines[1][1:]
    elif case == "divergent":
        forged = jrb.PlacementState(num_trainers=4, num_shards=2,
                                    generation=99, overrides=((3, 0),))
        lines[2] = jrb.RebalanceJournal.encode(
            jrb.PlacementDecision("commit", rank=1, source=1, target=0),
            forged)
    elif case == "no_base":
        del lines[0]
    elif case == "base_after_head":
        lines.insert(2, lines[0])
    return lines


@pytest.mark.parametrize("case", ["torn_tail", "forged_interior",
                                  "crc_tamper", "divergent", "no_base",
                                  "base_after_head"])
def test_replay_of_a_damaged_journal_equals_jax(case, tmp_path):
    """Both packages skip a torn tail and refuse the same damage with the
    same message."""
    path = str(tmp_path / "rb.journal")
    _churn(trb, tir, path)
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(_tamper(lines, case)) + "\n")
    outcome = {}
    for pkg, rb in (("port", trb), ("jax", jrb)):
        try:
            outcome[pkg] = rb.replay(path).to_dict()
        except ValueError as e:
            outcome[pkg] = str(e)
    assert outcome["port"] == outcome["jax"]
    assert isinstance(outcome["port"], dict) is (case == "torn_tail")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_compact_then_continue(writer, tmp_path):
    """A compacted journal (by either package) is one snapshot line, byte
    for byte the other's, and keeps taking decisions that replay."""
    path = str(tmp_path / "rb.journal")
    rb, ir = PKGS[writer][:2]
    expected = _churn(rb, ir, path).current_state().to_dict()
    rb.RebalanceJournal(path).compact()
    with open(path, encoding="utf-8") as f:
        lines = [line for line in f.read().splitlines() if line]
    assert len(lines) == 1
    other = trb if writer == "jax" else jrb
    assert lines[0] == other.RebalanceJournal.encode(
        other.PlacementDecision("snapshot", reason="compact"),
        other.PlacementState.from_dict(expected))
    resumed = trb.RebalanceController(_shard_map(tir), journal_path=path,
                                      rebalance_max_moves=8)
    resumed.begin(3, target=0)
    resumed.commit(3)
    resumed.close()
    assert jrb.replay(path).generation == 3
    assert trb.replay(path).overrides == ((1, 0), (2, 1), (3, 0))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_restart_aborts_a_trailing_intent(writer, tmp_path):
    """A driver that died between intent and commit (either package's):
    the port's controller journals the abort at its restart, and the
    journal still replays in both packages."""
    path = str(tmp_path / "rb.journal")
    rb, ir = PKGS[writer][:2]
    controller = rb.RebalanceController(_shard_map(ir), journal_path=path)
    controller.begin(1, target=0, reason="about to crash")
    assert controller.current_state().pending == (1, 1, 0)
    controller.close()
    recovered = trb.RebalanceController(_shard_map(tir), journal_path=path)
    state = recovered.current_state()
    recovered.close()
    assert state.pending is None and state.generation == 0
    kinds = [r["decision"].kind for r in jrb.RebalanceJournal.load(path)]
    assert kinds == ["bootstrap", "intent", "abort"]
    assert jrb.replay(path).to_dict() == trb.replay(path).to_dict()


def test_commit_budget_blocks_a_ping_pong():
    outcomes = {}
    for pkg in PKGS:
        rb, ir = PKGS[pkg][:2]
        controller = rb.RebalanceController(_shard_map(ir),
                                            rebalance_max_moves=1,
                                            rebalance_cooldown_s=3600.0)
        first = controller.begin(1, target=0)
        controller.commit(1)
        outcomes[pkg] = (first.to_dict(), controller.begin(1, target=1),
                         controller.moves_total, controller.may_move())
        assert controller.may_move(now=time.monotonic() + 3601.0)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][1:] == (None, 1, False)


@pytest.mark.parametrize("key", ["rebalance_slo_p99_s",
                                 "rebalance_cooldown_s",
                                 "rebalance_max_moves"])
def test_rebalance_policy_keys_equal_jax(key, monkeypatch):
    assert (tpolicy.resolve("rebalance", key)
            == jpolicy.resolve("rebalance", key))
    monkeypatch.setenv(f"RSDL_{key.upper()}", "7")
    controllers = [rb.RebalanceController(_shard_map(ir))
                   for rb, ir, _, _ in PKGS.values()]
    attr = {"rebalance_slo_p99_s": "slo_p99_s",
            "rebalance_cooldown_s": "cooldown_s",
            "rebalance_max_moves": "max_moves"}[key]
    values = [getattr(c, attr) for c in controllers]
    assert values[0] == values[1] == 7
    assert type(values[0]) is type(values[1])


@pytest.mark.parametrize("spec", ["rebalance_prepare@0.5:rank2:epoch1",
                                  "rebalance_commit:rank0:epoch3:x2",
                                  "rebalance_abort:after1"])
def test_rebalance_chaos_selectors_equal_jax(spec):
    port = tfaults.install(spec, seed=0).rules
    jax_rules = jfaults.install(spec, seed=0).rules
    assert [vars(r) for r in port] == [vars(r) for r in jax_rules]


def test_driver_killed_mid_decision_aborts_on_restart(tmp_path):
    """``rebalance_abort`` fires after the intent is durable and before
    any actuator byte moves; the restarted controller aborts it."""
    path = str(tmp_path / "rb.journal")
    tfaults.install("rebalance_abort:rank1:epoch1", seed=0)
    controller = trb.RebalanceController(_shard_map(tir), journal_path=path)
    with pytest.raises(tfaults.InjectedFault):
        controller.begin(1, target=0, reason="slo breach")
    controller.close()
    tfaults.clear()
    kinds = [r["decision"].kind for r in trb.RebalanceJournal.load(path)]
    assert kinds == ["bootstrap", "intent"]
    recovered = trb.RebalanceController(_shard_map(tir), journal_path=path)
    state = recovered.current_state()
    recovered.close()
    assert (state.pending, state.generation, state.overrides) == (None, 0,
                                                                  ())


# ---------------------------------------------------------------------------
# The actuator, in process
# ---------------------------------------------------------------------------


def _tables(n, rows=2000):
    """Tables that compress (runs of one value) and name their place."""
    return [pa.table({"key": np.arange(i * rows, (i + 1) * rows),
                      "run": np.full(rows, i, dtype=np.int32)})
            for i in range(n)]


def _keys(table):
    return table.column("key").to_pylist()


def _feed(queue, rank, tables, sentinel=True):
    q = tir.queue_index(0, rank, TRAINERS)
    for table in tables:
        queue.put(q, table)
    if sentinel:
        queue.put(q, None)
    return q


def _mode_env(monkeypatch, mode):
    if mode == "zlib":
        monkeypatch.setenv("RSDL_QUEUE_COMPRESSION", "zlib")
        monkeypatch.setenv("RSDL_QUEUE_COMPRESSION_MIN_BYTES", "1")
    return "stream" if mode in ("stream", "zlib") else "handle"


@pytest.mark.parametrize("mode", ["stream", "handle", "zlib"])
def test_live_move_mid_stream_is_exactly_once(mode, monkeypatch, tmp_path):
    """Rank 1 moves from shard 1 to shard 0 after three of its eight
    tables: the consumer follows the redirect and sees every row offset
    once, in order; the decision journal replays; the source's pins are
    released."""
    delivery = _mode_env(monkeypatch, mode)
    queue = tmq.MultiQueue(TRAINERS)
    tables = _tables(8)
    moves = tmetrics.counter("rsdl_rebalance_moves_total",
                             "committed live queue migrations")
    before_moves = moves.value
    ledger = tnative.buffer_ledger().bytes_in_use()
    phases = {}
    with tsvc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS) as sss:
        q1 = _feed(queue, 1, tables)
        controller = trb.RebalanceController(
            sss.shard_map, journal_path=str(tmp_path / "rb.journal"))
        remote = tsvc.ShardedRemoteQueue(sss.shard_map, max_batch=2,
                                         delivery=delivery)
        try:
            stream = [remote.get_positioned(q1) for _ in range(3)]
            state = trb.migrate(controller, 1, target=0, reason="test",
                                phases=phases)
            assert state is not None and state.generation == 1
            while stream[-1][0] is not None:
                stream.append(remote.get_positioned(q1))
        finally:
            remote.close()
            controller.close()
    assert [offset for _, offset in stream[:-1]] == [
        i * 2000 for i in range(8)]
    assert [_keys(t) for t, _ in stream[:-1]] == [_keys(t) for t in tables]
    assert sss.shard_map.overrides == {1: 0}
    assert sss.shard_map.generation == 1
    assert trb.replay(str(tmp_path / "rb.journal")).overrides == ((1, 0),)
    assert moves.value == before_moves + 1
    assert set(phases) == {"prepare_s", "adopt_s", "intent_to_commit_s",
                           "release_s", "manifest_bytes", "manifest_frames"}
    assert phases["manifest_frames"] >= 1
    assert tnative.buffer_ledger().bytes_in_use() == ledger
    events = ttelemetry.recorder().events()
    for kind in ("rebalance_intent", "rebalance_prepare",
                 "rebalance_commit", "rebalance_release"):
        assert any(e["kind"] == kind and e["epoch"] == 1 and e["task"] == 1
                   for e in events), kind


def test_prepare_does_not_wait_behind_a_parked_get():
    """A consumer parked in a blocking GET on its idle queue holds the
    queue's lock; PREPARE's export gets it within a tick, and the parked
    consumer then reads the rest from the target."""
    queue = tmq.MultiQueue(TRAINERS)
    tables = _tables(3)
    with tsvc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS) as sss:
        q1 = tir.queue_index(0, 1, TRAINERS)
        controller = trb.RebalanceController(sss.shard_map)
        got = []
        with tsvc.ShardedRemoteQueue(sss.shard_map,
                                     delivery="stream") as remote:
            consumer = threading.Thread(
                target=lambda: got.extend(
                    remote.get(q1) for _ in range(len(tables) + 1)),
                daemon=True)
            consumer.start()
            time.sleep(0.5)  # the GET is parked server-side
            start = time.monotonic()
            trb.migrate(controller, 1, target=0, timeout_s=10.0)
            took = time.monotonic() - start
            _feed(queue, 1, tables)
            consumer.join(timeout=30)
            assert not consumer.is_alive()
    assert took < 2.0
    assert [_keys(t) for t in got[:-1]] == [_keys(t) for t in tables]
    assert got[-1] is None


def test_moved_source_serving_on_is_fenced_and_counted():
    """A source that missed its RELEASE serves the moved rank on at the
    old generation: a consumer whose fence the move raised drops every
    such frame, counted and recorded; the target serves the rest exactly
    once."""
    queue = tmq.MultiQueue(TRAINERS)
    tables = _tables(4, rows=10)
    fenced = tmetrics.counter(
        "rsdl_rebalance_fenced_frames_total",
        "frames dropped below the placement-generation fence")
    with tsvc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS) as sss:
        q1 = _feed(queue, 1, tables, sentinel=False)
        source, target = sss.servers[1].address, sss.servers[0].address
        first = tsvc.RemoteQueue(source, num_trainers=TRAINERS, max_batch=4,
                                 prefetch=False, ack_mode="manual")
        try:
            assert first.get_positioned(q1)[1] == 0
            manifest = tsvc.rebalance_prepare(source, 1, generation=1)
            tsvc.rebalance_adopt(target, manifest)
            tsvc.rebalance_unseal(source, 1)
            positions = first.export_positions(1)
        finally:
            first.close()
        before = fenced.value
        stale = tsvc.RemoteQueue(source, num_trainers=TRAINERS, max_batch=8,
                                 prefetch=False)
        try:
            stale.adopt_positions({}, generation=1, rank=1)
            items, _ = stale._fetch_batch(q1)
        finally:
            stale.close()
        assert items == []
        assert fenced.value >= before + 4
        fence = [e for e in ttelemetry.recorder().events()
                 if e["kind"] == "rebalance_fence"][-1]
        assert (fence["generation"], fence["floor"]) == (0, 1)
        second = tsvc.RemoteQueue(target, num_trainers=TRAINERS, max_batch=4,
                                  prefetch=False)
        try:
            second.adopt_positions(positions, generation=1, rank=1)
            offsets = [second.get_positioned(q1)[1] for _ in range(3)]
        finally:
            second.close()
    assert offsets == [10, 20, 30]


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_bare_client_raises_queue_moved(client_pkg):
    """After RELEASE the port's source redirects; a bare client of either
    package raises its ``QueueMoved`` with the target and generation."""
    svc = jsvc if client_pkg == "jax" else tsvc
    queue = tmq.MultiQueue(TRAINERS)
    with tsvc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS) as sss:
        q1 = _feed(queue, 1, _tables(2, rows=10))
        source, target = sss.servers[1].address, sss.servers[0].address
        manifest = tsvc.rebalance_prepare(source, 1, generation=1)
        tsvc.rebalance_adopt(target, manifest)
        tsvc.rebalance_release(source, 1, generation=1, target=target)
        with svc.RemoteQueue(source, num_trainers=TRAINERS,
                             prefetch=False) as stale:
            with pytest.raises(svc.QueueMoved) as excinfo:
                stale.get(q1)
    moved = excinfo.value
    assert (moved.rank, moved.address, moved.generation) == (
        1, (target[0], target[1]), 1)


def test_adopting_a_manifest_twice_is_a_noop_and_errors_come_back():
    queue = tmq.MultiQueue(TRAINERS)
    with tsvc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS) as sss:
        q1 = _feed(queue, 1, _tables(3, rows=10))
        source, target = sss.servers[1].address, sss.servers[0].address
        with tsvc.RemoteQueue(source, num_trainers=TRAINERS, max_batch=2,
                              prefetch=False, ack_mode="manual") as remote:
            remote.get(q1)
        manifest = tsvc.rebalance_prepare(source, 1, generation=1)
        tsvc.rebalance_adopt(target, manifest)
        adopted = sss.servers[0]._states[q1]
        tsvc.rebalance_adopt(target, manifest)
        assert sss.servers[0]._states[q1] is adopted
        # A manifest damaged on the way: the target checks its CRC and
        # answers with an error line, which the call raises.
        tampered = manifest.replace('"rank":1', '"rank":0')
        with pytest.raises(RuntimeError, match="crc mismatch"):
            tsvc._rebalance_call(target, tsvc.REB_ADOPT, 0, 2,
                                 payload=tampered.encode())
        body = json.loads(manifest)["entry"]["manifest"]
        assert body["source_shard"] == 1
        # migrate's frame count: one '"seq":' key per frame.
        assert manifest.count('"seq":') == sum(
            len(entry["frames"]) for entry in body["queues"].values()) == 2


# ---------------------------------------------------------------------------
# The wire, both ways
# ---------------------------------------------------------------------------


def _served(server_pkg, queue_tables):
    """A 2-shard in-process serving plane of ``server_pkg`` over a queue
    holding rank 1's tables and sentinel."""
    _, _, svc, mq = PKGS[server_pkg]
    queue = mq.MultiQueue(TRAINERS)
    q1 = tir.queue_index(0, 1, TRAINERS)
    for table in queue_tables:
        queue.put(q1, table)
    queue.put(q1, None)
    return svc.ShardedQueueServer(queue, 2, num_trainers=TRAINERS), q1


@pytest.mark.parametrize("server_pkg,driver_pkg,client_pkg", [
    ("jax", "port", "port"), ("jax", "port", "jax"),
    ("port", "jax", "port"), ("port", "jax", "jax"),
    ("port", "port", "jax"), ("jax", "jax", "port")])
def test_migration_across_packages(server_pkg, driver_pkg, client_pkg,
                                   tmp_path):
    """One package's shards, the other's (or the same) ``migrate`` and
    either package's client: the stream equals what was queued, exactly
    once, and the client's map learned the move."""
    tables = _tables(6, rows=50)
    sss, q1 = _served(server_pkg, tables)
    drb, dir_ = PKGS[driver_pkg][:2]
    _, cir, csvc, _ = PKGS[client_pkg]
    try:
        controller = drb.RebalanceController(
            dir_.ShardMap.from_json(sss.shard_map.to_json()),
            journal_path=str(tmp_path / "rb.journal"))
        remote = csvc.ShardedRemoteQueue(
            cir.ShardMap.from_json(sss.shard_map.to_json()), max_batch=2)
        try:
            stream = [remote.get_positioned(q1) for _ in range(2)]
            assert drb.migrate(controller, 1, target=0).generation == 1
            while stream[-1][0] is not None:
                stream.append(remote.get_positioned(q1))
            client_map = remote.shard_map
        finally:
            remote.close()
            controller.close()
    finally:
        sss.close()
    assert [offset for _, offset in stream[:-1]] == [
        i * 50 for i in range(6)]
    assert [_keys(t) for t, _ in stream[:-1]] == [_keys(t) for t in tables]
    assert (client_map.overrides, client_map.generation) == ({1: 0}, 1)
    journal = str(tmp_path / "rb.journal")
    assert trb.replay(journal).to_dict() == jrb.replay(journal).to_dict()


def test_wire_constants_equal_jax():
    for name in ("OP_REBALANCE", "REB_PREPARE", "REB_ADOPT", "REB_RELEASE",
                 "REB_UNSEAL", "KIND_MOVED", "OP_TENANT"):
        assert getattr(tsvc, name) == getattr(jsvc, name), name
    # No serving-plane feature is refused any more.
    assert not hasattr(tsvc, "not_ported")


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_placement_adopts_and_redirects_as_jax(server_pkg):
    """A shard built with the placement a committed move left (rank 1 on
    shard 0 at generation 1): shard 0 serves rank 1 stamped with
    generation 1, shard 1 redirects it; either package's server, read by
    the port's client (a JAX shard is built one at a time, as its
    ``ShardedQueueServer`` takes no placement)."""
    _, _, svc, mq = PKGS[server_pkg]
    queue = mq.MultiQueue(TRAINERS)
    q1 = tir.queue_index(0, 1, TRAINERS)
    queue.put(q1, _tables(1, rows=10)[0])
    placement = {"generation": 1, "overrides": {"1": 0},
                 "rank_generations": {"1": 1},
                 "addresses": [["127.0.0.1", 1], ["127.0.0.1", 2]]}
    if server_pkg == "port":
        plane = tsvc.serve_queue_sharded(queue, num_shards=2,
                                         num_trainers=TRAINERS,
                                         placement=placement)
        servers = plane.servers
    else:
        servers = [jsvc.QueueServer(queue, ("127.0.0.1", 0),
                                    num_trainers=TRAINERS, shard_index=i,
                                    num_shards=2, placement=placement)
                   for i in range(2)]
    try:
        with tsvc.RemoteQueue(servers[0].address, num_trainers=TRAINERS,
                              prefetch=False) as remote:
            assert _keys(remote.get(q1)) == list(range(10))
            assert remote._gen_floor == {1: 1}
        with tsvc.RemoteQueue(servers[1].address, num_trainers=TRAINERS,
                              prefetch=False) as remote:
            with pytest.raises(tsvc.QueueMoved) as excinfo:
                remote.get(q1)
    finally:
        for server in servers:
            server.close()
    assert (excinfo.value.address, excinfo.value.generation) == (
        ("127.0.0.1", 1), 1)
