"""The port's elastic membership (``membership/{__init__,detector}.py``, the
membership half of ``parallel/transport.py``, ``plan.ir.rebalance_spans``
/ ``reduce_placement``, ``plan.scheduler.rewrite_for_view`` and
``checkpoint.crc_line``) against the JAX package's, on the same inputs.

- Views: seeded random event sequences (downs, joins, rejoins at a bumped
  and at a stale incarnation, no-ops) fold to equal ``to_dict()`` views in
  both packages.
- Journals: the same transitions give byte-identical journals; a journal
  written by either package replays in the other; both skip a torn tail,
  raise on interior corruption and on a tampered view, and compact to one
  snapshot.
- Detector: one beat and poll schedule on a fake clock (no sleeps) gives
  the same states, phi values and callbacks in both.
- Transport: a world of a port transport (host 0) and a JAX transport
  (host 1). Heartbeats reach the other side's observer and never its
  inbox; the port fences a stale incarnation (the counter moves by
  exactly 1, and the zombie's payload charges no ledger bytes) and an old
  view; ``member_partition`` drops frames silently; ``connect(
  on_unreachable="skip")`` names the same dead peers as the JAX package's.
- Placement: equal over a grid of item counts and live-rank sets.
"""

import random
import socket
import threading

import jax  # noqa: F401  (imported before any worker thread needs it)
import pytest

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import membership as jmem
from ray_shuffling_data_loader_tpu.membership import detector as jdet
from ray_shuffling_data_loader_tpu.parallel import transport as jtp
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.plan import scheduler as jsched
from ray_shuffling_data_loader_tpu.runtime import faults as jfaults
from ray_shuffling_data_loader_tpu_torch import checkpoint as tckpt
from ray_shuffling_data_loader_tpu_torch import membership as tmem
from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch.membership import detector as tdet
from ray_shuffling_data_loader_tpu_torch.parallel import transport as ttp
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.plan import scheduler as tsched
from ray_shuffling_data_loader_tpu_torch.runtime import faults as tfaults
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

PACKAGES = {"port": tmem, "jax": jmem}
RECV_TIMEOUT_S = 10.0
ABSENT_S = 0.2


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    tfaults.clear()
    jfaults.clear()


def _events(seed: int, n: int = 40):
    """A seeded event sequence over ranks 0-5: downs (of live and absent
    ranks), joins of new ranks, rejoins at the next and at a stale
    incarnation, and joins of a live rank at its own incarnation."""
    rng = random.Random(seed)
    view = jmem.MembershipView.bootstrap([0, 1, 2, 3])
    out = []
    for _ in range(n):
        rank = rng.randrange(6)
        kind = rng.choice(["down", "join", "join"])
        if kind == "down":
            event = ("down", rank, view.incarnation(rank))
        else:
            inc = jmem.next_incarnation(view, rank) + rng.choice([-2, -1,
                                                                  0, 0])
            event = ("join", rank, max(0, inc))
        out.append(event)
        view = jmem.apply_event(view, jmem.MembershipEvent(
            event[0], rank=event[1], incarnation=event[2]))
    return out


# ---------------------------------------------------------------------------
# views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_random_event_sequences_fold_to_equal_views(seed):
    tview = tmem.MembershipView.bootstrap([3, 1, 0, 2, 1])
    jview = jmem.MembershipView.bootstrap([3, 1, 0, 2, 1])
    changes = 0
    for kind, rank, inc in _events(seed):
        tnext = tmem.apply_event(tview, tmem.MembershipEvent(
            kind, rank=rank, incarnation=inc))
        jnext = jmem.apply_event(jview, jmem.MembershipEvent(
            kind, rank=rank, incarnation=inc))
        assert tnext.to_dict() == jnext.to_dict()
        # A no-op returns the view itself in both packages.
        assert (tnext is tview) == (jnext is jview)
        changes += tnext is not tview
        tview, jview = tnext, jnext
        for r in range(7):
            assert (tmem.next_incarnation(tview, r)
                    == jmem.next_incarnation(jview, r))
            assert tview.live(r) == jview.live(r)
    assert 0 < changes < 40


def test_base_records_and_unknown_kinds_are_rejected_in_both():
    for mem in PACKAGES.values():
        view = mem.MembershipView.bootstrap([0], incarnations={0: 3})
        assert mem.next_incarnation(view, 0) == 4
        assert mem.next_incarnation(view, 9) == 0
        for kind in ("bootstrap", "snapshot"):
            with pytest.raises(ValueError, match="carry their own view"):
                mem.apply_event(view, mem.MembershipEvent(kind))
        with pytest.raises(ValueError, match="unknown"):
            mem.apply_event(view, mem.MembershipEvent("promote", rank=0))


@pytest.mark.parametrize("base_reducers,base_world", [(8, 4), (1, 4),
                                                      (6, 3), (5, 2)])
def test_reducers_for_view_agrees(base_reducers, base_world):
    for ranks in ([0], [0, 1, 2], [0, 2, 5, 7, 9]):
        tview = tmem.MembershipView.bootstrap(ranks)
        jview = jmem.MembershipView.bootstrap(ranks)
        assert (tmem.reducers_for_view(base_reducers, base_world, tview)
                == jmem.reducers_for_view(base_reducers, base_world, jview))
    for mem in PACKAGES.values():
        with pytest.raises(ValueError):
            mem.reducers_for_view(8, 0, mem.MembershipView.bootstrap([0]))


# ---------------------------------------------------------------------------
# journals
# ---------------------------------------------------------------------------


def _drive(manager, seed: int) -> None:
    rng = random.Random(seed)
    for kind, rank, inc in _events(seed):
        if kind == "down":
            manager.member_down(rank, reason=f"detector {rng.random():.3f}")
        elif rng.random() < 0.5:
            manager.member_join(rank, reason="grow")
        else:
            manager.member_join(rank, incarnation=inc, reason="rejoin")


def _churn(mem, path):
    manager = mem.MembershipManager([0, 1, 2, 3], journal_path=path)
    manager.member_down(2, reason="detector verdict")
    manager.member_join(2, reason="rejoin")
    manager.member_join(4, reason="grow")
    manager.close()
    return manager


@pytest.mark.parametrize("seed", range(3))
def test_the_same_transitions_journal_byte_identically(seed, tmp_path):
    tman = tmem.MembershipManager([0, 1, 2, 3],
                                  journal_path=str(tmp_path / "port.jsonl"))
    jman = jmem.MembershipManager([0, 1, 2, 3],
                                  journal_path=str(tmp_path / "jax.jsonl"))
    _drive(tman, seed)
    _drive(jman, seed)
    tman.close()
    jman.close()
    assert tman.journal.journal_bytes() == jman.journal.journal_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
    assert tman.current_view().to_dict() == jman.current_view().to_dict()


def test_crc_line_equals_the_jax_encoding():
    entry = {"b": [1, 2, {"z": None}], "a": "é", "n": -3.5}
    line = tckpt.crc_line(entry)
    assert line == jckpt.crc_line(entry)
    assert tckpt.parse_crc_line(line) == jckpt.parse_crc_line(line) == entry
    with pytest.raises(ValueError, match="crc"):
        tckpt.parse_crc_line(line.replace("-3.5", "-3.25"))


@pytest.mark.parametrize("writer,reader", [(tmem, jmem), (jmem, tmem)])
def test_a_journal_replays_in_the_other_package(writer, reader, tmp_path):
    path = str(tmp_path / "membership.jsonl")
    manager = _churn(writer, path)
    view = reader.replay(path)
    assert view.to_dict() == manager.current_view().to_dict()
    assert view.ranks == (0, 1, 2, 3, 4) and view.incarnation(2) == 1


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_torn_tail_skipped_interior_corruption_raises(name, tmp_path):
    mem = PACKAGES[name]
    path = str(tmp_path / "membership.jsonl")
    _churn(mem, path)
    with open(path, "ab") as f:
        f.write(b'{"torn":')
    assert mem.replay(path).ranks == (0, 1, 2, 3, 4)
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    lines[1] = '{"forged": 1}'
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="interior corruption"):
        mem.replay(path)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_a_tampered_view_and_a_noop_record_raise(name, tmp_path):
    mem = PACKAGES[name]
    path = str(tmp_path / "membership.jsonl")
    _churn(mem, path)
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    # A whole valid line (crc and all) whose view disagrees with the fold.
    lines[1] = mem.MembershipJournal.encode(
        mem.MembershipEvent("down", rank=2),
        mem.MembershipView(view_id=99, ranks=(7,), incarnations=((7, 0),)))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="diverged"):
        mem.replay(path)
    view = mem.MembershipView.bootstrap([0])
    with open(path, "w", encoding="utf-8") as f:
        f.write(mem.MembershipJournal.encode(mem.MembershipEvent("bootstrap"),
                                             view) + "\n")
        f.write(mem.MembershipJournal.encode(
            mem.MembershipEvent("down", rank=9), view) + "\n")
    with pytest.raises(ValueError, match="no-op"):
        mem.replay(path)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_compact_collapses_to_one_snapshot(name, tmp_path):
    mem = PACKAGES[name]
    path = str(tmp_path / "membership.jsonl")
    manager = _churn(mem, path)
    expected = manager.current_view()
    assert manager.member_down(9) == expected  # an absent rank: no-op
    manager.journal.compact()
    with open(path, encoding="utf-8") as f:
        lines = [line for line in f.read().splitlines() if line]
    assert len(lines) == 1
    assert mem.replay(path) == expected
    # The snapshot replays in the other package too.
    other = PACKAGES["jax" if name == "port" else "port"]
    assert other.replay(path).to_dict() == expected.to_dict()
    resumed = mem.MembershipManager(expected.ranks, journal_path=path,
                                    incarnations=dict(expected.incarnations))
    resumed.member_down(4)
    resumed.close()


def test_listeners_see_each_transition_once_and_metrics_export():
    seen = []
    manager = tmem.MembershipManager([0, 1, 2])
    manager.add_listener(lambda event, view: seen.append(
        (event.kind, event.rank, view.view_id)))
    downs = tmetrics.counter("rsdl_member_downs_total")
    before = downs.value
    manager.member_down(1)
    manager.member_down(1)  # no-op: never fanned out
    manager.member_join(1)
    assert seen == [("down", 1, 1), ("join", 1, 2)]
    assert downs.value == before + 1
    assert tmetrics.get("rsdl_member_view_id").value == 2
    assert tmetrics.get("rsdl_member_live").value == 3
    assert tmetrics.get("rsdl_member_incarnation",
                        {"rank": "1"}).value == 1
    manager.member_suspect(0)
    assert tmetrics.get("rsdl_member_suspect").value == 1
    manager.member_alive(0)
    assert tmetrics.get("rsdl_member_suspect").value == 0


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_member_crash_rank_selector_downs_through_the_manager(name):
    mem = PACKAGES[name]
    faults = tfaults if name == "port" else jfaults
    faults.install("member_crash:rank1:epoch0", seed=0)
    manager = mem.MembershipManager([0, 1, 2])
    assert manager.maybe_crash(0, 0) is False
    assert manager.maybe_crash(1, 1) is False
    assert manager.maybe_crash(0, 1) is True
    assert manager.current_view().ranks == (0, 2)
    assert manager.maybe_crash(0, 1) is False  # once per key


# ---------------------------------------------------------------------------
# failure detector (fake clock, no sleeps)
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


def _detectors(**kwargs):
    """One detector of each package over rank 1, each with its own fake
    clock and event list."""
    out = []
    for det in (tdet, jdet):
        clock = _FakeClock()
        events = []
        d = det.FailureDetector(
            [1], heartbeat_s=0.5, suspect_s=3.0, phi_threshold=4.0,
            clock=clock,
            on_suspect=lambda r, e=events: e.append(("suspect", r)),
            on_down=lambda r, e=events: e.append(("down", r)),
            on_alive=lambda r, e=events: e.append(("alive", r)), **kwargs)
        out.append((d, clock, events))
    return out


def _run(schedule):
    """Play ``schedule`` (("beat", dt) / ("poll", dt) / ("revive", dt))
    on both packages; each step's (state, phi, poll result) and the
    callbacks must be equal."""
    trace = []
    for d, clock, events in _detectors():
        steps = []
        for op, dt in schedule:
            clock.now += dt
            got = None
            if op == "beat":
                d.beat(1)
            elif op == "poll":
                got = d.poll()
            elif op == "revive":
                d.revive(1)
            else:
                d.forget(1)
            steps.append((d.state(1), round(d.phi(1), 12), got))
        trace.append((steps, list(events)))
    assert trace[0] == trace[1]
    return trace[0]


def test_detector_suspect_then_down_at_the_deadlines():
    steps, events = _run([("beat", 0.5)] * 4 + [("poll", 2.5),
                                                ("poll", 0.6),
                                                ("beat", 0.1),
                                                ("revive", 0.0),
                                                ("poll", 0.1)])
    assert [s[0] for s in steps[4:]] == ["suspect", "down", "down", "alive",
                                         "alive"]
    assert events == [("suspect", 1), ("down", 1)]


def test_detector_a_flapping_link_fires_once():
    steps, events = _run([("beat", 0.5)] * 15 + [("poll", 2.5),
                                                 ("beat", 0.1),
                                                 ("poll", 2.6),
                                                 ("poll", 0.5)])
    assert steps[17][2] == {1: "flap"}
    assert events == [("suspect", 1), ("alive", 1), ("down", 1)]


@pytest.mark.parametrize("cadence", [0.25, 0.5, 1.0, 2.0])
def test_detector_phi_scales_with_the_cadence(cadence):
    steps, _ = _run([("beat", cadence)] * 8 + [("poll", 2.0)])
    assert steps[-1][1] == pytest.approx(2.0 / max(0.5, cadence))


def test_detector_forget_drops_the_rank():
    steps, events = _run([("beat", 0.5), ("forget", 0.0), ("poll", 100.0)])
    assert steps[-1] == ("down", 0.0, {})
    assert events == []


# ---------------------------------------------------------------------------
# the generation-fenced transport, port against JAX
# ---------------------------------------------------------------------------


class _World:
    """A port transport (host 0) and a JAX transport (host 1), connected."""

    def __init__(self):
        addresses = [("127.0.0.1", 0)] * 2
        self.port = ttp.TcpTransport(0, addresses,
                                     recv_timeout_s=RECV_TIMEOUT_S)
        self.jax = jtp.TcpTransport(1, addresses,
                                    recv_timeout_s=RECV_TIMEOUT_S)
        pair = [self.port, self.jax]
        for t in pair:
            t.start()
        bound = [("127.0.0.1", t.bound_port()) for t in pair]
        for t in pair:
            t.addresses = bound
            t.connect()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.port.close()
        self.jax.close()


def _observer():
    seen = []
    got = threading.Event()

    def observe(src, incarnation, view, is_heartbeat):
        seen.append((src, incarnation, view, is_heartbeat))
        got.set()

    return observe, seen, got


def test_heartbeats_reach_the_observer_both_ways_and_never_the_inbox():
    with _World() as w:
        tobs, tseen, tgot = _observer()
        jobs, jseen, jgot = _observer()
        w.port.set_frame_observer(tobs)
        w.jax.set_frame_observer(jobs)
        w.port.announce(incarnation=2, view_id=3)
        w.jax.announce(incarnation=4, view_id=5)
        w.port.send_heartbeat(1)
        w.jax.send_heartbeat(0)
        assert jgot.wait(RECV_TIMEOUT_S) and tgot.wait(RECV_TIMEOUT_S)
        assert jseen == [(0, 2, 3, True)] and tseen == [(1, 4, 5, True)]
        assert w.jax._inbox == {} and w.port._inbox == {}
        # Data frames are observed too, and delivered.
        w.jax.send(0, (0, 0, 0), b"data")
        assert bytes(w.port.recv(1, (0, 0, 0))) == b"data"
        assert tseen[-1] == (1, 4, 5, False)
        w.port.send(1, (0, 0, 0), b"back")
        assert bytes(w.jax.recv(0, (0, 0, 0))) == b"back"
        assert jseen[-1] == (0, 2, 3, False)
        assert w.port.known_peers() == [1]
        w.port.send_heartbeat(0)  # to itself: nothing


def test_the_port_fences_a_stale_incarnation_before_charging_the_ledger():
    fenced = tmetrics.counter("rsdl_member_fenced_frames_total")
    ledger = native.buffer_ledger()
    zombie = bytes(4 << 20)
    with _World() as w:
        w.jax.announce(incarnation=1, view_id=1)
        w.jax.send(0, (0, 0, 0), b"new-gen")
        assert bytes(w.port.recv(1, (0, 0, 0))) == b"new-gen"
        before = fenced.value
        ledger.reset_peak()
        base = ledger.bytes_in_use()
        w.jax.announce(incarnation=0, view_id=1)  # the zombie
        w.jax.send(0, (0, 1, 0), zombie)
        w.jax.announce(incarnation=1, view_id=1)
        w.jax.send(0, (0, 2, 0), b"after")
        assert bytes(w.port.recv(1, (0, 2, 0))) == b"after"
        assert fenced.value == before + 1
        assert ledger.peak_bytes() - base < len(zombie)
        with pytest.raises(ttp.TransportTimeout):
            w.port.recv(1, (0, 1, 0), timeout_s=ABSENT_S)
        # The port's own frames carry its incarnation and view.
        jobs, jseen, jgot = _observer()
        w.jax.set_frame_observer(jobs)
        w.port.announce(incarnation=7, view_id=2)
        w.port.send(1, (1, 0, 0), b"stamped")
        assert bytes(w.jax.recv(0, (1, 0, 0))) == b"stamped"
        assert jseen == [(0, 7, 2, False)]


def test_fence_view_drops_frames_of_the_old_view():
    fenced = tmetrics.counter("rsdl_member_fenced_frames_total")
    with _World() as w:
        w.port.fence_view(2)
        before = fenced.value
        w.jax.set_view(1)
        w.jax.send(0, (0, 0, 0), b"old")
        w.jax.send_heartbeat(0)
        w.jax.set_view(2)
        w.jax.send(0, (0, 1, 0), b"current")
        assert bytes(w.port.recv(1, (0, 1, 0))) == b"current"
        assert fenced.value == before + 2
        with pytest.raises(ttp.TransportTimeout):
            w.port.recv(1, (0, 0, 0), timeout_s=ABSENT_S)


def test_member_partition_drops_frames_silently():
    with _World() as w:
        obs, seen, _ = _observer()
        w.jax.set_frame_observer(obs)
        injector = tfaults.install("member_partition:task1", seed=0)
        w.port.send(1, (0, 0, 0), b"lost")  # no error reaches the sender
        w.port.send_heartbeat(1)
        fired = [f["site"] for f in injector.fired()]
        assert fired == ["member_partition", "member_partition"]
        with pytest.raises(jtp.TransportTimeout):
            w.jax.recv(0, (0, 0, 0), timeout_s=ABSENT_S)
        tfaults.clear()
        w.port.send(1, (0, 0, 0), b"healed")
        assert bytes(w.jax.recv(0, (0, 0, 0))) == b"healed"
        assert seen == [(0, 0, 0, False)]


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_connect_skip_names_the_same_unreachable_peers():
    live = socket.socket()
    live.bind(("127.0.0.1", 0))
    live.listen(4)
    addresses = [("127.0.0.1", 0), ("127.0.0.1", _dead_port()),
                 live.getsockname(), ("127.0.0.1", _dead_port())]
    got = {}
    try:
        for name, tp in (("port", ttp), ("jax", jtp)):
            t = tp.TcpTransport(0, list(addresses), recv_timeout_s=5.0)
            t.start()
            t.addresses[0] = ("127.0.0.1", t.bound_port())
            try:
                with pytest.raises(tp.PeerUnreachable) as err:
                    t.connect(retries=1, initial_backoff_s=0.01)
                assert err.value.peer == 1 and err.value.attempts == 2
                got[name] = t.connect(retries=1, initial_backoff_s=0.01,
                                      on_unreachable="skip")
                assert t.known_peers() == [2]
                with pytest.raises(ValueError, match="raise|skip"):
                    t.connect(on_unreachable="explode")
                with pytest.raises(tp.PeerUnreachable):
                    t.dial(3, retries=0)
            finally:
                t.close()
    finally:
        live.close()
    assert got["port"] == got["jax"] == [1, 3]


def test_a_port_prober_feeds_a_jax_detector_and_member_flap_drops_rounds():
    with _World() as w:
        obs, seen, got = _observer()
        w.jax.set_frame_observer(obs)
        injector = tfaults.install("member_flap:task1:x2", seed=0)
        detector = tdet.FailureDetector([1], heartbeat_s=0.01, suspect_s=60)
        prober = tdet.HeartbeatProber(w.port, detector).start()
        try:
            assert got.wait(RECV_TIMEOUT_S)
        finally:
            prober.stop()
        assert [f["call"] for f in injector.fired()] == [0, 1]
        assert seen[0] == (0, 0, 0, True)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

LIVE_SETS = [(0,), (0, 2), (1, 2, 3), (0, 1, 2, 3, 4), (9, 3, 7)]


@pytest.mark.parametrize("live", LIVE_SETS)
def test_rebalance_spans_and_reduce_placement_agree(live):
    for items in (1, 2, 5, 8, 13, 64):
        assert (tir.rebalance_spans(items, live)
                == jir.rebalance_spans(items, live))
        assert (tir.reduce_placement(items, live)
                == jir.reduce_placement(items, live))
    with pytest.raises(tir.PlanError):
        tir.rebalance_spans(4, [])


@pytest.mark.parametrize("live", LIVE_SETS)
def test_rewrite_for_view_moves_the_same_nodes(live):
    files = ["a", "b", "c"]
    for reducers, trainers in ((4, 2), (8, 3), (5, 5)):
        plans = [ir.build_epoch_plan(files, reducers, trainers, seed=1,
                                     epoch=2) for ir in (tir, jir)]
        moves = []
        for plan, sched in zip(plans, (tsched, jsched)):
            first = sched.rewrite_for_view(plan, [0, 1, 2, 3])
            moves.append((first, sched.rewrite_for_view(plan, live)))
        assert moves[0] == moves[1]
        hosts = [{n.id: n.meta.get("host") for n in p.nodes.values()}
                 for p in plans]
        assert hosts[0] == hosts[1]
        assert set(hosts[0][n.id] for n in plans[0].reduces()) <= set(live)
        assert plans[0].to_json() == plans[1].to_json()
