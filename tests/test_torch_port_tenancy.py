"""The port's tenancy package (``tenancy/{__init__,fairshare,admission}.py``),
the tiered store's per-tenant hot-tier quotas, the prefetch quota and the
stream runner's tenant, against the JAX package's, on the CPU.

Every comparison is exact (no tolerance): the same seeded inputs, drawn
with numpy, go through both packages.

- Contexts: the canonical JSON bytes (the ``OP_TENANT`` payload), each
  package parsing the other's, ``resolve``'s forms, ``tenants_from_config``
  and the ambient scope (it nests, and a thread started inside it does not
  see it).
- ``FairShare`` on an injected clock: seeded sequences of ``touch``,
  ``idle``, ``charge``, ``grant``, ``budget``, ``set_weight`` and clock
  steps give equal answers and snapshots; ``simulate_rounds`` delivers
  equal bytes.
- Admission: a seeded register/release sequence journals equal bytes;
  each package replays the other's journal byte for byte, and a tampered
  journal raises in both.
- ``TieredStore(tenant_quotas=)``: a seeded put/get sequence under two
  tenant scopes gives equal hits, misses, evictions (by the tenant charged)
  and resident bytes per tenant; a cold scan never evicts the hot
  tenant's pages; the prefetch quota throttles the same tasks.
- The stream runner: ``tenant=`` stamps the window specs as JAX's does and
  its scope reaches the same batch-consumer calls; ``server_config
  (tenant_id=)`` equals JAX's.
"""

import importlib
import json
import threading

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu import storage as jst
from ray_shuffling_data_loader_tpu import streaming as jstreaming
from ray_shuffling_data_loader_tpu import tenancy as jten
from ray_shuffling_data_loader_tpu.plan import ir as jir
from ray_shuffling_data_loader_tpu.runtime import metrics as jmetrics
from ray_shuffling_data_loader_tpu.streaming import runner as jrunner
from ray_shuffling_data_loader_tpu.tenancy import admission as jadm
from ray_shuffling_data_loader_tpu.tenancy import fairshare as jfair
from ray_shuffling_data_loader_tpu_torch import storage as tst
from ray_shuffling_data_loader_tpu_torch import streaming as tstreaming
from ray_shuffling_data_loader_tpu_torch import tenancy as tten
from ray_shuffling_data_loader_tpu_torch.plan import ir as tir
from ray_shuffling_data_loader_tpu_torch.runtime import metrics as tmetrics
from ray_shuffling_data_loader_tpu_torch.streaming import runner as trunner
from ray_shuffling_data_loader_tpu_torch.tenancy import admission as tadm
from ray_shuffling_data_loader_tpu_torch.tenancy import fairshare as tfair

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

PORT = {"ten": tten, "fair": tfair, "adm": tadm, "st": tst,
        "metrics": tmetrics, "ir": tir, "streaming": tstreaming,
        "runner": trunner}
JAX = {"ten": jten, "fair": jfair, "adm": jadm, "st": jst,
       "metrics": jmetrics, "ir": jir, "streaming": jstreaming,
       "runner": jrunner}
PRIORITIES = ("batch", "standard", "interactive")


# ---------------------------------------------------------------------------
# contexts
# ---------------------------------------------------------------------------


def _seeded_context_kwargs(seed, n=16):
    """Context fields drawn from ``seed``: optional fields present or not,
    weights and SLOs as floats, quotas as ints."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = {"tenant_id": f"t{i}-{int(rng.integers(1000))}",
              "priority": PRIORITIES[int(rng.integers(3))]}
        if rng.random() < 0.5:
            kw["weight"] = float(np.round(rng.uniform(0.25, 8.0), 3))
        for field in ("cache_quota_bytes", "prefetch_quota_bytes",
                      "byte_quota"):
            if rng.random() < 0.5:
                kw[field] = int(rng.integers(1, 1 << 40))
        for field in ("slo_p99_ms", "slo_freshness_s"):
            if rng.random() < 0.5:
                kw[field] = float(rng.uniform(0.5, 500.0))
        out.append(kw)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_context_bytes_equal_jax_and_cross_parse(seed):
    for kw in _seeded_context_kwargs(seed):
        port, jax_ = tten.TenantContext(**kw), jten.TenantContext(**kw)
        blob = port.to_json()
        assert blob == jax_.to_json()
        assert port.to_dict() == jax_.to_dict()
        assert list(json.loads(blob)) == sorted(json.loads(blob))
        assert port.effective_weight == jax_.effective_weight
        # Each package parses the other's bytes into an equal context.
        assert tten.TenantContext.from_json(jax_.to_json()) == port
        assert jten.TenantContext.from_json(blob) == jax_


@pytest.mark.parametrize("bad", ["", "UPPER", "has space", "-lead",
                                 "a" * 65, 7, None])
def test_invalid_ids_raise_as_jax(bad):
    for pkg in (tten, jten):
        with pytest.raises((ValueError, TypeError)):
            pkg.TenantContext(bad)
    for kw in ({"priority": "urgent"}, {"weight": 0.0}):
        with pytest.raises(ValueError):
            tten.TenantContext("t", **kw)


def test_constants_equal_jax():
    assert tten.PRIORITY_WEIGHTS == jten.PRIORITY_WEIGHTS
    assert tten.DEFAULT_TENANT_ID == jten.DEFAULT_TENANT_ID
    assert tten.DEFAULT_TENANT.to_json() == jten.DEFAULT_TENANT.to_json()
    assert tfair.DEFAULT_QUANTUM_BYTES == jfair.DEFAULT_QUANTUM_BYTES
    assert tten.__all__ == jten.__all__
    assert tfair.__all__ == jfair.__all__
    assert tadm.__all__ == jadm.__all__


@pytest.mark.parametrize("form", [
    "named", {"tenant_id": "named", "priority": "batch", "extra": 1},
    {"tenant_id": "q", "byte_quota": 5}, None])
def test_resolve_forms_equal_jax(form):
    assert tten.resolve(form).to_json() == jten.resolve(form).to_json()
    ctx = tten.TenantContext("same")
    assert tten.resolve(ctx) is ctx
    for pkg in (tten, jten):
        with pytest.raises(TypeError):
            pkg.resolve(42)


def test_tenants_from_config_equal_jax():
    table = {"a": {"priority": "interactive", "ranks": [0]},
             "b": {"weight": 2.5}, "c": None,
             "d": {"priority": "batch", "ranks": [1, 3], "x": "kept"}}
    assert tten.tenants_from_config(table) == \
        jten.tenants_from_config(table)
    assert tten.tenants_from_config(None) == {}
    for bad in ({"bad id": {}}, {"t": {"weight": -1}}):
        for pkg in (tten, jten):
            with pytest.raises(ValueError):
                pkg.tenants_from_config(bad)


@pytest.mark.parametrize("name,pkg", [("port", tten), ("jax", jten)])
def test_scope_nests_and_is_per_thread(name, pkg):
    """The ambient tenant is a ContextVar in both packages: it nests, and
    a thread started inside the scope does not see it."""
    seen = {}

    def probe():
        seen["thread"] = pkg.current_tenant().tenant_id

    outer, inner = pkg.TenantContext("outer"), pkg.TenantContext("inner")
    assert pkg.current_tenant().tenant_id == pkg.DEFAULT_TENANT_ID
    with pkg.tenant_scope(outer):
        assert pkg.resolve(None) is outer
        with pkg.tenant_scope(inner):
            assert pkg.current_tenant() is inner
        assert pkg.current_tenant() is outer
        thread = threading.Thread(target=probe)
        thread.start()
        thread.join()
    assert seen["thread"] == pkg.DEFAULT_TENANT_ID
    assert pkg.current_tenant().tenant_id == pkg.DEFAULT_TENANT_ID


def test_scopes_of_the_two_packages_are_independent():
    with tten.tenant_scope(tten.TenantContext("port-only")):
        assert jten.current_tenant().tenant_id == jten.DEFAULT_TENANT_ID
        assert tten.current_tenant().tenant_id == "port-only"


# ---------------------------------------------------------------------------
# weighted fair share
# ---------------------------------------------------------------------------

FAIR_TENANTS = ("hot", "cold", "mid", "stranger")


def _fair_ops(seed, n=600):
    rng = np.random.default_rng(seed)
    kinds = ("touch", "idle", "charge", "grant", "budget", "advance",
             "active", "deficit", "set_weight")
    probs = np.array([5, 1, 6, 6, 3, 2, 1, 1, 0.2])
    ops = []
    for _ in range(n):
        kind = kinds[int(rng.choice(len(kinds), p=probs / probs.sum()))]
        tenant = FAIR_TENANTS[int(rng.integers(len(FAIR_TENANTS)))]
        if kind == "charge":
            arg = int(rng.integers(1, 1 << 18))
        elif kind == "advance":
            arg = float(rng.choice([0.01, 0.02, 0.2]))
        elif kind == "set_weight":
            arg = float(rng.choice([0.5, 1.0, 3.0, 5.0]))
        else:
            arg = None
        ops.append((kind, tenant, arg))
    return ops


def _run_fair(pkg, ops):
    clock = [0.0]
    fair = pkg.FairShare({"hot": 3.0, "cold": 1.0, "mid": 2.0},
                         total_budget=1 << 22, quantum_bytes=1 << 16,
                         active_window_s=0.05, clock=lambda: clock[0])
    out = []
    for i, (kind, tenant, arg) in enumerate(ops):
        if kind == "advance":
            clock[0] += arg
            result = None
        elif kind == "charge":
            result = fair.charge(tenant, arg)
        elif kind == "set_weight":
            result = fair.set_weight(tenant, arg)
        elif kind == "active":
            result = sorted(fair.active())
        else:
            result = getattr(fair, kind)(tenant)
        out.append(result)
        if i % 50 == 49:
            out.append(fair.snapshot())
    out.append(fair.snapshot())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fair_share_sequence_equals_jax(seed):
    ops = _fair_ops(seed)
    port, jax_ = _run_fair(tfair, ops), _run_fair(jfair, ops)
    assert port == jax_
    grants = [r for (kind, _, _), r in zip(ops, port) if kind == "grant"]
    assert True in grants and False in grants  # both answers exercised


@pytest.mark.parametrize("weights,frame,rounds", [
    ({"hot": 3.0, "cold": 1.0}, 1 << 14, 200),
    ({"a": 1.0, "b": 1.0}, 1 << 14, 200),
    ({"hot": 3.0, "cold": 1.0, "mid": 2.0}, 6_900_000, 40),
])
def test_simulate_rounds_equals_jax(weights, frame, rounds):
    results = []
    for pkg in (tfair, jfair):
        clock = [0.0]
        fair = pkg.FairShare(weights, total_budget=256 << 20,
                             quantum_bytes=1 << 18,
                             clock=lambda: clock[0])
        delivered = pkg.simulate_rounds(
            fair, {t: 1 << 34 for t in weights}, frame_bytes=frame,
            rounds=rounds,
            advance=lambda: clock.__setitem__(0, clock[0] + 0.01))
        results.append((delivered, fair.snapshot()))
    assert results[0] == results[1]


def test_fair_share_validation_as_jax():
    for pkg in (tfair, jfair):
        with pytest.raises(ValueError):
            pkg.FairShare({"t": 1.0}, total_budget=0)
        with pytest.raises(ValueError):
            pkg.FairShare({"t": 0.0}, total_budget=1)
        with pytest.raises(ValueError):
            pkg.FairShare({}, total_budget=1).set_weight("t", -1.0)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

CAPACITY = 1 << 30


def _admission_requests(seed, n=60):
    """Registers (some duplicate, some over a quota or the capacity) and
    releases of earlier names, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    contexts = {
        "hot": {"tenant_id": "hot", "priority": "interactive",
                "weight": 3.0},
        "cold": {"tenant_id": "cold", "priority": "batch",
                 "byte_quota": CAPACITY // 2},
        "mid": {"tenant_id": "mid"},
    }
    names, reqs = [], []
    for _ in range(n):
        if names and rng.random() < 0.3:
            tid, name = names[int(rng.integers(len(names)))]
            reqs.append(("release", tid, name))
            continue
        tid = ("hot", "cold", "mid")[int(rng.integers(3))]
        if names and rng.random() < 0.1:
            name = names[int(rng.integers(len(names)))][1]  # a retry
        else:
            name = f"ds{int(rng.integers(10_000))}"
        nbytes = int(rng.choice([rng.integers(1, CAPACITY // 4),
                                 CAPACITY * 2, -1]))
        kind = ("dataset", "stream")[int(rng.integers(2))]
        reqs.append(("register", contexts[tid], kind, name, nbytes))
        names.append((tid, name))
    return reqs, contexts


def _run_admission(pkgs, reqs, path):
    ctl = pkgs["adm"].AdmissionController(CAPACITY, journal_path=path)
    actions = []
    for req in reqs:
        if req[0] == "register":
            _, ctx, kind, name, nbytes = req
            d = ctl.register(pkgs["ten"].TenantContext(**ctx), kind, name,
                             nbytes)
            actions.append(d.action)
        else:
            actions.extend(d.action for d in ctl.release(req[1], req[2]))
    snapshot, waiting = ctl.ledger.snapshot(), ctl.waiting()
    ctl.close()
    with open(path, "rb") as f:
        return f.read(), actions, snapshot, waiting


@pytest.mark.parametrize("seed", range(3))
def test_admission_journal_bytes_equal_jax(seed, tmp_path):
    reqs, _ = _admission_requests(seed)
    port = _run_admission(PORT, reqs, str(tmp_path / "port.journal"))
    jax_ = _run_admission(JAX, reqs, str(tmp_path / "jax.journal"))
    assert port == jax_
    assert {"accept", "reject", "release"} <= set(port[1])


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port_journal_jax_replay",
                              "jax_journal_port_replay"])
def test_admission_replays_across_packages(writer, reader, tmp_path):
    reqs, contexts = _admission_requests(7)
    path = str(tmp_path / "admission.journal")
    original, _, snapshot, _ = _run_admission(writer, reqs, path)
    tenants = {tid: reader["ten"].TenantContext(**ctx)
               for tid, ctx in contexts.items()}
    rebuilt = reader["adm"].replay(path, CAPACITY, tenants=tenants)
    assert rebuilt.journal_bytes() == original
    assert rebuilt.ledger.snapshot() == snapshot


@pytest.mark.parametrize("tamper", ["forged_line", "flipped_action",
                                    "missing_quota"])
def test_a_tampered_journal_raises_in_both(tamper, tmp_path):
    path = str(tmp_path / "admission.journal")
    ctl = tadm.AdmissionController(1000, journal_path=path)
    quota = tten.TenantContext("q", byte_quota=500)
    ctl.register(quota, "dataset", "a", 400)
    ctl.register(quota, "dataset", "b", 400)  # reject: over the quota
    ctl.close()
    tenants = {"q": quota}
    if tamper == "forged_line":
        with open(path, "ab") as f:
            f.write(b'{"forged":1}\n')
    elif tamper == "flipped_action":
        data = open(path, "rb").read().replace(b'"accept"', b'"reject"', 1)
        open(path, "wb").write(data)
    else:
        tenants = {}  # replayed without the quota: an accept diverges
    for adm, ten in ((tadm, tten), (jadm, jten)):
        ctx = {t: ten.TenantContext(**c.to_dict())
               for t, c in tenants.items()}
        with pytest.raises((ValueError, TypeError)):
            adm.replay(path, 1000, tenants=ctx)


def test_decision_line_equal_jax():
    for args in ((1, "accept", "t", "dataset", "x", 5),
                 (9, "queue", "a.b", "stream", "w", 1 << 40, "waiting")):
        line = tadm.AdmissionDecision(*args).to_line()
        assert line == jadm.AdmissionDecision(*args).to_line()
        assert tadm.AdmissionDecision.from_line(line) == \
            tadm.AdmissionDecision(*args)


def test_admission_metrics_equal_jax():
    reqs, _ = _admission_requests(3, n=20)
    deltas = []
    for pkgs in (PORT, JAX):
        names = [("rsdl_admission_decisions_total", {"action": a})
                 for a in ("accept", "queue", "reject", "admit",
                           "release")]
        before = [pkgs["metrics"].counter(n, **lb).value for n, lb in names]
        ctl = pkgs["adm"].AdmissionController(CAPACITY)
        for req in reqs:
            if req[0] == "register":
                ctl.register(pkgs["ten"].TenantContext(**req[1]), *req[2:])
            else:
                ctl.release(req[1], req[2])
        deltas.append((
            [pkgs["metrics"].counter(n, **lb).value - b
             for (n, lb), b in zip(names, before)],
            pkgs["metrics"].gauge("rsdl_admission_used_bytes").value))
    assert deltas[0] == deltas[1]


# ---------------------------------------------------------------------------
# storage quotas
# ---------------------------------------------------------------------------


def _tables(seed, n=12):
    rng = np.random.default_rng(seed)
    return {f"f{i}": pa.table({"key": np.arange(
        int(rng.integers(50, 400)), dtype=np.int64) + 1000 * i})
            for i in range(n)}


def _tenant_counts(pkgs, tenants):
    return {t: tuple(pkgs["metrics"].counter(
        f"rsdl_tenant_storage_{w}_total", tenant=t).value
        for w in ("hits", "misses", "evictions")) for t in tenants}


def _run_store(pkgs, tables, ops, quotas, hot_bytes):
    ten = pkgs["ten"]
    store = pkgs["st"].TieredStore(hot_bytes, tenant_quotas=quotas)
    scopes = {t: ten.TenantContext(t) for t in ("hot", "cold")}
    before = _tenant_counts(pkgs, scopes)
    trace = []
    try:
        for tenant, op, key in ops:
            with ten.tenant_scope(scopes[tenant]):
                if op == "put":
                    trace.append(store.put(key, tables[key]))
                else:
                    got = store.get(key)
                    trace.append(got is not None)
                    if got is None and hasattr(store, "release"):
                        store.release(key)  # the port's load claim
            trace.append(dict(sorted(store._tenant_hot_bytes.items())))
        after = _tenant_counts(pkgs, scopes)
        deltas = {t: tuple(a - b for a, b in zip(after[t], before[t]))
                  for t in scopes}
        gauges = {t: pkgs["metrics"].gauge("rsdl_tenant_cache_bytes",
                                           tenant=t).value for t in scopes}
        return trace, deltas, gauges, list(store._hot)
    finally:
        store.close()


@pytest.mark.parametrize("seed", range(3))
def test_store_quota_sequence_equals_jax(seed):
    tables = _tables(seed)
    rng = np.random.default_rng(100 + seed)
    ops = [(("hot", "cold")[int(rng.integers(2))],
            ("put", "get")[int(rng.integers(2))],
            f"f{int(rng.integers(len(tables)))}") for _ in range(150)]
    size = max(t.nbytes for t in tables.values())
    quotas = {"hot": 3 * size, "cold": 2 * size}
    port = _run_store(PORT, tables, ops, quotas, hot_bytes=4 * size)
    jax_ = _run_store(JAX, tables, ops, quotas, hot_bytes=4 * size)
    assert port == jax_
    assert all(sum(port[1][t]) > 0 for t in ("hot", "cold"))


def test_a_cold_scan_never_evicts_the_hot_tenants_pages():
    """The hot tenant warms 4 files, then the cold tenant scans 10 files,
    more than its quota of 2 holds: every hot file still hits, and every
    eviction is charged to cold (both packages)."""
    tables = _tables(5, n=14)
    size = max(t.nbytes for t in tables.values())
    hot_keys, cold_keys = list(tables)[:4], list(tables)[4:]
    ops = ([("hot", "put", k) for k in hot_keys]
           + [("cold", op, k) for k in cold_keys for op in ("get", "put")]
           + [("hot", "get", k) for k in hot_keys])
    quotas = {"hot": 4 * size, "cold": 2 * size}
    results = [_run_store(pkgs, tables, ops, quotas, hot_bytes=8 * size)
               for pkgs in (PORT, JAX)]
    assert results[0] == results[1]
    trace, deltas, _, resident = results[0]
    hot_gets = trace[-8::2]
    assert hot_gets == [True] * 4
    assert deltas["hot"] == (4, 0, 0)
    cold_resident = [k for k in resident if k in cold_keys]
    assert len(cold_resident) >= 2
    assert deltas["cold"] == (0, len(cold_keys),
                              len(cold_keys) - len(cold_resident))
    assert set(hot_keys) <= set(resident)


def test_a_table_over_the_quota_is_not_kept_hot_and_context_quota_applies():
    tables = _tables(9, n=3)
    results = []
    for pkgs in (PORT, JAX):
        ten = pkgs["ten"]
        store = pkgs["st"].TieredStore(1 << 30)
        try:
            small = ten.TenantContext("ctx", cache_quota_bytes=1)
            with ten.tenant_scope(small):
                ok = store.put("f0", tables["f0"])
            quota = pkgs["metrics"].gauge("rsdl_tenant_cache_quota_bytes",
                                          tenant="ctx").value
            results.append((ok, store.resident("f0"), quota))
        finally:
            store.close()
    assert results[0] == results[1] == (False, False, 1)


@pytest.mark.parametrize("quota_files", [0, 1, 2, None])
def test_prefetch_quota_throttles_as_jax(quota_files, tmp_path):
    """A tenant's ``prefetch_quota_bytes``: the manager warms until the
    warmed bytes reach it, then skips and counts the rest."""
    paths = []
    for i in range(5):
        path = str(tmp_path / f"p{i}.parquet")
        pq.write_table(pa.table({"key": np.arange(200, dtype=np.int64)
                                 + 200 * i}), path)
        paths.append(path)
    nbytes = pa.table({"key": np.arange(200, dtype=np.int64)}).nbytes
    quota = None if quota_files is None else quota_files * nbytes
    results = []
    for pkgs in (PORT, JAX):
        ten = pkgs["ten"]
        tenant = ten.TenantContext(f"pf{quota_files}".lower(),
                                   prefetch_quota_bytes=quota)
        store = pkgs["st"].TieredStore(1 << 30,
                                       source=pkgs["st"].LocalSource())
        throttled = pkgs["metrics"].counter(
            "rsdl_tenant_prefetch_throttled_total",
            tenant=tenant.tenant_id)
        before = throttled.value
        try:
            manager = pkgs["st"].PrefetchManager(store, paths,
                                                 tenant=tenant)
            ran = []
            while True:
                task = manager.next()
                if task is None:
                    break
                ran.append(task.run())
            results.append((ran, throttled.value - before,
                            [store.resident(p) for p in paths],
                            manager._warmed_bytes))
        finally:
            store.close()
    assert results[0] == results[1]
    warmed = 5 if quota_files is None else quota_files
    assert results[0][0] == [True] * warmed + [False] * (5 - warmed)
    assert results[0][1] == 5 - warmed


def test_make_prefetcher_pins_the_plans_or_the_ambient_tenant():
    got = []
    for pkgs in (PORT, JAX):
        ten, ir = pkgs["ten"], pkgs["ir"]
        store = pkgs["st"].TieredStore(1 << 20)
        try:
            plan = ir.build_epoch_plan(["a", "b"], 2, 1, 0, 0,
                                       tenant_id="planned")
            bare = ir.build_epoch_plan(["a", "b"], 2, 1, 0, 0)
            with ten.tenant_scope(ten.TenantContext("ambient")):
                planned = store.make_prefetcher(plan)
                ambient = store.make_prefetcher(bare)
            got.append((planned.tenant.to_json(), ambient.tenant.to_json(),
                        list(planned._pending)))
        finally:
            store.close()
    assert got[0] == got[1]
    assert json.loads(got[0][0])["tenant_id"] == "planned"
    assert json.loads(got[0][1])["tenant_id"] == "ambient"


# ---------------------------------------------------------------------------
# the stream runner's tenant
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_tenancy_stream"))
    filenames, _ = jdg.generate_data_local(400, 4, 1, 0.0, d, seed=8)
    return filenames


def _run_stream(pkgs, files_):
    """A 2-window stream run as tenant ``live``: the specs it emits, the
    tables each consumer call got, and the tenant each call saw."""
    ten = pkgs["ten"]
    calls = []

    def consumer(rank, epoch, refs):
        tenant = ten.current_tenant().tenant_id
        keys = (None if refs is None else
                [r.result().column("key").to_pylist() for r in refs])
        calls.append((rank, epoch, keys, tenant))

    runner = pkgs["streaming"].StreamingShuffleRunner(
        pkgs["streaming"].SyntheticEventSource(files_, seed=3,
                                               total_events=len(files_)),
        consumer, 2, 1, seed=5, max_concurrent_epochs=1,
        policy=pkgs["streaming"].WindowPolicy(max_files=2),
        tenant=ten.TenantContext("live", priority="interactive"))
    specs = []
    original = runner._specs

    def recording_specs():
        for spec in original():
            specs.append(spec)
            yield spec

    runner._specs = recording_specs
    summary = runner.run()
    dicts = importlib.import_module(
        pkgs["streaming"].__name__ + ".window").specs_to_dicts(specs)
    return dicts, sorted(calls, key=lambda c: (c[1], c[0], c[2] is None)), \
        summary["windows_served"], runner.tenant.to_json()


def test_stream_runner_tenant_equals_jax(stream_files):
    port = _run_stream(PORT, list(stream_files))
    jax_ = _run_stream(JAX, list(stream_files))
    assert port == jax_
    assert {d["tenant_id"] for d in port[0]} == {"live"}
    assert port[2] == 2
    # The scope reaches the consumer calls JAX's does (the shuffle's
    # threads do not inherit a ContextVar).
    assert [c[3] for c in port[1]] == [c[3] for c in jax_[1]]


def test_server_config_with_tenant_equals_jax(stream_files):
    configs = []
    for pkgs in (PORT, JAX):
        source = pkgs["streaming"].SyntheticEventSource(
            list(stream_files), seed=3, total_events=len(stream_files))
        configs.append(pkgs["runner"].server_config(
            source, 2, 2, "wm.wal", seed=5,
            policy=pkgs["streaming"].WindowPolicy(max_files=2),
            tenant_id="live", tenants={"live": {"weight": 3,
                                                "ranks": [0]}}))
    assert configs[0] == configs[1]
    assert {e["tenant_id"] for e in configs[0]["epochs"]} == {"live"}
