"""The port's whole-program concurrency pass (``analysis/{callgraph,
locksets,rules_concurrency}.py``, ``core.check_program_paths``, the CLI's
``--concurrency``) and its runtime lock sanitizer (``runtime/locksan.py``)
against the JAX package's, on the CPU:

- the JAX tests' synthetic ``pkgx`` fixtures through both checkers: the
  same findings as (rule, path, line, message) and the same
  ``--emit-order-graph`` JSON;
- both checkers over the port's own package: one static graph, no
  finding;
- a live two-thread inversion recorded by each sanitizer in a child
  process: the same graph;
- both sanitizers armed in one process, in either order: each graph
  holds only its own package's sites and no lock is wrapped twice;
- an armed port workload (a served queue drained by two tenant-bound
  clients) records port sites, the ``_QueueState.lock`` ->
  ``QueueServer._tenant_lock`` edge among them, reconciled by its
  reviewed pragma;
- the committed ``.rsdl-locksan-torch-graph.json`` cross-checks clean.

Fixtures live in string literals, which the checkers' AST walk never
sees when they scan this file.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from ray_shuffling_data_loader_tpu.analysis import cli as jcli
from ray_shuffling_data_loader_tpu.analysis import core as jcore
from ray_shuffling_data_loader_tpu.analysis import locksets as jlocksets
from ray_shuffling_data_loader_tpu.runtime import locksan as jlocksan
from ray_shuffling_data_loader_tpu_torch.analysis import cli as tcli
from ray_shuffling_data_loader_tpu_torch.analysis import core as tcore
from ray_shuffling_data_loader_tpu_torch.analysis import locksets
from ray_shuffling_data_loader_tpu_torch.runtime import locksan

import test_concurrency_analysis as jtests
from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "ray_shuffling_data_loader_tpu_torch"
ARTIFACT = os.path.join(REPO_ROOT, ".rsdl-locksan-torch-graph.json")
A_KEY = f"pkgx/locks.py:{jtests.LOCK_A_LINE}"
B_KEY = f"pkgx/locks.py:{jtests.LOCK_B_LINE}"


def _dyn(*edges):
    return {"kind": "rsdl-lock-order-graph", "source": "dynamic",
            "nodes": [{"key": A_KEY, "kind": "Lock"},
                      {"key": B_KEY, "kind": "Lock"}],
            "edges": [{"src": s, "dst": d, "count": 1,
                       "same_instance": False} for s, d in edges]}


_LEAF_SRC = """\
    from pkgx.locks import LOCK_A, LOCK_B


    def a_only():
        with LOCK_A:
            pass


    def b_only():
        with LOCK_B:
            pass
    """
_SNEAK_PRAGMA = (
    jtests.STORE_SRC[:jtests.STORE_SRC.rindex("        self._items.append(x)")]
    + "        # rsdl-lint: disable=unguarded-shared-mutation\n"
    + "        self._items.append(x)\n")
_COUNTER_SRC = """\
    import threading


    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0
            self._m = 0

        def incr(self):
            with self._lock:
                self._n += 1
                self._bump()

        def set_both(self, v):
            with self._lock:
                self._n = v
                self._m = v

        def _bump(self):
            self._m += 1
            self._n += 1
    """

#: The JAX tests' fixtures: files, the locksan graph handed to the pass
#: (or None) and the number of findings the JAX checker reports.
FIXTURES = {
    "ab_ba_inversion": ({"locks.py": jtests.LOCKS_SRC,
                         "mod_a.py": jtests.AB_SRC,
                         "mod_b.py": jtests.BA_SRC}, None, 1),
    "consistent_order": ({"locks.py": jtests.LOCKS_SRC,
                          "mod_a.py": jtests.AB_SRC,
                          "mod_b.py": jtests.AB_SRC.replace("def ab",
                                                            "def ab2")},
                         None, 0),
    "dynamic_edge_missing": ({"locks.py": jtests.LOCKS_SRC,
                              "mod_b.py": jtests.BA_SRC},
                             _dyn((A_KEY, B_KEY)), 2),
    "dynamic_edge_into_leaf": ({"locks.py": jtests.LOCKS_SRC,
                                "mod_a.py": _LEAF_SRC},
                               _dyn((A_KEY, B_KEY)), 0),
    "static_cycle_confirmed": ({"locks.py": jtests.LOCKS_SRC,
                                "mod_a.py": jtests.AB_SRC,
                                "mod_b.py": jtests.BA_SRC},
                               _dyn((A_KEY, B_KEY), (B_KEY, A_KEY)), 1),
    "unguarded_mutation": ({"store.py": jtests.STORE_SRC}, None, 1),
    "unguarded_mutation_pragma": ({"store.py": _SNEAK_PRAGMA}, None, 0),
    "entry_held_credit": ({"counter.py": _COUNTER_SRC}, None, 0),
}


def _pass(core, tmp_path, graph):
    config = core.Config(concurrency_globs=("pkgx/*",))
    violations, analysis = core.check_program_paths(
        ["pkgx"], config=config, root=str(tmp_path), locksan_graph=graph)
    return ([(v.rule, v.path, v.line, v.message) for v in violations],
            analysis)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pkgx_fixtures_give_the_jax_findings_and_graph(name, tmp_path):
    files, graph, n_findings = FIXTURES[name]
    jtests._write_fixture(tmp_path, files)
    got, port_analysis = _pass(tcore, tmp_path, graph)
    want, jax_analysis = _pass(jcore, tmp_path, graph)
    assert got == want
    assert len(got) == n_findings
    assert port_analysis.static_graph() == jax_analysis.static_graph()
    assert port_analysis.cycles() == jax_analysis.cycles()
    if graph is not None:
        assert locksets.crosscheck(port_analysis.static_graph(), graph) \
            == jlocksets.crosscheck(jax_analysis.static_graph(), graph)


@pytest.mark.parametrize("name", ["ab_ba_inversion", "entry_held_credit"])
def test_cli_order_graph_and_output_equal_jax(name, tmp_path, monkeypatch,
                                              capsys):
    files, _, n_findings = FIXTURES[name]
    jtests._write_fixture(tmp_path, files)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"concurrency_globs": ["pkgx/*"]}))
    monkeypatch.chdir(tmp_path)
    out = {}
    for pkg, cli in (("port", tcli), ("jax", jcli)):
        graph = tmp_path / f"{pkg}-graph.json"
        rc = cli.main(["--no-baseline", "--concurrency", "--config",
                       str(config), "--emit-order-graph", str(graph),
                       "--format", "json", "pkgx"])
        out[pkg] = (rc, json.loads(capsys.readouterr().out),
                    graph.read_text())
    assert out["port"] == out["jax"]
    program = set(tcore.program_rules())
    assert sum(v["rule"] in program
               for v in out["port"][1]["violations"]) == n_findings


def test_program_rules_stay_out_of_the_per_file_registry():
    assert set(tcore.program_rules()) == set(jcore.program_rules()) == {
        "inconsistent-lock-order", "unguarded-shared-mutation"}
    assert not set(tcore.all_rules()) & set(tcore.program_rules())


@pytest.mark.parametrize("flag", ["--locksan-graph", "--emit-order-graph"])
def test_graph_flags_require_concurrency(flag, tmp_path, monkeypatch,
                                         capsys):
    (tmp_path / "empty.py").write_text("x = 1\n")
    (tmp_path / "g.json").write_text("{}")
    monkeypatch.chdir(tmp_path)
    args = ["--no-baseline", flag, "g.json", "empty.py"]
    assert tcli.main(list(args)) == jcli.main(list(args)) \
        == tcore.EXIT_ERROR
    err = capsys.readouterr().err
    assert "rsdl-lint-torch: --emit-order-graph/--locksan-graph require " \
        "--concurrency" in err


def test_per_file_output_is_the_same_with_and_without_concurrency(
        tmp_path, monkeypatch, capsys):
    (tmp_path / "sample.py").write_text(textwrap.dedent("""\
        import threading

        _lock = threading.Lock()


        def risky(fut):
            with _lock:
                return fut.result()
        """))
    monkeypatch.chdir(tmp_path)
    rcs, outs = [], []
    for extra in ([], ["--concurrency"]):
        rcs.append(tcli.main(["--no-baseline", "sample.py"] + extra))
        outs.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1] == tcore.EXIT_VIOLATIONS
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The port's own package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_pass():
    return tcore.check_program_paths([PKG], root=REPO_ROOT)


def test_both_checkers_give_one_static_graph_of_the_port(port_pass):
    violations, analysis = port_pass
    jax_violations, jax_analysis = jcore.check_program_paths(
        [PKG], config=jcore.Config(concurrency_globs=(f"{PKG}/*",)),
        root=REPO_ROOT)
    assert violations == [] and jax_violations == []
    graph = analysis.static_graph()
    assert graph == jax_analysis.static_graph()
    assert analysis.cycles() == []
    # Not vacuous: the serving plane's locks and their orders.
    assert len(graph["nodes"]) >= 70 and len(graph["edges"]) >= 50
    assert all(n["key"].startswith(f"{PKG}/") for n in graph["nodes"])


def test_port_gate_with_concurrency_and_the_artifact_is_clean(
        monkeypatch, capsys):
    """The CLI's whole-program pass over the port with the committed
    order graph: no finding, the baseline empty (the per-file rules'
    gate is ``test_torch_port_analysis.py``'s)."""
    monkeypatch.chdir(REPO_ROOT)
    with open(".rsdl-lint-torch-baseline.json", encoding="utf-8") as f:
        assert json.load(f) == {"entries": [], "version": 1}
    rc = tcli.main(["--concurrency", "--select",
                    ",".join(sorted(tcore.program_rules())),
                    "--locksan-graph", ARTIFACT, "--baseline",
                    ".rsdl-lint-torch-baseline.json", PKG])
    out = capsys.readouterr().out
    assert rc == tcore.EXIT_CLEAN, out


def _site_of(graph, path, text):
    """The node key of the lock constructed on the line of ``path``
    holding ``text``."""
    with open(os.path.join(REPO_ROOT, path), encoding="utf-8") as f:
        lines = f.read().splitlines()
    line = next(i for i, ln in enumerate(lines, 1) if text in ln)
    key = f"{path}:{line}"
    assert key in {n["key"] for n in graph["nodes"]}, key
    return key


STATE_LOCK = (f"{PKG}/multiqueue_service.py", "self.lock = threading.Lock()")
TENANT_LOCK = (f"{PKG}/multiqueue_service.py",
               "self._tenant_lock = threading.Lock()")


def _pragma_above(key):
    path, _, line = key.rpartition(":")
    with open(os.path.join(REPO_ROOT, path), encoding="utf-8") as f:
        lines = f.read().splitlines()
    return "rsdl-lint: disable=inconsistent-lock-order" in lines[int(line)
                                                                 - 2]


def test_committed_order_graph_crosschecks_clean(port_pass):
    with open(ARTIFACT, encoding="utf-8") as f:
        dynamic = json.load(f)
    _, analysis = port_pass
    report = locksets.crosscheck(analysis.static_graph(), dynamic)
    assert report["confirmed_cycles"] == []
    assert report["union_cycles"] == []
    assert locksan.cycles(dynamic) == []
    # It covers the served tenancy tests: the queue state lock taken
    # before the tenant lock, an edge the static pass lacks, reconciled
    # (as every such gap) by a reviewed pragma at the held lock's site.
    static = analysis.static_graph()
    edge = (_site_of(static, *STATE_LOCK), _site_of(static, *TENANT_LOCK))
    assert edge in {(e["src"], e["dst"]) for e in report["missing_edges"]}
    assert all(_pragma_above(e["src"]) for e in report["missing_edges"])
    assert len(dynamic["nodes"]) >= 60
    assert all(n["key"].startswith(f"{PKG}/") for n in dynamic["nodes"])


# ---------------------------------------------------------------------------
# The sanitizer in child processes
# ---------------------------------------------------------------------------

_LOAD = """\
import importlib.util
import os
import sys


def load(repo_root, package):
    name = package + ".runtime.locksan"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(repo_root, package, "runtime", "locksan.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
"""

INVERSION_DRIVER = _LOAD + """
import threading

repo_root, package, out = sys.argv[1:4]
sanitizer = load(repo_root, package)
sanitizer.install(root=os.getcwd(), include=("pkgx/",))
sys.path.insert(0, os.getcwd())
import pkgx.mod_a, pkgx.mod_b  # noqa: E401,E402 - allocates the locks

for fn in (pkgx.mod_a.ab, pkgx.mod_b.ba):
    t = threading.Thread(target=fn)
    t.start()
    t.join()
sanitizer.dump(out)
"""


@pytest.mark.parametrize("package", [PKG, "ray_shuffling_data_loader_tpu"])
def test_live_inversion_graph_equals_jax(package, tmp_path):
    jtests._write_fixture(tmp_path, {"locks.py": jtests.LOCKS_SRC,
                                     "mod_a.py": jtests.AB_SRC,
                                     "mod_b.py": jtests.BA_SRC})
    (tmp_path / "driver.py").write_text(INVERSION_DRIVER)
    out = tmp_path / f"{package}.json"
    subprocess.run([sys.executable, "driver.py", REPO_ROOT, package,
                    str(out)], cwd=str(tmp_path), check=True, timeout=60)
    with open(out) as f:
        graph = json.load(f)
    assert {(e["src"], e["dst"]) for e in graph["edges"]} == {
        (A_KEY, B_KEY), (B_KEY, A_KEY)}
    assert [n["key"] for n in graph["nodes"]] == [A_KEY, B_KEY]
    assert [sorted(c) for c in locksan.cycles(graph)] == \
        [sorted(c) for c in jlocksan.cycles(graph)] == [[A_KEY, B_KEY]]
    violations, analysis = _pass(tcore, tmp_path, graph)
    report = locksets.crosscheck(analysis.static_graph(), graph)
    assert report["missing_edges"] == []
    assert len(report["confirmed_cycles"]) == 1
    assert [v[3].startswith("DEADLOCK CONFIRMED") for v in violations] \
        == [True]


# A served queue drained by a hot and a cold tenant-bound client, from
# the package named on the command line.
_TENANT_DRAIN = """
def tenant_drain(package):
    import importlib
    import threading

    import numpy as np
    import pyarrow as pa

    mq = importlib.import_module(package + ".multiqueue")
    svc = importlib.import_module(package + ".multiqueue_service")
    ten = importlib.import_module(package + ".tenancy")
    ir = importlib.import_module(package + ".plan.ir")
    tenants = {"hot": {"weight": 3.0, "priority": "interactive",
                       "ranks": [0]},
               "cold": {"weight": 1.0, "priority": "batch", "ranks": [1]}}
    queue = mq.MultiQueue(2)
    for rank in range(2):
        for i in range(6):
            queue.put(ir.queue_index(0, rank, 2), pa.table(
                {"key": np.arange(i * 50, (i + 1) * 50, dtype=np.int64)}))
        queue.put(ir.queue_index(0, rank, 2), None)
    rows = {}
    with svc.serve_queue(queue, num_trainers=2, tenants=tenants) as server:
        def consume(rank, tenant_id):
            ctx = ten.TenantContext(tenant_id,
                                    priority=tenants[tenant_id]["priority"],
                                    weight=tenants[tenant_id]["weight"])
            with svc.RemoteQueue(server.address, max_batch=2,
                                 num_trainers=2, tenant=ctx) as remote:
                n = 0
                while True:
                    item = remote.get(ir.queue_index(0, rank, 2))
                    if item is None:
                        break
                    n += item.num_rows
                rows[rank] = n

        threads = [threading.Thread(target=consume, args=(r, t))
                   for r, t in ((0, "hot"), (1, "cold"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert rows == {0: 300, 1: 300}, rows
"""

ARMED_DRIVER = _LOAD + _TENANT_DRAIN + """
import json

repo_root, out = sys.argv[1:3]
os.environ["RSDL_LOCKSAN"] = "1"
sys.path.insert(0, repo_root)
import ray_shuffling_data_loader_tpu_torch  # noqa: E402,F401 - arms
from ray_shuffling_data_loader_tpu_torch.runtime import locksan  # noqa

tenant_drain("ray_shuffling_data_loader_tpu_torch")
assert locksan.installed()
locksan.dump(out)
"""


def test_armed_port_workload_records_port_sites(tmp_path, port_pass):
    out = tmp_path / "graph.json"
    (tmp_path / "driver.py").write_text(ARMED_DRIVER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RSDL_LOCKSAN")}
    subprocess.run([sys.executable, "driver.py", REPO_ROOT, str(out)],
                   cwd=str(tmp_path), check=True, timeout=120, env=env)
    with open(out) as f:
        graph = json.load(f)
    keys = {n["key"] for n in graph["nodes"]}
    # The wrong-prefix trap: a copied "ray_shuffling_data_loader_tpu/"
    # prefix wraps no port lock and its empty graph checks "clean".
    assert len(keys) >= 20
    assert all(k.startswith(f"{PKG}/") for k in keys)
    _, analysis = port_pass
    static = analysis.static_graph()
    edge = (_site_of(static, *STATE_LOCK), _site_of(static, *TENANT_LOCK))
    assert edge in {(e["src"], e["dst"]) for e in graph["edges"]}
    report = locksets.crosscheck(static, graph)
    assert edge in {(e["src"], e["dst"]) for e in report["missing_edges"]}
    # Each gap is reconciled at its held lock; no cycle in any view.
    assert all(_pragma_above(e["src"]) for e in report["missing_edges"])
    assert report["union_cycles"] == report["confirmed_cycles"] == []


BOTH_DRIVER = _LOAD + _TENANT_DRAIN + """
import json

repo_root, order, out = sys.argv[1:4]
sys.path.insert(0, repo_root)


def arm_jax():
    sanitizer = load(repo_root, "ray_shuffling_data_loader_tpu")
    sanitizer.install(root=repo_root)
    return sanitizer


def arm_port():
    os.environ["RSDL_LOCKSAN"] = "1"
    import ray_shuffling_data_loader_tpu_torch  # noqa: F401 - arms
    from ray_shuffling_data_loader_tpu_torch.runtime import locksan
    return locksan


if order == "jax_first":
    jax_san, port_san = arm_jax(), arm_port()
else:
    port_san, jax_san = arm_port(), arm_jax()
for package in ("ray_shuffling_data_loader_tpu_torch",
                "ray_shuffling_data_loader_tpu"):
    tenant_drain(package)
from ray_shuffling_data_loader_tpu import multiqueue as jmq  # noqa: E402
from ray_shuffling_data_loader_tpu_torch import multiqueue as tmq  # noqa

# One lock of each package, and what each proxy wraps.
port_lock = tmq.MultiQueue(1)._queues[0]._mutex
jax_lock = jmq.MultiQueue(1)._queues[0]._mutex
wrapped = {
    "port_is_port_proxy": isinstance(port_lock, port_san._SanLock),
    "port_real_is_a_proxy": isinstance(
        port_lock._real, (port_san._SanLock, jax_san._SanLock)),
    "jax_is_jax_proxy": isinstance(jax_lock, jax_san._SanLock),
    "jax_real_is_a_proxy": isinstance(
        jax_lock._real, (port_san._SanLock, jax_san._SanLock)),
}
with open(out, "w") as f:
    json.dump({"port": port_san.graph(), "jax": jax_san.graph(),
               "wrapped": wrapped}, f)
"""


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_both_sanitizers_armed_keep_their_own_sites(order, tmp_path):
    out = tmp_path / "graphs.json"
    (tmp_path / "driver.py").write_text(BOTH_DRIVER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RSDL_LOCKSAN")}
    subprocess.run([sys.executable, "driver.py", REPO_ROOT, order,
                    str(out)], cwd=str(tmp_path), check=True, timeout=180,
                   env=env)
    with open(out) as f:
        got = json.load(f)
    for name, prefix in (("port", f"{PKG}/"),
                         ("jax", "ray_shuffling_data_loader_tpu/")):
        keys = [n["key"] for n in got[name]["nodes"]]
        assert len(keys) >= 10, name
        assert all(k.startswith(prefix) for k in keys), (name, keys)
        assert any("multiqueue_service.py" in k for k in keys), name
    assert got["wrapped"] == {"port_is_port_proxy": True,
                              "port_real_is_a_proxy": False,
                              "jax_is_jax_proxy": True,
                              "jax_real_is_a_proxy": False}


# ---------------------------------------------------------------------------
# Per-process graphs
# ---------------------------------------------------------------------------


def test_merge_folds_process_graphs(tmp_path):
    a = {"nodes": [{"key": A_KEY, "kind": "Lock"}],
         "edges": [{"src": A_KEY, "dst": B_KEY, "count": 2,
                    "same_instance": False}],
         "events": [{"type": "held-while-blocking", "site": A_KEY}]}
    b = {"nodes": [{"key": B_KEY, "kind": "RLock"},
                   {"key": A_KEY, "kind": "Lock"}],
         "edges": [{"src": A_KEY, "dst": B_KEY, "count": 3,
                    "same_instance": True}], "events": []}
    for pid, g in ((11, a), (12, b)):
        locksan.write_graph(str(tmp_path / f"rsdl-locksan-torch-{pid}.json"),
                            g)
    out = tmp_path / "merged.json"
    assert locksan.main([str(tmp_path), str(out)]) == 0
    with open(out) as f:
        merged = json.load(f)
    assert merged["nodes"] == [{"key": A_KEY, "kind": "Lock"},
                               {"key": B_KEY, "kind": "RLock"}]
    assert merged["edges"] == [{"src": A_KEY, "dst": B_KEY, "count": 5,
                                "same_instance": True}]
    assert len(merged["events"]) == 1
    assert merged == locksan.load_dir(str(tmp_path))


EXIT_DRIVER = """
import os
import sys
import threading

sys.path.insert(0, sys.argv[1])
import ray_shuffling_data_loader_tpu_torch  # noqa: E402,F401 - arms
from ray_shuffling_data_loader_tpu_torch import multiqueue  # noqa: E402

queue = multiqueue.MultiQueue(1)
queue.put(0, 1)
pid = os.fork()
if pid == 0:
    # The child records its own acquisitions only.
    queue.get(0)
    sys.exit(0)
os.waitpid(pid, 0)
"""


def test_each_process_writes_its_own_graph_at_exit(tmp_path):
    (tmp_path / "driver.py").write_text(EXIT_DRIVER)
    out_dir = tmp_path / "graphs"
    env = dict(os.environ, RSDL_LOCKSAN="1",
               RSDL_LOCKSAN_TORCH_DIR=str(out_dir))
    subprocess.run([sys.executable, "driver.py", REPO_ROOT],
                   cwd=str(tmp_path), check=True, timeout=60, env=env)
    files = sorted(os.listdir(out_dir))
    assert len(files) == 2
    graphs = []
    for name in files:
        with open(out_dir / name) as f:
            graphs.append(json.load(f))
    # The parent allocated the queue's locks; the child, forked after,
    # holds none of its parent's records.
    fifo = f"{PKG}/multiqueue.py:77"
    assert [fifo in {n["key"] for n in g["nodes"]} for g in graphs] \
        in ([True, False], [False, True])
