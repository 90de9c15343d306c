"""Runtime lock sanitizer: the dynamic half of the concurrency pass (own
copy of the JAX package's ``runtime/locksan.py``).

The static lock-order analysis (``analysis/locksets.py``) proves what
the source *says*; this module records what a live process actually
*does*. Opt-in: with ``RSDL_LOCKSAN=1`` the package's ``__init__`` loads
this file by path and calls :func:`install` before any port module
allocates a lock. :func:`install` patches the ``threading.Lock`` /
``RLock`` / ``Condition`` factories so that every lock **allocated from
port code** (``ray_shuffling_data_loader_tpu_torch/``) is wrapped in a
recording proxy. Locks allocated elsewhere (stdlib internals,
third-party code, test files, the JAX package) pass through untouched.

Each proxy knows its allocation site as ``path:line`` relative to the
repo root — the exact key ``locksets.LockDecl`` uses for the same
construction site, which is what makes the static and dynamic order
graphs directly comparable (:func:`crosscheck`). Recorded per process:

- **acquisition-order edges**: acquiring B while holding A adds
  ``A -> B`` (with a ``same_instance`` flag when one allocation site
  serves several runtime instances — orderings the static pass
  declines to judge);
- **held-while-blocking events**: a ``Condition.wait`` entered while
  holding *other* port locks, or a contended acquire that stalled past
  ``RSDL_LOCKSAN_SLOW_MS`` (default 50) while holding locks.

**Beside the JAX package's sanitizer.** The JAX tests' conftest arms
that package's copy under the same ``RSDL_LOCKSAN=1``, before this one.
Installed second, this sanitizer goes *beneath* the first one (it
becomes that module's ``_REAL_*`` factories) instead of over
``threading``, so the first still sees its callers at the frame it
expects. Installed first, it is what the other one takes for the real
factories. Either way a frame inside any ``locksan.py`` is never an
allocation site, each graph holds only its own package's sites, and no
lock is wrapped twice.

**Processes.** Every process that imports the package under
``RSDL_LOCKSAN=1`` records its own graph (children inherit the
environment: supervised servers, the pool's worker template). When
``RSDL_LOCKSAN_TORCH_DIR`` is set, each such process writes its graph at
exit to ``rsdl-locksan-torch-<pid>.json`` there — one file per process,
so no two processes ever write one file — and :func:`merge` folds them
into one graph (``python -m ray_shuffling_data_loader_tpu_torch.runtime.
locksan DIR OUT``). A process that ends without running ``atexit`` (a
pool worker's ``os._exit``, a SIGKILL) is left out. A forked child
starts with empty tables, so it never repeats its parent's records.

:func:`dump` writes one process's graph (by default to
``.rsdl-locksan-torch-graph.json``, the committed artifact's name);
``python -m ray_shuffling_data_loader_tpu_torch.analysis --concurrency
--locksan-graph <file> ...`` cross-checks it: dynamic edges the static
graph lacks are findings, static cycles confirmed dynamically are hard
failures.

Overhead is one dict update per acquisition under a dedicated real
lock — fine for tests and chaos soaks, not meant for production runs.
Stdlib-only.
"""

from __future__ import annotations

import atexit
import glob
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

#: Package whose allocation sites get wrapped (path prefix under root).
_DEFAULT_INCLUDE = ("ray_shuffling_data_loader_tpu_torch/",)
#: Per-process graph files under ``RSDL_LOCKSAN_TORCH_DIR``.
_PROCESS_FILE = "rsdl-locksan-torch-{pid}.json"

_installed = False
_root: str = ""
_include: Tuple[str, ...] = _DEFAULT_INCLUDE
_slow_ms: float = 50.0
#: The sanitizer module this one was installed beneath (its ``_REAL_*``
#: factories are ours while installed), else None.
_beneath: Any = None

_guard = _REAL_LOCK()          # protects the shared tables below
_edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
_events: List[Dict[str, Any]] = []
_sites: Dict[str, str] = {}    # site -> kind
_tls = threading.local()

_MODULE_FILE = os.path.abspath(__file__)
_SANITIZER_BASENAME = os.path.basename(_MODULE_FILE)


def _held_stack() -> List["_SanLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _alloc_site() -> Optional[str]:
    """``path:line`` of the nearest caller frame inside the port, past
    every frame of a sanitizer module (this one or one stacked with it)."""
    frame = sys._getframe(2)
    while frame is not None and os.path.basename(
            frame.f_code.co_filename) == _SANITIZER_BASENAME:
        frame = frame.f_back
    if frame is None:
        return None
    filename = os.path.abspath(frame.f_code.co_filename)
    rel = os.path.relpath(filename, _root).replace(os.sep, "/")
    if rel.startswith("..") or not rel.startswith(_include):
        return None
    return f"{rel}:{frame.f_lineno}"


def _record_acquired(proxy: "_SanLock", waited_s: float,
                     reentered: bool) -> None:
    stack = _held_stack()
    if not reentered:
        with _guard:
            for held in stack:
                if held is proxy:
                    continue
                key = (held.site, proxy.site)
                entry = _edges.get(key)
                if entry is None:
                    entry = _edges[key] = {
                        "src": held.site, "dst": proxy.site, "count": 0,
                        "same_instance": False}
                entry["count"] += 1
                if held.site == proxy.site:
                    entry["same_instance"] = True
            if stack and waited_s * 1000.0 >= _slow_ms:
                _events.append({
                    "type": "contended-acquire-while-holding",
                    "site": proxy.site,
                    "held": [h.site for h in stack],
                    "waited_ms": round(waited_s * 1000.0, 3),
                    "thread": threading.current_thread().name,
                })
    stack.append(proxy)


def _record_released(proxy: "_SanLock") -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is proxy:
            del stack[i]
            return


class _SanLock:
    """Recording proxy over a real lock/rlock primitive."""

    __slots__ = ("_real", "site", "reentrant")

    def __init__(self, real: Any, site: str, reentrant: bool):
        self._real = real
        self.site = site
        self.reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentered = self.reentrant and self in _held_stack()
        start = time.monotonic()
        got = self._real.acquire(blocking, timeout)
        if got:
            _record_acquired(self, time.monotonic() - start, reentered)
        return got

    def release(self) -> None:
        self._real.release()
        _record_released(self)

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition() interrogates its lock for these; delegate so a
    # proxied RLock keeps its reentrancy bookkeeping intact.
    def _release_save(self):
        inner = getattr(self._real, "_release_save", None)
        state = inner() if inner is not None else self._real.release()
        _record_released(self)
        return state

    def _acquire_restore(self, state) -> None:
        start = time.monotonic()
        inner = getattr(self._real, "_acquire_restore", None)
        if inner is not None:
            inner(state)
        else:
            self._real.acquire()
        _record_acquired(self, time.monotonic() - start, reentered=False)

    def _is_owned(self) -> bool:
        inner = getattr(self._real, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<locksan {self._real!r} @ {self.site}>"


class _SanCondition:
    """Recording proxy over a real Condition bound to a _SanLock."""

    __slots__ = ("_real", "_lock", "site")

    def __init__(self, real: Any, lock: _SanLock, site: str):
        self._real = real
        self._lock = lock
        self.site = site

    def acquire(self, *args, **kwargs) -> bool:
        return self._real.acquire(*args, **kwargs)

    def release(self) -> None:
        self._real.release()

    def __enter__(self):
        return self._real.__enter__()

    def __exit__(self, *exc):
        return self._real.__exit__(*exc)

    def _note_blocking_wait(self) -> None:
        others = [h.site for h in _held_stack() if h is not self._lock]
        if not others:
            return
        frame = sys._getframe(2)
        where = "?"
        if frame is not None:
            rel = os.path.relpath(
                os.path.abspath(frame.f_code.co_filename),
                _root).replace(os.sep, "/")
            where = f"{rel}:{frame.f_lineno}"
        with _guard:
            _events.append({
                "type": "held-while-blocking",
                "site": self.site,
                "held": others,
                "where": where,
                "thread": threading.current_thread().name,
            })

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._note_blocking_wait()
        return self._real.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._note_blocking_wait()
        return self._real.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<locksan {self._real!r} @ {self.site}>"


def _lock_factory():
    site = _alloc_site()
    real = _REAL_LOCK()
    if site is None:
        return real
    with _guard:
        _sites.setdefault(site, "Lock")
    return _SanLock(real, site, reentrant=False)


def _rlock_factory():
    site = _alloc_site()
    real = _REAL_RLOCK()
    if site is None:
        return real
    with _guard:
        _sites.setdefault(site, "RLock")
    return _SanLock(real, site, reentrant=True)


def _condition_factory(lock=None):
    site = _alloc_site()
    if site is None:
        return _REAL_CONDITION(lock)
    if lock is None:
        # Same default as the real Condition, but the inner RLock must
        # be OUR proxy so acquisitions through the condition record.
        lock = _SanLock(_REAL_RLOCK(), site, reentrant=True)
    elif not isinstance(lock, _SanLock):
        lock = _SanLock(lock, site, reentrant=True)
    with _guard:
        _sites.setdefault(lock.site, "Condition")
    real = _REAL_CONDITION(lock)
    return _SanCondition(real, lock, lock.site)


def _installed_sanitizer():
    """The module of another sanitizer of this design whose factories
    are installed over ``threading`` now, else None."""
    module = sys.modules.get(getattr(threading.Lock, "__module__", None))
    if module is None or module is sys.modules.get(__name__):
        return None
    if threading.Lock is getattr(module, "_lock_factory", None) and all(
            hasattr(module, name) for name in
            ("_REAL_LOCK", "_REAL_RLOCK", "_REAL_CONDITION")):
        return module
    return None


def _forget_parent() -> None:
    """In a forked child: new tables, so the child records only itself
    (and never waits on a guard another parent thread held at fork)."""
    global _guard, _edges, _events, _sites
    _guard = _REAL_LOCK()
    _edges, _events, _sites = {}, [], {}


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def enabled_by_env() -> bool:
    return os.environ.get("RSDL_LOCKSAN", "") == "1"


def installed() -> bool:
    return _installed


def install(root: Optional[str] = None,
            include: Tuple[str, ...] = _DEFAULT_INCLUDE) -> None:
    """Patch the threading factories (or go beneath another installed
    sanitizer, see the module docstring). Must run BEFORE the port's
    modules allocate their module-level locks to see those sites;
    idempotent. ``root`` is the repo root the static analyzer runs from
    (default: the checkout containing this file)."""
    global _installed, _root, _include, _slow_ms, _beneath
    global _REAL_LOCK, _REAL_RLOCK, _REAL_CONDITION
    _root = os.path.abspath(root) if root else os.path.dirname(
        os.path.dirname(os.path.dirname(_MODULE_FILE)))
    _include = tuple(include)
    _slow_ms = float(os.environ.get("RSDL_LOCKSAN_SLOW_MS", "50"))
    if _installed:
        return
    other = _installed_sanitizer()
    if other is not None:
        _REAL_LOCK = other._REAL_LOCK
        _REAL_RLOCK = other._REAL_RLOCK
        _REAL_CONDITION = other._REAL_CONDITION
        other._REAL_LOCK = _lock_factory
        other._REAL_RLOCK = _rlock_factory
        other._REAL_CONDITION = _condition_factory
        _beneath = other
    else:
        _REAL_LOCK = threading.Lock
        _REAL_RLOCK = threading.RLock
        _REAL_CONDITION = threading.Condition
        threading.Lock = _lock_factory
        threading.RLock = _rlock_factory
        threading.Condition = _condition_factory
    _installed = True


def uninstall() -> None:
    """Restore the factories found at :func:`install` (existing proxies
    keep recording)."""
    global _installed, _beneath
    if not _installed:
        return
    if _beneath is not None:
        _beneath._REAL_LOCK = _REAL_LOCK
        _beneath._REAL_RLOCK = _REAL_RLOCK
        _beneath._REAL_CONDITION = _REAL_CONDITION
        _beneath = None
    else:
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        threading.Condition = _REAL_CONDITION
    _installed = False


def arm_from_env() -> bool:
    """:func:`install` when ``RSDL_LOCKSAN=1`` (the package's
    ``__init__`` calls this first thing); with ``RSDL_LOCKSAN_TORCH_DIR``
    set, also write this process's graph there at exit. True if armed."""
    if not enabled_by_env():
        return False
    first = not _installed
    install()
    out_dir = os.environ.get("RSDL_LOCKSAN_TORCH_DIR")
    if first:
        os.register_at_fork(after_in_child=_forget_parent)
        if out_dir:
            atexit.register(_dump_process_graph, out_dir)
    return True


def _dump_process_graph(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    dump(os.path.join(out_dir, _PROCESS_FILE.format(pid=os.getpid())))


def reset() -> None:
    """Drop recorded edges/events/sites (tests)."""
    with _guard:
        _edges.clear()
        _events.clear()
        _sites.clear()


def graph() -> Dict[str, Any]:
    """The dynamic order graph in the same JSON shape as the static
    one (``locksets.LockAnalysis.static_graph``)."""
    with _guard:
        return {
            "kind": "rsdl-lock-order-graph",
            "source": "dynamic",
            "nodes": [{"key": site, "kind": kind}
                      for site, kind in sorted(_sites.items())],
            "edges": [dict(e) for _, e in sorted(_edges.items())],
            "events": [dict(e) for e in _events],
        }


def merge(graphs: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """One dynamic graph from several (one per process): the union of
    the nodes, each edge's counts summed (``same_instance`` if any
    graph saw it so), the events concatenated."""
    sites: Dict[str, str] = {}
    edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
    events: List[Dict[str, Any]] = []
    for g in graphs:
        for node in g.get("nodes", []):
            sites.setdefault(node["key"], node["kind"])
        for e in g.get("edges", []):
            entry = edges.setdefault((e["src"], e["dst"]), {
                "src": e["src"], "dst": e["dst"], "count": 0,
                "same_instance": False})
            entry["count"] += e["count"]
            entry["same_instance"] = (entry["same_instance"]
                                      or e["same_instance"])
        events.extend(dict(e) for e in g.get("events", []))
    return {
        "kind": "rsdl-lock-order-graph",
        "source": "dynamic",
        "nodes": [{"key": site, "kind": kind}
                  for site, kind in sorted(sites.items())],
        "edges": [e for _, e in sorted(edges.items())],
        "events": events,
    }


def load_dir(out_dir: str) -> Dict[str, Any]:
    """:func:`merge` of every per-process graph under ``out_dir``."""
    graphs = []
    for path in sorted(glob.glob(os.path.join(
            out_dir, _PROCESS_FILE.format(pid="*")))):
        with open(path, encoding="utf-8") as f:
            graphs.append(json.load(f))
    return merge(graphs)


def cycles(order_graph: Optional[Dict[str, Any]] = None
           ) -> List[List[str]]:
    """Distinct-site cycles in the (dynamic) order graph — a non-empty
    result means two threads actually interleaved opposing acquisition
    orders in this process."""
    g = order_graph if order_graph is not None else graph()
    adj: Dict[str, List[str]] = {}
    for e in g.get("edges", []):
        if e["src"] != e["dst"]:
            adj.setdefault(e["src"], []).append(e["dst"])
    # Iterative DFS cycle collection over SCCs (no recursion limits).
    from ray_shuffling_data_loader_tpu_torch.analysis.locksets import (
        _cycle_path, _tarjan)
    out: List[List[str]] = []
    for scc in _tarjan(adj):
        if len(scc) >= 2:
            out.append(_cycle_path(adj, scc))
    return out


def crosscheck(static_graph: Dict[str, Any],
               dynamic_graph: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Static<->dynamic comparison (see ``locksets.crosscheck``)."""
    from ray_shuffling_data_loader_tpu_torch.analysis import locksets
    g = dynamic_graph if dynamic_graph is not None else graph()
    return locksets.crosscheck(static_graph, g)


def write_graph(path: str, payload: Dict[str, Any]) -> str:
    """Write an order-graph artifact (sorted keys, trailing newline)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def dump(path: str = ".rsdl-locksan-torch-graph.json") -> str:
    """Write this process's order-graph artifact; returns the path."""
    return write_graph(path, graph())


def main(argv: Optional[List[str]] = None) -> int:
    """``DIR OUT``: merge the per-process graphs under DIR into OUT and
    print its counts; exit 1 if the merged graph has a cycle."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m ray_shuffling_data_loader_tpu_torch."
              "runtime.locksan DIR OUT", file=sys.stderr)
        return 2
    out_dir, out = argv
    files = glob.glob(os.path.join(out_dir, _PROCESS_FILE.format(pid="*")))
    merged = load_dir(out_dir)
    write_graph(out, merged)
    cyc = cycles(merged)
    print(f"locksan: {len(files)} process graph(s) -> {out}: "
          f"{len(merged['nodes'])} lock site(s), {len(merged['edges'])} "
          f"edge(s), {len(merged['events'])} event(s), {len(cyc)} "
          "cycle(s)")
    return 1 if cyc else 0


if __name__ == "__main__":
    sys.exit(main())
