"""Lockset inference and static lock-order analysis for the port's
checker (its copy of the JAX package's ``analysis/locksets.py``).

Built on :mod:`.callgraph`, this module answers two whole-program
questions the per-file rules cannot:

1. **Which lock guards which state?** Every ``threading.Lock`` /
   ``RLock`` / ``Condition`` constructed in the package becomes a
   :class:`LockDecl` keyed by its construction site (``path:line`` —
   the same key the runtime sanitizer records, so the static and
   dynamic graphs are directly comparable). Every attribute/global
   write is recorded with the set of locks held at that point,
   including locks a *caller* provably holds (private methods inherit
   the intersection of their call sites' held-sets). State written
   under a lock at several sites but bare at another is an
   ``unguarded-shared-mutation`` candidate.

2. **Is the acquisition order consistent?** Acquiring B while holding
   A adds the edge A->B to the lock-order graph — lexically (nested
   ``with``), and interprocedurally (calling a function that
   transitively acquires B while holding A). A cycle in that graph is
   a potential deadlock; the report names every edge of the cycle
   with its ``file:line`` witness.

Both analyses are deliberately under-approximate where resolution is
uncertain (an unresolvable receiver contributes nothing), and
self-edges are not treated as cycles: one static construction site can
serve many runtime instances (per-queue ``_QueueState.lock``), and
ordering *instances* of the same lock is invisible to a static pass —
the runtime sanitizer covers that side.
"""

from __future__ import annotations

import ast
import re
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence, Set,
                    Tuple)

from ray_shuffling_data_loader_tpu_torch.analysis import core
from ray_shuffling_data_loader_tpu_torch.analysis.callgraph import (
    FunctionInfo, ModuleInfo, Program)

#: threading factory names treated as lock constructions.
_LOCK_FACTORIES = ("Lock", "RLock", "Condition")

#: Methods treated as acquisitions in setup code only (``__init__`` has
#: no concurrent peer yet) — matches rules_lock._SETUP_METHODS.
_SETUP_METHODS = ("__init__", "__new__", "__del__", "__init_subclass__",
                  "__post_init__")

#: Container-mutating method names: ``self._xs.append(...)`` mutates
#: shared state just as surely as ``self._xs[k] = v``, but only a
#: whole-program pass bothers tracking it (the per-file lock-mutation
#: rule predates this and only sees Assign/AugAssign/Delete).
_MUTATOR_METHODS = frozenset((
    "append", "extend", "insert", "remove", "discard", "pop", "popitem",
    "clear", "update", "setdefault", "add", "appendleft", "popleft",
    "sort", "reverse"))


class LockDecl:
    """One lock construction site.

    ``key`` is ``path:line`` of the ``threading.X(...)`` call — the
    identity shared with ``runtime/locksan.py``'s dynamic graph.
    """

    __slots__ = ("key", "kind", "owner", "attr", "path", "line", "cls")

    def __init__(self, key: str, kind: str, owner: str, attr: str,
                 path: str, line: int, cls: Optional[str]):
        self.key = key
        self.kind = kind        # Lock | RLock | Condition
        self.owner = owner      # "mod:Class.attr" or "mod:attr" (global)
        self.attr = attr        # bare attribute/global name
        self.path = path
        self.line = line
        self.cls = cls          # owning class qualname ("mod:Class") or None

    def as_dict(self) -> dict:
        return {"key": self.key, "kind": self.kind, "owner": self.owner}


class Acquisition:
    __slots__ = ("lock", "line", "held", "func")

    def __init__(self, lock: str, line: int, held: Tuple[str, ...],
                 func: str):
        self.lock = lock
        self.line = line
        self.held = held        # lock keys held when this one is taken
        self.func = func


class CallSite:
    __slots__ = ("callee", "line", "held", "func")

    def __init__(self, callee: str, line: int, held: Tuple[str, ...],
                 func: str):
        self.callee = callee
        self.line = line
        self.held = held
        self.func = func


class Write:
    __slots__ = ("target", "line", "col", "held", "func", "setup", "kind")

    def __init__(self, target: str, line: int, col: int,
                 held: Tuple[str, ...], func: str, setup: bool, kind: str):
        self.target = target    # "mod:Class.attr" or "mod:name" (global)
        self.line = line
        self.col = col
        self.held = held
        self.func = func
        self.setup = setup
        self.kind = kind        # "assign" | "mutate"


class FuncConc:
    """Concurrency-relevant facts for one function."""

    __slots__ = ("info", "acquisitions", "calls", "writes", "entry_held")

    def __init__(self, info: FunctionInfo):
        self.info = info
        self.acquisitions: List[Acquisition] = []
        self.calls: List[CallSite] = []
        self.writes: List[Write] = []
        #: Locks provably held on entry (interprocedural; None until
        #: the fixpoint assigns it).
        self.entry_held: Optional[Set[str]] = None


def _factory_kind(call: ast.Call, mod: ModuleInfo) -> Optional[str]:
    """``Lock``/``RLock``/``Condition`` when ``call`` constructs one."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _LOCK_FACTORIES:
        base = core.dotted_name(func.value)
        resolved = mod.imports.get(base.partition(".")[0], base)
        if resolved == "threading" or resolved.startswith("threading."):
            return func.attr
    if isinstance(func, ast.Name) and func.id in _LOCK_FACTORIES:
        # ``from threading import Lock``
        if mod.imports.get(func.id, "").startswith("threading."):
            return func.id
    return None


class LockAnalysis:
    """The whole-program lockset/lock-order pass over a Program."""

    def __init__(self, program: Program, config: core.Config):
        self.program = program
        self.config = config
        self._lock_re = re.compile(config.lock_name_regex)
        self.decls: Dict[str, LockDecl] = {}        # by key
        self._class_locks: Dict[Tuple[str, str], LockDecl] = {}
        self._global_locks: Dict[Tuple[str, str], LockDecl] = {}
        self._attr_locks: Dict[str, List[LockDecl]] = {}
        #: Condition-over-existing-lock attrs aliasing the wrapped decl.
        self._aliases: Dict[Tuple[str, str], LockDecl] = {}
        #: attr name -> class qualnames that assign ``self.attr``.
        self._attr_classes: Dict[str, Set[str]] = {}
        self.funcs: Dict[str, FuncConc] = {}
        #: (src, dst) -> first witness string.
        self.edges: Dict[Tuple[str, str], Dict[str, str]] = {}
        self._trans_acquired: Dict[str, Dict[str, str]] = {}

    # -- discovery --------------------------------------------------------

    def _add_decl(self, kind: str, owner: str, attr: str, mod: ModuleInfo,
                  line: int, cls: Optional[str],
                  alias_of: Optional[LockDecl] = None) -> LockDecl:
        if alias_of is not None:
            decl = alias_of  # Condition(self._mutex): same identity
        else:
            key = f"{mod.path}:{line}"
            decl = self.decls.get(key)
            if decl is None:
                decl = LockDecl(key, kind, owner, attr, mod.path, line, cls)
                self.decls[key] = decl
        if cls is not None:
            self._class_locks.setdefault((cls, attr), decl)
            self._attr_locks.setdefault(attr, [])
            if decl not in self._attr_locks[attr]:
                self._attr_locks[attr].append(decl)
        else:
            self._global_locks.setdefault((mod.name, attr), decl)
        return decl

    def _discover_module(self, mod: ModuleInfo) -> None:
        # Module-level: NAME = threading.Lock()
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                kind = _factory_kind(node.value, mod)
                if kind is None:
                    continue
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        self._add_decl(kind, f"{mod.name}:{target.id}",
                                       target.id, mod, node.value.lineno,
                                       None)
        # Class-level and self.X = threading.Lock() in method bodies.
        for node in mod.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            cls_q = f"{mod.name}:{node.name}"
            deferred: List[Tuple[str, ast.Call]] = []
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Assign)
                        and isinstance(sub.value, ast.Call)):
                    continue
                kind = _factory_kind(sub.value, mod)
                if kind is None:
                    continue
                for target in sub.targets:
                    attr = _self_attr_target(target)
                    if attr is None and isinstance(target, ast.Name):
                        attr = target.id  # class-body assignment
                    if attr is None:
                        continue
                    if kind == "Condition" and sub.value.args:
                        deferred.append((attr, sub.value))
                        continue
                    self._add_decl(kind, f"{cls_q}.{attr}", attr, mod,
                                   sub.value.lineno, cls_q)
            # Second pass: Condition(wrapped_lock) aliases the wrapped
            # lock's identity — acquiring the condition IS acquiring it.
            for attr, call in deferred:
                wrapped = None
                arg = call.args[0]
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id == "self":
                    wrapped = self._class_locks.get((cls_q, arg.attr))
                decl = self._add_decl(
                    "Condition", f"{cls_q}.{attr}", attr, mod,
                    call.lineno, cls_q, alias_of=wrapped)
                if wrapped is not None:
                    self._aliases[(cls_q, attr)] = decl
            # Attr ownership index for write attribution: ``self.X``
            # assignments anywhere in the class, plus class-body field
            # declarations (dataclass fields, class attributes) — both
            # make X "an attribute of this class", and attribution must
            # refuse when two classes share a name.
            for sub in ast.walk(node):
                for target in _write_targets(sub):
                    attr = _self_attr_target(target)
                    if attr is not None:
                        self._attr_classes.setdefault(attr,
                                                      set()).add(cls_q)
            for sub in node.body:
                for target in _write_targets(sub):
                    if isinstance(target, ast.Name):
                        self._attr_classes.setdefault(target.id,
                                                      set()).add(cls_q)

    # -- lock reference resolution ----------------------------------------

    def resolve_lock(self, expr: ast.expr,
                     func: FunctionInfo) -> Optional[LockDecl]:
        """The LockDecl an acquisition expression refers to, if known."""
        mod = func.module
        if isinstance(expr, ast.Subscript):
            return self.resolve_lock(expr.value, func)
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if isinstance(expr.value, ast.Name):
                base = expr.value.id
                if base == "self" and func.cls is not None:
                    cls_q = f"{mod.name}:{func.cls}"
                    decl = self._aliases.get((cls_q, attr)) or \
                        self._class_locks.get((cls_q, attr))
                    if decl is not None:
                        return decl
                else:
                    # module alias (``mod.GLOBAL_LOCK``)?
                    imported = mod.imports.get(base)
                    if imported is not None:
                        decl = self._global_locks.get((imported, attr))
                        if decl is not None:
                            return decl
            # Fall through: a foreign receiver (``state.lock``, a
            # handle passed in). Resolve only when the attribute name
            # names exactly one lock program-wide — ambiguity would
            # invent edges.
            candidates = self._attr_locks.get(attr, [])
            if len(candidates) == 1:
                return candidates[0]
            return None
        if isinstance(expr, ast.Name):
            decl = self._global_locks.get((mod.name, expr.id))
            if decl is not None:
                return decl
            imported = mod.imports.get(expr.id)
            if imported and "." in imported:
                owner_mod, _, leaf = imported.rpartition(".")
                return self._global_locks.get((owner_mod, leaf))
        return None

    def is_lock_name(self, name: str) -> bool:
        return bool(self._lock_re.search(name))

    # -- per-function scan -------------------------------------------------

    def _scan_functions(self) -> None:
        for qual, info in self.program.functions.items():
            conc = FuncConc(info)
            _FuncScanner(self, conc).run()
            self.funcs[qual] = conc

    # -- interprocedural fixpoints ----------------------------------------

    def _entry_held_fixpoint(self) -> None:
        """Private functions inherit the intersection of held-sets over
        all their (resolved) call sites; public entry points assume
        nothing. Iterated because a call site's held-set includes the
        caller's own entry set."""
        callsites: Dict[str, List[CallSite]] = {}
        for conc in self.funcs.values():
            for cs in conc.calls:
                callsites.setdefault(cs.callee, []).append(cs)
        def _internal(conc: FuncConc) -> bool:
            # ``_helper`` by name, or any method of a module-private
            # class (``_Frame.resolve_codec``): either way the call
            # sites are a closed world, so the intersection over them
            # is a sound entry assumption.
            name = conc.info.name
            if name.startswith("_") and not name.startswith("__"):
                return True
            return bool(conc.info.cls) and conc.info.cls.startswith("_")

        private = {
            q for q, conc in self.funcs.items()
            if _internal(conc) and callsites.get(q)
        }
        for q, conc in self.funcs.items():
            conc.entry_held = None if q in private else set()
        for _ in range(12):
            changed = False
            for q in private:
                acc: Optional[Set[str]] = None
                for cs in callsites[q]:
                    caller_entry = self.funcs[cs.func].entry_held
                    site_held = set(cs.held) | (caller_entry or set())
                    acc = site_held if acc is None else acc & site_held
                acc = acc or set()
                if self.funcs[q].entry_held != acc:
                    self.funcs[q].entry_held = acc
                    changed = True
            if not changed:
                break
        for conc in self.funcs.values():
            if conc.entry_held is None:
                conc.entry_held = set()

    def _transitive_acquired(self) -> None:
        """lock key -> witness site for every lock a function may
        acquire directly or through resolved callees (fixpoint)."""
        for q, conc in self.funcs.items():
            self._trans_acquired[q] = {
                a.lock: f"{conc.info.module.path}:{a.line}"
                for a in conc.acquisitions}
        for _ in range(16):
            changed = False
            for q, conc in self.funcs.items():
                mine = self._trans_acquired[q]
                for cs in conc.calls:
                    for lock, site in self._trans_acquired.get(
                            cs.callee, {}).items():
                        if lock not in mine:
                            mine[lock] = site
                            changed = True
            if not changed:
                break

    # -- lock-order graph --------------------------------------------------

    def _add_edge(self, src: str, dst: str, where: str, func: str,
                  via: str = "") -> None:
        if src == dst:
            return  # instance-order is the runtime sanitizer's job
        self.edges.setdefault((src, dst), {
            "src": src, "dst": dst, "where": where, "func": func,
            "via": via})

    def _build_edges(self) -> None:
        for q, conc in self.funcs.items():
            entry = conc.entry_held or set()
            path = conc.info.module.path
            for acq in conc.acquisitions:
                for held in set(acq.held) | entry:
                    self._add_edge(held, acq.lock, f"{path}:{acq.line}", q)
            for cs in conc.calls:
                held_at_call = set(cs.held) | entry
                if not held_at_call:
                    continue
                callee_entry = self.funcs[cs.callee].entry_held \
                    if cs.callee in self.funcs else set()
                for lock, site in self._trans_acquired.get(
                        cs.callee, {}).items():
                    # A lock the callee assumes held on entry is not
                    # *acquired* inside it; edges for its nested
                    # acquisitions were already drawn at their site.
                    if lock in held_at_call or lock in (callee_entry
                                                        or set()):
                        continue
                    for held in held_at_call:
                        self._add_edge(
                            held, lock, f"{path}:{cs.line}", q,
                            via=f"call to {cs.callee} which acquires it "
                                f"at {site}")

    # -- public API --------------------------------------------------------

    def run(self) -> "LockAnalysis":
        for mod in self.program.modules.values():
            self._discover_module(mod)
        self._scan_functions()
        self._entry_held_fixpoint()
        self._transitive_acquired()
        self._build_edges()
        return self

    def effective_held(self, conc: FuncConc,
                       held: Tuple[str, ...]) -> Set[str]:
        return set(held) | (conc.entry_held or set())

    def cycles(self) -> List[List[Dict[str, str]]]:
        """Each cycle as its list of edge-witness dicts (A->B, B->..->A)."""
        adj: Dict[str, List[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, []).append(dst)
        sccs = _tarjan(adj)
        out: List[List[Dict[str, str]]] = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            cycle = _cycle_path(adj, scc)
            out.append([self.edges[(a, b)]
                        for a, b in zip(cycle, cycle[1:] + cycle[:1])
                        if (a, b) in self.edges])
        return out

    def static_graph(self) -> dict:
        """The order graph in the JSON shape locksan dumps, for the
        static<->dynamic cross-check."""
        return {
            "kind": "rsdl-lock-order-graph",
            "source": "static",
            "nodes": [d.as_dict() for d in
                      sorted(self.decls.values(), key=lambda d: d.key)],
            "edges": [dict(w) for (_, _), w in sorted(self.edges.items())],
        }


def analyze(program: Program, config: Optional[core.Config] = None
            ) -> LockAnalysis:
    return LockAnalysis(program, config or core.Config()).run()


# ---------------------------------------------------------------------------
# Static <-> dynamic cross-check
# ---------------------------------------------------------------------------


def crosscheck(static_graph: dict, dynamic_graph: dict) -> dict:
    """Compare the static order graph against a locksan dump.

    Returns ``{"missing_edges", "benign_leaf_edges", "union_cycles",
    "confirmed_cycles"}``:

    - ``missing_edges``: dynamic edges between statically-known locks
      that the static pass has no edge for AND that are
      *order-relevant* — the destination lock has at least one
      outgoing edge in the merged (static + dynamic) graph, so the
      edge extends an acquisition chain that could some day close a
      cycle. These are analysis gaps -> findings.
    - ``benign_leaf_edges``: missing edges whose destination is a leaf
      in the merged graph (nothing is ever acquired while holding it,
      statically or at runtime). A leaf edge can never participate in
      a cycle, so it is recorded for transparency, not flagged —
      without this, every component lock held across a metrics
      increment would demand its own pragma.
    - ``union_cycles``: cycles that appear only once the runtime-
      observed edges are merged into the static graph — a deadlock
      neither view shows alone. Hard findings.
    - ``confirmed_cycles``: static cycles whose every edge was
      observed at runtime (hard failures).

    Dynamic edges touching locks the static pass never declared
    (test-local locks, closure locks) are ignored, as are same-site
    edges — the static graph cannot order instances of one
    construction site.
    """
    nodes = {n["key"] for n in static_graph.get("nodes", [])}
    static_edges = {(e["src"], e["dst"])
                    for e in static_graph.get("edges", [])}
    dynamic_edges = {}
    for e in dynamic_graph.get("edges", []):
        src, dst = e.get("src"), e.get("dst")
        if src == dst or src not in nodes or dst not in nodes:
            continue
        dynamic_edges[(src, dst)] = e
    union_out: Dict[str, List[str]] = {}
    for src, dst in static_edges | set(dynamic_edges):
        union_out.setdefault(src, []).append(dst)
    missing, benign = [], []
    for (src, dst), e in sorted(dynamic_edges.items()):
        if (src, dst) in static_edges:
            continue
        (missing if union_out.get(dst) else benign).append(e)
    confirmed = []
    adj: Dict[str, List[str]] = {}
    for src, dst in static_edges:
        adj.setdefault(src, []).append(dst)
    static_cyclic_nodes = set()
    for scc in _tarjan(adj):
        if len(scc) < 2:
            continue
        static_cyclic_nodes.update(scc)
        cycle = _cycle_path(adj, scc)
        edges = list(zip(cycle, cycle[1:] + cycle[:1]))
        if all((a, b) in dynamic_edges for a, b in edges):
            confirmed.append([list(e) for e in edges])
    union_cycles = []
    for scc in _tarjan(union_out):
        if len(scc) < 2 or set(scc) <= static_cyclic_nodes:
            continue
        cycle = _cycle_path(union_out, scc)
        union_cycles.append(list(zip(cycle, cycle[1:] + cycle[:1])))
    return {"missing_edges": missing, "benign_leaf_edges": benign,
            "union_cycles": union_cycles, "confirmed_cycles": confirmed}


# ---------------------------------------------------------------------------
# Function-body scanner
# ---------------------------------------------------------------------------


def _self_attr_target(node: ast.AST) -> Optional[str]:
    """``self.X`` / ``self.X[k]`` assignment target -> ``X``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _write_targets(node: ast.AST) -> List[ast.expr]:
    if isinstance(node, ast.Assign):
        out: List[ast.expr] = []
        for t in node.targets:
            out.extend(t.elts if isinstance(t, ast.Tuple) else [t])
        return out
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    if isinstance(node, ast.Delete):
        return list(node.targets)
    return []


class _FuncScanner:
    """Linear walk of one function body tracking the held-lock stack."""

    def __init__(self, analysis: LockAnalysis, conc: FuncConc):
        self.an = analysis
        self.conc = conc
        self.info = conc.info
        self.held: List[str] = []
        self.setup = conc.info.name in _SETUP_METHODS
        self._globals: Set[str] = set()
        self._fresh_locals: Set[str] = set()

    def run(self) -> None:
        for node in ast.walk(self.info.node):
            if isinstance(node, ast.Global):
                self._globals.update(node.names)
        self._find_fresh_locals()
        self._scan_block(self.info.node.body)

    def _find_fresh_locals(self) -> None:
        """Locals that only ever hold an object constructed HERE (every
        assignment is ``name = SomeProgramClass(...)``): writes through
        them are to an unpublished object no other thread can see yet
        (``load_slice``'s ``ring``), not shared-state mutations."""
        assigns: Dict[str, List[ast.expr]] = {}
        for node in ast.walk(self.info.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns.setdefault(node.targets[0].id,
                                   []).append(node.value)
        args = self.info.node.args
        params = {a.arg for a in (args.args + args.kwonlyargs
                                  + getattr(args, "posonlyargs", []))}
        for name, values in assigns.items():
            if name in params:
                continue
            if all(isinstance(v, ast.Call)
                   and self.an.program.resolve_class(
                       self.info.module, v) is not None
                   for v in values):
                self._fresh_locals.add(name)

    # -- structure ---------------------------------------------------------

    def _scan_block(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self._scan_stmt(stmt)

    def _scan_child_block(self, stmts: Sequence[ast.stmt]) -> None:
        # Branch-local acquire/release effects stay in the branch: the
        # continuation after an ``if``/loop body sees the entry state
        # (full restore, so a branch-local ``release()`` cannot strip a
        # lock the enclosing ``with`` still holds).
        saved = list(self.held)
        self._scan_block(stmts)
        self.held[:] = saved

    def _scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # Nested defs run on their own schedule (often another
            # thread): scan them lock-free, like rules_lock does.
            saved, self.held = self.held, []
            for sub in (stmt.body if isinstance(stmt, ast.ClassDef)
                        else [stmt]):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_block(sub.body)
            self.held = saved
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in stmt.items:
                self._visit_expr(item.context_expr)
                decl = self.an.resolve_lock(item.context_expr, self.info)
                if decl is not None:
                    self._record_acquire(decl.key, item.context_expr.lineno)
                    acquired.append(decl.key)
            saved = list(self.held)
            self.held.extend(acquired)
            self._scan_block(stmt.body)
            self.held[:] = saved
            return
        if isinstance(stmt, ast.If):
            self._visit_expr(stmt.test)
            self._scan_child_block(stmt.body)
            self._scan_child_block(stmt.orelse)
            return
        if isinstance(stmt, (ast.While,)):
            self._visit_expr(stmt.test)
            self._scan_child_block(stmt.body)
            self._scan_child_block(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.iter)
            self._record_writes(stmt.target, kind="assign")
            self._scan_child_block(stmt.body)
            self._scan_child_block(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._scan_child_block(stmt.body)
            for handler in stmt.handlers:
                self._scan_child_block(handler.body)
            self._scan_child_block(stmt.orelse)
            # ``finally`` ALWAYS runs before the continuation, so its
            # acquire/release effects persist — this is what models the
            # ``release(); try: ... finally: acquire()`` bracket
            # (RemoteQueue.get_positioned) correctly.
            self._scan_block(stmt.finalbody)
            return
        # Leaf statements: writes, then every call in the expressions.
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Delete)):
            for target in _write_targets(stmt):
                self._record_writes(target, kind="assign")
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                self._visit_call(node)

    # -- expressions -------------------------------------------------------

    def _visit_expr(self, expr: Optional[ast.expr]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._visit_call(node)

    def _visit_call(self, call: ast.Call) -> None:
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr == "acquire":
                decl = self.an.resolve_lock(func.value, self.info)
                if decl is not None:
                    self._record_acquire(decl.key, call.lineno)
                    self.held.append(decl.key)
                    return
            elif func.attr == "release":
                decl = self.an.resolve_lock(func.value, self.info)
                if decl is not None and decl.key in self.held:
                    # remove the innermost occurrence
                    for i in range(len(self.held) - 1, -1, -1):
                        if self.held[i] == decl.key:
                            del self.held[i]
                            break
                    return
            elif func.attr in _MUTATOR_METHODS:
                self._record_writes(func.value, kind="mutate")
        callee = self.an.program.resolve_call(self.info, call)
        if callee is not None:
            self.conc.calls.append(CallSite(
                callee, call.lineno, tuple(self.held),
                self.info.qualname))

    # -- recording ---------------------------------------------------------

    def _record_acquire(self, key: str, line: int) -> None:
        self.conc.acquisitions.append(Acquisition(
            key, line, tuple(self.held), self.info.qualname))

    def _record_writes(self, target: ast.expr, kind: str) -> None:
        mod = self.info.module
        if isinstance(target, ast.Tuple):
            for elt in target.elts:
                self._record_writes(elt, kind)
            return
        sub = isinstance(target, ast.Subscript)
        inner = target.value if isinstance(target, ast.Subscript) \
            else target
        attr = _self_attr_target(inner)
        target_id: Optional[str] = None
        if attr is not None and self.info.cls is not None:
            if self.an.is_lock_name(attr):
                return
            target_id = f"{mod.name}:{self.info.cls}.{attr}"
        elif isinstance(inner, ast.Attribute) and \
                isinstance(inner.value, ast.Name) and \
                inner.value.id != "self":
            if inner.value.id in self._fresh_locals:
                return  # constructed here, unpublished: not shared yet
            # Foreign receiver: attribute owned by exactly one class
            # program-wide, else unattributable.
            owners = self.an._attr_classes.get(inner.attr, set())
            if len(owners) == 1 and not self.an.is_lock_name(inner.attr):
                target_id = f"{next(iter(owners))}.{inner.attr}"
        elif isinstance(inner, ast.Name):
            name = inner.id
            is_global = name in mod.global_names and \
                (sub or kind == "mutate" or name in self._globals)
            if is_global and not self.an.is_lock_name(name):
                target_id = f"{mod.name}:{name}"
        if target_id is None:
            return
        self.conc.writes.append(Write(
            target_id, target.lineno, target.col_offset,
            tuple(self.held), self.info.qualname, self.setup, kind))


# ---------------------------------------------------------------------------
# Graph utilities
# ---------------------------------------------------------------------------


def _tarjan(adj: Dict[str, Iterable[str]]) -> List[List[str]]:
    """Strongly connected components (iterative Tarjan)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    nodes = set(adj)
    for vs in adj.values():
        nodes.update(vs)

    def strongconnect(root: str) -> None:
        work: List[Tuple[str, Iterator]] = [(root, iter(adj.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)

    for node in sorted(nodes):
        if node not in index:
            strongconnect(node)
    return sccs


def _cycle_path(adj: Dict[str, Iterable[str]], scc: Sequence[str]
                ) -> List[str]:
    """A simple cycle visiting nodes of one cyclic SCC (DFS walk)."""
    members = set(scc)
    start = sorted(scc)[0]
    path = [start]
    seen = {start}
    node = start
    while True:
        for nxt in sorted(adj.get(node, ())):
            if nxt == start and len(path) > 1:
                return path
            if nxt in members and nxt not in seen:
                path.append(nxt)
                seen.add(nxt)
                node = nxt
                break
        else:
            # dead end inside the SCC: back out
            path.pop()
            if not path:
                return list(scc)
            node = path[-1]
        if len(path) > len(members):
            return path
