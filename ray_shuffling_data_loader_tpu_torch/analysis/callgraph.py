"""Lightweight whole-program module/call-graph for the port's checker
(its copy of the JAX package's ``analysis/callgraph.py``).

The per-file rules in ``rules_*`` see one ``ast.Module`` at a time,
which is exactly the wrong granularity for concurrency contracts: a
method that mutates ``self._states`` without ``self._states_lock`` is
fine when every caller already holds the lock, and a lock-order
inversion by definition spans at least two acquisition sites that may
live in different modules. This module gives the concurrency pass
(:mod:`.locksets`, :mod:`.rules_concurrency`) the minimum
interprocedural substrate: every module of the package parsed once, a
function index keyed by ``module:Class.method`` qualnames, per-module
import tables, and best-effort resolution of call expressions to those
qualnames.

Resolution is deliberately conservative — ``self.m()`` within the
defining class, bare names within the defining module, and
``alias.attr()`` through the import table. Anything dynamic (bound
methods passed around, getattr, duck-typed receivers) resolves to
``None`` and the downstream analyses treat the call as opaque. A
linter that under-resolves misses edges; one that over-resolves
invents deadlocks. Stdlib-only, like the rest of ``analysis/``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis import core


class ModuleInfo:
    """One parsed module of the program under analysis."""

    __slots__ = ("name", "path", "source", "tree", "imports",
                 "global_names")

    def __init__(self, name: str, path: str, source: str, tree: ast.Module):
        self.name = name          # dotted module name ("pkg.sub.mod")
        self.path = path          # repo-relative posix path
        self.source = source
        self.tree = tree
        #: local alias -> dotted module name (``import x.y as z``,
        #: ``from pkg import mod``).
        self.imports: Dict[str, str] = {}
        #: names bound at module level (globals candidates).
        self.global_names: "set[str]" = set()


class FunctionInfo:
    """One function/method definition, addressable by qualname."""

    __slots__ = ("qualname", "module", "cls", "name", "node")

    def __init__(self, qualname: str, module: ModuleInfo,
                 cls: Optional[str], node: ast.AST):
        self.qualname = qualname  # "mod:Class.method" or "mod:func"
        self.module = module
        self.cls = cls            # class name or None
        self.name = node.name
        self.node = node


#: Method names shared with builtin containers / threading primitives /
#: sockets / futures. The unique-method fallback must never fire on
#: these: a program class happening to define ``append`` would swallow
#: every ``list.append`` in the package and invent call edges (a real
#: incident: ``FaultInjector.check``'s list append resolving to
#: ``StreamJournal.append`` manufactured lock-order edges out of thin
#: air).
_GENERIC_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "sort", "reverse", "copy",
    "count", "index", "get", "put", "keys", "values", "items",
    "acquire", "release", "locked", "wait", "wait_for", "notify",
    "notify_all", "read", "write", "close", "flush", "send", "recv",
    "sendall", "connect", "accept", "join", "start", "run", "stop",
    "result", "done", "cancel", "submit", "split", "strip",
})


def module_name_for(path: str) -> str:
    """Dotted module name for a repo-relative ``.py`` path."""
    name = path[:-3] if path.endswith(".py") else path
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    return name


def _record_imports(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                # ``import a.b.c`` binds ``a``; ``import a.b.c as m``
                # binds ``m`` to the full dotted path.
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                mod.imports[local] = target
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative import: resolve against our package
                base_parts = mod.name.split(".")
                # level 1 == "from . import x" relative to the package,
                # which for a module "pkg.mod" is "pkg".
                base_parts = base_parts[:len(base_parts) - node.level]
                base = ".".join(base_parts)
            else:
                base = ""
            src = node.module or ""
            prefix = ".".join(p for p in (base, src) if p)
            for alias in node.names:
                local = alias.asname or alias.name
                mod.imports[local] = f"{prefix}.{alias.name}" if prefix \
                    else alias.name


def _record_globals(mod: ModuleInfo) -> None:
    for node in mod.tree.body:
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for target in targets:
            if isinstance(target, ast.Name):
                mod.global_names.add(target.id)
            elif isinstance(target, ast.Tuple):
                for elt in target.elts:
                    if isinstance(elt, ast.Name):
                        mod.global_names.add(elt.id)


class Program:
    """Every module of the package, parsed, with a function index."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}      # by dotted name
        self.modules_by_path: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}  # by qualname
        #: class qualname ("mod:Class") -> method name -> FunctionInfo
        self.classes: Dict[str, Dict[str, FunctionInfo]] = {}
        #: method name -> every FunctionInfo defining it (for the
        #: unique-name fallback on untyped receivers).
        self._methods_by_name: Dict[str, List[FunctionInfo]] = {}

    @classmethod
    def load(cls, paths: Sequence[str],
             root: Optional[str] = None) -> "Program":
        """Parse every ``.py`` under ``paths`` (files or directories).

        Unparseable files are skipped — the per-file pass already
        reports ``parse-error`` for them.
        """
        program = cls()
        base = os.path.abspath(root or os.getcwd())
        for filename in core.iter_python_files(paths, root=root):
            rel = os.path.relpath(os.path.abspath(filename), base)
            if rel.startswith(".."):
                rel = filename
            rel = rel.replace(os.sep, "/")
            if rel in program.modules_by_path:
                continue
            try:
                with open(filename, "r", encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=filename)
            except (OSError, UnicodeDecodeError, SyntaxError):
                continue
            program.add_module(rel, source, tree)
        program.index()
        return program

    def add_module(self, rel_path: str, source: str,
                   tree: ast.Module) -> ModuleInfo:
        mod = ModuleInfo(module_name_for(rel_path), rel_path, source, tree)
        self.modules[mod.name] = mod
        self.modules_by_path[mod.path] = mod
        return mod

    def index(self) -> None:
        """(Re)build import tables and the function/class index."""
        self.functions.clear()
        self.classes.clear()
        self._methods_by_name.clear()
        for mod in self.modules.values():
            mod.imports.clear()
            mod.global_names.clear()
            _record_imports(mod)
            _record_globals(mod)
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info = FunctionInfo(f"{mod.name}:{node.name}", mod,
                                        None, node)
                    self.functions[info.qualname] = info
                elif isinstance(node, ast.ClassDef):
                    cls_q = f"{mod.name}:{node.name}"
                    methods = self.classes.setdefault(cls_q, {})
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            info = FunctionInfo(
                                f"{cls_q}.{item.name}", mod, node.name,
                                item)
                            self.functions[info.qualname] = info
                            methods[item.name] = info
                            self._methods_by_name.setdefault(
                                item.name, []).append(info)

    # -- call resolution --------------------------------------------------

    def resolve_call(self, caller: FunctionInfo,
                     call: ast.Call) -> Optional[str]:
        """Best-effort qualname of the called function, else ``None``."""
        func = call.func
        mod = caller.module
        # self.m(...) -> method of the caller's own class.
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self" and caller.cls is not None):
            cls_q = f"{mod.name}:{caller.cls}"
            info = self.classes.get(cls_q, {}).get(func.attr)
            return info.qualname if info else None
        # f(...) -> module-level function of the caller's module, or an
        # imported name (``from mod import f``). A constructor call
        # resolves to the class's __init__ — acquiring a lock while
        # building an object (a client that dials on construction) is
        # a lock-order edge like any other.
        if isinstance(func, ast.Name):
            qual = f"{mod.name}:{func.id}"
            if qual in self.functions:
                return qual
            init = self.classes.get(qual, {}).get("__init__")
            if init is not None:
                return init.qualname
            imported = mod.imports.get(func.id)
            if imported and "." in imported:
                target_mod, _, leaf = imported.rpartition(".")
                qual = f"{target_mod}:{leaf}"
                if qual in self.functions:
                    return qual
                init = self.classes.get(qual, {}).get("__init__")
                if init is not None:
                    return init.qualname
            return None
        # alias.f(...) / pkg.mod.f(...) through the import table.
        if isinstance(func, ast.Attribute):
            dotted = core.dotted_name(func.value)
            if dotted and not dotted.startswith("?"):
                head, _, rest = dotted.partition(".")
                imported = mod.imports.get(head)
                if imported is not None:
                    target = f"{imported}.{rest}" if rest else imported
                    if target in self.modules:
                        qual = f"{target}:{func.attr}"
                        if qual in self.functions:
                            return qual
                        init = self.classes.get(qual, {}).get("__init__")
                        return init.qualname if init is not None else None
            # Untyped receiver (``self._journal.record(...)``,
            # ``handle.beat()``): resolve only when exactly ONE class
            # in the program defines a method of that name — ambiguity
            # must stay opaque or the analysis invents edges — and the
            # name is not one a builtin container/primitive also has
            # (an accidentally-unique ``append`` would capture every
            # list in the package).
            if func.attr in _GENERIC_METHODS:
                return None
            candidates = self._methods_by_name.get(func.attr, [])
            if len(candidates) == 1:
                return candidates[0].qualname
        return None

    def resolve_class(self, mod: ModuleInfo,
                      call: ast.Call) -> Optional[str]:
        """Class qualname when ``call`` constructs a program class."""
        func = call.func
        if isinstance(func, ast.Name):
            qual = f"{mod.name}:{func.id}"
            if qual in self.classes:
                return qual
            imported = mod.imports.get(func.id)
            if imported and "." in imported:
                owner_mod, _, leaf = imported.rpartition(".")
                qual = f"{owner_mod}:{leaf}"
                if qual in self.classes:
                    return qual
            return None
        if isinstance(func, ast.Attribute):
            dotted = core.dotted_name(func.value)
            if not dotted or dotted.startswith("?"):
                return None
            head, _, rest = dotted.partition(".")
            imported = mod.imports.get(head)
            if imported is None:
                return None
            target = f"{imported}.{rest}" if rest else imported
            if target in self.modules:
                qual = f"{target}:{func.attr}"
                return qual if qual in self.classes else None
        return None

    def iter_calls(self, info: FunctionInfo
                   ) -> Iterator[Tuple[ast.Call, Optional[str]]]:
        """Every Call in ``info``'s body with its resolved qualname."""
        for node in ast.walk(info.node):
            if isinstance(node, ast.Call):
                yield node, self.resolve_call(info, node)
