"""Lock-discipline rules.

Many modules of this pipeline guard shared state with
``threading.Lock`` (shuffle caches, the spill manager, queue internals,
the device binding's prefetch wrapper). The two hazard classes a
reviewer keeps re-catching by hand:

- a class that protects an attribute with ``with self._lock:`` in one
  method but mutates the same attribute bare in another (a data race
  that only bites under producer/consumer overlap), and
- blocking while holding a lock (``Future.result()`` / ``queue.get``
  with no timeout / ``Executor.wait``), which turns one slow task into
  a pipeline-wide stall or deadlock.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, get_keyword, is_constant,
    keyword_names, register)

#: Methods where self-attribute writes are exempt: the object is not
#: yet (or no longer) shared with other threads.
_SETUP_METHODS = ("__init__", "__new__", "__del__", "__init_subclass__")


def _lockish(name: str, ctx: FileContext) -> bool:
    return re.search(ctx.config.lock_name_regex, name) is not None


def _withitem_lock_name(item: ast.withitem,
                        ctx: FileContext) -> Optional[str]:
    """The lock-ish name a ``with`` item acquires, if any.

    Recognizes ``with self._lock:``, ``with lock:``, and container
    lookups like ``with self._peer_locks[dest]:``.
    """
    expr = item.context_expr
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute) and _lockish(expr.attr, ctx):
        return expr.attr
    if isinstance(expr, ast.Name) and _lockish(expr.id, ctx):
        return expr.id
    return None


def _self_attr_writes(stmt: ast.stmt) -> List[Tuple[str, ast.AST]]:
    """Attribute names of ``self`` written by one statement: direct
    assignment, augmented assignment, subscript stores
    (``self._paths[k] = v``) and deletes."""
    writes: List[Tuple[str, ast.AST]] = []

    def target_attr(node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = stmt.targets
    else:
        return writes
    for target in targets:
        elements = (target.elts if isinstance(target, (ast.Tuple, ast.List))
                    else [target])
        for element in elements:
            attr = target_attr(element)
            if attr is not None:
                writes.append((attr, element))
    return writes


@register
class LockMutationRule(Rule):
    id = "lock-mutation"
    category = "lock-discipline"
    description = ("attribute guarded by `with self.<lock>:` elsewhere in "
                   "the class is mutated without holding the lock")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(node, ctx)

    def _check_class(self, cls: ast.ClassDef,
                     ctx: FileContext) -> Iterator[Violation]:
        guarded: Set[str] = set()
        unguarded: List[Tuple[str, ast.AST]] = []

        def scan(stmts, in_lock: bool, exempt: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    # A nested def's body runs whenever it is CALLED,
                    # not where it is defined — never under this lock.
                    body = getattr(stmt, "body", [])
                    scan(body if isinstance(body, list) else [], False,
                         exempt)
                    continue
                for attr, target in _self_attr_writes(stmt):
                    if in_lock:
                        guarded.add(attr)
                    elif not exempt:
                        unguarded.append((attr, target))
                if isinstance(stmt, ast.With):
                    locked = in_lock or any(
                        _withitem_lock_name(i, ctx) is not None
                        for i in stmt.items)
                    scan(stmt.body, locked, exempt)
                else:
                    for field in ("body", "orelse", "finalbody", "handlers"):
                        children = getattr(stmt, field, None)
                        if not children:
                            continue
                        for child in children:
                            if isinstance(child, ast.ExceptHandler):
                                scan(child.body, in_lock, exempt)
                            elif isinstance(child, ast.stmt):
                                scan([child], in_lock, exempt)

        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            scan(method.body, False, method.name in _SETUP_METHODS)
        for attr, target in unguarded:
            if attr in guarded:
                yield ctx.violation(
                    self, target,
                    f"`self.{attr}` is written under a lock elsewhere in "
                    f"`{cls.name}` but mutated here without holding it; "
                    "take the lock (or move all access out from under it "
                    "if the attribute is single-thread-owned)")


@register
class LockBlockingCallRule(Rule):
    id = "lock-blocking-call"
    category = "lock-discipline"
    description = ("potentially-unbounded blocking call (Future.result, "
                   "timeout-less queue.get/join/recv, Executor.wait, "
                   "sleep) while holding a lock")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        out: List[Violation] = []

        def visit(node: ast.AST, held: Optional[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                held = None  # a nested def runs outside this lock scope
            if isinstance(node, ast.With):
                for item in node.items:
                    name = _withitem_lock_name(item, ctx)
                    if name is not None:
                        held = name
            if held is not None and isinstance(node, ast.Call):
                message = self._blocking_reason(node, ctx)
                if message is not None:
                    out.append(ctx.violation(
                        self, node,
                        f"{message} while holding `{held}` can stall every "
                        "thread contending for it; release the lock first "
                        "or pass a timeout"))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(tree, None)
        yield from out

    def _blocking_reason(self, call: ast.Call,
                         ctx: FileContext) -> Optional[str]:
        config = ctx.config
        kwargs = keyword_names(call)
        name = dotted_name(call.func)
        if isinstance(call.func, ast.Attribute):
            method = call.func.attr
            base = dotted_name(call.func.value)
            if _lockish(base.rsplit(".", 1)[-1], ctx):
                return None  # the lock object's own API (acquire etc.)
            if method in config.blocking_get_methods:
                block = get_keyword(call, "block")
                queueish = re.search(config.queue_name_regex,
                                     base.rsplit(".", 1)[-1])
                if queueish is None and not is_constant(block, True):
                    return None  # a dict/env .get, not a queue get
                if "timeout" in kwargs:
                    return None
                if block is not None and is_constant(block, False):
                    return None
                # Positional block=False: get(idx, False)
                if any(is_constant(a, False) for a in call.args):
                    return None
                return f"timeout-less blocking `{name}()`"
            if method in config.blocking_methods:
                if "timeout" in kwargs or call.args:
                    # result(timeout)/join(timeout)/recv(n) style args
                    # bound or qualify the wait.
                    return None
                return f"`{name}()` with no timeout"
        tail = name.rsplit(".", 1)[-1]
        if tail in config.blocking_functions and "timeout" in kwargs:
            return None
        if tail in config.blocking_functions:
            return f"blocking `{name}(...)`"
        return None
