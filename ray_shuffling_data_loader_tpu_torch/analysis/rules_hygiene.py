"""Worker-thread hygiene rules.

Every stage of this pipeline runs on background threads feeding bounded
queues. An `except: pass` (or ``except Exception: pass``) in that
topology does not just lose a traceback — it silently drops the
sentinel/batch the consumer is blocked on, stranding it forever (the
exact failure mode ShuffleFailure/poison-pill machinery exists to
prevent). Narrow handlers (``except OSError: pass`` around best-effort
cleanup) are fine and are not flagged.

``wallclock-interval`` guards the clock discipline the telemetry spine
depends on: ``time.time()`` is WALL clock — NTP steps/slew move it
backwards or by seconds at a time — so any duration, deadline, or
interval computed from it is wrong exactly when the host is unhealthy
(the moment observability matters). Durations use ``time.monotonic()``
/ ``perf_counter``; ``time.time()`` stays only where a real calendar
timestamp is serialized.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, register)

_BROAD = {"Exception", "BaseException"}


def _is_broad(type_node) -> bool:
    if type_node is None:
        return True  # bare except
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(t) for t in type_node.elts)
    return False


def _is_noop(body) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / `...`
        return False
    return True


@register
class SwallowedExceptionRule(Rule):
    id = "swallowed-exception"
    category = "hygiene"
    description = ("broad `except:`/`except Exception:` with a pass-only "
                   "body swallows worker failures and strands queue "
                   "consumers")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node.type) and _is_noop(node.body):
                yield ctx.violation(
                    self, node,
                    "a swallowed broad exception in a worker thread drops "
                    "the batch/sentinel its consumer is blocked on; catch "
                    "the specific exception, or log and forward the "
                    "failure (ShuffleFailure / on_failure hook)")


def _wallclock_names(tree: ast.Module) -> Set[str]:
    """Names resolving to ``time.time`` in this module: the dotted form
    for ``import time [as t]``, bare names for ``from time import time
    [as now]``."""
    names: Set[str] = {"time.time"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    names.add(f"{alias.asname or alias.name}.time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "time":
                    names.add(alias.asname or alias.name)
    return names


def _scopes(tree: ast.Module):
    """Module body + each function body, walked without descending into
    nested function scopes (each gets its own pass)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _scope_nodes(scope) -> List[ast.AST]:
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested scope: analyzed separately
        stack.extend(ast.iter_child_nodes(node))
    return out


@register
class WallclockIntervalRule(Rule):
    id = "wallclock-interval"
    category = "hygiene"
    description = ("`time.time()` used in a duration/interval/deadline "
                   "computation — wall clock steps under NTP; durations "
                   "must use time.monotonic()/perf_counter()")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        wallclock = _wallclock_names(tree)

        def is_wallclock_call(node: ast.AST) -> bool:
            return (isinstance(node, ast.Call)
                    and dotted_name(node.func) in wallclock)

        for scope in _scopes(tree):
            nodes = _scope_nodes(scope)
            # Variables assigned directly from a wall-clock read in this
            # scope: `start = time.time()`.
            assigned: Set[str] = set()
            for node in nodes:
                if isinstance(node, ast.Assign) \
                        and is_wallclock_call(node.value):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            assigned.add(target.id)
            for node in nodes:
                if not isinstance(node, ast.BinOp) \
                        or not isinstance(node.op, (ast.Sub, ast.Add)):
                    continue
                operands = (node.left, node.right)
                direct = any(is_wallclock_call(op) for op in operands)
                via_name = isinstance(node.op, ast.Sub) and any(
                    isinstance(op, ast.Name) and op.id in assigned
                    for op in operands)
                if direct or via_name:
                    yield ctx.violation(
                        self, node,
                        "interval arithmetic on time.time(): wall clock "
                        "jumps under NTP steps/slew, so this duration or "
                        "deadline is wrong exactly when the host is "
                        "unhealthy; use time.monotonic() (or "
                        "perf_counter) and keep time.time() only for "
                        "serialized timestamps")
