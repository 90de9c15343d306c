"""Telemetry-discipline rules.

The causal tracing layer added a manual span API
(``telemetry.span_begin`` / ``telemetry.span_end``) for measurements a
``with`` block cannot express — a wait spanning loop iterations, a
handoff between threads. Manual spans revive the classic paired-call
bug class the ``with`` form made impossible: an exit path that skips
the close leaves the thread's active-kind registry pointing at a dead
span (the sampling profiler then bills every later sample to it) and
loses the duration event entirely — the trace silently under-reports
exactly the code path that failed, which is when the trace matters.

``span-unbalanced`` pins the only safe shape: every ``span_begin``
must be paired with a ``span_end`` that runs on ALL exit paths, i.e.
inside a ``finally`` block of the same function (``span_end(None)`` is
a no-op by contract, so the ``finally`` form needs no enabled-guard).
A ``span_begin`` whose token is immediately returned is exempt — that
is a deliberate helper handing the obligation to its caller.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, register)

_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef)


def _scope_nodes(func: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's OWN body (nested defs/classes own their spans)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, _SCOPE_BARRIERS):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_call_tail(node: ast.AST, tail: str) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func).rsplit(".", 1)[-1] == tail)


@register
class SpanUnbalancedRule(Rule):
    id = "span-unbalanced"
    category = "telemetry"
    description = ("telemetry `span_begin` without a `span_end` on all "
                   "paths: the close must sit in a `finally` (or the "
                   "token be returned to the caller), else a raising "
                   "exit loses the span and poisons the profiler's "
                   "active-kind registry")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        for func in ast.walk(tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            begins = [n for n in _scope_nodes(func)
                      if _is_call_tail(n, "span_begin")]
            if not begins:
                continue
            # Tokens handed straight to the caller: the obligation
            # moves with them.
            returned = {
                id(stmt.value) for stmt in _scope_nodes(func)
                if isinstance(stmt, ast.Return) and stmt.value is not None
            }
            has_end = any(_is_call_tail(n, "span_end")
                          for n in _scope_nodes(func))
            end_in_finally = False
            for node in _scope_nodes(func):
                if not isinstance(node, ast.Try) or not node.finalbody:
                    continue
                for stmt in node.finalbody:
                    if any(_is_call_tail(n, "span_end")
                           for n in ast.walk(stmt)):
                        end_in_finally = True
                        break
                if end_in_finally:
                    break
            for begin in begins:
                if id(begin) in returned:
                    continue
                if not has_end:
                    yield ctx.violation(
                        self, begin,
                        "span_begin has no matching span_end in "
                        f"`{func.name}` — the span never closes")
                elif not end_in_finally:
                    yield ctx.violation(
                        self, begin,
                        "span_end is not in a `finally` block in "
                        f"`{func.name}` — a raising exit path loses "
                        "the span (span_end(None) is a no-op; the "
                        "finally form needs no guard)")
