"""Bench-record gating discipline.

Every numeric key ``bench.py`` emits into its JSON record is a claim
about performance — and a claim nobody thresholds is a regression
channel nobody watches: a stream duration that doubles between two
committed records fails nothing. ``ungated-bench-metric`` closes the
loop from the producer side: a numeric record emission must either be
covered by a ``tools/rsdl_bench_diff.py`` ``DEFAULT_RULES`` entry (exact
key, or a ``_``-separated refinement of one — ``train_fill_s`` under
``fill_s``, ``train_rows_per_sec_median`` under ``train_rows_per_sec``)
or be listed in ``bench.py``'s own ``BENCH_INFORMATIONAL_KEYS``
allowlist — an explicit, reviewable declaration that the number is
forensic context, not a gated contract. Adding a metric therefore forces
the one-line review that decides which it is.

The rule inspects the emission idiom, not runtime values: subscript
assignments ``record["k"] = <numeric expr>`` and dict-literal keys in
``record.update({...})`` whose value expression is numeric-shaped
(literals, ``round``/``int``/``float``/``len``/``min``/``max``/``sum``
calls, arithmetic over them, conditional numerics). Non-numeric values
(strings, dicts, plain name references) are out of scope by design.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, Optional

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, register)

#: Builtins whose call result is numeric for gating purposes.
_NUMERIC_CALLS = frozenset({"round", "int", "float", "len", "min", "max",
                            "sum", "abs"})

_gate_keys_cache: Optional[frozenset] = None


def _gate_keys() -> frozenset:
    """DEFAULT_RULES keys from tools/rsdl_bench_diff.py, loaded by file
    path (tools/ is not a package). Empty on hosts without the tools
    tree — the rule then stays silent rather than inventing findings
    against an unknowable gate."""
    global _gate_keys_cache
    if _gate_keys_cache is not None:
        return _gate_keys_cache
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "tools", "rsdl_bench_diff.py")
    try:
        spec = importlib.util.spec_from_file_location(
            "_rsdl_bench_diff_rules", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _gate_keys_cache = frozenset(
            rule["key"] for rule in module.DEFAULT_RULES)
    except (OSError, AttributeError, KeyError, TypeError, SyntaxError):
        _gate_keys_cache = frozenset()
    return _gate_keys_cache


def _allowlisted(tree: ast.Module) -> frozenset:
    """String elements of the linted module's own
    ``BENCH_INFORMATIONAL_KEYS = frozenset({...})`` declaration."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name)
                   and t.id == "BENCH_INFORMATIONAL_KEYS"
                   for t in node.targets):
            continue
        value = node.value
        if isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id == "frozenset" and value.args and \
                isinstance(value.args[0], ast.Set):
            return frozenset(
                e.value for e in value.args[0].elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str))
    return frozenset()


def _numeric_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return (isinstance(node.value, (int, float))
                and not isinstance(node.value, bool))
    if isinstance(node, ast.BinOp):
        return _numeric_expr(node.left) or _numeric_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _numeric_expr(node.operand)
    if isinstance(node, ast.IfExp):
        return _numeric_expr(node.body) or _numeric_expr(node.orelse)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in _NUMERIC_CALLS
    return False


def _gated(key: str, gate: frozenset) -> bool:
    if key in gate:
        return True
    # A refinement of a gated family counts: spread stats and per-phase
    # variants of a thresholded quantity (train_rows_per_sec_median,
    # train_fill_s) are watched through their family's rule.
    for rule_key in gate:
        if key.startswith(rule_key + "_") or key.endswith("_" + rule_key):
            return True
    return False


@register
class UngatedBenchMetricRule(Rule):
    id = "ungated-bench-metric"
    category = "bench"
    description = ("numeric bench-record key has no tools/"
                   "rsdl_bench_diff.py rule and no "
                   "BENCH_INFORMATIONAL_KEYS entry: an unthresholded "
                   "number is a regression channel nobody watches — "
                   "gate it or declare it informational")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.bench_record_globs):
            return
        gate = _gate_keys()
        if not gate:
            return
        allow = _allowlisted(tree)

        def judge(key_node: ast.AST, value: ast.AST, anchor: ast.AST):
            if not (isinstance(key_node, ast.Constant)
                    and isinstance(key_node.value, str)):
                return None
            key = key_node.value
            if not _numeric_expr(value):
                return None
            if key in allow or _gated(key, gate):
                return None
            return ctx.violation(
                self, anchor,
                f"record key {key!r} is numeric but has no "
                "rsdl_bench_diff rule and no BENCH_INFORMATIONAL_KEYS "
                "entry")

        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id == "record":
                        v = judge(target.slice, node.value, node)
                        if v is not None:
                            yield v
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "update" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "record":
                for arg in node.args:
                    if not isinstance(arg, ast.Dict):
                        continue
                    for key_node, value in zip(arg.keys, arg.values):
                        if key_node is None:
                            continue
                        v = judge(key_node, value, key_node)
                        if v is not None:
                            yield v
