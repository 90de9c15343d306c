"""Metric-vocabulary discipline.

Everything downstream of the registry — the merged multi-process
exposition, rsdl_top, the history ring, the health detectors, the run
report — addresses metrics BY NAME, across process and repo boundaries.
A metric created under an ad-hoc name still renders and still exports;
nothing fails until an operator's dashboard quietly shows no data, which
is the worst possible failure mode for an ops plane. ``runtime/
metric_names.py`` is the one catalog those consumers are written
against; ``unregistered-metric`` closes the loop from the producer side:
every literal ``rsdl_*`` name passed to ``metrics.counter`` / ``gauge``
/ ``histogram`` / ``get`` in library code must be a catalog entry, so
adding a metric forces the one-line catalog review that keeps dashboards
and detectors truthful.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, register)

_REGISTRY_METHODS = frozenset({"counter", "gauge", "histogram", "sketch",
                               "get"})
#: Registry methods that CREATE series (label kwargs are label keys);
#: ``get`` is a read and takes labels as a dict argument instead.
_CREATE_METHODS = frozenset({"counter", "gauge", "histogram", "sketch"})
#: Non-label keyword arguments of the create methods.
_CONFIG_KWARGS = frozenset({"buckets"})
#: Receivers that look like the metrics registry module/object
#: (``metrics``, ``rt_metrics``, ``rsdl_metrics``, ``self._metrics``).
_RECEIVER_RE = re.compile(r"(^|[._])metrics$")
#: Histogram/sketch families expose derived series names in the text
#: format; a ``get`` against one resolves through its base name.
_SERIES_SUFFIXES = ("_bucket", "_centroid", "_sum", "_count")


def _catalog_names() -> frozenset:
    from ray_shuffling_data_loader_tpu_torch.runtime.metric_names import NAMES
    return NAMES


def _catalog_labels(name: str):
    from ray_shuffling_data_loader_tpu_torch.runtime.metric_names import (
        METRIC_NAMES)
    entry = METRIC_NAMES.get(name)
    return None if entry is None else frozenset(entry[1])


@register
class UnregisteredMetricRule(Rule):
    id = "unregistered-metric"
    category = "metrics"
    description = ("literal `rsdl_*` metric name not present in "
                   "runtime/metric_names.py: dashboards, rsdl_top, the "
                   "health detectors and the run report address metrics "
                   "by catalog name — an uncataloged metric silently "
                   "drops out of every one of them")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.metric_catalog_globs):
            return
        names = _catalog_names()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in _REGISTRY_METHODS):
                continue
            if not _RECEIVER_RE.search(dotted_name(func.value)):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue
            name = first.value
            if not name.startswith("rsdl_"):
                continue  # test_*/probe metrics are out of scope
            base = name
            for suffix in _SERIES_SUFFIXES:
                if name.endswith(suffix) and name[:-len(suffix)] in names:
                    base = name[:-len(suffix)]
                    break
            if base not in names:
                yield ctx.violation(
                    self, first,
                    f"metric name {name!r} is not in "
                    "runtime/metric_names.py — add it to the catalog "
                    "(one reviewed line) so dashboards/detectors/"
                    "reports can address it")


@register
class MetricLabelCardinalityRule(Rule):
    id = "metric-label-cardinality"
    category = "metrics"
    description = ("`rsdl_*` metric labeled with a key outside the "
                   "catalog's allowed label set (runtime/"
                   "metric_names.py) — per-task/per-seq/per-pid labels "
                   "mint one child series per value, exploding the "
                   "registry, every federation shard and every "
                   "history-ring snapshot without bound; labels must be "
                   "fixed-cardinality identities (stage, hop, shard, "
                   "trainer rank) declared in the catalog")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.metric_catalog_globs):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in _CREATE_METHODS):
                continue
            if not _RECEIVER_RE.search(dotted_name(func.value)):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue
            name = first.value
            if not name.startswith("rsdl_"):
                continue
            allowed = _catalog_labels(name)
            if allowed is None:
                continue  # unregistered-metric already flags the name
            for keyword in node.keywords:
                if (keyword.arg is None
                        or keyword.arg in _CONFIG_KWARGS
                        or keyword.arg in allowed):
                    continue
                yield ctx.violation(
                    self, keyword.value,
                    f"label {keyword.arg!r} on {name!r} is outside its "
                    f"catalog label set {sorted(allowed)} — an "
                    "undeclared label is how unbounded values (task "
                    "ids, seqs, pids) leak into the series space; "
                    "declare it in runtime/metric_names.py only if its "
                    "value set is provably bounded")
