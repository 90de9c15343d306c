"""Executor / retry-safety rules.

The executor's retry policy (``task_retries``) is only sound for
idempotent tasks. Two contracts from executor.py's prose become
mechanical here:

- a function that consumes one-shot transport messages (``.recv`` —
  each tag is delivered exactly once) must be submitted with
  ``submit_once``; a retrying ``submit`` would re-run it against
  already-consumed tags, block to the recv timeout, and mask the real
  error (see parallel/distributed.py's reduce tasks);
- every random draw in a shuffle task must be keyed by
  ``(seed, epoch, task)``. Global-state RNG (``np.random.*`` module
  functions, stdlib ``random``) makes a retried task produce different
  output than the original — silent data corruption under retries, and
  it breaks replayable epochs (checkpoint/resume).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, register)

#: numpy.random module attributes that are seeded CONSTRUCTORS, not
#: global-state draws.
_SEEDED_CONSTRUCTORS = {
    "Generator", "SeedSequence", "Philox", "PCG64", "PCG64DXSM", "MT19937",
    "SFC64", "BitGenerator", "RandomState", "default_rng",
}


def _function_name(func: ast.expr) -> Optional[str]:
    """Resolve a callable argument to a def name this module may hold:
    a bare ``Name`` or a ``self.<method>`` attribute."""
    if isinstance(func, ast.Name):
        return func.id
    if (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"):
        return func.attr
    return None


@register
class OneShotSubmitRule(Rule):
    id = "oneshot-submit"
    category = "executor-safety"
    description = ("function that consumes one-shot transport messages "
                   "(.recv) submitted via retrying `submit` instead of "
                   "`submit_once`")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        consumers: Set[str] = set(ctx.config.oneshot_functions)
        recv_methods = set(ctx.config.oneshot_recv_methods)
        # Pass 1: functions that directly call a one-shot receive.
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in recv_methods):
                    consumers.add(node.name)
                    break
        if not consumers:
            return
        # Pass 2: retrying submits of those functions.
        for node in ast.walk(tree):
            # (`submit_once` and argument-less `submit()` fall through.)
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "submit" and node.args):
                continue
            target = _function_name(node.args[0])
            if target in consumers:
                yield ctx.violation(
                    self, node,
                    f"`{target}` consumes one-shot transport messages "
                    "(.recv); submit it with `submit_once` — a retrying "
                    "`submit` would re-run it against already-consumed "
                    "tags and block until the recv timeout")


@register
class UnseededRandomRule(Rule):
    id = "unseeded-random"
    category = "executor-safety"
    description = ("global-state RNG draw (np.random.* / random.*) — "
                   "breaks the (seed, epoch, task) determinism contract "
                   "that makes task retries and checkpoint replay safe")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        np_draws = set(ctx.config.unseeded_random_names)
        stdlib_draws = set(ctx.config.stdlib_random_names)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            parts = name.split(".")
            if len(parts) == 3 and parts[0] in ("np", "numpy") \
                    and parts[1] == "random":
                tail = parts[2]
                if tail == "default_rng" and not node.args \
                        and not node.keywords:
                    yield ctx.violation(
                        self, node,
                        "`default_rng()` with no seed draws OS entropy; "
                        "key it by (seed, epoch, task) — e.g. "
                        "`np.random.default_rng(np.random.SeedSequence("
                        "[seed, task_index]))`")
                elif tail in np_draws and tail not in _SEEDED_CONSTRUCTORS:
                    yield ctx.violation(
                        self, node,
                        f"`np.random.{tail}` uses the global RNG; use a "
                        "Generator keyed by (seed, epoch, task) "
                        "(partition.py map_rng/reduce_rng) so retries "
                        "and epoch replay are bit-identical")
            elif len(parts) == 2 and parts[0] == "random" \
                    and parts[1] in stdlib_draws:
                yield ctx.violation(
                    self, node,
                    f"stdlib `random.{parts[1]}` uses global RNG state; "
                    "use a seeded `random.Random(...)` or a numpy "
                    "Generator keyed by (seed, epoch, task)")
