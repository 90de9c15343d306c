"""Lineage-key discipline: derivation belongs to ``plan/``.

The pipeline's determinism contract is an explicit epoch plan
(plan/ir.py): the route-key arithmetic
(``queue = epoch * num_trainers + rank`` and its ``//`` / ``%``
inverses) and the per-task lineage RNG streams live in exactly one
place, and every resume/recovery/chaos consumer queries the plan. The
historical failure mode was drift: five modules each re-deriving the
same keys with private arithmetic, where one edited formula silently
de-synchronizes replay from delivery. ``lineage-outside-plan`` pins the
invariant mechanically: fresh key-derivation arithmetic in library code
outside ``plan/`` (and the RNG primitive ``partition.py``) is
flagged — call ``plan.ir.queue_index`` / ``queue_epoch`` /
``queue_rank`` / ``resume_from_watermarks`` instead.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, register)


def _name_words(node: ast.AST) -> Set[str]:
    """Lower-cased identifier words reachable in a subtree (Name ids and
    Attribute attrs) — ``self._num_trainers`` contributes
    ``_num_trainers``."""
    words: Set[str] = set()
    for child in ast.walk(node):
        if isinstance(child, ast.Name):
            words.add(child.id.lower())
        elif isinstance(child, ast.Attribute):
            words.add(child.attr.lower())
    return words


def _mentions(words: Set[str], stem: str) -> bool:
    return any(stem in w for w in words)


@register
class LineageOutsidePlanRule(Rule):
    id = "lineage-outside-plan"
    category = "plan"
    description = ("fresh (seed, epoch, task) key-derivation arithmetic "
                   "outside plan/ — resume/recovery must query the epoch "
                   "plan (plan.ir.queue_index/queue_epoch/queue_rank/"
                   "resume_from_watermarks), not re-derive keys that can "
                   "drift from the engine's")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.lineage_plan_globs):
            return
        if ctx.path_matches(ctx.config.lineage_plan_exempt_globs):
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp):
                violation = self._check_binop(node, ctx)
                if violation is not None:
                    yield violation
            elif isinstance(node, ast.Call):
                violation = self._check_seedseq(node, ctx)
                if violation is not None:
                    yield violation

    def _check_binop(self, node: ast.BinOp,
                     ctx: FileContext):
        # Forward derivation: `epoch * num_trainers + rank` — an Add
        # whose subtree multiplies an epoch-ish name by a trainer-count
        # name and offsets by a rank-ish name.
        if isinstance(node.op, ast.Add):
            for mult, other in ((node.left, node.right),
                                (node.right, node.left)):
                if not (isinstance(mult, ast.BinOp)
                        and isinstance(mult.op, ast.Mult)):
                    continue
                mult_words = _name_words(mult)
                other_words = _name_words(other)
                if (_mentions(mult_words, "epoch")
                        and _mentions(mult_words, "trainer")
                        and _mentions(other_words, "rank")):
                    return ctx.violation(
                        self, node,
                        "queue-route key derived inline "
                        "(epoch * num_trainers + rank); use "
                        "plan.ir.queue_index(epoch, rank, num_trainers)")
        # Inverse derivation: `queue_idx // num_trainers` (epoch) and
        # `queue_idx % num_trainers` (rank). Keyed on the trainer-COUNT
        # name specifically: dividing by e.g. `trainers_per_host` is a
        # topology mapping, not a queue-route key.
        if isinstance(node.op, (ast.FloorDiv, ast.Mod)):
            right_words = _name_words(node.right)
            if _mentions(right_words, "num_trainers"):
                helper = ("queue_epoch" if isinstance(node.op, ast.FloorDiv)
                          else "queue_rank")
                return ctx.violation(
                    self, node,
                    "queue-route key inverted inline "
                    f"(queue {'//' if helper == 'queue_epoch' else '%'} "
                    "num_trainers); use "
                    f"plan.ir.{helper}(queue_idx, num_trainers)")
        return None

    def _check_seedseq(self, node: ast.Call, ctx: FileContext):
        # A fresh per-task lineage RNG stream: SeedSequence keyed by BOTH
        # a seed and an epoch. The only blessed homes are partition.py
        # (the primitive) and plan/ — anything else is a private lineage
        # stream recovery cannot reproduce by querying the plan.
        func = node.func
        name = (func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else "")
        if name != "SeedSequence":
            return None
        words = _name_words(ast.Module(body=[ast.Expr(value=arg)
                                             for arg in node.args],
                                       type_ignores=[]))
        for kw in node.keywords:
            words |= _name_words(kw.value)
        if _mentions(words, "seed") and _mentions(words, "epoch"):
            return ctx.violation(
                self, node,
                "fresh (seed, epoch, ...) SeedSequence stream outside "
                "plan/ops — derive task RNG through the plan's lineage "
                "keys (ops.partition map_rng/reduce_rng)")
        return None


@register
class StaticEpochAssumptionRule(Rule):
    id = "static-epoch-assumption"
    category = "plan"
    description = ("library code counting epochs with range(num_epochs) "
                   "or indexing per-epoch state by a literal epoch — the "
                   "epoch sequence belongs to plan/ "
                   "(plan.ir.epoch_range / static_epoch_specs); a static "
                   "count silently breaks unbounded streaming input")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.static_epoch_globs):
            return
        if ctx.path_matches(ctx.config.static_epoch_exempt_globs):
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                violation = self._check_range(node, ctx)
                if violation is not None:
                    yield violation
            elif isinstance(node, ast.Subscript):
                violation = self._check_subscript(node, ctx)
                if violation is not None:
                    yield violation

    def _check_range(self, node: ast.Call, ctx: FileContext):
        # `range(num_epochs)` / `range(start, self.num_epochs)`: a hard
        # assumption that the trial's epoch count is finite and known up
        # front. Streaming windows arrive as epochs with no count;
        # plan.ir.epoch_range handles both shapes (None = unbounded) and
        # plan.ir.static_epoch_specs IS the bounded schedule.
        func = node.func
        if not (isinstance(func, ast.Name) and func.id == "range"):
            return None
        for arg in node.args:
            if _mentions(_name_words(arg), "num_epochs"):
                return ctx.violation(
                    self, node,
                    "epochs counted with range(..num_epochs..); iterate "
                    "plan.ir.epoch_range(start, num_epochs) (None = "
                    "unbounded stream) or consume "
                    "plan.ir.static_epoch_specs")
        return None

    def _check_subscript(self, node: ast.Subscript, ctx: FileContext):
        # `epoch_refs[2]` / `per_epoch[0]`: per-epoch state indexed by a
        # literal epoch — code that can only be correct for one frozen
        # epoch numbering. Dynamic indices (loop variables, plan-derived
        # epochs) are fine.
        if not isinstance(node.slice, ast.Constant):
            return None
        if not isinstance(node.slice.value, int):
            return None
        words = _name_words(node.value)
        per_epoch = any(
            ("epoch" in w and ("ref" in w or "plan" in w or "queue" in w))
            or w in ("per_epoch", "epochs")
            for w in words)
        if per_epoch:
            return ctx.violation(
                self, node,
                "per-epoch state indexed by a literal epoch number — "
                "derive the index from the plan (plan.ir.queue_index / "
                "the EpochSpec being served), not a frozen count")
        return None


@register
class ShardAffinityAssumptionRule(Rule):
    id = "shard-affinity-assumption"
    category = "plan"
    description = ("library code deriving queue->shard placement with "
                   "literal num_shards arithmetic or resolving/caching a "
                   "shard's (host, port) by index — placement moves "
                   "under live rebalancing (rebalance/), so routing must "
                   "query ShardMap.shard_for_queue / address_for_queue "
                   "at call time")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.shard_affinity_globs):
            return
        if ctx.path_matches(ctx.config.shard_affinity_exempt_globs):
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp):
                violation = self._check_binop(node, ctx)
                if violation is not None:
                    yield violation
            elif isinstance(node, ast.Subscript):
                violation = self._check_subscript(node, ctx)
                if violation is not None:
                    yield violation

    def _check_binop(self, node: ast.BinOp, ctx: FileContext):
        # `rank % num_shards` / `q // num_shards` / `x * num_shards`:
        # the STATIC placement formula. Correct on a fresh plan, stale
        # the moment a committed migration installs an override — the
        # consumer keeps dialing the pre-move shard and eats a failure
        # frame (or worse, a zombie's stream).
        if not isinstance(node.op, (ast.Mod, ast.FloorDiv, ast.Mult)):
            return None
        sides = ([node.left, node.right]
                 if isinstance(node.op, ast.Mult) else [node.right])
        for side in sides:
            if _mentions(_name_words(side), "num_shards"):
                return ctx.violation(
                    self, node,
                    "queue->shard placement derived with literal "
                    "num_shards arithmetic; query plan.ir.ShardMap."
                    "shard_for_queue/shard_for_rank — overrides from "
                    "live rebalancing make the static formula stale")
        return None

    def _check_subscript(self, node: ast.Subscript, ctx: FileContext):
        # `shard_map.addresses[shard]`: a shard address resolved by
        # index — the caller is about to cache a (host, port) that a
        # committed migration invalidates. `address_for_queue` (or the
        # MOVED-following ShardedRemoteQueue) re-resolves per call.
        words = _name_words(node.value)
        if not _mentions(words, "addresses"):
            return None
        if not _mentions(_name_words(node.slice), "shard"):
            return None
        return ctx.violation(
            self, node,
            "shard (host, port) resolved by address-table index; use "
            "plan.ir.ShardMap.address_for_queue (or route through "
            "ShardedRemoteQueue, which follows MOVED redirects) — "
            "cached shard addresses go stale under live rebalancing")


@register
class FixedWorldAssumptionRule(Rule):
    id = "fixed-world-assumption"
    category = "plan"
    description = ("library code fanning out over a frozen world size "
                   "(range(..world..) / len(addresses)) or scaling by "
                   "it — world composition is a membership view "
                   "(membership/), and placement over live ranks "
                   "belongs to plan.ir.rebalance_spans / "
                   "reduce_placement; frozen-world arithmetic silently "
                   "breaks elastic resize")

    #: Identifier stems that name a world/host count.
    _WORLD_STEMS = ("world", "num_hosts", "num_ranks")
    #: Identifier stems whose len() is a world size in disguise.
    _ROSTER_STEMS = ("addresses", "hosts", "peers")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.fixed_world_globs):
            return
        if ctx.path_matches(ctx.config.fixed_world_exempt_globs):
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                violation = self._check_range(node, ctx)
                if violation is not None:
                    yield violation
            elif isinstance(node, ast.BinOp):
                violation = self._check_binop(node, ctx)
                if violation is not None:
                    yield violation

    def _world_sized(self, node: ast.AST) -> bool:
        # A world-count name (`self.world`, `num_hosts`) or the length
        # of a host roster (`len(self.addresses)`, `len(peers)`).
        for stem in self._WORLD_STEMS:
            if _mentions(_name_words(node), stem):
                return True
        for child in ast.walk(node):
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Name)
                    and child.func.id == "len" and child.args):
                words = _name_words(child.args[0])
                if any(_mentions(words, s) for s in self._ROSTER_STEMS):
                    return True
        return False

    def _check_range(self, node: ast.Call, ctx: FileContext):
        # `range(world)` / `range(len(self.addresses))`: a fan-out that
        # hard-assumes every configured rank is alive. The live set is
        # a membership view; placement over it is
        # plan.ir.rebalance_spans / reduce_placement.
        func = node.func
        if not (isinstance(func, ast.Name) and func.id == "range"):
            return None
        if any(self._world_sized(arg) for arg in node.args):
            return ctx.violation(
                self, node,
                "fan-out over a frozen world size "
                "(range(..world../len(addresses)..)); iterate a "
                "membership view's live ranks and place with "
                "plan.ir.rebalance_spans / reduce_placement")
        return None

    def _check_binop(self, node: ast.BinOp, ctx: FileContext):
        # `x * world` / `q % world` / `n // world`: per-rank shares
        # computed from the configured size — wrong the moment the
        # world shrinks or grows. (Add/Sub are untouched: offsets over
        # a roster are topology math, not a share split.)
        if not isinstance(node.op, (ast.Mult, ast.Mod, ast.FloorDiv)):
            return None
        sides = [node.left, node.right] if isinstance(node.op, ast.Mult) \
            else [node.right]
        for side in sides:
            for stem in self._WORLD_STEMS:
                if _mentions(_name_words(side), stem):
                    return ctx.violation(
                        self, node,
                        "per-rank share scaled by a frozen world size; "
                        "derive shares from the live membership view "
                        "(plan.ir.rebalance_spans over view.ranks)")
        return None
