"""Arrow schema-discipline rules.

The >2GiB regime promotes variable-width columns to 64-bit-offset
``large_*`` types per reducer output (shuffle.py), so one trainer's
epoch stream can legally mix ``large_*`` and 32-bit-offset schemas.
Any ``pa.concat_tables`` on that stream without schema promotion
raises ``ArrowInvalid`` exactly in the huge-corpus regime the
promotion targets (the ADVICE round-5 crash in slice_batches' carry
buffer). Likewise ``to_numpy(zero_copy_only=True)`` raises on chunked
or nullable columns — both hazards are one kwarg away from safe.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, get_keyword, is_constant,
    keyword_names, register)


@register
class ConcatPromoteRule(Rule):
    id = "arrow-concat-promote"
    category = "arrow-schema"
    description = ("`pa.concat_tables` without `promote_options=` crashes "
                   "on mixed large_*/32-bit-offset schemas (the >2GiB "
                   "promotion regime)")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func).rsplit(".", 1)[-1] != "concat_tables":
                continue
            kwargs = keyword_names(node)
            if "promote_options" in kwargs or "promote" in kwargs:
                continue
            yield ctx.violation(
                self, node,
                "pass `promote_options=\"permissive\"`: reducer outputs "
                "may mix large_* and 32-bit-offset schemas once the "
                ">2GiB offset promotion engages, and an unpromoted "
                "concat raises ArrowInvalid in exactly that regime")


@register
class ZeroCopyChunkedRule(Rule):
    id = "arrow-zero-copy"
    category = "arrow-schema"
    description = ("`.to_numpy(zero_copy_only=True)` raises on chunked or "
                   "nullable columns")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "to_numpy"):
                continue
            if is_constant(get_keyword(node, "zero_copy_only"), True):
                yield ctx.violation(
                    self, node,
                    "`zero_copy_only=True` raises ArrowInvalid on chunked "
                    "or nullable columns; combine_chunks() first and prove "
                    "null_count == 0, or pass zero_copy_only=False and "
                    "accept the copy")
