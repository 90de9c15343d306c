"""Tenancy discipline.

The tenancy plane (tenancy/) only works if EVERY entry point that
accepts new work into a shared plane — queue serving, storage warming,
stream registration — knows whose work it is. An entry point that
takes neither a tenant parameter nor resolves the ambient
``tenancy.current_tenant()`` admits unattributable bytes: they land on
the ``default`` tenant's ledger, dodge the fair-share scheduler and the
admission quotas, and the whole QoS story silently regresses to
first-come-first-served. Nothing fails loudly — single-tenant tests
pass forever — so ``tenant-context-bypass`` closes the hole
mechanically: functions named like entry points
(``config.tenancy_entry_names``) inside the serving/storage planes
(``config.tenancy_entry_globs``) must mention a tenant somewhere — a
parameter, an attribute, a config key — or they flag.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterator

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, register)


def _mentions_tenant(node: ast.AST) -> bool:
    """Does the function take a tenant-ish parameter or reference a
    tenant-ish name/attribute/string anywhere in its body?"""
    args = node.args
    params = (list(getattr(args, "posonlyargs", ())) + list(args.args)
              + list(args.kwonlyargs) + [args.vararg, args.kwarg])
    for param in params:
        if param is not None and "tenant" in param.arg.lower():
            return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "tenant" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "tenant" in sub.attr.lower():
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "tenant" in sub.value.lower():
            return True
    return False


@register
class TenantContextBypassRule(Rule):
    id = "tenant-context-bypass"
    category = "tenancy"
    description = ("queue/storage entry point accepts work without a "
                   "TenantContext — bytes admitted here are "
                   "unattributable, so they bypass the weighted-fair "
                   "scheduler, the admission quotas and the per-tenant "
                   "cache partitions; take a tenant/tenants parameter "
                   "or resolve tenancy.current_tenant()")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.tenancy_entry_globs):
            return
        patterns = ctx.config.tenancy_entry_names
        for node in ast.walk(tree):
            if not isinstance(node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(fnmatch.fnmatchcase(node.name, p)
                       for p in patterns):
                continue
            if _mentions_tenant(node):
                continue
            yield ctx.violation(
                self, node,
                f"`{node.name}` accepts work into a shared plane "
                "without a TenantContext — add a tenant/tenants "
                "parameter or resolve tenancy.current_tenant() so the "
                "bytes stay attributable to a tenant ledger")
