"""Command-line front end of the port's checker.

Usage::

    python -m ray_shuffling_data_loader_tpu_torch.analysis \\
        ray_shuffling_data_loader_tpu_torch chip_smoke.py \\
        tests/test_torch_port_*.py tests/torch_port_*.py

Exit codes: 0 clean (modulo pragmas/baseline), 1 violations,
2 usage/internal error. The baseline is the port's own file
(``.rsdl-lint-torch-baseline.json``), empty by policy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ray_shuffling_data_loader_tpu_torch.analysis import (
    baseline as baseline_mod)
from ray_shuffling_data_loader_tpu_torch.analysis import core

DEFAULT_BASELINE = ".rsdl-lint-torch-baseline.json"


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rsdl-lint-torch",
        description="Project-invariant static analyzer for the "
                    "ray_shuffling_data_loader_tpu_torch pipeline (lock "
                    "discipline, executor/one-shot safety, Torch host-sync "
                    "hygiene, Arrow schema rules).")
    parser.add_argument("paths", nargs="*", default=["."],
                        help="files or directories to analyze "
                             "(default: .)")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human", help="output format")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="baseline file of grandfathered findings "
                             f"(default: ./{DEFAULT_BASELINE} when present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings to the baseline file "
                             "and exit 0")
    parser.add_argument("--config", default=None, metavar="FILE",
                        help="JSON file overriding analysis.core.Config "
                             "fields")
    parser.add_argument("--select", default=None, metavar="IDS",
                        help="comma-separated rule ids to run exclusively")
    parser.add_argument("--disable", default=None, metavar="IDS",
                        help="comma-separated rule ids to skip")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the registered rules and exit")
    parser.add_argument("--concurrency", action="store_true",
                        help="additionally run the whole-program "
                             "concurrency pass (lock-order cycles, "
                             "cross-module unguarded mutations) over the "
                             "library files among PATHS")
    parser.add_argument("--emit-order-graph", default=None, metavar="FILE",
                        help="with --concurrency: write the static "
                             "lock-order graph JSON to FILE")
    parser.add_argument("--locksan-graph", default=None, metavar="FILE",
                        help="with --concurrency: cross-check the static "
                             "graph against a runtime locksan dump "
                             "(RSDL_LOCKSAN=1 run artifact)")
    return parser


def _split_ids(value: Optional[str]) -> List[str]:
    if not value:
        return []
    return [v.strip() for v in value.split(",") if v.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    registry = core.all_rules()
    program_registry = core.program_rules()

    if args.list_rules:
        combined = dict(registry)
        combined.update(program_registry)
        width = max(len(rule_id) for rule_id in combined)
        for rule_id, rule in sorted(combined.items()):
            scope = " (whole-program, --concurrency)" \
                if rule_id in program_registry else ""
            print(f"{rule_id:<{width}}  [{rule.category}] "
                  f"{rule.description}{scope}")
        return core.EXIT_CLEAN

    unknown = [r for r in _split_ids(args.select) + _split_ids(args.disable)
               if r not in registry and r not in program_registry]
    if unknown:
        print(f"rsdl-lint-torch: unknown rule id(s): {', '.join(unknown)} "
              f"(see --list-rules)", file=sys.stderr)
        return core.EXIT_ERROR

    config = core.Config()
    if args.config:
        try:
            with open(args.config, "r", encoding="utf-8") as f:
                config = core.Config.from_dict(json.load(f))
        except (OSError, ValueError, TypeError) as e:
            print(f"rsdl-lint-torch: bad --config {args.config}: {e}",
                  file=sys.stderr)
            return core.EXIT_ERROR

    default_ids = list(registry) + (list(program_registry)
                                    if args.concurrency else [])
    selected = set(_split_ids(args.select) or default_ids)
    selected -= set(_split_ids(args.disable))
    rules = [rule for rule_id, rule in sorted(registry.items())
             if rule_id in selected]

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"rsdl-lint-torch: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return core.EXIT_ERROR

    violations, files_checked = core.check_paths(args.paths, config, rules)

    if args.concurrency:
        locksan_graph = None
        if args.locksan_graph:
            try:
                with open(args.locksan_graph, "r", encoding="utf-8") as f:
                    locksan_graph = json.load(f)
            except (OSError, ValueError) as e:
                print(f"rsdl-lint-torch: bad --locksan-graph "
                      f"{args.locksan_graph}: {e}", file=sys.stderr)
                return core.EXIT_ERROR
        program_rules = [rule for rule_id, rule
                         in sorted(program_registry.items())
                         if rule_id in selected]
        program_violations, analysis = core.check_program_paths(
            args.paths, config, program_rules,
            locksan_graph=locksan_graph)
        violations = sorted(
            violations + program_violations,
            key=lambda v: (v.path, v.line, v.col, v.rule))
        if args.emit_order_graph:
            graph = analysis.static_graph()
            with open(args.emit_order_graph, "w", encoding="utf-8") as f:
                json.dump(graph, f, indent=2, sort_keys=True)
                f.write("\n")
    elif args.emit_order_graph or args.locksan_graph:
        print("rsdl-lint-torch: --emit-order-graph/--locksan-graph require "
              "--concurrency", file=sys.stderr)
        return core.EXIT_ERROR

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None)
    if args.write_baseline:
        path = args.baseline or DEFAULT_BASELINE
        baseline_mod.write_baseline(path, violations)
        print(f"rsdl-lint-torch: wrote {len(violations)} finding(s) to "
              f"{path}")
        return core.EXIT_CLEAN

    suppressed = 0
    if baseline_path and not args.no_baseline:
        try:
            allowed = baseline_mod.load_baseline(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"rsdl-lint-torch: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return core.EXIT_ERROR
        violations, suppressed = baseline_mod.apply_baseline(
            violations, allowed)

    if args.format == "json":
        print(json.dumps({
            "violations": [v.as_dict() for v in violations],
            "files_checked": files_checked,
            "baseline_suppressed": suppressed,
        }, indent=2))
    else:
        for violation in violations:
            print(violation.format())
        summary = (f"rsdl-lint-torch: {len(violations)} finding(s) in "
                   f"{files_checked} file(s)")
        if suppressed:
            summary += f" ({suppressed} baselined)"
        print(summary if violations
              else summary.replace("finding(s)", "findings"))
    return core.EXIT_VIOLATIONS if violations else core.EXIT_CLEAN


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
