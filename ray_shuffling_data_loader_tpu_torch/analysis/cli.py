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
    return parser


def _split_ids(value: Optional[str]) -> List[str]:
    if not value:
        return []
    return [v.strip() for v in value.split(",") if v.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    registry = core.all_rules()

    if args.list_rules:
        width = max(len(rule_id) for rule_id in registry)
        for rule_id, rule in sorted(registry.items()):
            print(f"{rule_id:<{width}}  [{rule.category}] "
                  f"{rule.description}")
        return core.EXIT_CLEAN

    unknown = [r for r in _split_ids(args.select) + _split_ids(args.disable)
               if r not in registry]
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

    selected = set(_split_ids(args.select) or registry)
    selected -= set(_split_ids(args.disable))
    rules = [rule for rule_id, rule in sorted(registry.items())
             if rule_id in selected]

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"rsdl-lint-torch: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return core.EXIT_ERROR

    violations, files_checked = core.check_paths(args.paths, config, rules)

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
