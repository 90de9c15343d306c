"""Checked-in baseline ("known findings") support for rsdl-lint.

A baseline entry fingerprints a violation by ``(path, rule, snippet)``
— deliberately NOT by line number, so unrelated edits that shift code
do not invalidate the baseline. Identical snippets in one file share a
fingerprint; the baseline then suppresses up to as many occurrences as
it recorded, so a *new* copy of a grandfathered violation still fails
the gate.

The project keeps the baseline empty by policy (every deliberate
exception carries an inline ``# rsdl-lint: disable=`` pragma with a
justification comment); the mechanism exists so a future sweep that
lands a new rule with many pre-existing findings can gate new code
immediately and burn the backlog down separately.
"""

from __future__ import annotations

import collections
import hashlib
import json
from typing import Dict, List, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import Violation

FORMAT_VERSION = 1


def fingerprint(violation: Violation) -> str:
    key = f"{violation.path}::{violation.rule}::{violation.snippet}"
    return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]


def write_baseline(path: str, violations: List[Violation]) -> None:
    entries = [{
        "rule": v.rule,
        "path": v.path,
        "line": v.line,  # informational only; matching uses the fingerprint
        "fingerprint": fingerprint(v),
    } for v in violations]
    payload = {"version": FORMAT_VERSION, "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def load_baseline(path: str) -> Dict[str, int]:
    """``fingerprint -> allowed occurrence count``."""
    with open(path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported baseline version {payload.get('version')!r} "
            f"in {path} (expected {FORMAT_VERSION})")
    counts: Dict[str, int] = collections.Counter(
        entry["fingerprint"] for entry in payload.get("entries", []))
    return dict(counts)


def apply_baseline(violations: List[Violation],
                   allowed: Dict[str, int]
                   ) -> Tuple[List[Violation], int]:
    """Drop baselined occurrences; returns ``(remaining, suppressed)``."""
    budget = dict(allowed)
    remaining: List[Violation] = []
    suppressed = 0
    for violation in violations:
        fp = fingerprint(violation)
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            suppressed += 1
        else:
            remaining.append(violation)
    return remaining, suppressed
