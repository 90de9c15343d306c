"""Differential regression forensics between two bench rounds (own copy
of the JAX package's ``runtime/regress.py``).

A bench record says *that* a number moved between two rounds; this
module answers *why*, from the evidence each round already recorded
about itself. A round's **flight capsule** (a directory beside the
record, written by ``health.capture_incident(reason="bench-round")`` in
the ``runtime/health.py`` incident layout) carries merged trace dumps,
the federated metric exposition, a bounded history slice, and the
resolved policy + ``RSDL_*`` environment. Given two rounds this module:

- aligns the rounds' pipeline stages by ``(kind, epoch-normalized
  rank)`` (``trace.stage_table`` — per-epoch critical-path ms, so a
  3-epoch round diffs against a 5-epoch round without bias);
- diffs per-stage latency **distributions** using the existing
  mergeable histogram buckets / sketch centroids
  (``metrics.distribution_masses``): the report carries the mean shift
  AND a bucket-overlap significance score, so a real shape change is
  distinguishable from a mean nudged by one outlier;
- diffs the two **critical paths** ("convert entered the critical
  path; reduce self-time +340 ms/epoch");
- diffs resolved **policy/env/config** ("RSDL_TENANT_FLOOR_PACE_S
  appeared");
- ranks **suspects** by what-if attribution: a stage's score is the
  share of the epoch-time increase its critical-path delta explains,
  cross-referenced with the current round's 2x-speedup what-if.

Records without capsules degrade LOUDLY to a record-only numeric diff
(the pre-r11 trajectory stays comparable, it just cannot name stages).
Provenance stamped in the records (``git_rev`` / ``tree_dirty`` / host
fingerprint) is cross-checked first: a dirty tree or a cross-host pair
gets a warning before any number is believed — the r09->r10 case this
plane was built on was exactly a host-capability change masquerading
as a code regression.

Run it as ``python -m ray_shuffling_data_loader_tpu_torch.runtime.regress
BASE CUR [--json] [--check]`` (:func:`main`; the JAX package's
``tools/rsdl_regress.py`` with the same options and exit codes).

Stdlib-only AND standalone on purpose: the file can be loaded by path
on hosts without numpy, pyarrow or torch (an operator laptop holding two
downloaded records and capsules); its sibling runtime modules
(``trace``, ``metrics``, both stdlib-only) are loaded the same way when
the package import fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple


def _load_sibling(stem: str):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{stem}.py")
    spec = importlib.util.spec_from_file_location(
        f"_rsdl_torch_regress_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


try:
    from ray_shuffling_data_loader_tpu_torch.runtime import trace as rt_trace
    from ray_shuffling_data_loader_tpu_torch.runtime import (
        metrics as rt_metrics)
except ImportError:  # stripped host: load siblings by path
    rt_trace = _load_sibling("trace")
    rt_metrics = _load_sibling("metrics")

SCHEMA = "rsdl-regress-v1"

#: A distribution diff is *significant* when the bucket-overlap
#: coefficient drops below this AND both rounds observed at least
#: :data:`MIN_SIGNIFICANT_COUNT` samples — overlap near 1.0 means the
#: two rounds drew from the same shape (noise), near 0.0 means the mass
#: moved buckets (a real shift).
SIGNIFICANT_OVERLAP = 0.75
MIN_SIGNIFICANT_COUNT = 8

#: Record keys that are identities/config, not measurements — excluded
#: from the numeric record diff (they change by design between rounds).
_RECORD_DIFF_SKIP = frozenset({
    "host_cpus", "executor_workers", "train_batch_size",
    "train_microbatch", "train_flops_per_row", "n",
})

#: Provenance fields whose mismatch makes two rounds non-comparable as
#: a *code* regression (the machine changed under the benchmark).
_HOST_FINGERPRINT_FIELDS = ("host", "cpu_model", "host_cpus", "cpu_mhz")


# ---------------------------------------------------------------------------
# Loading: records, capsule discovery, capsule contents
# ---------------------------------------------------------------------------


def load_record(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(wrapper, record)`` from a raw bench JSON line or the committed
    ``BENCH_r*`` wrapper; for raw records the wrapper IS the record."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        return data, data["parsed"]
    if not isinstance(data, dict) or "value" not in data:
        raise ValueError(f"{path}: not a bench record "
                         "(no 'value' and no 'parsed' wrapper)")
    return data, data


def find_capsule(record_path: str,
                 record: Dict[str, Any]) -> Optional[str]:
    """The round's flight-capsule directory, or None.

    Resolution order: the record's ``capsule`` reference (absolute, or
    relative to the record's directory), then the sibling-directory
    convention ``<record-stem>.capsule/`` — the latter keeps the
    reference alive after a committed wrapper renames the capsule to
    match its round number. A directory only counts with a readable
    ``capsule.json`` manifest (the manifest is written LAST, so its
    presence means the capsule is complete)."""
    base_dir = os.path.dirname(os.path.abspath(record_path))
    candidates = []
    ref = record.get("capsule")
    if isinstance(ref, str) and ref:
        candidates.append(ref if os.path.isabs(ref)
                          else os.path.join(base_dir, ref))
    stem = os.path.basename(record_path)
    if stem.endswith(".json"):
        stem = stem[:-len(".json")]
    candidates.append(os.path.join(base_dir, f"{stem}.capsule"))
    for cand in candidates:
        if os.path.isfile(os.path.join(cand, "capsule.json")):
            return cand
    return None


def load_capsule(capsule_dir: str,
                 whatif_speedup: float = 2.0) -> Dict[str, Any]:
    """One capsule directory -> the in-memory evidence the differ
    consumes: ``{path, manifest, policy, env, analysis, stage_table,
    masses, means, history_snapshots}``. Every section is best-effort
    (a capsule missing its history is still worth a trace diff)."""
    out: Dict[str, Any] = {
        "path": capsule_dir, "manifest": None, "policy": {}, "env": {},
        "analysis": None, "stage_table": {}, "masses": {}, "means": {},
        "history_snapshots": 0,
    }
    with open(os.path.join(capsule_dir, "capsule.json"),
              encoding="utf-8") as f:
        out["manifest"] = json.load(f)
    policy_path = os.path.join(capsule_dir, "policy.json")
    if os.path.isfile(policy_path):
        with open(policy_path, encoding="utf-8") as f:
            data = json.load(f)
        out["policy"] = data.get("policy", {})
        out["env"] = data.get("env", {})
    dumps = sorted(glob.glob(os.path.join(capsule_dir, "traces",
                                          "*.jsonl")))
    if dumps:
        merged = rt_trace.merge_dumps(dumps)
        if merged["events"]:
            analysis = rt_trace.analyze(merged["events"],
                                        whatif_speedup=whatif_speedup)
            out["analysis"] = analysis
            out["stage_table"] = rt_trace.stage_table(analysis)
    prom_path = os.path.join(capsule_dir, "metrics.prom")
    if os.path.isfile(prom_path):
        with open(prom_path, encoding="utf-8") as f:
            text = f.read()
        samples, types = rt_metrics.parse_exposition_typed(text)
        out["masses"], out["means"] = _distribution_views(samples, types)
    hist_path = os.path.join(capsule_dir, "history.json")
    if os.path.isfile(hist_path):
        with open(hist_path, encoding="utf-8") as f:
            data = json.load(f)
        out["history_snapshots"] = len(data.get("snapshots", []))
    return out


def _distribution_views(samples: Dict[str, Dict[Any, float]],
                        types: Dict[str, str]
                        ) -> Tuple[Dict[Any, Dict[float, float]],
                                   Dict[Any, Tuple[float, int]]]:
    """``(masses, means)`` over every histogram/sketch family in one
    parsed exposition, keyed by ``(family, group_labels)``. Means come
    from the family's ``_sum``/``_count`` series (histograms) or the
    centroid-weighted mass (sketches)."""
    masses: Dict[Any, Dict[float, float]] = {}
    means: Dict[Any, Tuple[float, int]] = {}
    for family, kind in sorted(types.items()):
        if kind not in ("histogram", "sketch"):
            continue
        for group, bucket in rt_metrics.distribution_masses(
                samples, family, kind).items():
            key = (family, group)
            masses[key] = bucket
            if kind == "sketch":
                total = sum(bucket.values())
                mean = (sum(c * n for c, n in bucket.items()) / total
                        if total > 0 else 0.0)
                means[key] = (mean, int(total))
            else:
                sums = samples.get(f"{family}_sum", {})
                counts = samples.get(f"{family}_count", {})
                count = counts.get(group, 0.0)
                means[key] = ((sums.get(group, 0.0) / count
                               if count > 0 else 0.0), int(count))
    return masses, means


# ---------------------------------------------------------------------------
# Differential pieces
# ---------------------------------------------------------------------------


def diff_record_metrics(base: Dict[str, Any], cur: Dict[str, Any],
                        min_delta_pct: float = 2.0
                        ) -> List[Dict[str, Any]]:
    """Relative deltas of every numeric key the rounds share, largest
    movers first — the record-only fallback evidence and the headline
    the capsule evidence must explain."""
    out: List[Dict[str, Any]] = []
    for key in sorted(set(base) & set(cur)):
        if key in _RECORD_DIFF_SKIP:
            continue
        b, c = base.get(key), cur.get(key)
        if isinstance(b, bool) or isinstance(c, bool):
            continue
        if not isinstance(b, (int, float)) or \
                not isinstance(c, (int, float)):
            continue
        if b == 0:
            continue
        delta_pct = 100.0 * (c - b) / abs(b)
        if abs(delta_pct) < min_delta_pct:
            continue
        out.append({"key": key, "base": b, "cur": c,
                    "delta_pct": round(delta_pct, 2)})
    out.sort(key=lambda d: -abs(d["delta_pct"]))
    return out


#: Policy/env keys whose values are per-run scratch paths (bench pins a
#: fresh trace tmpdir for every capsuled round, incident capsules get
#: pid-stamped dirs): they differ on EVERY pair by construction, so
#: diffing them would bury real knob changes under permanent noise.
_VOLATILE_KNOBS = frozenset({
    "trace_dir", "RSDL_TRACE_DIR",
    "incident_dir", "RSDL_INCIDENT_DIR",
    "bench_capsule_dir", "RSDL_BENCH_CAPSULE_DIR",
    "RSDL_TELEMETRY_DUMP_DIR",
})


def diff_policy(base: Dict[str, Any],
                cur: Dict[str, Any]) -> Dict[str, Any]:
    """Appeared / disappeared / changed keys between two flat dicts
    (resolved policy, or the ``RSDL_*`` environment). Per-run scratch
    paths (:data:`_VOLATILE_KNOBS`) are excluded."""
    base = {k: v for k, v in base.items() if k not in _VOLATILE_KNOBS}
    cur = {k: v for k, v in cur.items() if k not in _VOLATILE_KNOBS}
    appeared = {k: cur[k] for k in sorted(set(cur) - set(base))}
    disappeared = {k: base[k] for k in sorted(set(base) - set(cur))}
    changed = {k: [base[k], cur[k]]
               for k in sorted(set(base) & set(cur))
               if base[k] != cur[k]}
    return {"appeared": appeared, "disappeared": disappeared,
            "changed": changed}


def diff_stage_tables(base: Dict[str, Dict[str, float]],
                      cur: Dict[str, Dict[str, float]]
                      ) -> List[Dict[str, Any]]:
    """Critical-path diff, per-epoch-normalized: one row per stage
    either round put on (or near) the path, flagged ``entered`` /
    ``left`` when the stage is on the path in only one round."""
    rows: List[Dict[str, Any]] = []
    for stage in sorted(set(base) | set(cur)):
        b = base.get(stage, {})
        c = cur.get(stage, {})
        b_ms = b.get("cp_ms_per_epoch", 0.0)
        c_ms = c.get("cp_ms_per_epoch", 0.0)
        rows.append({
            "stage": stage,
            "base_cp_ms_per_epoch": round(b_ms, 3),
            "cur_cp_ms_per_epoch": round(c_ms, 3),
            "delta_ms_per_epoch": round(c_ms - b_ms, 3),
            "base_pct": b.get("pct", 0.0),
            "cur_pct": c.get("pct", 0.0),
            "entered": b_ms <= 0.0 < c_ms,
            "left": c_ms <= 0.0 < b_ms,
        })
    rows.sort(key=lambda r: -abs(r["delta_ms_per_epoch"]))
    return rows


def bucket_overlap(base_masses: Dict[float, float],
                   cur_masses: Dict[float, float]) -> Optional[float]:
    """Overlap coefficient of two bucket-mass distributions over their
    shared edges: ``sum(min(p_i, q_i))`` of the count-normalized
    masses, 1.0 = identical shape, 0.0 = disjoint. None when the edge
    vocabularies share fewer than two buckets (nothing comparable —
    bucket layouts drifted between rounds)."""
    edges = sorted(set(base_masses) & set(cur_masses))
    if len(edges) < 2:
        return None
    b_total = sum(base_masses[e] for e in edges)
    c_total = sum(cur_masses[e] for e in edges)
    if b_total <= 0 or c_total <= 0:
        return None
    return sum(min(base_masses[e] / b_total, cur_masses[e] / c_total)
               for e in edges)


def diff_distributions(base_cap: Dict[str, Any],
                       cur_cap: Dict[str, Any]
                       ) -> List[Dict[str, Any]]:
    """Shift + significance per shared distribution family/group:
    ``{family, labels, base_mean, cur_mean, shift_pct, overlap,
    significance, significant, base_count, cur_count}``, most
    significant first."""
    rows: List[Dict[str, Any]] = []
    shared = set(base_cap["masses"]) & set(cur_cap["masses"])
    for key in sorted(shared, key=repr):
        family, group = key
        overlap = bucket_overlap(base_cap["masses"][key],
                                 cur_cap["masses"][key])
        if overlap is None:
            continue
        b_mean, b_count = base_cap["means"].get(key, (0.0, 0))
        c_mean, c_count = cur_cap["means"].get(key, (0.0, 0))
        shift_pct = (100.0 * (c_mean - b_mean) / b_mean
                     if b_mean > 0 else 0.0)
        significance = round(1.0 - overlap, 4)
        rows.append({
            "family": family,
            "labels": dict(group),
            "base_mean": round(b_mean, 6),
            "cur_mean": round(c_mean, 6),
            "shift_pct": round(shift_pct, 2),
            "overlap": round(overlap, 4),
            "significance": significance,
            "significant": (overlap < SIGNIFICANT_OVERLAP
                            and min(b_count, c_count)
                            >= MIN_SIGNIFICANT_COUNT),
            "base_count": b_count,
            "cur_count": c_count,
        })
    rows.sort(key=lambda r: -r["significance"])
    return rows


# ---------------------------------------------------------------------------
# Provenance comparability
# ---------------------------------------------------------------------------


def provenance_warnings(base_rec: Dict[str, Any],
                        cur_rec: Dict[str, Any],
                        include_missing: bool = True) -> List[str]:
    """Why these two rounds may not be comparable, before any delta is
    believed: missing provenance, dirty trees, host-fingerprint
    mismatches. The r09->r10 'regression' was a host change nothing in
    the records could falsify — these warnings are that falsifier.
    ``include_missing=False`` keeps only the hard mismatches (dirty /
    cross-host) for callers that routinely see pre-provenance rounds
    (the bench-diff gate over the committed trajectory)."""
    warnings: List[str] = []
    base_p = base_rec.get("provenance")
    cur_p = cur_rec.get("provenance")
    for name, prov in (("baseline", base_p), ("current", cur_p)):
        if not isinstance(prov, dict):
            if include_missing:
                warnings.append(
                    f"{name} record has no provenance (pre-r11 round): "
                    "host/commit comparability is unverifiable")
        elif prov.get("tree_dirty"):
            warnings.append(
                f"{name} record was measured on a DIRTY tree "
                f"(git_rev {prov.get('git_rev', '?')[:12]} + uncommitted "
                "changes): the measured code is not the committed code")
    if isinstance(base_p, dict) and isinstance(cur_p, dict):
        mismatched = [
            f for f in _HOST_FINGERPRINT_FIELDS
            if base_p.get(f) is not None and cur_p.get(f) is not None
            and base_p.get(f) != cur_p.get(f)
        ]
        if mismatched:
            detail = ", ".join(
                f"{f}: {base_p.get(f)!r} -> {cur_p.get(f)!r}"
                for f in mismatched)
            warnings.append(
                f"CROSS-HOST comparison ({detail}): throughput deltas "
                "reflect the machine as much as the code")
    return warnings


# ---------------------------------------------------------------------------
# Suspect ranking
# ---------------------------------------------------------------------------


def rank_suspects(report: Dict[str, Any],
                  max_suspects: int = 8) -> List[Dict[str, Any]]:
    """Rank what most plausibly explains the delta, best first.

    Stage suspects score by what-if attribution: the share of the
    baseline per-epoch time the stage's critical-path delta added
    (a stage that added 20% of an epoch outranks one that added 2%),
    boosted when a latency distribution it owns shifted significantly.
    Policy/env changes score a flat nudge each — a changed knob is
    always worth a look but never outranks hard trace evidence unless
    the traces are silent. Record-only mode falls back to the largest
    regressing record metrics."""
    suspects: List[Dict[str, Any]] = []
    base_wall = (report.get("base", {}).get("wall_ms_per_epoch")
                 or 0.0)
    sig_by_stage: Dict[str, float] = {}
    for row in report.get("distribution_diff", []):
        stage = row["labels"].get("stage") or row["labels"].get("kind")
        if stage and row["significant"] and row["shift_pct"] > 0:
            sig_by_stage[stage] = max(sig_by_stage.get(stage, 0.0),
                                      row["significance"])
    for row in report.get("critical_path_diff", []):
        delta = row["delta_ms_per_epoch"]
        if delta <= 0:
            continue
        score = (100.0 * delta / base_wall if base_wall > 0
                 else row["cur_pct"])
        boost = sig_by_stage.get(row["stage"], 0.0)
        score *= (1.0 + boost)
        what = "entered the critical path" if row["entered"] else \
            (f"+{delta:.1f} ms/epoch on the critical path "
             f"({row['base_cp_ms_per_epoch']:.1f} -> "
             f"{row['cur_cp_ms_per_epoch']:.1f})")
        evidence = what + (
            f"; latency distribution shifted (significance {boost:.2f})"
            if boost else "")
        suspects.append({"kind": "stage", "name": row["stage"],
                         "score": round(score, 2),
                         "evidence": evidence})
    for section, label in (("policy_diff", "policy"),
                           ("env_diff", "env")):
        diff = report.get(section) or {}
        for key, value in diff.get("appeared", {}).items():
            suspects.append({
                "kind": label, "name": key, "score": 15.0,
                "evidence": f"{key} appeared (= {value!r})"})
        for key, value in diff.get("disappeared", {}).items():
            suspects.append({
                "kind": label, "name": key, "score": 15.0,
                "evidence": f"{key} disappeared (was {value!r})"})
        for key, (old, new) in sorted(
                (k, tuple(v)) for k, v in
                diff.get("changed", {}).items()):
            suspects.append({
                "kind": label, "name": key, "score": 12.0,
                "evidence": f"{key} changed: {old!r} -> {new!r}"})
    for row in report.get("distribution_diff", []):
        if not row["significant"] or row["shift_pct"] <= 0:
            continue
        name = row["family"] + (
            "{" + ",".join(f"{k}={v}" for k, v in
                           sorted(row["labels"].items())) + "}"
            if row["labels"] else "")
        suspects.append({
            "kind": "distribution", "name": name,
            "score": round(10.0 * row["significance"], 2),
            "evidence": (f"mean {row['base_mean']:.6g} -> "
                         f"{row['cur_mean']:.6g} "
                         f"({row['shift_pct']:+.1f}%), bucket overlap "
                         f"{row['overlap']:.2f}")})
    if not suspects:
        for row in report.get("record_diff", [])[:max_suspects]:
            suspects.append({
                "kind": "metric", "name": row["key"],
                "score": round(abs(row["delta_pct"]) / 10.0, 2),
                "evidence": (f"{row['base']:g} -> {row['cur']:g} "
                             f"({row['delta_pct']:+.1f}%)")})
    suspects.sort(key=lambda s: -s["score"])
    for rank, s in enumerate(suspects[:max_suspects], start=1):
        s["rank"] = rank
    return suspects[:max_suspects]


# ---------------------------------------------------------------------------
# Top-level diff
# ---------------------------------------------------------------------------


def _round_summary(path: str, record: Dict[str, Any],
                   capsule: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    analysis = (capsule or {}).get("analysis")
    n_epochs = max(1, len((analysis or {}).get("epochs") or []))
    return {
        "path": path,
        "provenance": record.get("provenance"),
        "capsule": (capsule or {}).get("path"),
        "epochs_traced": (len(analysis["epochs"]) if analysis else 0),
        "wall_ms_per_epoch": (round(analysis["wall_ms"] / n_epochs, 3)
                              if analysis else None),
        "history_snapshots": (capsule or {}).get("history_snapshots", 0),
    }


def diff_rounds(base_path: str, cur_path: str,
                whatif_speedup: float = 2.0,
                max_suspects: int = 8) -> Dict[str, Any]:
    """The full differential report between two bench record paths.

    Capsule-bearing pairs get the stage/distribution/policy diff;
    anything less degrades loudly to record-only mode. Always returns a
    report (missing evidence is a ``warnings`` entry, never an
    exception) — callers gate on ``report["suspects"]``."""
    _, base_rec = load_record(base_path)
    _, cur_rec = load_record(cur_path)
    warnings = provenance_warnings(base_rec, cur_rec)

    base_dir = find_capsule(base_path, base_rec)
    cur_dir = find_capsule(cur_path, cur_rec)
    base_cap = cur_cap = None
    for name, cap_dir, setter in (("baseline", base_dir, "base"),
                                  ("current", cur_dir, "cur")):
        if cap_dir is None:
            warnings.append(
                f"{name} record has NO flight capsule: stage-level "
                "attribution unavailable, degrading to record-only "
                "diff")
            continue
        try:
            cap = load_capsule(cap_dir, whatif_speedup=whatif_speedup)
        except (OSError, ValueError) as e:
            warnings.append(f"{name} capsule unreadable ({e}): "
                            "degrading to record-only diff")
            continue
        if setter == "base":
            base_cap = cap
        else:
            cur_cap = cap

    mode = "capsule" if (base_cap is not None and cur_cap is not None) \
        else "record-only"
    report: Dict[str, Any] = {
        "schema": SCHEMA,
        "mode": mode,
        "base": _round_summary(base_path, base_rec, base_cap),
        "cur": _round_summary(cur_path, cur_rec, cur_cap),
        "warnings": warnings,
        "record_diff": diff_record_metrics(base_rec, cur_rec),
        "policy_diff": None,
        "env_diff": None,
        "critical_path_diff": [],
        "distribution_diff": [],
    }
    if mode == "capsule":
        report["policy_diff"] = diff_policy(base_cap["policy"],
                                            cur_cap["policy"])
        report["env_diff"] = diff_policy(base_cap["env"], cur_cap["env"])
        report["critical_path_diff"] = diff_stage_tables(
            base_cap["stage_table"], cur_cap["stage_table"])
        report["distribution_diff"] = diff_distributions(base_cap,
                                                         cur_cap)
        whatif = ((cur_cap.get("analysis") or {}).get("whatif")) or {}
        report["whatif_cur"] = whatif
    report["suspects"] = rank_suspects(report, max_suspects=max_suspects)
    return report


def render_report(report: Dict[str, Any]) -> List[str]:
    """Human-readable report lines (the CLI and the bench-diff forensic
    footer both print these)."""
    lines: List[str] = []
    lines.append(f"regress: {report['base']['path']} -> "
                 f"{report['cur']['path']} [{report['mode']} mode]")
    for warning in report["warnings"]:
        lines.append(f"  WARNING {warning}")
    for row in report["record_diff"][:10]:
        lines.append(f"  record  {row['key']:<30} {row['base']:g} -> "
                     f"{row['cur']:g} ({row['delta_pct']:+.1f}%)")
    for row in report["critical_path_diff"]:
        if row["delta_ms_per_epoch"] == 0 and not (row["entered"]
                                                   or row["left"]):
            continue
        marker = (" ENTERED" if row["entered"]
                  else " LEFT" if row["left"] else "")
        lines.append(
            f"  path    {row['stage']:<30} "
            f"{row['base_cp_ms_per_epoch']:.1f} -> "
            f"{row['cur_cp_ms_per_epoch']:.1f} ms/epoch "
            f"({row['delta_ms_per_epoch']:+.1f}){marker}")
    for row in report["distribution_diff"]:
        if not row["significant"]:
            continue
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted(row["labels"].items()))
        lines.append(
            f"  dist    {row['family']}{{{labels}}} mean "
            f"{row['base_mean']:.6g} -> {row['cur_mean']:.6g} "
            f"({row['shift_pct']:+.1f}%), overlap {row['overlap']:.2f}")
    for section in ("policy_diff", "env_diff"):
        diff = report.get(section) or {}
        for verb in ("appeared", "disappeared"):
            for key, value in diff.get(verb, {}).items():
                lines.append(f"  {section.split('_')[0]:<7} {key} "
                             f"{verb} ({value!r})")
        for key, pair in diff.get("changed", {}).items():
            lines.append(f"  {section.split('_')[0]:<7} {key} changed: "
                         f"{pair[0]!r} -> {pair[1]!r}")
    if report["suspects"]:
        lines.append("  suspects (most likely first):")
        for s in report["suspects"]:
            lines.append(f"    #{s['rank']} [{s['kind']}] "
                         f"{s['name']} (score {s['score']:g}) — "
                         f"{s['evidence']}")
    else:
        lines.append("  no suspects: rounds are indistinguishable at "
                     "this evidence level")
    return lines


# ---------------------------------------------------------------------------
# Self-test (``--check``)
# ---------------------------------------------------------------------------


def _synthetic_events(reduce_s: float,
                      n_epochs: int = 2) -> List[Dict[str, Any]]:
    """A deterministic two-stage pipeline: per epoch, map_read then
    reduce then train_step back-to-back; ``reduce_s`` is the planted
    dial the self-test turns between 'rounds'."""
    events = []
    t = 1.0
    for epoch in range(n_epochs):
        for kind, dur, task in (("map_read", 0.10, 0),
                                ("reduce", reduce_s, 0),
                                ("train_step", 0.10, None)):
            t += dur
            events.append({"kind": kind, "epoch": epoch, "task": task,
                           "t_mono": t, "dur_s": dur})
        t += 0.01
    return events


def _synthetic_exposition(reduce_scale: float) -> str:
    """A minimal round exposition: one histogram family with the reduce
    group's mass planted ``reduce_scale`` buckets to the right."""
    edges = [0.1, 0.2, 0.4, 0.8]
    counts = {"map_read": [30, 2, 0, 0]}
    if reduce_scale <= 1.0:
        counts["reduce"] = [4, 24, 4, 0]
    else:
        counts["reduce"] = [0, 4, 24, 4]
    lines = ["# TYPE rsdl_stage_latency_seconds histogram"]
    for stage, masses in sorted(counts.items()):
        cumulative = 0
        total_mass = 0.0
        for edge, n in zip(edges, masses):
            cumulative += n
            lines.append(
                f'rsdl_stage_latency_seconds_bucket{{le="{edge}",'
                f'stage="{stage}"}} {cumulative}')
            total_mass += n * edge
        lines.append(
            f'rsdl_stage_latency_seconds_bucket{{le="+Inf",'
            f'stage="{stage}"}} {cumulative}')
        lines.append(
            f'rsdl_stage_latency_seconds_sum{{stage="{stage}"}} '
            f'{total_mass}')
        lines.append(
            f'rsdl_stage_latency_seconds_count{{stage="{stage}"}} '
            f'{cumulative}')
    return "\n".join(lines) + "\n"


def _synthetic_capsule(reduce_s: float, env: Dict[str, str]
                       ) -> Dict[str, Any]:
    analysis = rt_trace.analyze(_synthetic_events(reduce_s))
    samples, types = rt_metrics.parse_exposition_typed(
        _synthetic_exposition(1.0 if reduce_s <= 0.15 else 3.0))
    masses, means = _distribution_views(samples, types)
    return {
        "path": "<synthetic>", "manifest": {"schema": "rsdl-incident-v1"},
        "policy": {"queue_maxsize": 4}, "env": env,
        "analysis": analysis,
        "stage_table": rt_trace.stage_table(analysis),
        "masses": masses, "means": means, "history_snapshots": 0,
    }


def self_check() -> Tuple[bool, List[str]]:
    """Synthesize two rounds with a planted suspect (reduce 3x slower,
    one env knob appeared), run the full differential, and require the
    top suspect to name the plant. Returns ``(ok, report_lines)`` —
    ``--check`` prints the lines either way."""
    base_cap = _synthetic_capsule(0.10, {})
    cur_cap = _synthetic_capsule(0.30, {"RSDL_PLANTED_KNOB": "1"})
    report: Dict[str, Any] = {
        "schema": SCHEMA, "mode": "capsule",
        "base": {"path": "<base>", "provenance": None,
                 "capsule": "<synthetic>", "epochs_traced": 2,
                 "wall_ms_per_epoch": round(
                     base_cap["analysis"]["wall_ms"] / 2, 3),
                 "history_snapshots": 0},
        "cur": {"path": "<cur>", "provenance": None,
                "capsule": "<synthetic>", "epochs_traced": 2,
                "wall_ms_per_epoch": round(
                    cur_cap["analysis"]["wall_ms"] / 2, 3),
                "history_snapshots": 0},
        "warnings": [],
        "record_diff": diff_record_metrics(
            {"value": 1000.0}, {"value": 640.0}),
        "policy_diff": diff_policy(base_cap["policy"],
                                   cur_cap["policy"]),
        "env_diff": diff_policy(base_cap["env"], cur_cap["env"]),
        "critical_path_diff": diff_stage_tables(
            base_cap["stage_table"], cur_cap["stage_table"]),
        "distribution_diff": diff_distributions(base_cap, cur_cap),
    }
    report["suspects"] = rank_suspects(report)
    lines = render_report(report)
    ok = bool(report["suspects"]) \
        and report["suspects"][0]["kind"] == "stage" \
        and report["suspects"][0]["name"] == "reduce" \
        and any(s["kind"] == "env" and s["name"] == "RSDL_PLANTED_KNOB"
                for s in report["suspects"]) \
        and any(r["significant"] and r["labels"].get("stage") == "reduce"
                for r in report["distribution_diff"]) \
        and not any(r["significant"]
                    and r["labels"].get("stage") == "map_read"
                    for r in report["distribution_diff"])
    return ok, lines


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    """Exit codes: 0 report produced (even record-only), 2 inputs
    unusable; ``--check`` exits 1 if the planted suspect is not ranked
    first."""
    parser = argparse.ArgumentParser(
        prog="python -m ray_shuffling_data_loader_tpu_torch.runtime.regress",
        description="differential forensics between two bench rounds")
    parser.add_argument("base", nargs="?",
                        help="baseline bench record (raw or BENCH_r* "
                             "wrapper)")
    parser.add_argument("cur", nargs="?",
                        help="current bench record to explain")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON instead of "
                             "the rendered summary")
    parser.add_argument("--max-suspects", type=int, default=8,
                        help="suspect list length (default 8)")
    parser.add_argument("--whatif-speedup", type=float, default=2.0,
                        help="what-if speedup factor for the current "
                             "round's trace attribution (default 2.0)")
    parser.add_argument("--check", action="store_true",
                        help="self-test: plant a known suspect in a "
                             "synthetic round pair and verify the "
                             "ranking names it")
    args = parser.parse_args(argv)

    if args.check:
        ok, lines = self_check()
        for line in lines:
            print(line)
        print("regress --check: %s" % (
            "planted suspect ranked #1" if ok
            else "FAILED (planted suspect not ranked #1)"))
        return 0 if ok else 1

    if not args.base or not args.cur:
        parser.error("two record paths required (or --check)")
    for path in (args.base, args.cur):
        if not os.path.isfile(path):
            print(f"regress: no such record: {path}", file=sys.stderr)
            return 2
    try:
        report = diff_rounds(args.base, args.cur,
                             whatif_speedup=args.whatif_speedup,
                             max_suspects=args.max_suspects)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for line in render_report(report):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
