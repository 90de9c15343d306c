"""Whole-program concurrency rules (the ``--concurrency`` pass; the
port's copy of the JAX package's ``analysis/rules_concurrency.py``).

Two rules over :mod:`.locksets`' interprocedural results:

``inconsistent-lock-order``
    The static lock-order graph (acquire B while holding A => edge
    A->B) contains a cycle: two code paths take the same locks in
    opposite orders, so two threads can deadlock. The finding anchors
    at one acquisition site of the cycle and names every edge with its
    ``file:line`` witness so both chains are readable from the one
    message. When a locksan dump is supplied (``--locksan-graph``),
    three cross-check findings join in: an *order-relevant* dynamic
    edge the static graph lacks (the destination lock has outgoing
    edges in the merged graph, so the gap could extend a chain — the
    static pass under-resolved a call path; edges into pure leaf
    locks can never close a cycle and are recorded as benign, not
    flagged), a cycle that appears only once runtime edges merge into
    the static graph (each view acyclic alone, deadlock together),
    and a static cycle every edge of which was actually observed at
    runtime (no longer "potential": a hard failure).

``unguarded-shared-mutation``
    An attribute/global written under a specific lock at >=
    ``concurrency_min_guarded_sites`` sites is taken to be guarded by
    convention; a site that writes it with no lock held — after
    crediting locks the caller provably holds (the entry-held
    intersection) — is flagged. Covers what the per-file lock-mutation
    rule structurally cannot: writes from *other* modules/classes,
    module-global mutations, and container-mutating calls
    (``.append``/``.pop``/``.update``/...).

Both follow the house rule contract: real ``path:line`` anchors, so
``# rsdl-lint: disable=<rule>`` pragmas and the baseline file apply
unchanged.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis import core, locksets


def _split_key(key: str) -> Tuple[str, int]:
    path, _, line = key.rpartition(":")
    try:
        return path, int(line)
    except ValueError:
        return key, 1


def _anchor(rule: core.ProgramRule, program, path: str, line: int,
            message: str) -> core.Violation:
    mod = program.modules_by_path.get(path)
    snippet = ""
    if mod is not None:
        lines = mod.source.splitlines()
        if 1 <= line <= len(lines):
            snippet = lines[line - 1].strip()
    return core.Violation(rule=rule.id, path=path, line=line, col=0,
                          message=message, snippet=snippet)


def _owner(analysis: locksets.LockAnalysis, key: str) -> str:
    decl = analysis.decls.get(key)
    return decl.owner if decl is not None else key


@core.register_program
class InconsistentLockOrderRule(core.ProgramRule):
    id = "inconsistent-lock-order"
    category = "concurrency"
    description = ("cycle in the whole-program lock-order graph (or a "
                   "runtime-observed acquisition edge the static graph "
                   "is missing): two paths can deadlock")

    def check_program(self, program, analysis: locksets.LockAnalysis,
                      config: core.Config,
                      locksan_graph: Optional[dict] = None
                      ) -> Iterator[core.Violation]:
        confirmed_edge_sets: List[set] = []
        if locksan_graph is not None:
            report = locksets.crosscheck(analysis.static_graph(),
                                         locksan_graph)
            for cycle_edges in report["confirmed_cycles"]:
                confirmed_edge_sets.append({tuple(e) for e in cycle_edges})
            for cycle_edges in report["union_cycles"]:
                # A cycle neither view shows alone: static edges plus
                # runtime-observed ones close a loop. Anchor at the
                # first edge's src construction site.
                chains = "; ".join(
                    f"`{_owner(analysis, a)}` -> `{_owner(analysis, b)}`"
                    for a, b in cycle_edges)
                path, line = _split_key(cycle_edges[0][0])
                yield _anchor(
                    self, program, path, line,
                    "DEADLOCK (static + runtime edges combined): "
                    f"lock-order cycle — {chains}; the static graph "
                    "alone is acyclic but runtime-observed "
                    "acquisitions close the loop — make every path "
                    "acquire these locks in one global order")
            for edge in report["missing_edges"]:
                # Anchor at the SRC lock's construction site: the gap
                # is in what its critical section calls, so that is
                # where a pragma justifying the opaque call belongs
                # (and one pragma covers every edge out of that lock).
                path, line = _split_key(edge["src"])
                yield _anchor(
                    self, program, path, line,
                    f"runtime lock sanitizer observed "
                    f"`{_owner(analysis, edge['src'])}` -> "
                    f"`{_owner(analysis, edge['dst'])}` "
                    "(acquired-while-held), but the static order graph "
                    "has no such edge; the static pass is missing a "
                    "call path — teach locksets.py about it or record "
                    "the ordering intent here")
        for cycle in analysis.cycles():
            if not cycle:
                continue
            edge_keys = {(e["src"], e["dst"]) for e in cycle}
            dynamic = any(edge_keys <= s for s in confirmed_edge_sets)
            chains = "; ".join(
                f"`{_owner(analysis, e['src'])}` -> "
                f"`{_owner(analysis, e['dst'])}` at {e['where']} "
                f"in {e['func']}" + (f" ({e['via']})" if e["via"] else "")
                for e in cycle)
            path, line = _split_key(cycle[0]["where"])
            severity = ("DEADLOCK CONFIRMED at runtime by locksan"
                        if dynamic else "potential deadlock")
            yield _anchor(
                self, program, path, line,
                f"{severity}: lock-order cycle — {chains}; make every "
                "path acquire these locks in one global order (or drop "
                "one lock from the nested scope)")


@core.register_program
class UnguardedSharedMutationRule(core.ProgramRule):
    id = "unguarded-shared-mutation"
    category = "concurrency"
    description = ("attribute/global is written under a lock at several "
                   "sites but mutated bare here (callers' held locks "
                   "credited interprocedurally)")

    def check_program(self, program, analysis: locksets.LockAnalysis,
                      config: core.Config,
                      locksan_graph: Optional[dict] = None
                      ) -> Iterator[core.Violation]:
        by_target: Dict[str, List[Tuple[locksets.Write, frozenset]]] = {}
        for conc in analysis.funcs.values():
            for write in conc.writes:
                held = frozenset(analysis.effective_held(conc, write.held))
                by_target.setdefault(write.target, []).append((write, held))
        for target, writes in sorted(by_target.items()):
            guarded = [(w, h) for w, h in writes if h and not w.setup]
            bare = [(w, h) for w, h in writes if not h and not w.setup]
            if not bare or \
                    len(guarded) < config.concurrency_min_guarded_sites:
                continue
            lock_votes = Counter()
            for _, held in guarded:
                for key in held:
                    lock_votes[key] += 1
            dominant, votes = lock_votes.most_common(1)[0]
            if votes < config.concurrency_min_guarded_sites:
                continue
            example = guarded[0][0]
            example_path = analysis.funcs[example.func].info.module.path
            for write, _ in bare:
                mod = analysis.funcs[write.func].info.module
                verb = ("mutated in place" if write.kind == "mutate"
                        else "written")
                yield _anchor(
                    self, program, mod.path, write.line,
                    f"`{target.partition(':')[2]}` is written under "
                    f"`{_owner(analysis, dominant)}` at {votes} site(s) "
                    f"(e.g. {example_path}:{example.line}) but {verb} "
                    f"here in {write.func.partition(':')[2]} with no "
                    "lock held; take the lock, or pragma with the "
                    "ownership argument if this access is "
                    "single-thread-confined")
