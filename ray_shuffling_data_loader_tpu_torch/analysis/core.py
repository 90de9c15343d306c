"""Core of the port's per-file static checker (rsdl-lint for the port).

The port's own copy of the JAX package's ``analysis/core.py``: an
AST-walking rule registry, per-rule configuration, inline
``# rsdl-lint: disable=<rule>`` pragmas, a checked-in baseline file for
grandfathered findings, and human/JSON reporting with a stable
exit-code contract (0 clean, 1 violations, 2 usage/internal error).

Rules live in the sibling ``rules_*`` modules and register themselves
via :func:`register`; the Torch rule set (``rules_torch``) takes the
place of the JAX package's ``rules_jax``. Everything here is
stdlib-only, so the checker runs where neither torch nor a card is.
:class:`Config`'s path defaults name the port's layout.

Two registries coexist: per-file :class:`Rule` subclasses (one parsed
module at a time) and whole-program :class:`ProgramRule` subclasses
(``rules_concurrency``'s ``inconsistent-lock-order`` and
``unguarded-shared-mutation``, which need the cross-module call graph
from ``callgraph.py``/``locksets.py`` and only run under
``--concurrency``). Both share the same pragma, baseline, and reporting
machinery — a program-rule violation is still anchored to one
``path:line`` and suppressible there.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import os
import re
import tokenize
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence, Set,
                    Tuple)

#: Exit-code contract of the CLI.
EXIT_CLEAN = 0
EXIT_VIOLATIONS = 1
EXIT_ERROR = 2


@dataclasses.dataclass
class Violation:
    """One finding: ``path:line:col: rule message``."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    snippet: str = ""  # stripped source line, used for baselining

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Config:
    """Per-rule knobs, overridable via ``--config <json>`` (keys are the
    field names; unknown keys are an error so typos fail loudly)."""

    # Attribute/variable names treated as locks for the lock rules.
    lock_name_regex: str = r"(?i)(lock|mutex)"
    # Attribute calls that block indefinitely when called with no
    # timeout while a lock is held.
    blocking_methods: Tuple[str, ...] = ("result", "join", "recv")
    # ``.get(...)`` blocks unless it passes ``timeout=`` or
    # ``block=False`` — queue.get / MultiQueue.get / BoundedFifo.get.
    blocking_get_methods: Tuple[str, ...] = ("get",)
    # ``.get`` is only treated as a BLOCKING get when its receiver looks
    # like a queue (otherwise every dict.get would flag) or the call
    # passes ``block=True`` explicitly.
    queue_name_regex: str = r"(?i)(queue|fifo|inbox)"
    # Function tails (``ex.wait``, ``time.sleep``) that block under a
    # lock when called without a timeout kwarg.
    blocking_functions: Tuple[str, ...] = ("wait", "sleep")
    # Method names whose call marks a function as a one-shot transport
    # consumer (it must be submitted via submit_once, never submit).
    oneshot_recv_methods: Tuple[str, ...] = ("recv",)
    # Extra function names to treat as one-shot consumers even without a
    # visible ``.recv`` call (cross-module consumers).
    oneshot_functions: Tuple[str, ...] = ()
    # fnmatch patterns of function names whose loops are prefetch/ingest
    # hot paths: host syncs inside their loops stall the pipeline.
    hot_loop_functions: Tuple[str, ...] = ("_persistent_producer",
                                           "_produce_epoch_tables",
                                           "*prefetch*", "producer",
                                           "*hot_loop*")
    # fnmatch patterns (against the repo-relative posix path) of files
    # whose device placements must name a device (the SPMD layers).
    sharded_path_globs: Tuple[str, ...] = ("*parallel/*",)
    # fnmatch patterns of the pipeline's hot-path modules, where copies
    # need a reason (copy-in-hot-path; fnmatch ``*`` crosses
    # directories, so ``*/dataset.py`` matches the module at any depth
    # but not ``device_dataset.py``).
    hot_path_globs: Tuple[str, ...] = (
        "*/shuffle.py", "shuffle.py", "*/dataset.py", "dataset.py",
        "*/device_dataset.py", "device_dataset.py")
    # Module-level numpy.random draws (global, unseeded RNG state).
    unseeded_random_names: Tuple[str, ...] = (
        "rand", "randn", "randint", "random", "random_sample", "ranf",
        "sample", "choice", "shuffle", "permutation", "bytes", "normal",
        "uniform", "standard_normal", "exponential", "poisson", "binomial",
        "beta", "gamma", "seed")
    # stdlib ``random`` module draws (same hazard).
    stdlib_random_names: Tuple[str, ...] = (
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "normalvariate", "seed")
    # fnmatch patterns of files whose literal rsdl_* metric names must
    # come from runtime/metric_names.py (library code; tests may mint
    # throwaway test_* names, which the rule ignores by prefix anyway).
    metric_catalog_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*", "chip_smoke.py")
    # fnmatch patterns of library files where fresh (seed, epoch, task)
    # key-derivation arithmetic is a lineage-outside-plan violation —
    # resume/recovery must query plan/ir.py, not re-derive keys.
    lineage_plan_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*",)
    # Files exempt from lineage-outside-plan: the plan IR itself (the
    # one home of the arithmetic) and the RNG-stream primitive the plan
    # contract is defined in terms of.
    lineage_plan_exempt_globs: Tuple[str, ...] = (
        "*ray_shuffling_data_loader_tpu_torch/plan/*",
        "*ray_shuffling_data_loader_tpu_torch/partition.py")
    # fnmatch patterns of library files where dataset bytes must flow
    # through storage/ (the tiered cache + chaos-site boundary), never
    # raw pyarrow.parquet reads.
    dataset_read_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*", "bench.py")
    # Files exempt from raw-dataset-read: the storage plane itself and
    # the low-level fileio primitive it is built on.
    dataset_read_exempt_globs: Tuple[str, ...] = (
        "*ray_shuffling_data_loader_tpu_torch/storage/*",
        "*ray_shuffling_data_loader_tpu_torch/utils/fileio.py")
    # fnmatch patterns of library files where counting epochs with
    # range(num_epochs) (or literal-epoch indexing of per-epoch state)
    # is a static-epoch-assumption violation — the epoch sequence
    # belongs to plan/ so unbounded streaming input keeps working.
    static_epoch_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*",)
    # Exempt: plan/ enumerates the schedule (epoch_range /
    # static_epoch_specs live there) and streaming/ derives epochs from
    # windows by construction.
    static_epoch_exempt_globs: Tuple[str, ...] = (
        "*ray_shuffling_data_loader_tpu_torch/plan/*",
        "*ray_shuffling_data_loader_tpu_torch/streaming/*")
    # fnmatch patterns of library files where arithmetic over a frozen
    # world size (range(..world..) / len(self.addresses) fan-outs) is a
    # fixed-world-assumption violation — world composition belongs to
    # membership/ (views) and plan/ (rebalance_spans /
    # reduce_placement), so an elastic resize keeps working.
    fixed_world_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*",)
    # Exempt: membership/ defines views, plan/ owns the rebalance
    # arithmetic, and the transport's address table is the dial list
    # membership layers liveness on top of.
    fixed_world_exempt_globs: Tuple[str, ...] = (
        "*ray_shuffling_data_loader_tpu_torch/membership/*",
        "*ray_shuffling_data_loader_tpu_torch/plan/*")
    # fnmatch patterns of library files where literal queue->shard
    # arithmetic (.. % num_shards) or indexed shard-address lookups
    # (shard_map.addresses[shard]) are a shard-affinity-assumption
    # violation — placement moves under live rebalancing (rebalance/),
    # so routing must query ShardMap.shard_for_queue /
    # address_for_queue at call time.
    shard_affinity_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*",)
    # Exempt: plan/ owns the placement arithmetic, rebalance/ journals
    # and rewrites it, and the serving plane implements the MOVED
    # redirect protocol itself (its cached routes are invalidated by
    # the redirect, by construction).
    shard_affinity_exempt_globs: Tuple[str, ...] = (
        "*ray_shuffling_data_loader_tpu_torch/plan/*",
        "*ray_shuffling_data_loader_tpu_torch/rebalance/*",
        "*ray_shuffling_data_loader_tpu_torch/multiqueue_service.py")
    # fnmatch patterns of files included in the whole-program
    # concurrency pass (--concurrency). Library code only: tests spin
    # throwaway threads/locks with no cross-module ordering contract.
    concurrency_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/*",)
    # ...minus these: the runtime lock sanitizer sits BELOW the lock
    # abstraction (its proxies wrap and forward acquire/release/wait),
    # so treating its classes as call-resolution targets invents
    # edges from every condition-wait in the package.
    concurrency_exclude_globs: Tuple[str, ...] = ("*locksan.py",)
    # unguarded-shared-mutation flags a bare write only when at least
    # this many OTHER sites write the same attribute under a lock.
    concurrency_min_guarded_sites: int = 1
    # fnmatch patterns of files whose serving/storage entry points must
    # be tenant-aware (tenancy/: every byte in flight attributable).
    tenancy_entry_globs: Tuple[str, ...] = (
        "ray_shuffling_data_loader_tpu_torch/multiqueue_service.py",
        "ray_shuffling_data_loader_tpu_torch/storage/*",
        "ray_shuffling_data_loader_tpu_torch/streaming/runner.py",
        "ray_shuffling_data_loader_tpu_torch/tenancy/*")
    # fnmatch patterns of function names that ARE tenancy entry points:
    # they accept new work into a shared plane, so they must take a
    # tenant-ish parameter or resolve tenancy.current_tenant().
    tenancy_entry_names: Tuple[str, ...] = (
        "serve_queue", "serve_pipeline", "server_config", "register",
        "make_prefetcher")
    # fnmatch patterns of files that assemble the bench JSON record —
    # their numeric emissions must be gated by a rsdl_bench_diff rule
    # or declared informational (rules_bench.py).
    bench_record_globs: Tuple[str, ...] = ("bench.py", "*/bench.py")

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        coerced = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in data.items()
        }
        return cls(**coerced)


class Rule:
    """One invariant checker. Subclasses set ``id``/``category``/
    ``description`` and implement :meth:`check` as a generator of
    :class:`Violation` over a parsed module."""

    id: str = ""
    category: str = ""
    description: str = ""

    def check(self, tree: ast.Module,
              ctx: "FileContext") -> Iterator[Violation]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Rule {self.id}>"


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and index the rule by id."""
    rule = cls()
    assert rule.id and rule.id not in _REGISTRY, rule.id
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> Dict[str, Rule]:
    """The registry, with the built-in rule modules imported."""
    from ray_shuffling_data_loader_tpu_torch.analysis import (  # noqa: F401
        rules_arrow, rules_bench, rules_executor, rules_hygiene, rules_lock,
        rules_metrics, rules_perf, rules_plan, rules_runtime, rules_storage,
        rules_telemetry, rules_tenancy, rules_torch)
    return dict(_REGISTRY)


class ProgramRule:
    """One whole-program invariant checker (``--concurrency`` pass).

    Unlike :class:`Rule`, ``check_program`` sees every module of the
    package at once (a ``callgraph.Program``) plus the finished
    ``locksets.LockAnalysis``; each yielded :class:`Violation` must
    still anchor to a single real ``path:line`` so pragmas and the
    baseline apply exactly as they do for per-file rules.
    """

    id: str = ""
    category: str = ""
    description: str = ""

    def check_program(self, program, analysis, config: "Config",
                      locksan_graph: Optional[dict] = None
                      ) -> Iterator[Violation]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<ProgramRule {self.id}>"


_PROGRAM_REGISTRY: Dict[str, ProgramRule] = {}


def register_program(cls):
    """Class decorator: instantiate and index a whole-program rule."""
    rule = cls()
    assert rule.id and rule.id not in _PROGRAM_REGISTRY, rule.id
    _PROGRAM_REGISTRY[rule.id] = rule
    return cls


def program_rules() -> Dict[str, ProgramRule]:
    """The whole-program registry (kept separate from :func:`all_rules`
    so per-file tooling — fixture-coverage tests, --select over file
    rules — keeps its closed-world assumption)."""
    from ray_shuffling_data_loader_tpu_torch.analysis import (  # noqa: F401
        rules_concurrency)
    return dict(_PROGRAM_REGISTRY)


class FileContext:
    """Everything a rule needs about the file under analysis."""

    def __init__(self, path: str, source: str, config: Config):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.config = config

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def violation(self, rule: Rule, node: ast.AST, message: str) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Violation(rule=rule.id, path=self.path, line=line, col=col,
                         message=message, snippet=self.line_text(line))

    def path_matches(self, globs: Sequence[str]) -> bool:
        return any(fnmatch.fnmatch(self.path, g) for g in globs)


# ---------------------------------------------------------------------------
# AST helpers shared by the rule modules
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for an Attribute/Name chain; unknown bases become ``?``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def keyword_names(call: ast.Call) -> Set[str]:
    return {kw.arg for kw in call.keywords if kw.arg is not None}


def get_keyword(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def is_constant(node: Optional[ast.expr], value) -> bool:
    return isinstance(node, ast.Constant) and node.value is value


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

# Matched anywhere inside a COMMENT token (never in strings/docstrings),
# so a pragma can follow its justification prose on the same line.
PRAGMA_RE = re.compile(
    r"rsdl-lint\s*:\s*(disable-file|disable)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*|all)")


class Pragmas:
    """Inline suppressions.

    ``# rsdl-lint: disable=<rule>[,<rule>...]`` on a line suppresses
    those rules on that line; on a line of its own it also covers the
    next line (for statements whose flagged call starts one line down).
    ``# rsdl-lint: disable-file=<rule>`` suppresses for the whole file.
    ``all`` disables every rule.
    """

    def __init__(self, source: str):
        self.file_disables: Set[str] = set()
        self.line_disables: Dict[int, Set[str]] = {}
        self.standalone_lines: Set[int] = set()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                match = PRAGMA_RE.search(tok.string)
                if match is None:
                    continue
                rules = {r.strip() for r in match.group(2).split(",")}
                if match.group(1) == "disable-file":
                    self.file_disables |= rules
                else:
                    line = tok.start[0]
                    self.line_disables.setdefault(line, set()).update(rules)
                    if tok.line[:tok.start[1]].strip() == "":
                        self.standalone_lines.add(line)
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # the AST parse reports the real problem

    def _disabled_at(self, line: int) -> Set[str]:
        return self.line_disables.get(line, set())

    def suppresses(self, violation: Violation) -> bool:
        for rules in (self.file_disables,
                      self._disabled_at(violation.line)):
            if violation.rule in rules or "all" in rules:
                return True
        prev = violation.line - 1
        if prev in self.standalone_lines:
            rules = self._disabled_at(prev)
            return violation.rule in rules or "all" in rules
        return False


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def check_source(source: str, path: str, config: Optional[Config] = None,
                 rules: Optional[Iterable[Rule]] = None) -> List[Violation]:
    """Run rules over one source text; applies pragmas, not baselines."""
    config = config or Config()
    if rules is None:
        rules = all_rules().values()
    ctx = FileContext(path, source, config)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation(rule="parse-error", path=ctx.path,
                          line=e.lineno or 1, col=(e.offset or 1) - 1,
                          message=f"could not parse: {e.msg}")]
    pragmas = Pragmas(source)
    out: List[Violation] = []
    for rule in rules:
        for violation in rule.check(tree, ctx):
            if not pragmas.suppresses(violation):
                out.append(violation)
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out


def iter_python_files(paths: Sequence[str],
                      root: Optional[str] = None) -> Iterator[str]:
    """Expand files/dirs into .py files, skipping hidden and cache dirs."""
    for path in paths:
        full = os.path.join(root, path) if root else path
        if os.path.isfile(full):
            yield full
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def check_paths(paths: Sequence[str], config: Optional[Config] = None,
                rules: Optional[Iterable[Rule]] = None,
                root: Optional[str] = None
                ) -> Tuple[List[Violation], int]:
    """Run the analyzer over files/directories.

    Returns ``(violations, files_checked)``. Paths inside ``root`` are
    reported relative to it so baselines are machine-independent.
    """
    base = os.path.abspath(root or os.getcwd())
    violations: List[Violation] = []
    count = 0
    for filename in iter_python_files(paths, root=root):
        count += 1
        rel = os.path.relpath(os.path.abspath(filename), base)
        if rel.startswith(".."):
            rel = filename  # outside root: report as given
        try:
            with open(filename, "r", encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            violations.append(Violation(
                rule="read-error", path=rel.replace(os.sep, "/"), line=1,
                col=0, message=f"could not read file: {e}"))
            continue
        violations.extend(check_source(source, rel, config, rules))
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations, count


def check_program_paths(paths: Sequence[str],
                        config: Optional[Config] = None,
                        rules: Optional[Iterable[ProgramRule]] = None,
                        root: Optional[str] = None,
                        locksan_graph: Optional[dict] = None
                        ) -> Tuple[List[Violation], "object"]:
    """Run the whole-program concurrency pass over the library files
    among ``paths`` (those matching ``config.concurrency_globs``).

    Returns ``(violations, analysis)`` — the ``LockAnalysis`` rides
    along so the CLI can emit the static order graph. Pragmas apply
    per anchored file/line exactly as in :func:`check_source`;
    baselines are the caller's job (the CLI applies one pass over the
    combined finding list).
    """
    from ray_shuffling_data_loader_tpu_torch.analysis import (callgraph,
                                                              locksets)
    config = config or Config()
    if rules is None:
        rules = program_rules().values()
    program = callgraph.Program.load(paths, root=root)
    for path in list(program.modules_by_path):
        if not any(fnmatch.fnmatch(path, g)
                   for g in config.concurrency_globs) or \
                any(fnmatch.fnmatch(path, g)
                    for g in config.concurrency_exclude_globs):
            mod = program.modules_by_path.pop(path)
            program.modules.pop(mod.name, None)
    program.index()
    analysis = locksets.analyze(program, config)
    pragmas = {mod.path: Pragmas(mod.source)
               for mod in program.modules.values()}
    out: List[Violation] = []
    for rule in rules:
        for violation in rule.check_program(program, analysis, config,
                                            locksan_graph=locksan_graph):
            file_pragmas = pragmas.get(violation.path)
            if file_pragmas is None or \
                    not file_pragmas.suppresses(violation):
                out.append(violation)
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out, analysis
