"""The port's per-file checker (``ray_shuffling_data_loader_tpu_torch.
analysis``) against the JAX package's: the same findings for every rule
both have, over the JAX package's whole gate, with the port's
``Config`` set to the JAX layout (raw findings and pragmas alike); the
JAX package's rule fixtures; the Torch rules' fixtures; the CLI's exit
codes; and the port's own gate, clean with an empty baseline.

Fixtures live in string literals, which the checkers' AST walk never
sees when they scan this file.
"""

import ast
import dataclasses
import glob
import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from ray_shuffling_data_loader_tpu.analysis import cli as jcli
from ray_shuffling_data_loader_tpu.analysis import core as jcore
from ray_shuffling_data_loader_tpu.analysis import rules_perf as jrules_perf
from ray_shuffling_data_loader_tpu_torch.analysis import cli as tcli
from ray_shuffling_data_loader_tpu_torch.analysis import core as tcore

import test_analysis as jtests

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The port's gate: its package, the smoke, its tests and their helpers.
PORT_GATE = ["ray_shuffling_data_loader_tpu_torch", "chip_smoke.py",
             "tests/test_torch_port_*.py", "tests/torch_port_*.py"]
PORT_BASELINE = os.path.join(REPO_ROOT, ".rsdl-lint-torch-baseline.json")
TORCH_RULES = {"torch-host-sync", "cuda-device-implicit"}
JAX_RULES = {"jax-host-sync", "device-put-unsharded"}


def _jax_layout() -> tcore.Config:
    """The port's Config with the JAX package's path defaults."""
    jax_cfg = jcore.Config()
    jax_fields = {f.name for f in dataclasses.fields(jcore.Config)}
    kwargs = {}
    for field in dataclasses.fields(tcore.Config):
        if field.name == "hot_path_globs":
            kwargs[field.name] = tuple(jrules_perf.HOT_PATH_GLOBS)
        else:
            assert field.name in jax_fields, field.name
            kwargs[field.name] = getattr(jax_cfg, field.name)
    return tcore.Config(**kwargs)


def test_rule_sets_differ_by_the_torch_rules_alone():
    port, jax_ = set(tcore.all_rules()), set(jcore.all_rules())
    assert port - jax_ == TORCH_RULES
    assert jax_ - port == JAX_RULES
    assert len(port & jax_) == 24


def _gate_files():
    for path in jcore.iter_python_files(jtests.GATE_PATHS, root=REPO_ROOT):
        yield os.path.relpath(path, REPO_ROOT).replace(os.sep, "/"), path


def _findings(core, rules, tree, rel, source, config):
    ctx = core.FileContext(rel, source, config)
    pragmas = core.Pragmas(source)
    out = []
    for rule in rules:
        for v in rule.check(tree, ctx):
            out.append((v.rule, v.path, v.line, v.col,
                        pragmas.suppresses(v)))
    return sorted(out)


def test_shared_rules_find_the_same_over_the_jax_gate():
    shared = sorted(set(tcore.all_rules()) & set(jcore.all_rules()))
    port_rules = [tcore.all_rules()[r] for r in shared]
    jax_rules = [jcore.all_rules()[r] for r in shared]
    port_cfg, jax_cfg = _jax_layout(), jcore.Config()
    got_all, files = [], 0
    for rel, path in _gate_files():
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=rel)
        got = _findings(tcore, port_rules, tree, rel, source, port_cfg)
        want = _findings(jcore, jax_rules, tree, rel, source, jax_cfg)
        assert got == want, rel
        got_all += got
        files += 1
    # Not vacuous: the JAX tree holds pragma'd findings of many rules.
    assert files > 100
    assert len({rule for rule, *_ in got_all}) >= 10
    assert all(suppressed for *_, suppressed in got_all)


def _lint(core, source, path, config=None):
    return [v.rule for v in core.check_source(textwrap.dedent(source), path,
                                              config)]


_SHARED_CASES = [c for c in jtests.CASES if c[0] not in JAX_RULES]


@pytest.mark.parametrize("rule_id,bad,good,kwargs", _SHARED_CASES,
                         ids=[f"{c[0]}-{i}"
                              for i, c in enumerate(_SHARED_CASES)])
def test_jax_fixtures_with_the_jax_layout(rule_id, bad, good, kwargs):
    path = kwargs.get("path", "pkg/mod.py")
    config = _jax_layout()
    assert rule_id in _lint(tcore, bad, path, config)
    assert rule_id not in _lint(tcore, good, path, config)


# ---------------------------------------------------------------------------
# The Torch rules
# ---------------------------------------------------------------------------

HOST_SYNC_BAD = {
    "compile_decorator": """
        import torch

        @torch.compile
        def step(x):
            return float(x.sum())
    """,
    "compile_factory": """
        import torch

        @torch.compile(mode="max-autotune")
        def step(x):
            return x.sum().item()
    """,
    "compile_call": """
        import torch

        def step(x):
            return x.cpu() * 2

        fast = torch.compile(step)
    """,
    "script": """
        import torch

        @torch.jit.script
        def step(x):
            return x.tolist()
    """,
    "numpy_in_compiled_lambda": """
        import numpy as np
        import torch

        fast = torch.compile(lambda x: np.asarray(x))
    """,
    "graph_capture": """
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = (x * 2).numpy()
            return y
    """,
    "hot_loop_item": """
        def _persistent_producer(batches, put):
            for b in batches:
                put(b.sum().item())
    """,
    "hot_loop_synchronize": """
        import torch

        def _produce_epoch_tables(tables, put):
            for t in tables:
                put(t.to("cuda", non_blocking=True))
                torch.cuda.synchronize()
    """,
    "hot_loop_event_wait": """
        def my_prefetch(batches, event):
            while batches:
                event.synchronize()
                batches.pop()
    """,
}

HOST_SYNC_OK = {
    "compiled_pure": """
        import torch

        @torch.compile
        def step(x):
            return (x * 2).sum()

        def report(x):
            return float(step(x))
    """,
    "uncompiled": """
        def step(x):
            return x.sum().item()
    """,
    "hot_loop_host_work": """
        import numpy as np

        def _produce_epoch_tables(tables, put):
            for t in tables:
                put(np.asarray(t).numpy())
    """,
    "sync_outside_the_loop": """
        import torch

        def _persistent_producer(batches, put):
            for b in batches:
                put(b)
            torch.cuda.synchronize()
    """,
}

DEVICE_BAD = {
    "cuda": "def f(t):\n    return t.cuda()\n",
    "to_cuda": "def f(t):\n    return t.to('cuda')\n",
    "to_device_kw": "def f(t):\n    return t.to(device='cuda')\n",
    "torch_device": ("import torch\n\n"
                     "DEVICE = torch.device('cuda')\n"),
}

DEVICE_OK = {
    "cuda_index": "def f(t, r):\n    return t.cuda(r)\n",
    "cuda_device_kw": "def f(t, r):\n    return t.cuda(device=r)\n",
    "to_indexed": "def f(t, r):\n    return t.to(f'cuda:{r}')\n",
    "to_zero": "def f(t):\n    return t.to('cuda:0')\n",
    "to_dtype": "import torch\n\ndef f(t):\n    return t.to(torch.float32)\n",
    "torch_device_index": ("import torch\n\n"
                           "def f(r):\n    return torch.device('cuda', r)\n"),
}


@pytest.mark.parametrize("case", sorted(HOST_SYNC_BAD))
def test_torch_host_sync_flags(case):
    assert "torch-host-sync" in _lint(tcore, HOST_SYNC_BAD[case],
                                      "pkg/mod.py")


@pytest.mark.parametrize("case", sorted(HOST_SYNC_OK))
def test_torch_host_sync_passes(case):
    assert "torch-host-sync" not in _lint(tcore, HOST_SYNC_OK[case],
                                          "pkg/mod.py")


@pytest.mark.parametrize("case", sorted(DEVICE_BAD))
def test_cuda_device_implicit_flags_in_spmd_paths(case):
    source = DEVICE_BAD[case]
    assert "cuda-device-implicit" in _lint(tcore, source,
                                           "pkg/parallel/mod.py")
    # Outside the SPMD layers a trainer picks its one card freely.
    assert "cuda-device-implicit" not in _lint(tcore, source, "pkg/mod.py")


@pytest.mark.parametrize("case", sorted(DEVICE_OK))
def test_cuda_device_implicit_passes(case):
    assert "cuda-device-implicit" not in _lint(tcore, DEVICE_OK[case],
                                               "pkg/parallel/mod.py")


def test_torch_rule_pragma_suppresses():
    source = HOST_SYNC_BAD["hot_loop_item"].replace(
        "put(b.sum().item())",
        "put(b.sum().item())  # rsdl-lint: disable=torch-host-sync")
    assert "torch-host-sync" not in _lint(tcore, source, "pkg/mod.py")


# ---------------------------------------------------------------------------
# The CLI and the gate
# ---------------------------------------------------------------------------

_CLI_RUNS = {
    "clean": ["clean.py"],
    "dirty": ["dirty.py"],
    "dirty_json": ["dirty.py", "--format", "json"],
    "missing_path": ["no/such/path.py"],
    "unknown_rule": ["dirty.py", "--select", "not-a-rule"],
    "disabled": ["dirty.py", "--disable", "arrow-concat-promote"],
    "selected_other": ["dirty.py", "--select", "unseeded-random"],
    "bad_config": ["dirty.py", "--config", "bad.json"],
    "list_rules": ["--list-rules"],
}


@pytest.mark.parametrize("run", sorted(_CLI_RUNS))
def test_cli_exit_codes_equal_jax(tmp_path, monkeypatch, capsys, run):
    (tmp_path / "dirty.py").write_text(textwrap.dedent(jtests.CONCAT_BAD))
    (tmp_path / "clean.py").write_text(textwrap.dedent(jtests.CONCAT_OK))
    (tmp_path / "bad.json").write_text(json.dumps({"no_such_knob": 1}))
    monkeypatch.chdir(tmp_path)
    args = _CLI_RUNS[run]
    got = tcli.main(list(args))
    port_out = capsys.readouterr().out
    want = jcli.main(list(args))
    jax_out = capsys.readouterr().out
    assert got == want, run
    assert got in (tcore.EXIT_CLEAN, tcore.EXIT_VIOLATIONS,
                   tcore.EXIT_ERROR)
    if "--format" in args:
        assert json.loads(port_out) == json.loads(jax_out)


def test_cli_baseline_roundtrip(tmp_path, monkeypatch, capsys):
    (tmp_path / "dirty.py").write_text(textwrap.dedent(jtests.CONCAT_BAD))
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["dirty.py", "--write-baseline"]) == tcore.EXIT_CLEAN
    assert os.path.exists(tcli.DEFAULT_BASELINE)
    assert tcli.main(["dirty.py"]) == tcore.EXIT_CLEAN
    assert tcli.main(["dirty.py", "--no-baseline"]) \
        == tcore.EXIT_VIOLATIONS
    capsys.readouterr()


def test_port_gate_is_clean_with_an_empty_baseline(monkeypatch):
    with open(PORT_BASELINE, encoding="utf-8") as f:
        assert json.load(f) == {"entries": [], "version": 1}
    monkeypatch.chdir(REPO_ROOT)
    paths = [p for pattern in PORT_GATE for p in sorted(glob.glob(pattern))]
    assert "chip_smoke.py" in paths and len(paths) > 40
    assert tcli.main(["--baseline", PORT_BASELINE] + paths) \
        == tcore.EXIT_CLEAN


def test_module_entry_point_flags_a_bare_concat(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import pyarrow as pa\n\n\n"
                     "def f(c):\n    return pa.concat_tables(c)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.analysis",
         str(probe)], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == tcore.EXIT_VIOLATIONS, proc.stderr
    assert "arrow-concat-promote" in proc.stdout


def test_importing_the_entry_point_runs_nothing():
    module = importlib.import_module(
        "ray_shuffling_data_loader_tpu_torch.analysis.__main__")
    assert callable(module.main)
