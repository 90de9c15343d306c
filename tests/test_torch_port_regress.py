"""The port's round forensics (``runtime/regress.py``) against the JAX
package's: the JAX tests' synthetic rounds (``make_round``) and pairs of
committed round capsules give equal ``diff_rounds`` reports and equal
``render_report`` lines; the pieces (``bucket_overlap``,
``provenance_warnings``, ``find_capsule``) agree; ``self_check`` passes;
the ``python -m`` entry point and the load-by-path fallback work."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from ray_shuffling_data_loader_tpu.runtime import regress as jregress
from ray_shuffling_data_loader_tpu_torch.runtime import regress as tregress

import test_regress as jtests
from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = [sys.executable, "-m",
         "ray_shuffling_data_loader_tpu_torch.runtime.regress"]

#: Round pairs built by the JAX tests' ``make_round``: (base kwargs, cur
#: kwargs), one per scenario those tests pin.
SYNTHETIC = {
    "planted_stage": ({}, dict(value=640.0, reduce_s=0.30,
                               reduce_shifted=True,
                               env={"RSDL_PLANTED_KNOB": "1"})),
    "epoch_normalization": (dict(n_epochs=4), dict(n_epochs=2)),
    "distribution_noise": ({}, dict(reduce_shifted=True, noise=2)),
    "policy_env": (dict(policy={"queue_maxsize": 4, "gone": 1}),
                   dict(policy={"queue_maxsize": 8},
                        env={"RSDL_NEW": "x"})),
    "capsule_less": (dict(capsule=False,
                          extra={"stream_rows_per_sec": 24000.0}),
                     dict(value=900.0, capsule=False,
                          extra={"stream_rows_per_sec": 12000.0})),
    "provenance": (
        dict(capsule=False, provenance={
            "git_rev": "a" * 40, "tree_dirty": False, "host": "h1",
            "cpu_model": "Xeon 2.10GHz", "host_cpus": 1}),
        dict(capsule=False, provenance={
            "git_rev": "b" * 40, "tree_dirty": True, "host": "h2",
            "cpu_model": "EPYC 2.45GHz", "host_cpus": 1})),
    "one_capsule": ({}, dict(value=700.0, capsule=False)),
}


def _pair(tmp_path, name):
    base_kw, cur_kw = SYNTHETIC[name]
    return (jtests.make_round(str(tmp_path), "base", **base_kw),
            jtests.make_round(str(tmp_path), "cur", **cur_kw))


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_rounds_give_the_jax_report(name, tmp_path):
    base, cur = _pair(tmp_path, name)
    got = tregress.diff_rounds(base, cur)
    want = jregress.diff_rounds(base, cur)
    assert got == want
    assert tregress.render_report(got) == jregress.render_report(want)
    if name in ("planted_stage", "policy_env", "capsule_less"):
        assert got["suspects"]
    if SYNTHETIC[name][0].get("capsule", True) and \
            SYNTHETIC[name][1].get("capsule", True):
        assert got["mode"] == "capsule"
    else:
        assert got["mode"] == "record-only"


@pytest.mark.parametrize("name,speedup,max_suspects", [
    ("planted_stage", 4.0, 2), ("policy_env", 1.5, 1)])
def test_options_give_the_jax_report(name, speedup, max_suspects,
                                     tmp_path):
    base, cur = _pair(tmp_path, name)
    kw = dict(whatif_speedup=speedup, max_suspects=max_suspects)
    got = tregress.diff_rounds(base, cur, **kw)
    assert got == jregress.diff_rounds(base, cur, **kw)
    assert len(got["suspects"]) == max_suspects


#: Committed round capsules (each holds its ``record.json``; both
#: traced and with an exposition), paired base -> cur.
CAPSULE_PAIRS = [("bench-7985-r", "bench-7343-r"),
                 ("bench-16406-r", "bench-19096-r")]


def _committed_round(tmp_path, stem):
    """The committed capsule copied into ``tmp_path`` with its record
    beside it as ``<stem>.json`` (the sibling-directory convention)."""
    shutil.copytree(os.path.join(REPO_ROOT, f"{stem}.capsule"),
                    os.path.join(tmp_path, f"{stem}.capsule"))
    record = os.path.join(tmp_path, f"{stem}.json")
    shutil.copy(os.path.join(REPO_ROOT, f"{stem}.capsule", "record.json"),
                record)
    return record


@pytest.mark.parametrize("base_stem,cur_stem", CAPSULE_PAIRS)
def test_committed_capsules_give_the_jax_report(base_stem, cur_stem,
                                                tmp_path):
    base = _committed_round(tmp_path, base_stem)
    cur = _committed_round(tmp_path, cur_stem)
    got = tregress.diff_rounds(base, cur)
    want = jregress.diff_rounds(base, cur)
    assert got["mode"] == want["mode"] == "capsule"
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert tregress.render_report(got) == jregress.render_report(want)
    # Not vacuous: real traces and expositions on both sides.
    assert got["critical_path_diff"] and got["distribution_diff"]
    assert got["base"]["epochs_traced"] and got["cur"]["epochs_traced"]


def test_capsule_pairs_name_what_moved(tmp_path):
    base = _committed_round(tmp_path, "bench-7985-r")
    cur = _committed_round(tmp_path, "bench-7343-r")
    report = tregress.diff_rounds(base, cur)
    rows = {r["stage"]: r for r in report["critical_path_diff"]}
    assert rows["device_transfer"]["entered"]
    assert rows["map_read"]["delta_ms_per_epoch"] > 100
    map_read = [r for r in report["distribution_diff"]
                if r["labels"].get("stage") == "map_read"]
    assert map_read[0]["significant"] and map_read[0]["shift_pct"] > 100
    assert report["policy_diff"]["changed"]["executor_backend"] == \
        ["process", "auto"]
    assert report["env_diff"]["disappeared"] == {
        "RSDL_EXECUTOR_BACKEND": "process"}
    base = _committed_round(tmp_path, "bench-16406-r")
    cur = _committed_round(tmp_path, "bench-19096-r")
    rows = {r["stage"]: r
            for r in tregress.diff_rounds(base, cur)["critical_path_diff"]}
    assert rows["reduce"]["left"]


@pytest.mark.parametrize("base,cur", [
    ({0.1: 10.0, 0.2: 20.0}, {0.1: 10.0, 0.2: 20.0}),
    ({0.1: 30.0, 0.2: 0.0}, {0.1: 0.0, 0.2: 30.0}),
    ({0.1: 1.0}, {0.2: 1.0}),
    ({0.1: 3.0, 0.4: 5.0, 0.8: 1.0}, {0.1: 1.0, 0.4: 2.0, 1.6: 9.0}),
])
def test_bucket_overlap_equals_jax(base, cur):
    assert tregress.bucket_overlap(base, cur) == \
        jregress.bucket_overlap(base, cur)


@pytest.mark.parametrize("include_missing", [True, False])
def test_provenance_warnings_equal_jax(include_missing):
    base = {"value": 1, "provenance": {"git_rev": "a" * 40,
                                       "tree_dirty": True, "host": "h1"}}
    cur = {"value": 2, "provenance": {"git_rev": "b" * 40,
                                      "host": "h2", "cpu_mhz": 2100}}
    for pair in ((base, cur), ({"value": 1}, cur), ({"value": 1},
                                                    {"value": 2})):
        assert tregress.provenance_warnings(
            *pair, include_missing=include_missing) == \
            jregress.provenance_warnings(*pair,
                                         include_missing=include_missing)


def test_find_capsule_and_load_record_equal_jax(tmp_path):
    path = jtests.make_round(str(tmp_path), "BENCH_r99")
    assert tregress.load_record(path) == jregress.load_record(path)
    _, record = tregress.load_record(path)
    stale = dict(record, capsule="nonexistent-dir")
    assert tregress.find_capsule(path, stale) == \
        jregress.find_capsule(path, stale) == \
        os.path.join(str(tmp_path), "BENCH_r99.capsule")
    missing = os.path.join(str(tmp_path), "missing.json")
    assert tregress.find_capsule(missing, {}) is None
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"metric": "x"}))
    with pytest.raises(ValueError):
        tregress.load_record(str(bad))


def test_self_check_passes_as_jax():
    ok, lines = tregress.self_check()
    assert ok, "\n".join(lines)
    assert (ok, lines) == jregress.self_check()


def test_module_entry_point(tmp_path):
    base, cur = _pair(tmp_path, "planted_stage")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    text = subprocess.run(ENTRY + [base, cur], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO_ROOT)
    assert text.returncode == 0, text.stderr
    assert text.stdout.splitlines() == jregress.render_report(
        jregress.diff_rounds(base, cur))
    as_json = subprocess.run(ENTRY + [base, cur, "--json"],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd=REPO_ROOT)
    assert as_json.returncode == 0, as_json.stderr
    report = json.loads(as_json.stdout)
    assert report == json.loads(json.dumps(jregress.diff_rounds(base, cur)))
    assert report["schema"] == "rsdl-regress-v1"
    check = subprocess.run(ENTRY + ["--check"], capture_output=True,
                           text=True, timeout=120, env=env, cwd=REPO_ROOT)
    assert check.returncode == 0, check.stdout + check.stderr
    assert "planted suspect ranked #1" in check.stdout
    missing = subprocess.run(
        ENTRY + [os.path.join(str(tmp_path), "nope.json"), base],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO_ROOT)
    assert missing.returncode == 2
    usage = subprocess.run(ENTRY + [base], capture_output=True, text=True,
                           timeout=120, env=env, cwd=REPO_ROOT)
    assert usage.returncode == 2


STANDALONE = """
import importlib.util
import json
import sys

sys.path = [p for p in sys.path if p not in ("", sys.argv[1])]
spec = importlib.util.spec_from_file_location("regress", sys.argv[2])
regress = importlib.util.module_from_spec(spec)
spec.loader.exec_module(regress)
assert not any(m.startswith("ray_shuffling_data_loader_tpu")
               for m in sys.modules), sorted(sys.modules)
ok, _ = regress.self_check()
report = regress.diff_rounds(sys.argv[3], sys.argv[4])
print(json.dumps({"ok": ok, "trace": regress.rt_trace.__name__,
                  "report": report}))
"""


def test_loads_by_path_without_the_package(tmp_path):
    base, cur = _pair(tmp_path, "planted_stage")
    (tmp_path / "standalone.py").write_text(STANDALONE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "standalone.py", REPO_ROOT,
         os.path.join(REPO_ROOT, "ray_shuffling_data_loader_tpu_torch",
                      "runtime", "regress.py"), base, cur],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["ok"] and got["trace"] == "_rsdl_torch_regress_trace"
    assert got["report"] == json.loads(json.dumps(
        jregress.diff_rounds(base, cur)))
