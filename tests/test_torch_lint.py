"""The port's analysis passes against the JAX package's.

Every source fixture of ``tests/test_analysis.py`` and
``tests/test_protocol_analysis.py`` (the race, durability and protocol
corpora: each string literal there that parses as Python) goes through
both packages' race, durability and protocol passes; the ``(rule, line)``
lists must be equal.  The model checker's scenarios and re-injected bugs
give the same verdicts and schedules in both.  Then the port's own
surfaces: the self-lint of ``hyperopt_tpu_torch/`` finds nothing, the
recompile audit (PL205) flags an injected per-call key leak, the
dispatch-container scan (PL208) flags a list container, and the CLI's
``self --json`` runs with JAX blocked from import.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from hyperopt_tpu.analysis import durability_lint as j_dl
from hyperopt_tpu.analysis import program_lint as j_pl
from hyperopt_tpu.analysis import protocol_lint as j_sg
from hyperopt_tpu.analysis import protocol_model as j_model
from hyperopt_tpu.analysis import race_lint as j_rl
from hyperopt_tpu_torch import analysis as T
from hyperopt_tpu_torch.algos import tpe_device
from hyperopt_tpu_torch.analysis import durability_lint as t_dl
from hyperopt_tpu_torch.analysis import program_lint as t_pl
from hyperopt_tpu_torch.analysis import protocol_lint as t_sg
from hyperopt_tpu_torch.analysis import protocol_model as t_model
from hyperopt_tpu_torch.analysis import race_lint as t_rl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hyperopt_tpu_torch")


def _fixtures():
    """(id, source) of every string literal in the reference's analysis
    tests that parses, after dedent, as a multi-line Python module."""
    out = []
    for fname in ("test_analysis.py", "test_protocol_analysis.py"):
        with open(os.path.join(REPO, "tests", fname), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        seen = set()
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
                continue
            src = textwrap.dedent(node.value)
            if "\n" not in src.strip() or src in seen:
                continue
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            seen.add(src)
            out.append((f"{fname[5:-3]}:{node.lineno}", src))
    return out


FIXTURES = _fixtures()


def _rule_lines(diags):
    return [(d.rule, d.location.rpartition(":")[2]) for d in diags]


def test_fixture_corpus_is_the_reference_corpus():
    """The corpus reaches every pass: each family of rules fires on some
    fixture."""
    assert len(FIXTURES) >= 60
    fired = set()
    for _, src in FIXTURES:
        fired.update(d.rule[:3] for d in t_rl.lint_source(src, "f.py"))
        fired.update(d.rule[:3] for d in t_dl.lint_source(src, "f.py"))
        fired.update(d.rule[:3] for d in t_sg.lint_source(src, "f.py"))
    assert {"RL3", "DL4", "SG7"} <= fired


@pytest.mark.parametrize("name,src", FIXTURES, ids=[n for n, _ in FIXTURES])
def test_fixture_same_findings_in_both_packages(name, src):
    for port_pass, ref_pass in ((t_rl, j_rl), (t_dl, j_dl), (t_sg, j_sg)):
        assert _rule_lines(port_pass.lint_source(src, "f.py")) == \
            _rule_lines(ref_pass.lint_source(src, "f.py")), port_pass.__name__
    assert _rule_lines(t_rl.lint_source(src, "f.py", lock_exempt=True)) == \
        _rule_lines(j_rl.lint_source(src, "f.py", lock_exempt=True))


def _verdict(v):
    return None if v is None else (v.scenario, v.invariant, v.message, v.schedule)


@pytest.mark.parametrize("scenario", sorted(j_model.SCENARIOS))
def test_model_scenario_same_verdict(scenario):
    got = t_model.find_violation(t_model.build_scenario(scenario))
    assert got is None
    assert _verdict(got) == _verdict(j_model.find_violation(j_model.build_scenario(scenario)))


@pytest.mark.parametrize("bug", sorted(j_model.MUTATIONS))
def test_model_mutation_same_schedule(bug):
    got = t_model.check_mutation(bug)
    assert got is not None
    assert _verdict(got) == _verdict(j_model.check_mutation(bug))
    assert t_model.format_schedule(got) == j_model.format_schedule(j_model.check_mutation(bug))


def test_rule_catalog_is_the_references_where_ported():
    from hyperopt_tpu.analysis.diagnostics import RULES as J_RULES

    ported = {r for r in J_RULES if r[:2] in ("SP", "RL", "DL", "SG")} | {"PL205", "PL208"}
    assert set(T.RULES) == ported
    for rid, rule in T.RULES.items():
        j = J_RULES[rid]
        assert (rule.severity, rule.title, rule.doc) == (j.severity, j.title, j.doc)


# -- the port's own tree --------------------------------------------------


def test_self_lint_of_the_port_finds_nothing():
    sections = T.run_self_lint()
    assert [k for k, *_ in sections] == ["race", "durability", "program", "protocol", "model"]
    found = {k: [d.format() for d in ds] for k, _, ds, _ in sections}
    assert all(not v for v in found.values()), found
    race = T.discover_race_files()
    assert os.path.join(PORT, "ops", "kernel_build.py") in race
    assert all(p.startswith(PORT) for p in race)
    assert T.RACE_LINT_EXEMPT == {}
    protocol = {os.path.relpath(p, PORT) for p in T.discover_protocol_files()}
    assert os.path.join("resilience", "fsck.py") in protocol


def test_the_repaired_annotations_are_what_the_passes_need():
    """Without its suppression the pipeline's spare-list access is RL301,
    without its exemptions fsck's offline repairs are DL405, and the
    orphan sweep carries its protocol role."""
    with open(os.path.join(PORT, "pipeline.py")) as f:
        pipeline = f.read()
    stripped = pipeline.replace("  # lint: disable=RL301", "")
    assert [d.rule for d in t_rl.lint_source(pipeline, "pipeline.py")] == []
    assert "RL301" in [d.rule for d in t_rl.lint_source(stripped, "pipeline.py")]
    with open(os.path.join(PORT, "resilience", "fsck.py")) as f:
        fsck = f.read()
    exempt = "# durability: exempt(offline repair: fsck runs single-writer against a stopped queue)"
    assert fsck.count(exempt) == 9
    assert t_dl.lint_source(fsck, "fsck.py") == []
    assert "DL405" in [d.rule for d in t_dl.lint_source(fsck.replace(exempt, "#"), "fsck.py")]
    assert "def _fsck_segments(qdir, repair, report: FsckReport) -> dict:  # protocol: orphan-sweep" in fsck


# -- PL205: the recompile audit ---------------------------------------------


def test_recompile_audit_clean_run_one_event_per_bucket():
    aud = t_pl.audit_tpe_run(n_trials=40, device="cpu")
    assert aud.diagnostics() == []
    assert aud.n_traces >= 1 and aud.n_programs == aud.n_traces
    buckets = aud.bucket_summary()
    assert [b for b, _ in buckets] == sorted({b for b, _ in buckets})
    assert all(n >= 1 for _, n in buckets)


def test_recompile_audit_flags_a_per_call_key_leak(monkeypatch):
    """A per-call value that leaks into the program key makes every
    dispatch a compile event: PL205, once per (bucket, families) group."""
    real = tpe_device.program_key
    calls = iter(range(10 ** 6))

    def leaky(requests):
        sig, shapes = real(requests)
        return sig, shapes + ((((), f"py:call{next(calls)}"),),)

    monkeypatch.setattr(tpe_device, "program_key", leaky)
    aud = t_pl.audit_tpe_run(n_trials=30, device="cpu")
    diags = aud.diagnostics()
    assert diags and {d.rule for d in diags} == {"PL205"}
    assert all("compiled" in d.message for d in diags)
    assert aud.n_traces == 10  # every TPE suggest past the 20 startup trials
    assert T.format_report(diags).count("PL205") == len(diags)
    assert aud.diagnostics(suppress=("PL205",)) == []


# -- PL208: dispatch containers ---------------------------------------------


LIST_CALLER = """
    from hyperopt_tpu_torch.algos import tpe_device

    def dispatch(a, b, statics):
        return tpe_device.multi_family_suggest_async(
            [("cont", [a, b], statics)])

    def dispatch_local(a, b, statics):
        args = list((a, b))
        return tpe_device.multi_study_suggest_async([[("idx", args, statics)]])
"""

TUPLE_CALLER = """
    from hyperopt_tpu_torch.algos import tpe_device

    def dispatch(a, b, statics):
        return tpe_device.multi_family_suggest_async([("cont", (a, b), statics)])
"""


def test_dispatch_list_container_is_pl208(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(LIST_CALLER))
    diags = t_pl.lint_dispatch_callers([str(bad)])
    assert [(d.rule, d.location.rpartition(":")[2]) for d in diags] == \
        [("PL208", "6"), ("PL208", "10")]
    assert _rule_lines(diags) == _rule_lines(j_pl.lint_dispatch_callers([str(bad)]))
    ok = tmp_path / "ok.py"
    ok.write_text(textwrap.dedent(TUPLE_CALLER))
    assert t_pl.lint_dispatch_callers([str(ok)]) == []


def test_port_dispatch_call_sites_are_tuples():
    """The scan reaches every dispatch call site of the port and finds
    them all in the tuple form."""
    sites = {}
    for path in T.package_files():
        with open(path, encoding="utf-8") as f:
            for node in ast.walk(ast.parse(f.read())):
                if isinstance(node, ast.Call) and isinstance(node.func, (ast.Attribute, ast.Name)):
                    name = getattr(node.func, "attr", getattr(node.func, "id", ""))
                    if name in t_pl._DISPATCH_FNS:
                        rel = os.path.relpath(path, PORT)
                        sites[rel] = sites.get(rel, 0) + 1
    for rel in (os.path.join("algos", "tpe.py"), os.path.join("algos", "tpe_device.py"),
                "compile_ledger.py", os.path.join("service", "core.py")):
        assert sites.get(rel), rel
    assert t_pl.lint_dispatch_callers() == []
    assert T.lint_programs() == []


# -- the CLI -----------------------------------------------------------------


_NO_JAX = (
    "import importlib.abc, runpy, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'hyperopt_tpu', 'orbax'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = ['analysis'] + sys.argv[1:]\n"
    "runpy.run_module('hyperopt_tpu_torch.analysis', run_name='__main__', alter_sys=True)\n"
)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _NO_JAX, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def test_cli_self_json_without_jax():
    proc = _cli("self", "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout) == []


def test_cli_race_target_exit_code_and_schema(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: _lock

            def bump(self):
                self.n += 1
    """))
    proc = _cli("race", str(bad), "--json")
    assert proc.returncode == 1, proc.stderr[-2000:]
    rows = json.loads(proc.stdout)
    assert [(r["rule"], r["line"]) for r in rows] == [("RL301", 10)]
    assert set(rows[0]) == {"rule", "severity", "file", "line", "message", "hint"}
    assert T.diagnostics_json(t_rl.lint_file(str(bad))) == rows
    assert "--device" in _cli("--help").stdout
