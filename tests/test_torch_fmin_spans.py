"""The fmin loop's tracing spans on the CPU (``fmin(tracer=...)``,
``docs/torch_fmin_spans.md``): one trace per loop iteration with the
documented tree, the objective's span on its worker thread at k=1, the
phase totals equal to the spans', the same trials with and without a
tracer, no trace built without one, slow trials kept in the log; and the
readers of ``scripts/fmin_spans.py`` on spans of known length and
attributes, and on the log of a traced study, where every counter the
program records has a reading."""

import importlib.util
import math
import threading
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import hyperopt_tpu_torch as T
from hyperopt_tpu_torch import tracing

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("fmin_spans", ROOT / "scripts" / "fmin_spans.py")
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

SPACE = {"x": T.hp.uniform("x", -5, 5), "lr": T.hp.loguniform("lr", -7, 0),
         "c": T.hp.choice("c", ["a", "b", "c"])}

# each span name and the names its parent may have (None: the root)
SUGGEST_PARENTS = {"fmin.suggest", "pipeline.speculate", "pipeline.validate",
                   "pipeline.sync_suggest"}
READBACK_PARENTS = {"fmin.suggest", "pipeline.resolve", "pipeline.sync_suggest"}
PARENTS = {
    "fmin.trial": {None},
    **{n: {"fmin.trial"} for n in ("fmin.suggest", "fmin.insert", "fmin.evaluate",
                                   "fmin.health", "fmin.scan", "fmin.early_stop",
                                   "fmin.checkpoint")},
    "fmin.objective": {"fmin.trial", "fmin.evaluate"},
    "trials.refresh": {"fmin.trial", "fmin.suggest", "fmin.insert", "fmin.evaluate",
                       "pipeline.speculate"},
    "pipeline.speculate": {"fmin.evaluate"},
    "pipeline.join": {"fmin.evaluate"},
    "pipeline.validate": {"fmin.suggest", "pipeline.speculate"},
    "pipeline.resolve": {"fmin.suggest"},
    "pipeline.sync_suggest": {"fmin.suggest"},
    "suggest.history": SUGGEST_PARENTS,
    "suggest.build": SUGGEST_PARENTS,
    "suggest.launch": SUGGEST_PARENTS,
    "suggest.readback": READBACK_PARENTS,
    "suggest.emit": READBACK_PARENTS,
}
ONCE = ("fmin.trial", "fmin.suggest", "fmin.insert", "fmin.evaluate", "fmin.objective",
        "fmin.scan", "fmin.early_stop", "fmin.checkpoint")


class Recorder:
    def __init__(self):
        self.traces = []

    def record_trace(self, trace):
        self.traces.append(trace)


def objective(p):
    return (p["x"] - 1.0) ** 2 + abs(math.log(p["lr"]) + 3.0) + (p["c"] == "b")


def prefilled(n=24):
    """A study past TPE's startup, so every traced suggest is a fit."""
    trials = T.Trials()
    T.fmin(objective, SPACE, algo=partial(T.rand.suggest, device="cpu"), max_evals=n,
           trials=trials, rstate=np.random.default_rng(5), max_speculation=0,
           show_progressbar=False)
    return trials


def traced_fmin(k, tracer, tmp_path=None, n=6):
    trials = prefilled()
    algo = partial(T.tpe.suggest, device="cpu", n_EI_candidates=32)
    kw = {}
    if tmp_path is not None:
        kw = {"early_stop_fn": lambda trials, *args: (False, []),
              "trials_save_file": str(tmp_path / "trials.pkl")}
    it = T.FMinIter(algo, T.Domain(objective, SPACE), trials, np.random.default_rng(9),
                    max_evals=len(trials) + n, max_speculation=k, show_progressbar=False,
                    tracer=tracer, **kw)
    it.exhaust()
    return it


def recorded(k, tmp_path=None):
    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    it = traced_fmin(k, tracer, tmp_path)
    return it, rec.traces


@pytest.mark.parametrize("k", [0, 1])
def test_each_trial_is_one_trace_with_the_documented_tree(k, tmp_path):
    it, traces = recorded(k, tmp_path)
    assert len(traces) == 6
    seen = set()
    for tr in traces:
        spans = tr.spans()
        by_id = {s.span_id: s for s in spans}
        for s in spans:
            parent = by_id[s.parent_id].name if s.parent_id is not None else None
            assert s.name in PARENTS and parent in PARENTS[s.name], (s.name, parent)
            assert s.t1 is not None and s.t1 >= s.t0
        names = [s.name for s in spans]
        for name in ONCE:
            assert names.count(name) == 1, (name, names)
        assert names.count("fmin.health") == 2
        assert tr.root.name == "fmin.trial" and tr.root.attrs["n_trials"] >= 24
        seen |= set(names)
    assert {"suggest.history", "suggest.build", "suggest.launch", "suggest.readback",
            "suggest.emit", "trials.refresh"} <= seen
    pipeline = {"pipeline.speculate", "pipeline.validate", "pipeline.resolve", "pipeline.join"}
    assert (pipeline <= seen) if k else not (seen & pipeline)
    attrs = {s.name: s.attrs for tr in traces for s in tr.spans()}
    assert attrs["fmin.suggest"]["path"] == ("speculated" if k else "sync")
    assert attrs["fmin.insert"] == {"n_docs": 1}
    assert attrs["fmin.checkpoint"] == {"kind": "pickle"}
    assert attrs["trials.refresh"]["rebuild"] in {"skipped", "unchanged", "appended", "rebuilt"}
    assert attrs["suggest.build"] == {"n_families": 3, "k": 1, "n_cand": 32}


@pytest.mark.parametrize("k", [0, 1])
def test_the_objective_span_is_on_its_thread_under_its_trial(k):
    it, traces = recorded(k)
    loop = threading.current_thread().name
    tids = [t["tid"] for t in it.trials.trials[24:]]
    for tr, tid in zip(traces, tids):
        spans = {s.name: s for s in tr.spans()}
        obj = spans["fmin.objective"]
        assert obj.attrs == {"tid": tid}
        assert spans["fmin.trial"].thread == loop
        if k:
            assert obj.thread == "hyperopt-eval"
            assert obj.parent_id == tr.root.span_id
        else:
            assert obj.thread == loop
            assert obj.parent_id == spans["fmin.evaluate"].span_id


@pytest.mark.parametrize("k", [0, 1])
def test_phase_totals_equal_the_spans(k):
    it, traces = recorded(k)
    summary = it.timings.summary()
    for phase in ("suggest", "evaluate"):
        total = sum(s.duration_s for tr in traces for s in tr.spans()
                    if s.name == f"fmin.{phase}")
        assert summary[phase]["count"] == len(traces)
        assert abs(total - summary[phase]["total_s"]) <= 1e-6


@pytest.mark.parametrize("k", [0, 1])
def test_a_tracer_changes_no_trial(k):
    plain = traced_fmin(k, None)
    traced, _ = recorded(k)
    docs = [(t["tid"], t["misc"]["vals"], t["result"]) for t in plain.trials.trials]
    assert docs == [(t["tid"], t["misc"]["vals"], t["result"]) for t in traced.trials.trials]


@pytest.mark.parametrize("k", [0, 1])
def test_without_a_tracer_no_trace_is_built(k, monkeypatch):
    built = []

    class Counted(tracing.Trace):
        __slots__ = ()

        def __init__(self, *args):
            built.append(1)
            super().__init__(*args)

    monkeypatch.setattr(tracing, "Trace", Counted)
    traced_fmin(k, None)
    assert built == []
    _, traces = recorded(k)
    assert len(built) == len(traces) == 6


def test_the_log_keeps_the_slow_trials(tmp_path):
    """Head sampling off and a slow threshold: only the trial whose
    objective outlasts the threshold lands in the log, with its spans."""
    log = tmp_path / "fmin.trace"

    def slow_once(p):
        if p["x"] > 0 and not slow_once.done:
            slow_once.done = True
            time.sleep(0.3)
        return objective(p)

    slow_once.done = False
    tracer = tracing.Tracer(path=str(log), sample=0.0, slow_threshold_s=0.25)
    T.fmin(slow_once, SPACE, algo=partial(T.rand.suggest, device="cpu"), max_evals=12,
           rstate=np.random.default_rng(3), show_progressbar=False, tracer=tracer)
    records, torn = tracing.read_trace_log(str(log))
    assert torn == 0 and slow_once.done
    assert [r["root"] for r in records] == ["fmin.trial"]
    assert records[0]["duration_s"] >= 0.25
    spans = {s["name"]: s for s in records[0]["spans"]}
    assert spans["fmin.objective"]["thread"] == "hyperopt-eval"
    assert spans["fmin.objective"]["dur_s"] >= 0.3
    out = S.report(str(log))
    assert out["traces"] == 1 and out["exclusive_ms"]["fmin.objective"] >= 300


# -- the readers -------------------------------------------------------------


def span(name, sid, parent, t0, t1, thread="loop", **attrs):
    return {"name": name, "id": sid, "parent": parent, "thread": thread, "t0": t0, "t1": t1,
            "attrs": attrs}


def one_trial(t=0.0, n_trials=100, path="speculated", n_new_rows=1):
    """One pipelined iteration of known times (seconds from ``t``) and
    counters."""
    return [
        span("fmin.trial", 1, None, t + 0.0, t + 0.100, n_trials=n_trials),
        span("fmin.suggest", 2, 1, t + 0.000, t + 0.004, path=path),
        span("pipeline.resolve", 3, 2, t + 0.001, t + 0.003),
        span("suggest.readback", 4, 3, t + 0.001, t + 0.002),
        span("trials.refresh", 5, 1, t + 0.004, t + 0.006, n_docs=n_trials + 1,
             rebuild="appended"),
        span("fmin.evaluate", 6, 1, t + 0.010, t + 0.080),
        span("fmin.objective", 7, 1, t + 0.011, t + 0.061, thread="hyperopt-eval",
             tid=n_trials),
        span("pipeline.speculate", 8, 6, t + 0.012, t + 0.070, n_launched=1, hypothesis=1),
        span("suggest.history", 9, 8, t + 0.012, t + 0.014, n_new_rows=n_new_rows),
        span("suggest.build", 10, 8, t + 0.014, t + 0.020),
        span("suggest.launch", 11, 8, t + 0.020, t + 0.069),
        span("pipeline.join", 12, 6, t + 0.070, t + 0.072),
        span("trials.refresh", 13, 6, t + 0.072, t + 0.075, n_docs=n_trials + 1,
             rebuild="skipped"),
        span("fmin.health", 14, 1, t + 0.080, t + 0.081),
        span("fmin.scan", 15, 1, t + 0.082, t + 0.090),
        span("trials.refresh", 16, 15, t + 0.083, t + 0.084, n_docs=n_trials + 1,
             rebuild="skipped"),
    ]


def test_exclusive_time_leaves_out_children_on_its_own_thread():
    ex = S.exclusive(one_trial())
    assert math.isclose(ex[1], 0.100 - 0.004 - 0.002 - 0.070 - 0.001 - 0.008)
    assert math.isclose(ex[6], 0.070 - 0.058 - 0.002 - 0.003)   # not the objective
    assert math.isclose(ex[15], 0.007)
    assert math.isclose(ex[8], 0.058 - 0.002 - 0.006 - 0.049)


def test_the_readings_of_known_spans():
    values, split = S.readings([one_trial(0.0), one_trial(1.0)])
    assert math.isclose(values["fmin.refresh_ms"], 6.0)
    assert math.isclose(values["fmin.scan_ms"], 8.0)
    assert math.isclose(values["pipeline.overrun_ms"], 9.0)
    assert math.isclose(values["fmin.suggest_ms"], 4.0)
    assert math.isclose(values["suggest.prep_ms"], 8.0)
    assert math.isclose(values["suggest.launch_ms"], 49.0)
    assert math.isclose(split["fmin.objective"], 50.0)
    assert math.isclose(split["trials.refresh@fmin.trial"], 2.0)
    assert math.isclose(split["trials.refresh@fmin.evaluate"], 3.0)
    assert math.isclose(split["trials.refresh@fmin.scan"], 1.0)
    serial = [s for s in one_trial() if s["name"] != "pipeline.speculate"]
    assert S.readings([serial])[0]["pipeline.overrun_ms"] == 0.0


def test_the_counters_of_known_spans():
    """Labels split their span's calls and exclusive time; numbers give
    their mean per span and total per trial; a tid is no count."""
    by_label, counts = S.counters([one_trial(0.0, 100, "speculated", 1),
                                   one_trial(1.0, 101, "sync", 3)])
    refresh = by_label["trials.refresh.rebuild"]
    assert refresh["appended"] == {"calls_per_trial": 1.0, "ms_per_trial": pytest.approx(2.0)}
    assert refresh["skipped"] == {"calls_per_trial": 2.0, "ms_per_trial": pytest.approx(4.0)}
    assert by_label["fmin.suggest.path"] == {
        "speculated": {"calls_per_trial": 0.5, "ms_per_trial": pytest.approx(1.0)},
        "sync": {"calls_per_trial": 0.5, "ms_per_trial": pytest.approx(1.0)}}
    assert counts["suggest.history.n_new_rows"] == {"mean": 2.0, "per_trial": 2.0}
    assert counts["trials.refresh.n_docs"] == {"mean": 101.5, "per_trial": 304.5}
    assert counts["pipeline.speculate.n_launched"] == {"mean": 1.0, "per_trial": 1.0}
    assert counts["fmin.trial.n_trials"]["mean"] == 100.5
    assert "fmin.objective.tid" not in counts
    assert S.counters([]) == ({}, {})


def test_the_incremental_share_of_known_refreshes():
    """``n_walked`` against ``n_docs``: the share of refreshes that walked
    fewer documents than the store held, the most one of those walked,
    and the attribute's mean and total in ``counts``."""
    traces = [one_trial(0.0), one_trial(1.0)]
    for spans in traces:
        refreshes = [s for s in spans if s["name"] == "trials.refresh"]
        for s, walked in zip(refreshes, (1, 101, 0)):
            s["attrs"]["n_walked"] = walked
    values, _ = S.readings(traces)
    assert values["refresh.incremental_share"] == pytest.approx(4 / 6)
    assert values["refresh.incremental_walked_max"] == 1
    _, counts = S.counters(traces)
    assert counts["trials.refresh.n_walked"] == {"mean": pytest.approx(34.0),
                                                 "per_trial": pytest.approx(102.0)}
    assert "refresh.incremental_share" not in S.readings([one_trial()])[0]


def test_the_tally_share_of_known_scans():
    """``fmin.scan``'s ``n_walked``: the share of scans that walked no
    document (the refresh's tallies served them), and the attribute's
    mean and total in ``counts``; no share where no scan records it."""
    traces = [one_trial(0.0), one_trial(1.0), one_trial(2.0)]
    for spans, walked in zip(traces, (101, 0, 0)):
        next(s for s in spans if s["name"] == "fmin.scan")["attrs"]["n_walked"] = walked
    values, _ = S.readings(traces)
    assert values["scan.tally_share"] == pytest.approx(2 / 3)
    _, counts = S.counters(traces)
    assert counts["fmin.scan.n_walked"] == {"mean": pytest.approx(101 / 3),
                                            "per_trial": pytest.approx(101 / 3)}
    assert "scan.tally_share" not in S.readings([one_trial()])[0]


def test_the_walk_share_of_known_validations():
    """``pipeline.validate``'s ``n_walked``: the share of validity checks
    that walked any document, and the attribute's mean and total in
    ``counts``; no share where no check records it."""
    traces = [one_trial(0.0), one_trial(1.0)]
    for spans, t, walked in zip(traces, (0.0, 1.0), ((0, 0), (0, 120))):
        spans += [span("pipeline.validate", 17, 2, t + 0.0005, t + 0.001, n_invalidated=0,
                       n_walked=walked[0]),
                  span("pipeline.validate", 18, 8, t + 0.012, t + 0.012, n_invalidated=0,
                       n_walked=walked[1])]
    values, _ = S.readings(traces)
    assert values["validate.walk_share"] == pytest.approx(1 / 4)
    _, counts = S.counters(traces)
    assert counts["pipeline.validate.n_walked"] == {"mean": pytest.approx(30.0),
                                                    "per_trial": pytest.approx(60.0)}
    assert "validate.walk_share" not in S.readings([one_trial()])[0]


def test_the_slowest_trials_name_their_study_size_tid_and_largest_span():
    fast = one_trial(0.0, 100)
    slow = one_trial(1.0, 101)
    slow[0]["t1"] += 0.5      # 0.5 s more in the root's own time
    rows = S.slowest([fast, slow], n=1)
    assert rows == [{"ms": pytest.approx(600.0), "n_trials": 101, "tid": 101,
                     "top": "fmin.trial", "top_ms": pytest.approx(515.0)}]
    assert [r["tid"] for r in S.slowest([fast, slow])] == [101, 100]


@pytest.mark.parametrize("k", [0, 1])
def test_the_report_reads_every_counter_of_a_traced_study(k, tmp_path):
    """Each attribute the program records lands in one reading: a label
    in ``by_label``, a tid in ``slowest``, every number in ``counts``."""
    log = tmp_path / "fmin.trace"
    traced_fmin(k, tracing.Tracer(path=str(log), sample=1.0), tmp_path)
    records, torn = tracing.read_trace_log(str(log))
    out = S.report(str(log))
    assert torn == 0 and out["traces"] == len(records) == 6
    recorded_attrs = {(s["name"], a) for r in records for s in r["spans"]
                      for a in s.get("attrs", {})}
    assert ("trials.refresh", "rebuild") in recorded_attrs
    assert ("trials.refresh", "n_walked") in recorded_attrs
    assert out["readings"]["refresh.incremental_share"] > 0.5
    assert out["readings"]["refresh.incremental_walked_max"] <= 4
    assert {("fmin.scan", "n_walked"), ("fmin.health", "n_walked")} <= recorded_attrs
    assert out["readings"]["scan.tally_share"] == 1.0
    for name, attr in recorded_attrs:
        if S.LABELS.get(name) == attr:
            assert out["by_label"][f"{name}.{attr}"], (name, attr)
        elif attr == "tid":
            assert all(isinstance(r["tid"], int) for r in out["slowest"])
        else:
            assert f"{name}.{attr}" in out["counts"], (name, attr)
    path = out["by_label"]["fmin.suggest.path"]
    assert set(path) == {"speculated" if k else "sync"}
    assert set(out["by_label"]["trials.refresh.rebuild"]) <= {
        "skipped", "unchanged", "appended", "rebuilt"}
    assert out["by_label"]["fmin.checkpoint.kind"] == {
        "pickle": {"calls_per_trial": 1.0, "ms_per_trial": pytest.approx(
            out["exclusive_ms"]["fmin.checkpoint"])}}
    if k:
        assert "pipeline.validate.n_invalidated" in out["counts"]
        assert out["readings"]["validate.walk_share"] == 0.0
        assert out["counts"]["pipeline.speculate.n_launched"]["per_trial"] > 0
