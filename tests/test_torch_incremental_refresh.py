"""The fmin loop's incremental refresh (``base.loop_refresh``,
``Trials._refresh_incremental``) against the full walk of
``Trials.refresh()``.

Twin stores take the same seeded sequence of the loop's legal mutations;
one folds each step incrementally, the other walks every document, and
after every step they hold the same ``_trials``, ``_ids``, history arrays
(values and dtypes), content versions and ``rebuild`` label.  Then the
cases where only the full walk is exact, and a pipelined ``fmin`` over
HPOBench's four-label XGBoost space whose documents equal those of the
same run with every loop refresh a full walk, with each refresh's
``n_walked`` counter.
"""

import math
import pickle
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu_torch as T
from hyperopt_tpu_torch import base, tracing
from hyperopt_tpu_torch.base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Ctrl,
    Trials,
    loop_refresh,
)

OPEN = (JOB_STATE_NEW, JOB_STATE_RUNNING)


def refreshed(store, refresh):
    """Run ``refresh(store)`` under a trace; the last ``trials.refresh``
    span's attributes."""
    trace = tracing.Trace("t", True)
    with tracing.use_trace(trace):
        refresh(store)
    spans = [s for s in trace.spans() if s.name == "trials.refresh"]
    assert spans, "no trials.refresh span"
    return dict(spans[-1].attrs)


def full(store):
    store.refresh()


def random_vals(rng, tid):
    """A trial's labels: a float, an int, a choice index, a bool, a label
    that is an int or a float (its column widens), and a conditional
    string label (a dtype the columns do not grow in place)."""
    vals = {"x": float(rng.normal()), "n": int(rng.integers(0, 9)),
            "c": int(rng.integers(0, 3)), "flag": bool(rng.integers(0, 2)),
            "mix": int(rng.integers(0, 5)) if rng.random() < 0.7 else float(rng.random())}
    if rng.random() < 0.4:
        vals["s"] = "abcd"[: int(rng.integers(1, 5))]
    return {"tid": tid, "cmd": None, "idxs": {k: [tid] for k in vals},
            "vals": {k: [v] for k, v in vals.items()}}


def result_for(rng):
    kind = rng.choice(["ok", "ok", "ok", "nan", "missing", "fail"])
    if kind == "ok":
        return {"status": "ok", "loss": float(rng.normal())}
    if kind == "nan":
        return {"status": "ok", "loss": float("nan")}
    if kind == "missing":
        return {"status": "ok"}
    return {"status": "fail"}


def mutate(rng, stores):
    """One legal mutation of the fmin loop (or a backend's workers),
    applied alike to every store of ``stores`` (twins: same documents in
    the same positions)."""
    dyn = stores[0]._dynamic_trials
    open_pos = [i for i, t in enumerate(dyn) if t["state"] in OPEN]
    op = rng.choice(["append", "append", "run", "done", "done", "error", "cancel",
                     "inject"])
    if op in ("run", "done", "error", "cancel") and not open_pos:
        op = "append"
    if op == "append":
        exp_key = None if rng.random() < 0.6 else "a"
        tids = [s.new_trial_ids(1) for s in stores]
        assert all(t == tids[0] for t in tids)
        misc = random_vals(rng, tids[0][0])
        for s in stores:
            doc = s.new_trial_docs(tids[0], [None], [{"status": "new"}], [misc])[0]
            doc["exp_key"] = exp_key
            s.insert_trial_docs([doc])
        return
    if op == "inject":
        pos = int(rng.integers(0, len(dyn))) if len(dyn) else None
        n = int(rng.integers(1, 3))
        seed = int(rng.integers(2 ** 31))
        for s in stores:
            r = np.random.default_rng(seed)
            current = s._dynamic_trials[pos] if pos is not None else {
                "exp_key": None, "owner": None}
            tids = s.new_trial_ids(n)
            miscs = [random_vals(r, tid) for tid in tids]
            results = [{"status": "ok", "loss": float(r.normal())} for _ in tids]
            Ctrl(s, current_trial=current).inject_results(
                [None] * n, results, miscs, new_tids=tids)
        return
    # two open trials complete out of order: any open one may move first
    pos = int(rng.choice(open_pos))
    result = result_for(rng)
    for s in stores:
        t = s._dynamic_trials[pos]
        if op == "run":
            t["state"] = JOB_STATE_RUNNING
        elif op == "done":
            t["result"] = dict(result)
            t["state"] = JOB_STATE_DONE
        elif op == "error":
            t["misc"]["error"] = ("E", "boom")
            t["state"] = JOB_STATE_ERROR
        else:
            t["state"] = JOB_STATE_CANCEL


def assert_same(a, b):
    assert [t["tid"] for t in a._trials] == [t["tid"] for t in b._trials]
    assert a._ids == b._ids
    ha, hb = a._history, b._history
    assert ha.loss_tids.dtype == hb.loss_tids.dtype == np.int64
    assert np.array_equal(ha.loss_tids, hb.loss_tids)
    assert ha.losses.dtype == hb.losses.dtype == np.float64
    assert np.array_equal(ha.losses, hb.losses, equal_nan=True)
    assert list(ha.idxs) == list(hb.idxs) and list(ha.vals) == list(hb.vals)
    for k in hb.idxs:
        assert ha.idxs[k].dtype == hb.idxs[k].dtype, k
        assert np.array_equal(ha.idxs[k], hb.idxs[k]), k
        assert ha.vals[k].dtype == hb.vals[k].dtype, k
        assert np.array_equal(ha.vals[k], hb.vals[k]), k
    assert ha.content_version == hb.content_version
    assert ha.last_nonappend_version == hb.last_nonappend_version


def twins(views=False):
    a, b = Trials(), Trials()
    if views:
        return a, b, a.view(exp_key="a"), b.view(exp_key="a")
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_incremental_equals_full_after_every_step(seed):
    """Each step makes 1-3 mutations, then one twin (and its ``exp_key``
    view over the same list) folds incrementally and the other walks
    everything; their states and ``rebuild`` labels agree."""
    rng = np.random.default_rng(seed)
    a, b, va, vb = twins(views=True)
    n_incremental = 0
    for _ in range(160):
        for _ in range(int(rng.integers(1, 4))):
            mutate(rng, [a, b])
        got, want = refreshed(a, loop_refresh), refreshed(b, full)
        assert got["rebuild"] == want["rebuild"]
        assert got["n_docs"] == want["n_docs"] == want["n_walked"]
        n_incremental += got["n_walked"] < got["n_docs"]
        assert_same(a, b)
        vgot, vwant = refreshed(va, loop_refresh), refreshed(vb, full)
        assert vgot["rebuild"] == vwant["rebuild"]
        assert_same(va, vb)
        assert {t["exp_key"] for t in va._trials} <= {"a"}
    assert n_incremental > 100
    # a full refresh after incremental ones, with nothing changed
    assert refreshed(a, full)["rebuild"] == "unchanged"
    assert_same(a, b)


def test_the_loop_steady_state_walks_only_the_open_and_new_documents():
    """The pipelined loop's refreshes of one trial: insert, the
    speculation's two, the evaluation's and the one after it."""
    a, b = twins()
    for t in range(200):
        tid = a.new_trial_ids(1)
        b.new_trial_ids(1)
        for s in (a, b):
            s.insert_trial_docs(s.new_trial_docs(tid, [None], [{"status": "new"}],
                                                 [random_vals(np.random.default_rng(t), tid[0])]))
        walked = [refreshed(a, loop_refresh)["n_walked"]]                 # the insert's
        for s in (a, b):
            s._dynamic_trials[-1]["state"] = JOB_STATE_RUNNING
        walked.append(refreshed(a, loop_refresh)["n_walked"])            # speculate's
        walked.append(refreshed(a, loop_refresh)["n_walked"])            # after new ids
        for s in (a, b):
            s._dynamic_trials[-1]["result"] = {"status": "ok", "loss": float(t % 7)}
            s._dynamic_trials[-1]["state"] = JOB_STATE_DONE
        got = refreshed(a, loop_refresh)                                 # the evaluation's
        walked.append(got["n_walked"])
        walked.append(refreshed(a, loop_refresh)["n_walked"])            # after "evaluate"
        b.refresh()
        assert got["rebuild"] == "appended"
        if t:
            assert walked == [1, 1, 1, 1, 0]
        assert_same(a, b)


def open_behind_a_row():
    """Twins where trial 0 is still RUNNING and trial 1 completed."""
    a, b = twins()
    for s in (a, b):
        tids = s.new_trial_ids(2)
        s.insert_trial_docs(s.new_trial_docs(
            tids, [None, None], [{"status": "new"}] * 2,
            [random_vals(np.random.default_rng(i), tid) for i, tid in enumerate(tids)]))
        s._dynamic_trials[0]["state"] = JOB_STATE_RUNNING
        s._dynamic_trials[1].update(state=JOB_STATE_DONE, result={"status": "ok", "loss": 1.0})
        loop_refresh(s)
    return a, b


def test_a_trial_completing_behind_a_row_takes_the_full_walk():
    a, b = open_behind_a_row()
    for s in (a, b):
        s._dynamic_trials[0].update(state=JOB_STATE_DONE, result={"status": "ok", "loss": 0.5})
    got, want = refreshed(a, loop_refresh), refreshed(b, full)
    assert got == want == {"n_docs": 2, "rebuild": "rebuilt", "n_walked": 2}
    assert_same(a, b)
    assert list(a._history.loss_tids) == [0, 1]


def test_an_open_trial_errored_behind_a_row_leaves_the_trials():
    a, b = open_behind_a_row()
    for s in (a, b):
        s._dynamic_trials[0]["state"] = JOB_STATE_ERROR
    got, want = refreshed(a, loop_refresh), refreshed(b, full)
    assert got["rebuild"] == want["rebuild"] == "unchanged"
    assert got["n_walked"] == 1
    assert [t["tid"] for t in a._trials] == [1]
    assert_same(a, b)
    mutate(np.random.default_rng(0), [a, b])
    loop_refresh(a)
    b.refresh()
    assert_same(a, b)


def grown(a, b, n=30, seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        mutate(rng, [a, b])
        loop_refresh(a)
        b.refresh()
    return rng


@pytest.mark.parametrize("change", ["replaced", "shrunk", "refilled", "history"])
def test_another_list_or_history_takes_the_full_walk(change):
    a, b = twins()
    rng = grown(a, b)
    for s in (a, b):
        if change == "replaced":
            s._dynamic_trials = list(s._dynamic_trials)
        elif change == "shrunk":
            del s._dynamic_trials[-1]
        elif change == "refilled":
            docs = list(s._dynamic_trials)
            s._dynamic_trials.clear()
            s._dynamic_trials.extend(docs[1:] + docs[:1])
        else:
            s._history = base._TrialsHistory()
    got, want = refreshed(a, loop_refresh), refreshed(b, full)
    assert got == want and got["n_walked"] == got["n_docs"]
    assert_same(a, b)
    grown(a, b, seed=int(rng.integers(100)))
    assert_same(a, b)


def test_a_store_that_overrides_refresh_runs_its_own():
    class Counting(Trials):
        calls = 0

        def refresh(self):
            type(self).calls += 1
            super().refresh()

    s = Counting()
    s.insert_trial_docs(s.new_trial_docs(s.new_trial_ids(1), [None], [{"status": "new"}],
                                         [random_vals(np.random.default_rng(0), 0)]))
    before = Counting.calls
    got = refreshed(s, loop_refresh)
    assert Counting.calls == before + 1
    assert got["n_walked"] == got["n_docs"] == 1


def old_format(store):
    """``store`` as a pickle from before the incremental refresh reads
    back: no refresh mark, and a history cache with a fingerprint and
    per-label lists instead of growable columns."""
    st = pickle.loads(pickle.dumps(store))
    del st.__dict__["_refresh_mark"]
    h = st._history
    state = {
        "_fingerprint": (len(h.loss_tids), h.loss_tids.tobytes(), h.losses.tobytes()),
        "_seen_revision": h._seen_revision,
        "_idxs_lists": {k: v.tolist() for k, v in h.idxs.items()},
        "_vals_lists": {k: list(v) for k, v in h._vals_lists.items()},
        "_loss_join_view": None,
        "idxs": {k: v.copy() for k, v in h.idxs.items()},
        "vals": {k: v.copy() for k, v in h.vals.items()},
        "loss_tids": h.loss_tids.copy(), "losses": h.losses.copy(),
        "content_version": h.content_version,
        "last_nonappend_version": h.last_nonappend_version,
    }
    old = base._TrialsHistory.__new__(base._TrialsHistory)
    old.__setstate__(state)
    st._history = old
    return st


def test_a_store_pickled_before_the_change_takes_the_full_walk_then_folds():
    a, b = twins()
    rng = grown(a, b)
    a = old_format(a)
    assert not hasattr(a, "_refresh_mark")
    got = refreshed(a, loop_refresh)
    assert got["rebuild"] == "unchanged" and got["n_walked"] == got["n_docs"]
    assert_same(a, b)
    grown(a, b, n=40, seed=int(rng.integers(100)))
    assert_same(a, b)


def test_a_pickled_store_keeps_folding():
    a, b = twins()
    grown(a, b)
    a = pickle.loads(pickle.dumps(a))
    assert "_bufs" not in a._history.__getstate__()
    grown(a, b, n=40, seed=11)
    assert_same(a, b)


def test_arrays_handed_out_never_change():
    """A reader keeps the arrays of one refresh while later ones append
    into the same buffers."""
    a, b = twins()
    rng = np.random.default_rng(3)
    kept = []
    for _ in range(120):
        mutate(rng, [a, b])
        loop_refresh(a)
        h = a._history
        kept.append((h.loss_tids, h.losses.copy(), h.losses,
                     {k: (v, v.copy()) for k, v in h.vals.items()}))
    for tids, losses_copy, losses, vals in kept:
        assert len(tids) == len(losses)
        assert np.array_equal(losses, losses_copy, equal_nan=True)
        for v, v_copy in vals.values():
            assert np.array_equal(v, v_copy)


def test_odd_dtypes_are_rematerialised_from_the_stored_values():
    """A string label's column is typed by ``np.asarray`` over all its
    values on each append; bool, int64 and float64 columns grow in
    place."""
    a, b = twins()
    grown(a, b, n=80)
    h = a._history
    assert h.vals["s"].dtype.kind == "U" and h.vals["s"].base is None
    assert h.vals["x"].dtype == np.float64 and h.vals["x"].base is not None
    assert np.array_equal(h.vals["s"], np.asarray(h._vals_lists["s"]))


# -- the loop ----------------------------------------------------------------

# HPOBench's XGBoost space (xgboost_benchmark.py, get_configuration_space)
XGB = {
    "eta": T.hp.loguniform("eta", math.log(2 ** -10), 0.0),
    "max_depth": T.hp.qloguniform("max_depth", 0.0, math.log(50), 1),
    "colsample_bytree": T.hp.uniform("colsample_bytree", 0.1, 1.0),
    "reg_lambda": T.hp.loguniform("reg_lambda", math.log(2 ** -10), math.log(2 ** 10)),
}


def xgb_loss(p):
    return ((math.log2(p["eta"]) + 5.0) ** 2 / 20 + abs(p["max_depth"] - 8) / 10
            + (p["colsample_bytree"] - 0.7) ** 2 + abs(math.log2(p["reg_lambda"])) / 30)


class Recorder:
    def __init__(self):
        self.traces = []

    def record_trace(self, trace):
        self.traces.append(trace)


def run_xgb(n, k=1, tracer=None):
    trials = Trials()
    algo = partial(T.tpe.suggest, device="cpu", n_EI_candidates=64)
    it = T.FMinIter(algo, T.Domain(xgb_loss, XGB), trials, np.random.default_rng(17),
                    max_evals=n, max_speculation=k, show_progressbar=False, tracer=tracer)
    it.exhaust()
    return trials


def docs_of(trials):
    return [(t["tid"], t["state"], t["misc"]["vals"], t["result"]) for t in trials.trials]


def test_pipelined_fmin_equals_the_full_walk_trial_for_trial(monkeypatch):
    """~300 trials of the pipelined loop (k=1): the same documents as the
    run whose loop refreshes all walk every document; every traced
    refresh but the run's first walks at most 4 documents while the study
    grows."""
    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    incremental = run_xgb(300, tracer=tracer)
    with monkeypatch.context() as m:
        m.setattr(Trials, "_refresh_incremental", Trials.refresh)
        walked = run_xgb(300)
    assert len(incremental.trials) == 300
    assert docs_of(incremental) == docs_of(walked)
    refreshes = [s.attrs for tr in rec.traces for s in tr.spans()
                 if s.name == "trials.refresh"]
    assert len(rec.traces) == 300 and len(refreshes) >= 4 * 300
    first, rest = refreshes[0], refreshes[1:]
    assert first["n_walked"] == first["n_docs"]
    assert all(r["n_walked"] <= 4 for r in rest)
    assert max(r["n_docs"] for r in rest) == 300
    assert all(r["n_walked"] < r["n_docs"] for r in rest if r["n_docs"] > 4)


def test_a_run_starts_with_a_full_walk_and_sees_edits_between_runs():
    """A completed trial edited in place between two runs (no refresh) is
    in the history the second run fits on."""
    trials = run_xgb(40)
    trials.trials[-1]["result"]["loss"] = -100.0
    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    algo = partial(T.tpe.suggest, device="cpu", n_EI_candidates=64)
    T.FMinIter(algo, T.Domain(xgb_loss, XGB), trials, np.random.default_rng(3),
               max_evals=44, show_progressbar=False, tracer=tracer).exhaust()
    first = next(s.attrs for s in rec.traces[0].spans() if s.name == "trials.refresh")
    assert first["n_walked"] == first["n_docs"]
    assert trials._history.losses.min() == -100.0


def test_an_objective_handed_the_store_keeps_the_full_walk():
    """``pass_expr_memo_ctrl``: every refresh of the loop walks every
    document, as the objective may edit any of them."""
    seen = []

    @T.fmin_pass_expr_memo_ctrl
    def objective(expr, memo, ctrl):
        seen.append(len(ctrl.trials._dynamic_trials))
        return float(len(seen) % 5)

    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    T.fmin(objective, XGB, algo=partial(T.rand.suggest, device="cpu"), max_evals=12,
           rstate=np.random.default_rng(0), show_progressbar=False, tracer=tracer)
    refreshes = [s.attrs for tr in rec.traces for s in tr.spans()
                 if s.name == "trials.refresh"]
    assert len(seen) == 12 and refreshes
    assert all(r["n_walked"] == r["n_docs"] for r in refreshes)
