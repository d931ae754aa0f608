"""The state tallies and the best OK loss that ``Trials``' refreshes keep
(``Trials.count_by_state_tallied``, ``Trials.min_ok_loss``), against the
walks over every document they replace in the fmin loop
(``count_by_state_unsynced`` and the ``losses()``/``statuses()`` scan).

Seeded random sequences of the loop's store operations (inserts, runs,
completions with OK, NaN, missing and failed losses, errors, cancels,
``Ctrl.inject_results``, an ``exp_key`` view, ``delete_all``, a pickle
and resume) compare the two at every refresh point; then the gate's
fallbacks, and whole ``fmin`` runs at k=0 and k=1 against the same runs
with the tallies turned off, and the asynchronous stores, which keep the
walks.
"""

import math
import pickle
import threading
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu_torch as T
from hyperopt_tpu_torch import tracing
from hyperopt_tpu_torch.base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATES,
    STATUS_OK,
    Ctrl,
    Trials,
    loop_refresh,
)

OPEN = (JOB_STATE_NEW, JOB_STATE_RUNNING)
# every argument the loop and SearchStats pass, and more
ARGS = [*JOB_STATES, [JOB_STATE_NEW, JOB_STATE_RUNNING], (JOB_STATE_DONE, JOB_STATE_ERROR),
        list(JOB_STATES), []]


def walked_min(store):
    """The fmin loop's best-loss scan as it was: ``min`` over the OK
    losses, None where there is none."""
    losses = [loss for loss, status in zip(store.losses(), store.statuses())
              if status == STATUS_OK and loss is not None]
    return min(losses) if losses else None


def same_loss(a, b):
    if a is None or b is None:
        return a is b
    return (math.isnan(a) and math.isnan(b)) or a == b


def assert_reads_equal_walks(store, tallied=True):
    """The loop's reads equal the walks; with ``tallied`` they come from
    the tallies (no walk)."""
    assert (store._tallies() is not None) == tallied
    for arg in ARGS:
        assert store.count_by_state_tallied(arg) == store.count_by_state_unsynced(arg), arg
    got, want = store.min_ok_loss(), walked_min(store)
    assert same_loss(got, want), (got, want)


def refreshed(store, refresh):
    """Run ``refresh(store)`` under a trace; the ``trials.refresh``
    span's attributes."""
    trace = tracing.Trace("t", True)
    with tracing.use_trace(trace):
        refresh(store)
    return next(s.attrs for s in trace.spans() if s.name == "trials.refresh")


def new_docs(store, n, exp_key):
    tids = store.new_trial_ids(n)
    docs = store.new_trial_docs(tids, [None] * n, [{"status": "new"}] * n,
                                [{"tid": t, "cmd": None, "idxs": {"x": [t]}, "vals": {"x": [0.5]}}
                                 for t in tids])
    for d in docs:
        d["exp_key"] = exp_key
    return docs


def result_for(rng, n_done):
    kind = rng.choice(["ok", "ok", "ok", "nan", "missing", "fail", "int"])
    if kind == "nan" or (n_done == 0 and rng.random() < 0.5):
        # a NaN among the first losses: min stays NaN from there on
        return {"status": "ok", "loss": float("nan")}
    if kind == "ok":
        return {"status": "ok", "loss": float(rng.normal())}
    if kind == "int":
        return {"status": "ok", "loss": int(rng.integers(-3, 3))}
    if kind == "missing":
        return {"status": "ok"}
    return {"status": "fail"}


def mutate(rng, store):
    """One of the loop's store operations (or an odd one its documented
    APIs allow: an OK result on a cancelled or a running trial, as
    ``Ctrl.checkpoint`` leaves); returns the store to go on with."""
    dyn = store._dynamic_trials
    open_pos = [i for i, t in enumerate(dyn) if t["state"] in OPEN]
    op = rng.choice(["insert", "insert", "run", "done", "done", "done", "error", "cancel",
                     "inject", "checkpoint", "delete_all", "pickle"],
                    p=[.16, .16, .1, .14, .14, .1, .05, .04, .05, .02, .01, .03])
    if op in ("run", "done", "error", "cancel", "checkpoint") and not open_pos:
        op = "insert"
    if op == "insert":
        exp_key = None if rng.random() < 0.7 else "a"
        store.insert_trial_docs(new_docs(store, int(rng.integers(1, 4)), exp_key))
    elif op == "inject":
        current = dyn[int(rng.integers(len(dyn)))] if dyn else {"exp_key": None, "owner": None}
        n = int(rng.integers(1, 3))
        tids = store.new_trial_ids(n)
        Ctrl(store, current_trial=current).inject_results(
            [None] * n, [{"status": "ok", "loss": float(rng.normal())} for _ in tids],
            [{"tid": t, "cmd": None, "idxs": {}, "vals": {}} for t in tids], new_tids=tids)
    elif op == "delete_all":
        store.delete_all()
    elif op == "pickle":
        return pickle.loads(pickle.dumps(store))
    else:
        # any open trial may move first: completions out of order
        t = dyn[int(rng.choice(open_pos))]
        n_done = sum(1 for d in dyn if d["state"] == JOB_STATE_DONE)
        if op == "run":
            t["state"] = JOB_STATE_RUNNING
        elif op == "done":
            t["result"] = result_for(rng, n_done)
            t["state"] = JOB_STATE_DONE
        elif op == "error":
            t["state"] = JOB_STATE_ERROR
        elif op == "checkpoint":
            t["result"] = {"status": "ok", "loss": float(rng.normal())}
        elif rng.random() < 0.5:
            t["state"] = JOB_STATE_CANCEL
        else:
            t.update(state=JOB_STATE_CANCEL, result={"status": "ok", "loss": float(rng.normal())})
    return store


@pytest.mark.parametrize("seed", range(8))
def test_the_tallies_equal_the_walks_at_every_refresh_point(seed):
    """Each step makes 1-3 operations, then the loop's refresh (or, one
    time in six, ``refresh()``); the store and an ``exp_key`` view over
    the same documents read the walks' counts and best loss from the
    tallies."""
    rng = np.random.default_rng(seed)
    store = Trials()
    view = store.view(exp_key="a")
    n_nan_first = n_incremental = 0
    for _ in range(200):
        for _ in range(int(rng.integers(1, 4))):
            store = mutate(rng, store)
        if view._dynamic_trials is not store._dynamic_trials:
            # delete_all or a resumed pickle: the view of the new list
            view = store.view(exp_key="a")
        for s in (store, view):
            walked = refreshed(s, Trials.refresh if rng.random() < 1 / 6 else loop_refresh)
            n_incremental += walked["n_walked"] < walked["n_docs"]
            assert_reads_equal_walks(s)
        best = store.min_ok_loss()
        n_nan_first += best is not None and math.isnan(best)
    assert n_nan_first > 0 and n_incremental > 100


def test_the_loop_steady_state_keeps_the_tallies_incremental():
    """The pipelined loop's refreshes of one trial each fold one document
    and leave the tallies exact; the first loss is NaN, so the best loss
    stays NaN."""
    store = Trials()
    for t in range(60):
        store.insert_trial_docs(new_docs(store, 1, None))
        loop_refresh(store)
        assert_reads_equal_walks(store)
        assert store.count_by_state_tallied(JOB_STATE_NEW) == 1
        store._dynamic_trials[-1]["state"] = JOB_STATE_RUNNING
        loop_refresh(store)
        loss = float("nan") if t == 0 else float(-t)
        store._dynamic_trials[-1].update(state=JOB_STATE_DONE,
                                         result={"status": "ok", "loss": loss})
        loop_refresh(store)
        assert_reads_equal_walks(store)
        assert store.count_by_state_tallied(JOB_STATE_DONE) == t + 1
        assert math.isnan(store.min_ok_loss())
        assert store._refresh_mark.tallies.last_ok == t


# -- where the tallies do not hold -------------------------------------------


def filled(n=12):
    store = Trials()
    for t in range(n):
        store.insert_trial_docs(new_docs(store, 1, None))
        store._dynamic_trials[-1].update(state=JOB_STATE_DONE,
                                         result={"status": "ok", "loss": float(n - t)})
    store.insert_trial_docs(new_docs(store, 2, None))
    store.refresh()
    return store


def test_a_store_changed_since_its_refresh_is_walked():
    """An append without a refresh, another document list, or an
    unrefreshed store: the reads walk, and read what the walk reads."""
    store = filled()
    assert_reads_equal_walks(store)
    store.insert_trial_docs(new_docs(store, 1, None))
    assert_reads_equal_walks(store, tallied=False)
    assert store.count_by_state_tallied(JOB_STATE_NEW) == 3
    loop_refresh(store)
    assert_reads_equal_walks(store)
    store._dynamic_trials = list(store._dynamic_trials)
    assert_reads_equal_walks(store, tallied=False)
    fresh = Trials(refresh=False)
    fresh.insert_trial_docs(new_docs(fresh, 2, None))
    assert fresh._tallies() is None
    assert fresh.count_by_state_tallied(JOB_STATE_NEW) == 2


def test_stores_that_override_refresh_or_are_asynchronous_are_walked():
    class OwnRefresh(Trials):
        def refresh(self):
            super().refresh()

    class Asynchronous(Trials):
        asynchronous = True

    for cls in (OwnRefresh, Asynchronous):
        store = cls()
        store.insert_trial_docs(new_docs(store, 3, None))
        store.refresh()
        assert_reads_equal_walks(store, tallied=False)


def test_a_mark_pickled_before_the_tallies_takes_the_walk_then_the_full_refresh():
    store = filled()
    del store._refresh_mark.tallies
    st = pickle.loads(pickle.dumps(store))
    assert_reads_equal_walks(st, tallied=False)
    st._dynamic_trials[-1]["state"] = JOB_STATE_RUNNING
    refresh = refreshed(st, loop_refresh)
    assert refresh["n_walked"] == refresh["n_docs"]
    assert_reads_equal_walks(st)


@pytest.mark.parametrize("where", ["cancelled", "running"])
def test_an_ok_loss_behind_the_last_one_takes_the_full_walk(where):
    """A trial that takes an OK loss behind the last one the tallies hold
    (a cancelled trial with a result, then an earlier trial completing)
    or an open trial holding an OK loss (``Ctrl.checkpoint``): the next
    loop refresh walks every document, and the tallies stay exact."""
    store = Trials()
    store.insert_trial_docs(new_docs(store, 3, None))
    loop_refresh(store)
    dyn = store._dynamic_trials
    if where == "cancelled":
        dyn[1].update(state=JOB_STATE_CANCEL, result={"status": "ok", "loss": 2.0})
    else:
        dyn[1].update(state=JOB_STATE_RUNNING, result={"status": "ok", "loss": 2.0})
    loop_refresh(store)
    assert_reads_equal_walks(store)
    assert store._refresh_mark.open_ok == (where == "running")
    dyn[0].update(state=JOB_STATE_DONE, result={"status": "ok", "loss": float("nan")})
    refresh = refreshed(store, loop_refresh)
    assert refresh["n_walked"] == refresh["n_docs"] == 3
    assert_reads_equal_walks(store)
    assert math.isnan(store.min_ok_loss())


def test_a_document_without_a_result_is_counted_and_its_best_loss_walked():
    """A partial document (a queue record torn before its result) refreshes
    as before; the counts come from the tallies, and the best-loss read
    walks and raises where the walk raises."""
    store = filled()
    store._insert_trial_docs([{"tid": 77, "misc": {"tid": 77}, "state": JOB_STATE_NEW,
                               "exp_key": None}])
    for refresh in (loop_refresh, Trials.refresh):
        refresh(store)
        assert store._tallies() is not None
        assert store.count_by_state_tallied(JOB_STATE_NEW) == 3
        with pytest.raises(KeyError):
            walked_min(store)
        with pytest.raises(KeyError):
            store.min_ok_loss()


def test_losses_min_cannot_order_raise_as_the_walk_does():
    """A numeric string injected as a loss beside float ones: the history
    takes it, the counts still come from the tallies, and the best loss
    walks and raises what ``min`` raises."""
    store = filled()
    tid = store.new_trial_ids(1)
    Ctrl(store, current_trial=store._dynamic_trials[0]).inject_results(
        [None], [{"status": "ok", "loss": "1.5"}],
        [{"tid": tid[0], "cmd": None, "idxs": {}, "vals": {}}], new_tids=tid)
    loop_refresh(store)
    assert store._tallies() is not None
    assert store.count_by_state_tallied(JOB_STATE_DONE) == 13
    assert store._history.losses[-1] == 1.5
    with pytest.raises(TypeError):
        walked_min(store)
    with pytest.raises(TypeError):
        store.min_ok_loss()


# -- the loop ----------------------------------------------------------------

SPACE = {"x": T.hp.uniform("x", -5, 5), "lr": T.hp.loguniform("lr", -7, 0),
         "c": T.hp.choice("c", ["a", "b", "c"])}


def objective(p):
    """NaN first, an error now and then, else a smooth surface."""
    objective.calls += 1
    if objective.calls == 1:
        return {"status": "ok", "loss": float("nan")}
    if objective.calls % 9 == 0:
        raise ValueError("boom")
    return (p["x"] - 1.0) ** 2 + abs(math.log(p["lr"]) + 3.0) + (p["c"] == "b")


class Recorder:
    def __init__(self):
        self.traces = []

    def record_trace(self, trace):
        self.traces.append(trace)


def run_fmin(k, nan_first, loss_threshold=None, n=40):
    objective.calls = 0 if nan_first else 1
    # a diag an earlier suggest on this thread published and nobody read
    # would be counted by the run's first (random) suggest
    T.diagnostics.last_suggest_diag()
    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    trials = Trials()
    it = T.FMinIter(partial(T.tpe.suggest, device="cpu", n_EI_candidates=32, n_startup_jobs=8),
                    T.Domain(objective, SPACE), trials, np.random.default_rng(21),
                    max_evals=n, max_speculation=k, loss_threshold=loss_threshold,
                    show_progressbar=False, tracer=tracer,
                    early_stop_fn=T.early_stop.no_progress_stop(iteration_stop_count=30,
                                                                n_startup_jobs=10))
    it.catch_eval_exceptions = True
    it.exhaust()
    docs = [(t["tid"], t["state"], t["misc"]["vals"], t["result"]) for t in trials._dynamic_trials]
    return docs, it.search_stats.snapshot(), rec.traces


def scan_walks(traces):
    return [a["n_walked"] for a in scan_attrs(traces)]


def scan_attrs(traces):
    """The attributes of the spans that read counts and the best loss."""
    return [s.attrs for tr in traces for s in tr.spans()
            if s.name in ("fmin.scan", "fmin.health") and "n_walked" in (s.attrs or {})]


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("nan_first,loss_threshold", [(True, None), (False, 1.0)])
def test_fmin_with_the_tallies_equals_fmin_with_the_walks(k, nan_first, loss_threshold,
                                                          monkeypatch):
    """The same trials, errors and NaN losses included, the same stopping
    trial under ``loss_threshold`` (never reached where the first loss is
    NaN: ``min`` stays NaN), and the same search health, with every scan
    read from the tallies."""
    docs, snap, traces = run_fmin(k, nan_first, loss_threshold)
    with monkeypatch.context() as m:
        m.setattr(Trials, "_tallies", lambda self: None)
        walked_docs, walked_snap, walked_traces = run_fmin(k, nan_first, loss_threshold)
    assert repr(docs) == repr(walked_docs)   # repr: a NaN loss equals itself
    assert repr(snap) == repr(walked_snap)
    assert snap["faults"]["n_error"] > 0 and snap["faults"]["n_nan"] >= nan_first
    states = [d[1] for d in docs]
    if loss_threshold is None:
        assert len(docs) == 40
    else:
        # stopped at the first trial at or under the threshold
        ok = [d[3]["loss"] for d in docs if d[1] == JOB_STATE_DONE]
        assert len(docs) < 40 and ok[-1] <= loss_threshold
        assert all(loss > loss_threshold for loss in ok[:-1])
    assert JOB_STATE_ERROR in states
    assert set(scan_walks(traces)) == {0}
    assert all(w > 0 for w in scan_walks(walked_traces))


# -- the asynchronous stores keep the walks -----------------------------------


def quad(p):
    return (p["x"] - 1.0) ** 2


def file_workers(queue_dir, n=2):
    from hyperopt_tpu_torch.parallel.worker import FileWorker, ReserveTimeout

    stop = threading.Event()

    def loop():
        w = FileWorker(queue_dir, poll_interval=0.02)
        while not stop.is_set():
            try:
                w.run_one(reserve_timeout=0.2)
            except ReserveTimeout:
                continue

    threads = [threading.Thread(target=loop, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    return threads, stop


@pytest.mark.parametrize("backend", ["torch_trials", "file_trials"])
def test_the_asynchronous_stores_keep_the_walks(backend, tmp_path):
    """``TorchTrials`` and ``FileTrials``: workers move states between
    polls, so every scan walks the whole store (``n_walked`` its size)
    and counts live."""
    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    algo = partial(T.rand.suggest, device="cpu")
    space = {"x": T.hp.uniform("x", -5, 5)}
    if backend == "torch_trials":
        from hyperopt_tpu_torch.parallel.torch_trials import TorchTrials

        trials = TorchTrials(parallelism=2, device="cpu")
        trials.fmin(quad, space, algo=algo, max_evals=8, rstate=np.random.default_rng(0),
                    show_progressbar=False, tracer=tracer)
    else:
        from hyperopt_tpu_torch.parallel.file_trials import FileTrials

        qdir = str(tmp_path / "q")
        trials = FileTrials(qdir)
        trials.poll_interval_secs = 0.02
        threads, stop = file_workers(qdir)
        try:
            T.fmin(quad, space, algo=algo, max_evals=8, trials=trials,
                   rstate=np.random.default_rng(0), show_progressbar=False, tracer=tracer)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
    assert len(trials.trials) == 8
    assert trials._tallies() is None
    scans = scan_attrs(rec.traces)
    assert scans
    assert all(a["n_walked"] > 0 for a in scans)
    assert all(a["n_walked"] == a["n_docs"] for a in scans if "n_docs" in a)
    assert trials.count_by_state_tallied(JOB_STATE_DONE) == 8
