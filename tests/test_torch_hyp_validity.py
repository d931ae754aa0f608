"""The lands-above hypothesis' validity check
(``SpeculativeSuggestEngine._hyp_still_valid``) against the full check it
replaced, which walked every document and ranked every loss.

The new check reads the hypothesized trials at the positions the launch
recorded and compares the appended losses with the float32 rank threshold
the launch took.  :func:`full_check` is the replaced body, kept here as
the oracle: on seeded histories (float32 ties at the threshold, ±inf,
NaN), one and several appended losses, a below set of 0 and of every real
loss, and a hypothesized trial that completed, errored or still runs, both
decide alike; a store whose list moved under the recorded positions makes
the check walk it (``n_walked``); and a pipelined ``fmin`` on ``Trials``
decides as the oracle at every check without walking a document.
"""

import copy
import itertools
import math
import zlib
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu_torch as T
from hyperopt_tpu_torch import tracing
from hyperopt_tpu_torch.base import JOB_STATE_NEW, JOB_STATE_RUNNING, Trials
from hyperopt_tpu_torch.pipeline import SpeculativeSuggestEngine, _n_below

SPACE = {"x": T.hp.uniform("x", -5, 5)}


def full_check(engine, snap, hist, n_now):
    """The check before the launch recorded positions and a threshold:
    a walk over every document and a stable float32 ranking of every loss
    (``snap`` is the launch's first six fields)."""
    _, n0, nb_fit, hyp_tids, cv, hist_ref = snap
    if hist_ref() is not hist:
        return False
    if cv is not None and getattr(hist, "last_nonappend_version", 0) > cv:
        return False
    if n_now < n0:
        return False
    done_tids = {int(t) for t in hist.loss_tids[n0:]}
    hyp_set = set(hyp_tids)
    still_out = 0
    for t in engine.trials._dynamic_trials:
        tid = int(t["tid"])
        if tid in hyp_set and tid not in done_tids:
            if t["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING):
                still_out += 1
            else:
                return False
    p = engine.policy_params
    if _n_below(n_now + still_out, p["gamma"], p["linear_forgetting"]) != nb_fit:
        return False
    if n_now > n0:
        losses = np.asarray(hist.losses[:n_now], dtype=np.float32)
        order = np.argsort(losses, kind="stable")
        ranks = np.empty(n_now, np.int64)
        ranks[order] = np.arange(n_now)
        if np.any(ranks[n0:] < nb_fit):
            return False
    return True


def _doc(tid, x, loss=None, state=2):
    result = {"status": "ok", "loss": loss} if state == 2 else {"status": "new"}
    return {"tid": tid, "spec": None, "result": result,
            "misc": {"tid": tid, "cmd": None, "idxs": {"x": [tid]}, "vals": {"x": [x]}},
            "state": state, "owner": None, "book_time": None, "refresh_time": None,
            "exp_key": None}


def _finish(trials, tid, state, loss=None):
    doc = next(t for t in trials._dynamic_trials if t["tid"] == tid)
    doc["state"] = state
    doc["result"] = {"status": "ok", "loss": loss} if state == 2 else {"status": "fail"}


def launched(losses, n_pending, **algo_kw):
    """An engine over ``Trials`` of the completed ``losses`` and
    ``n_pending`` running trials, and the snapshot its launch took (the
    device launch itself left out)."""
    n0 = len(losses)
    trials = Trials()
    trials._insert_trial_docs([_doc(i, 0.5, float(v)) for i, v in enumerate(losses)]
                              + [_doc(n0 + j, 0.5, state=1) for j in range(n_pending)])
    trials.refresh()
    algo = partial(T.tpe.suggest, device="cpu", **algo_kw)
    engine = SpeculativeSuggestEngine(algo, T.Domain(lambda c: 0.0, SPACE), trials,
                                      np.random.default_rng(0))
    engine._algo_async = lambda *a, **kw: None
    _, snap = engine._launch_spec([n0 + n_pending], 0)
    assert snap[0] == "hyp" and snap[3] == tuple(range(n0, n0 + n_pending))
    return engine, snap


def decisions(engine, snap):
    """``(new check, oracle, n_walked)`` on the engine's current history."""
    hist = engine.trials.history
    n_now = len(hist.losses)
    engine._n_walked = 0
    new = engine._still_valid(snap)
    return new, full_check(engine, snap[:6], hist, n_now), engine._n_walked


# -- seeded cases --------------------------------------------------------------

HISTORIES = ("ties", "inf", "nan")
APPENDED = ("tie", "tie_f64", "just_below", "just_above", "+inf", "-inf", "nan", "random")
FATES = ("done", "error", "running")
BELOW = ("default", "zero", "all")   # nb_fit: tpe's defaults, 0, and n0


def _history(rng, n0, kind):
    """Losses on a 0.1 grid (many exact ties), with ±inf or NaN mixed in;
    NaN sometimes so many that fewer than the below set are numbers."""
    losses = np.round(rng.standard_normal(n0), 1)
    if kind == "inf":
        losses[rng.choice(n0, int(rng.integers(1, 6)), replace=False)] = -math.inf
        losses[rng.choice(n0, int(rng.integers(1, 6)), replace=False)] = math.inf
    elif kind == "nan":
        n_nan = int(rng.integers(1, 4)) if rng.random() < 0.7 else n0 - 1
        losses[rng.choice(n0, n_nan, replace=False)] = math.nan
    return losses


def _algo_kw(mode, n0):
    if mode == "zero":
        return {"linear_forgetting": 0}
    if mode == "all":
        return {"gamma": float(n0), "linear_forgetting": n0}
    return {}


def _special(rng, kind, losses, nb_fit):
    """A loss placed against the float32 threshold of ``losses`` (0 where
    that threshold is not a finite number)."""
    l32 = np.sort(np.asarray(losses, np.float32))
    thr = l32[nb_fit - 1] if nb_fit >= 1 else np.float32(0.0)
    if not np.isfinite(thr):
        thr = np.float32(0.0)
    t64 = float(thr)
    if kind == "tie":
        return t64
    if kind == "tie_f64":   # below in float64, a tie in float32
        v = t64 - abs(t64) * 2.0 ** -40 if t64 else -1e-300
        assert np.float32(v) == thr and v < t64
        return v
    if kind == "just_below":
        return float(np.nextafter(thr, np.float32(-np.inf)))
    if kind == "just_above":
        return float(np.nextafter(thr, np.float32(np.inf)))
    if kind == "random":
        return float(np.round(rng.standard_normal(), 1))
    return {"+inf": math.inf, "-inf": -math.inf, "nan": math.nan}[kind]


# each (history, appended loss) pair three times, the other dimensions
# rotated so that each pair meets several of them
CASES = [
    (hist, app, (1, 3)[(i + r) % 2], FATES[(i + r) % 3], BELOW[(i // 3 + r) % 3],
     (50, 600, 5000)[(i + 2 * r) % 3])
    for i, (hist, app) in enumerate(itertools.product(HISTORIES, APPENDED))
    for r in range(3)
]
IDS = ["-".join(map(str, c)) for c in CASES]


def run_case(hist, appended, k, fate, below, n0):
    """``k`` losses appended after the launch, one of them placed against
    the threshold (``appended``); the first hypothesized trial completes
    into them, errors or still runs, and with ``k`` > 1 a second one
    completes too.  ``(new check, oracle, n_walked, snapshot, appended
    losses)``."""
    rng = np.random.default_rng(zlib.crc32("-".join(map(str, (hist, appended, k, fate,
                                                             below, n0))).encode()))
    losses = _history(rng, n0, hist)
    n_pending = 2 if k > 1 else 1
    engine, snap = launched(losses, n_pending, **_algo_kw(below, n0))
    nb_fit = snap[2]
    assert nb_fit == {"zero": 0, "all": n0}.get(below, nb_fit)
    vals = [float(np.round(rng.standard_normal(), 1)) for _ in range(k)]
    vals[int(rng.integers(0, k))] = _special(rng, appended, losses, nb_fit)
    appended_losses = list(vals)
    first, second = n0, n0 + 1
    if fate == "done":
        _finish(engine.trials, first, 2, vals.pop(0))
    elif fate == "error":
        _finish(engine.trials, first, 3)
    if n_pending == 2:
        _finish(engine.trials, second, 2, vals.pop(0))
    engine.trials._insert_trial_docs(
        [_doc(n0 + n_pending + j, 0.5, v) for j, v in enumerate(vals)])
    engine.trials.refresh()
    assert len(engine.trials.history.losses) == n0 + k
    return (*decisions(engine, snap), snap, appended_losses)


@pytest.mark.parametrize("hist,appended,k,fate,below,n0", CASES, ids=IDS)
def test_the_check_decides_as_the_full_walk_and_ranking(hist, appended, k, fate, below, n0):
    new, oracle, walked, _, _ = run_case(hist, appended, k, fate, below, n0)
    assert new == oracle
    assert walked == 0
    if fate == "error":
        assert new is False


def test_the_cases_reach_both_decisions_on_both_rankings():
    """The seeded cases are not all decided before the losses are
    compared: past the document check, both decisions occur on the
    threshold and on the full ranking (a NaN appended or a NaN
    threshold)."""
    seen = set()
    for case in CASES:
        if case[3] == "error" or case[5] == 5000:
            continue
        new, _, _, snap, appended = run_case(*case)
        seen.add((bool(np.isnan(snap[7]) or np.isnan(appended).any()), new))
    assert seen == {(False, False), (False, True), (True, False), (True, True)}


# -- a list that moved under the recorded positions ----------------------------

STALE = {  # what a store does to its list after the launch; whether the check walks
    "shortened": (lambda docs: docs[1:], True),
    "hypothesized_trial_dropped": (lambda docs: [d for d in docs if d["tid"] != 200], True),
    "reordered": (lambda docs: docs[::-1], True),
    "equal_copies": (lambda docs: [copy.deepcopy(d) for d in docs], False),
    "equal_copies_reordered": (lambda docs: [copy.deepcopy(d) for d in reversed(docs)], True),
}


@pytest.mark.parametrize("fate", ["running", "error"])
@pytest.mark.parametrize("change", list(STALE))
def test_a_list_moved_under_the_positions_is_walked(change, fate):
    """After the launch the store shortens, reorders or replaces its list
    (the history cache stays as its last refresh left it): the check
    decides as the oracle, and walks the list exactly where a recorded
    position no longer holds its trial."""
    rng = np.random.default_rng(200)
    engine, snap = launched(np.round(rng.standard_normal(200), 1), 1)
    if fate == "error":
        _finish(engine.trials, 200, 3)
    engine.trials._insert_trial_docs([_doc(201, 0.5, -5.0 if fate == "running" else 5.0)])
    engine.trials.refresh()
    edit, walks = STALE[change]
    engine.trials._dynamic_trials = edit(engine.trials._dynamic_trials)
    new, oracle, walked = decisions(engine, snap)
    assert new == oracle
    assert walked == (len(engine.trials._dynamic_trials) if walks else 0)


# -- the pipelined loop --------------------------------------------------------

class Recorder:
    def __init__(self):
        self.traces = []

    def record_trace(self, trace):
        self.traces.append(trace)


def test_pipelined_fmin_decides_as_the_oracle_without_walking(monkeypatch):
    """~300 trials of the pipelined loop (k=1) on ``Trials``: every check
    decides as the full walk and ranking would, some of them invalidate,
    and no exposed ``pipeline.validate`` span walks a document."""
    calls = []
    check = SpeculativeSuggestEngine._hyp_still_valid

    def checked(self, snap, hist, n_now):
        new = check(self, snap, hist, n_now)
        calls.append((new, full_check(self, snap[:6], hist, n_now)))
        return new

    monkeypatch.setattr(SpeculativeSuggestEngine, "_hyp_still_valid", checked)
    rec = Recorder()
    tracer = tracing.Tracer(sample=1.0)
    tracer.set_recorder(rec)
    algo = partial(T.tpe.suggest, device="cpu", n_EI_candidates=64)
    it = T.FMinIter(algo, T.Domain(lambda c: (c["x"] - 3.0) ** 2, SPACE), Trials(),
                    np.random.default_rng(21), max_evals=300, max_speculation=1,
                    show_progressbar=False, tracer=tracer)
    it.exhaust()
    assert len(calls) >= 250
    assert all(new == oracle for new, oracle in calls)
    assert 0 < sum(not new for new, _ in calls) == it.speculation_stats.n_invalidated
    exposed = []
    for trace in rec.traces:
        names = {s.span_id: s.name for s in trace.spans()}
        exposed += [s.attrs for s in trace.spans() if s.name == "pipeline.validate"
                    and names.get(s.parent_id) == "fmin.suggest"]
    assert len(exposed) >= 250
    assert all(a["n_walked"] == 0 for a in exposed)
