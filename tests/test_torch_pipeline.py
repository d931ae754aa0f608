"""The port's speculative suggest engine (``hyperopt_tpu_torch.pipeline``)
and pipelined ``fmin`` on the CPU, and the engine's host-side policy and
validity checks against the JAX package's on the same trials (mirrors
tests/test_pipeline.py:74-332)."""

import importlib
import itertools
import threading
import weakref
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import pipeline as jpipe
from hyperopt_tpu_torch import pipeline
from hyperopt_tpu_torch.algos import tpe

# the modules, not the ``fmin`` functions the packages re-export
jfmin_mod = importlib.import_module("hyperopt_tpu.fmin")
tfmin_mod = importlib.import_module("hyperopt_tpu_torch.fmin")

SPACE = {"x": T.hp.uniform("x", -5, 5)}
# small TPE config so the device phase engages within a short run
FAST_TPE = partial(T.tpe.suggest, n_startup_jobs=5, n_EI_candidates=64, device="cpu")


def _quadratic(cfg):
    return (cfg["x"] - 3.0) ** 2


def _vals(trials):
    return [t["misc"]["vals"] for t in trials.trials]


def _run(k, max_evals=14, seed=0, fn=_quadratic, algo=FAST_TPE, space=SPACE, **kw):
    trials = T.Trials()
    T.fmin(fn, space, algo=algo, max_evals=max_evals, trials=trials,
           rstate=np.random.default_rng(seed), show_progressbar=False, verbose=False,
           max_speculation=k, **kw)
    return trials


def _fminiter(k, fn, max_evals=14, seed=0, algo=FAST_TPE, **kw):
    """Direct FMinIter construction: exposes speculation_stats."""
    trials = T.Trials()
    rval = T.FMinIter(algo, T.Domain(fn, SPACE), trials, rstate=np.random.default_rng(seed),
                      max_evals=max_evals, show_progressbar=False, verbose=False,
                      max_speculation=k, **kw)
    rval.catch_eval_exceptions = False
    return rval, trials


def test_policy_defaults_match_tpe():
    assert pipeline._TPE_DEFAULTS == {
        "gamma": tpe._default_gamma,
        "linear_forgetting": tpe._default_linear_forgetting,
        "n_startup_jobs": tpe._default_n_startup_jobs,
    } == jpipe._TPE_DEFAULTS


@pytest.mark.parametrize("env,expect", [(None, 1), ("0", 0), ("3", 3)])
def test_default_max_speculation_matches_reference(monkeypatch, env, expect):
    if env is None:
        monkeypatch.delenv("HYPEROPT_MAX_SPECULATION", raising=False)
    else:
        monkeypatch.setenv("HYPEROPT_MAX_SPECULATION", env)
    assert tfmin_mod._default_max_speculation() == jfmin_mod._default_max_speculation() == expect
    rval, _ = _fminiter(None, _quadratic)
    assert rval.max_speculation == expect


def test_max_speculation_two_runs():
    rval, trials = _fminiter(2, _quadratic, max_evals=12)
    rval.exhaust()
    assert len(trials.trials) == 12
    assert rval.speculation_stats.n_dispatched > 0


def test_k0_never_constructs_engine(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("engine constructed at k=0")

    monkeypatch.setattr(pipeline, "SpeculativeSuggestEngine", boom)
    assert len(_run(k=0).trials) == 14


def _mixed_obj(cfg):
    return (cfg["x"] - 3.0) ** 2 + 0.1 * cfg["c"] + 0.01 * cfg["lg"]


def _flaky(cfg):
    x = float(cfg["x"])
    if int(round(x * 1e6)) % 3 == 0:  # deterministic in x
        raise RuntimeError("flaky")
    return (x - 3.0) ** 2


def _sometimes_nan(cfg):
    x = float(cfg["x"])
    return float("nan") if x > 2.0 else (x - 1.0) ** 2


MIXED = {"x": T.hp.uniform("x", -5, 5), "c": T.hp.choice("c", [0, 1, 2]),
         "lg": T.hp.loguniform("lg", -3, 2)}
K1_CASES = {
    # across bucket boundaries (the hypothetical rebuild) with an index label
    "mixed_seed0": dict(fn=_mixed_obj, space=MIXED, max_evals=25, seed=0),
    "mixed_seed1": dict(fn=_mixed_obj, space=MIXED, max_evals=25, seed=1),
    "mixed_seed2": dict(fn=_mixed_obj, space=MIXED, max_evals=25, seed=2),
    # an error trial appends no loss: the hypothesis is relaunched
    "error_trials": dict(fn=_flaky, max_evals=20, seed=11, catch_eval_exceptions=True),
    # a NaN loss ranks last in both rankings and lands above
    "nan_losses": dict(fn=_sometimes_nan, max_evals=20, seed=5),
    # warm starts evaluate back to back in one pipelined round
    "points_to_evaluate": dict(fn=_quadratic, max_evals=18, seed=6,
                               points_to_evaluate=[{"x": 1.0}, {"x": -2.0}, {"x": 4.0}]),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_matches_serial_trajectory_exactly(case):
    def run(k):
        trials = _run(k, **K1_CASES[case])
        return _vals(trials), [t["state"] for t in trials.trials]

    assert run(1) == run(0)


def test_k1_speculations_use_hypothesis_fit():
    rval, _ = _fminiter(k=1, fn=_quadratic)
    rval.exhaust()
    s = rval.speculation_stats
    assert 0 < s.n_hypothesis <= s.n_dispatched, s.summary()


def test_k1_deterministic_and_shares_startup_prefix():
    a = _vals(_run(k=1, seed=7))
    assert a == _vals(_run(k=1, seed=7))
    serial = _vals(_run(k=0, seed=7))
    assert a[:5] == serial[:5] and len(a) == len(serial) == 14


def test_policy_linear_forgetting_mirrors_tpe_semantics():
    algo = partial(T.tpe.suggest, linear_forgetting=None)
    assert pipeline._policy_for(algo)[1]["linear_forgetting"] is None
    assert pipeline._n_below(10 ** 8, 0.25, None) == 2500
    assert pipeline._n_below(10 ** 8, 0.25, 0) == 0
    assert pipeline._n_below(10 ** 8, 0.25, 25) == 25


def test_wide_queue_keeps_serial_path(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("engine constructed with a wide queue")

    monkeypatch.setattr(pipeline, "SpeculativeSuggestEngine", boom)
    rval, trials = _fminiter(1, _quadratic, max_evals=8, max_queue_len=4)
    rval.exhaust()
    assert len(trials.trials) == 8


@pytest.mark.parametrize("trend,invalidated", [("improving", True), ("worsening", False)])
def test_invalidation_follows_the_quantile(trend, invalidated):
    """Strictly improving losses enter the below set every time, so every
    speculation is relaunched; strictly worsening ones never shift it."""
    calls = itertools.count()
    fn = ((lambda cfg: 100.0 - next(calls)) if trend == "improving"
          else (lambda cfg: float(next(calls))))
    rval, _ = _fminiter(k=1, fn=fn)
    rval.exhaust()
    s = rval.speculation_stats
    assert (s.n_invalidated > 0) == invalidated, s.summary()
    assert s.n_used > 0 and s.n_dispatched >= s.n_used


def test_objective_exception_propagates_and_discards():
    calls = itertools.count()

    def exploding(cfg):
        i = next(calls)
        if i == 8:  # past startup: a TPE speculation is in flight
            raise RuntimeError("objective blew up")
        return float(i)

    rval, trials = _fminiter(k=2, fn=exploding)
    with pytest.raises(RuntimeError, match="objective blew up"):
        rval.exhaust()
    assert rval.speculation_stats.n_discarded >= 1
    assert not any(t.name.startswith("hyperopt-eval") and t.is_alive()
                   for t in threading.enumerate())
    assert sum(t["state"] == T.JOB_STATE_DONE for t in trials.trials) == 8
    assert len(_run(k=2, max_evals=6).trials) == 6


def test_strict_policy_stays_serial():
    calls = {"n": 0}

    def counting_algo(new_ids, domain, trials, seed):
        calls["n"] += 1
        return T.rand.suggest(new_ids, domain, trials, seed, device="cpu")

    t_spec = _run(k=2, algo=counting_algo, seed=3)
    assert calls["n"] == 14
    t_serial = _run(k=0, algo=counting_algo, seed=3)
    assert calls["n"] == 28
    assert _vals(t_spec) == _vals(t_serial)


def test_trial_filter_demotes_policy_to_strict():
    algo = partial(FAST_TPE, trial_filter=lambda t: True)
    assert pipeline._policy_for(algo) == ("strict", {})
    assert pipeline._policy_for(FAST_TPE)[0] == "tpe_quantile"
    assert pipeline._policy_for(partial(FAST_TPE, trial_filter=None))[0] == "tpe_quantile"


def test_speculation_budget_caps_at_max_evals():
    rval, trials = _fminiter(k=2, fn=_quadratic, max_evals=10)
    rval.exhaust()
    s = rval.speculation_stats
    assert len(trials.trials) == 10
    assert s.n_discarded == 0, s.summary()
    assert s.n_dispatched == s.n_used + s.n_invalidated, s.summary()


def test_async_variant_keeps_the_partials_keywords():
    afn = pipeline._async_variant(partial(partial(T.tpe.suggest, device="cpu"),
                                          n_EI_candidates=7))
    assert afn.func is T.tpe.suggest_async
    assert afn.keywords == {"device": "cpu", "n_EI_candidates": 7}
    assert pipeline._async_variant(partial(T.rand.suggest, device="cpu")) is None


# -- the same decisions as the JAX package ---------------------------------------

def _algos(pkg):
    return {
        "tpe": pkg.tpe.suggest,
        "tpe_gamma": partial(pkg.tpe.suggest, gamma=0.4, n_startup_jobs=3),
        "tpe_lf_none": partial(pkg.tpe.suggest, linear_forgetting=None),
        "tpe_lf0": partial(partial(pkg.tpe.suggest, linear_forgetting=0), gamma=None),
        "tpe_filter": partial(pkg.tpe.suggest, trial_filter=np.ones(3, bool)),
        "rand": pkg.rand.suggest,
        "plain": lambda new_ids, domain, trials, seed: None,
    }


@pytest.mark.parametrize("name", list(_algos(J)))
def test_policy_for_matches_jax(name):
    assert pipeline._policy_for(_algos(T)[name]) == jpipe._policy_for(_algos(J)[name])


def test_n_below_matches_jax():
    for n, gamma, lf in itertools.product([0, 1, 7, 50, 401, 10_000], [0.1, 0.25, 1.0],
                                          [None, 0, 3, 25]):
        assert pipeline._n_below(n, gamma, lf) == jpipe._n_below(n, gamma, lf)


def _doc(tid, x, loss=None, state=2):
    result = {"status": "ok", "loss": loss} if state == 2 else {"status": "new"}
    return {"tid": tid, "spec": None, "result": result,
            "misc": {"tid": tid, "cmd": None, "idxs": {"x": [tid]}, "vals": {"x": [x]}},
            "state": state, "owner": None, "book_time": None, "refresh_time": None,
            "exp_key": None}


def _engines(n, running=0):
    """A JAX and a port engine over Trials of the same ``n`` completed and
    ``running`` in-flight docs."""
    rng = np.random.default_rng(n)
    xs, losses = rng.uniform(-5, 5, n + running), rng.standard_normal(n)
    out = []
    for pkg, mod in ((J, jpipe), (T, pipeline)):
        trials = pkg.Trials()
        trials._insert_trial_docs(
            [_doc(i, float(xs[i]), float(losses[i])) for i in range(n)]
            + [_doc(n + j, float(xs[n + j]), state=1) for j in range(running)])
        trials.refresh()
        domain = pkg.Domain(_quadratic, {"x": pkg.hp.uniform("x", -5, 5)})
        out.append(mod.SpeculativeSuggestEngine(pkg.tpe.suggest, domain, trials,
                                                np.random.default_rng(0)))
    return out


def _complete(engine, tid, loss, state=2):
    for t in engine.trials._dynamic_trials:
        if t["tid"] == tid:
            t["state"] = state
            t["result"] = {"status": "ok", "loss": loss} if state == 2 else {"status": "fail"}
    engine.trials.refresh()


def _append(engine, losses, first_tid):
    engine.trials._insert_trial_docs([_doc(first_tid + i, 0.5, float(v))
                                      for i, v in enumerate(losses)])
    engine.trials.refresh()


QUANTILE_CASES = {  # appended losses after a snapshot of 50 completed trials
    "none": [],
    "worse": [50.0, 60.0],
    "better": [-50.0],
    "nan": [float("nan")],
    "threshold_tie": ["threshold"],
    "n_below_grows": [99.0] * 40,
}


@pytest.mark.parametrize("case", list(QUANTILE_CASES))
def test_still_valid_matches_jax(case):
    """``_still_valid`` on a quantile snapshot: the same decision in both
    packages for the same appended losses."""
    decisions = []
    for eng in _engines(50):
        snap = eng._snapshot()
        assert snap[0] == "quantile"
        losses = [snap[3] if v == "threshold" else v for v in QUANTILE_CASES[case]]
        _append(eng, losses, 50)
        decisions.append(eng._still_valid(snap))
    assert decisions[0] == decisions[1]


def test_still_valid_after_a_rewrite_matches_jax():
    decisions = []
    for eng in _engines(50):
        snap = eng._snapshot()
        eng.trials._dynamic_trials[3]["result"]["loss"] = -100.0  # in-place edit
        eng.trials.refresh()
        decisions.append(eng._still_valid(snap))
    assert decisions == [False, False]


HYP_CASES = {  # how the one hypothesized in-flight trial ends
    "lands_above": (2, 1e3),
    "lands_below": (2, -1e3),
    "errors": (3, None),
    "still_running": (1, None),
}


@pytest.mark.parametrize("case", list(HYP_CASES))
def test_hyp_still_valid_matches_jax(case):
    """A lands-above hypothesis snapshot: both packages keep or drop it
    alike when the hypothesized trial lands above, below, errors or is
    still running."""
    state, loss = HYP_CASES[case]
    decisions = []
    for eng, mod in zip(_engines(60, running=1), (jpipe, pipeline)):
        hist = eng.trials.history
        nb_fit = mod._n_below(61, 0.25, 25)
        snap = ("hyp", 60, nb_fit, (60,), hist.content_version, weakref.ref(hist))
        if state != 1:
            _complete(eng, 60, loss, state)
        decisions.append(eng._still_valid(snap))
    assert decisions[0] == decisions[1]
    assert decisions[0] == (case in ("lands_above", "still_running"))
