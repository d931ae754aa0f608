"""Search-health diagnostics of the PyTorch port against the JAX package, on
the CPU: ``snapshot_from_fused`` and ``SearchStats`` fed the same diag rows
and results in both packages, and ``fmin(search_stats=...)`` and
``no_progress_stop`` end to end."""

import types
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import diagnostics as jdiag
from hyperopt_tpu_torch import diagnostics as tdiag

CONT = types.SimpleNamespace(key=("cont", False, False), labels=["x", "y"])
IDX = types.SimpleNamespace(key=("idx",), labels=["c"])


def diag_rows(seed, collapse=False, flat=False, exhausted=False):
    """One suggest's ``[L, DIAG_COLS]`` rows for a 2-label continuous and a
    1-label index family."""
    rng = np.random.default_rng(seed)
    cont = np.zeros((2, tdiag.DIAG_COLS), np.float32)
    cont[:, 0], cont[:, 1] = 10, 90
    cont[:, 2] = rng.uniform(1, 5, 2)
    cont[:, 3] = cont[:, 2] - (0.01 if flat else rng.uniform(0.5, 2, 2))
    cont[:, 4] = rng.uniform(0, 1, 2)
    cont[:, 5:] = [0.01, 0.02, 0.95 if collapse else 0.1]
    idx = np.array([[10, 90, 0.5, 0.4, 0.3, 3, 1.0 if exhausted else 0.2, 3]], np.float32)
    return [cont, idx]


def snapshots(rows, **ctx):
    kw = dict(n_below=10, gamma=0.25, n_eff=100, k=1, n_cand=24, **ctx)
    return (jdiag.snapshot_from_fused([CONT, IDX], rows, **kw),
            tdiag.snapshot_from_fused([CONT, IDX], rows, **kw))


@pytest.mark.parametrize("kind", ["plain", "collapse", "flat", "exhausted"])
def test_snapshot_from_fused_matches_jax(kind):
    rows = diag_rows(1, **({kind: True} if kind != "plain" else {}))
    j, t = snapshots(rows)
    assert t == j
    assert set(t["labels"]) == {"x", "y", "c"} and t["labels"]["c"]["kind"] == "idx"


SCENARIOS = {
    "warmup": dict(n=10, losses="down"),
    "ok": dict(n=60, losses="down"),
    "stalled": dict(n=80, losses="flat"),
    "flat_ei": dict(n=60, losses="down", diag=dict(flat=True)),
    "sigma_collapse": dict(n=60, losses="down", diag=dict(collapse=True)),
    "faults": dict(n=40, losses="down", errors=40, nans=5),
}


def feed(diag, stats, sc):
    n = sc["n"]
    losses = (np.linspace(10, 0, n) if sc["losses"] == "down" else
              np.r_[np.linspace(10, 1, 20), np.ones(n - 20)])
    for i, loss in enumerate(losses):
        stats.record_suggest(None)
        stats.record_result(float(loss), "ok")
    for _ in range(sc.get("errors", 0)):
        stats.record_result(None, "fail")
    for tid in range(sc.get("nans", 0)):
        stats.record_nan_rejected(tid)
        stats.record_nan_rejected(tid)  # a retried report counts once
    rows = diag_rows(2, **sc.get("diag", {}))
    stats.record_suggest(diag.snapshot_from_fused([CONT, IDX], rows, n_below=10,
                                                  gamma=0.25, n_eff=n, k=1, n_cand=24))


@pytest.mark.parametrize("name", SCENARIOS)
def test_search_stats_matches_jax(name):
    """Both packages' SearchStats, fed the same stream, hold the same
    snapshot and give the same SH5xx verdict."""
    sc = SCENARIOS[name]
    j, t = jdiag.SearchStats(stall_window=30), tdiag.SearchStats(stall_window=30)
    feed(jdiag, j, sc)
    feed(tdiag, t, sc)
    assert t.snapshot() == j.snapshot()
    assert t.health() == j.health()
    assert t.metrics_row() == j.metrics_row()


def test_search_stats_verdicts():
    states = {}
    for name, sc in SCENARIOS.items():
        stats = tdiag.SearchStats(stall_window=30)
        feed(tdiag, stats, sc)
        states[name] = stats.health()["state"]
    assert states == {"warmup": "WARMUP", "ok": "OK", "stalled": "STALLED",
                      "flat_ei": "FLAT_EI", "sigma_collapse": "SIGMA_COLLAPSE",
                      "faults": "FAULT_DEGRADED"}


def test_publish_and_consume_on_this_thread():
    tdiag.last_suggest_diag()  # clear
    assert tdiag.last_suggest_diag() is None
    snap = {"labels": {}}
    tdiag.publish_suggest_diag(snap)
    assert tdiag.last_suggest_diag(consume=False) is snap
    assert tdiag.last_suggest_diag() is snap
    assert tdiag.last_suggest_diag() is None
    tdiag.set_enabled(False)
    try:
        assert not tdiag.enabled()
    finally:
        tdiag.set_enabled(True)


def done_doc(tid, x, loss, state=2):
    return {
        "tid": tid, "spec": None,
        "result": {"status": "ok", "loss": loss} if state == 2 else {"status": "new"},
        "misc": {"tid": tid, "cmd": None, "idxs": {"x": [tid]}, "vals": {"x": [x]}},
        "state": state, "owner": None, "book_time": None, "refresh_time": None,
        "exp_key": None,
    }


def test_observe_trials_matches_jax():
    """Pull feeding from a Trials object (OK losses with a NaN, error-state
    trials), then a shrunken history that resets the counts."""
    stats = {}
    for pkg, diag in ((J, jdiag), (T, tdiag)):
        trials = pkg.Trials()
        docs = [done_doc(i, 0.1 * i, float(10 - i)) for i in range(12)]
        docs[5]["result"]["loss"] = float("nan")
        docs += [done_doc(12, 0.0, None, state=3), done_doc(13, 0.0, None, state=3)]
        trials._insert_trial_docs(docs)
        trials.refresh()
        st = diag.SearchStats(n_startup_jobs=5)
        st.observe_trials(trials)
        st.observe_trials(trials)  # idempotent
        first = st.snapshot()
        trials.delete_all()
        trials._insert_trial_docs([done_doc(0, 0.0, 3.0)])
        trials.refresh()
        st.observe_trials(trials)
        stats[pkg.__name__] = (first, st.snapshot())
    assert stats["hyperopt_tpu_torch"] == stats["hyperopt_tpu"]
    first, after = stats["hyperopt_tpu_torch"]
    assert first["n_results"] == 14 and first["faults"]["n_nan"] == 1
    assert first["faults"]["n_error"] == 2 and after["n_results"] == 1


def objective(c):
    return float((c["x"] - 0.3) ** 2 + 0.1 * c["c"])


SPACE = {"x": T.hp.uniform("x", -1.0, 1.0), "c": T.hp.choice("c", [0, 1, 2])}


def test_fmin_feeds_search_stats():
    """``fmin(search_stats=...)`` on the CPU: one record per suggest, TPE
    suggests (past the startup ones) carry their snapshot, every result is
    observed; the default instance is built when none is passed."""
    stats = tdiag.SearchStats(n_startup_jobs=8)
    trials = T.Trials()
    algo = partial(T.tpe.suggest, n_startup_jobs=8, n_EI_candidates=16, device="cpu")
    T.fmin(objective, SPACE, algo=algo, max_evals=20, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, search_stats=stats)
    snap = stats.snapshot()
    assert snap["n_suggests"] == 20 and snap["n_device_suggests"] == 12
    assert snap["n_results"] == 20 and snap["best_loss"] == min(trials.losses())
    last = snap["last_suggest"]
    assert set(last["labels"]) == {"x", "c"} and last["n_cand"] == 16
    assert last["labels"]["x"]["kind"] == "cont" and last["labels"]["c"]["kind"] == "idx"
    it = T.FMinIter(algo, T.Domain(objective, SPACE), T.Trials(),
                    rstate=np.random.default_rng(0))
    assert isinstance(it.search_stats, tdiag.SearchStats)
    assert it.search_stats.n_startup_jobs == 8  # from the partial's keywords
    # through Trials.fmin as well
    stats2 = tdiag.SearchStats()
    T.Trials().fmin(objective, SPACE, algo=partial(T.rand.suggest, device="cpu"),
                    max_evals=5, rstate=np.random.default_rng(0), show_progressbar=False,
                    search_stats=stats2)
    assert stats2.snapshot()["n_suggests"] == 5


@pytest.mark.parametrize("window", [5, 12])
def test_no_progress_stop_matches_jax(window):
    """``no_progress_stop`` ends a run whose best loss stalls after the
    warm-up, at the same trial in both packages (random search on the same
    losses: the stop reads only the losses)."""
    counts = {}
    for pkg, algo in ((J, J.rand.suggest), (T, partial(T.rand.suggest, device="cpu"))):
        trials = pkg.Trials()
        stop = pkg.no_progress_stop(iteration_stop_count=window, n_startup_jobs=10)
        losses = iter(np.r_[np.linspace(5, 1, 12), np.full(200, 2.0)])
        pkg.fmin(lambda c: float(next(losses)), {"x": pkg.hp.uniform("x", 0, 1)},
                 algo=algo, max_evals=200, trials=trials, early_stop_fn=stop,
                 rstate=np.random.default_rng(0), show_progressbar=False)
        counts[pkg.__name__] = len(trials.trials)
        assert stop.search_stats.health()["state"] == "STALLED"
    assert counts["hyperopt_tpu_torch"] == counts["hyperopt_tpu"] < 200
    assert counts["hyperopt_tpu_torch"] == 12 + window


def test_no_progress_stop_with_shared_stats_and_tpe():
    stats = tdiag.SearchStats(n_startup_jobs=5, stall_window=6)
    trials = T.Trials()
    T.fmin(lambda c: 1.0, SPACE,
           algo=partial(T.tpe.suggest, n_startup_jobs=5, n_EI_candidates=8, device="cpu"),
           max_evals=60, trials=trials, rstate=np.random.default_rng(1),
           early_stop_fn=T.no_progress_stop(search_stats=stats), show_progressbar=False)
    assert len(trials.trials) < 60
    assert any(r["rule"] == "SH502" for r in stats.health()["rules"])
