"""The port's host-side algorithm suite against the JAX package's: the
``rdists`` mirrors, the ``criteria`` formulas, ``anneal``, ``mix`` and the
``models.domains`` zoo.  All of it is numpy (and scipy) in both packages,
so every comparison here is exact unless a test says otherwise; the
anneal behaviours are the reference's own (``tests/test_anneal.py``), run
through the port with ``device="cpu"`` wherever a suggest reaches torch.
"""

import copy
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import rdists as jrd
from hyperopt_tpu.algos import criteria as jcrit
from hyperopt_tpu.models import domains as jdomains
from hyperopt_tpu_torch import rdists as trd
from hyperopt_tpu_torch.algos import anneal as tanneal
from hyperopt_tpu_torch.algos import criteria as tcrit
from hyperopt_tpu_torch.models import domains as tdomains

CPU_RAND = partial(T.rand.suggest, device="cpu")


def jax_history(name, n, seed):
    """``n`` random-search trials on zoo domain ``name``, run by the JAX
    package; the port's Trials hold copies of the same docs."""
    d = jdomains.get(name)
    jt = J.Trials()
    J.fmin(d.fn, d.space, algo=J.rand.suggest, max_evals=n, trials=jt,
           rstate=np.random.default_rng(seed), show_progressbar=False, verbose=False)
    tt = T.trials_from_docs(copy.deepcopy(jt.trials))
    return (J.Domain(d.fn, d.space), jt,
            T.Domain(tdomains.get(name).fn, tdomains.get(name).space), tt)


# -- rdists -----------------------------------------------------------------

RDISTS = [
    ("loguniform_gen", (-2.0, 1.5), np.linspace(0.14, 4.4, 9)),
    ("lognorm_tx_gen", (0.3, 1.2), np.linspace(0.05, 6.0, 9)),
    ("quniform_gen", (-1.0, 7.0, 2.0), np.arange(-2.0, 10.0, 1.0)),
    ("qloguniform_gen", (0.0, 3.0, 2.0), np.arange(0.0, 24.0, 2.0)),
    ("qnormal_gen", (0.5, 3.0, 1.0), np.arange(-6.0, 7.0, 1.0)),
    ("qlognormal_gen", (0.0, 1.0, 0.5), np.arange(0.0, 5.0, 0.5)),
]


@pytest.mark.parametrize("name,args,xs", RDISTS, ids=[r[0] for r in RDISTS])
def test_rdists_equal_reference(name, args, xs):
    """pdf (pmf for the quantized ones), cdf and seeded rvs: exact."""
    ref, got = getattr(jrd, name)(*args), getattr(trd, name)(*args)
    dens = "pmf" if name.startswith("q") else "pdf"
    np.testing.assert_array_equal(getattr(got, dens)(xs), getattr(ref, dens)(xs))
    np.testing.assert_array_equal(got.cdf(xs), ref.cdf(xs))
    for seed in range(3):
        np.testing.assert_array_equal(got.rvs(size=50, random_state=seed),
                                      ref.rvs(size=50, random_state=seed))


# -- criteria ---------------------------------------------------------------


def test_criteria_equal_reference():
    """Every formula on a grid that reaches the asymptotic logEI branch:
    exact."""
    rng = np.random.default_rng(0)
    samples = rng.normal(size=64)
    for thresh in (-1.0, 0.0, 0.7):
        assert tcrit.EI_empirical(samples, thresh) == jcrit.EI_empirical(samples, thresh)
    for mean, var, thresh in [(0.0, 1.0, 0.5), (2.0, 0.25, 1.0), (-1.0, 4.0, 3.0),
                              (0.0, 1.0, 40.0), (-3.0, 0.01, 5.0)]:
        assert tcrit.EI_gaussian(mean, var, thresh) == jcrit.EI_gaussian(mean, var, thresh)
        assert tcrit.logEI_gaussian(mean, var, thresh) == jcrit.logEI_gaussian(mean, var, thresh)
        assert tcrit.UCB(mean, var, 1.5) == jcrit.UCB(mean, var, 1.5)


# -- anneal -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["quadratic1", "branin", "many_dists"])
def test_anneal_docs_equal_reference(name):
    """Seeds 0-4, two ids per call, from a 30-trial history and from an
    empty one: the port's trial docs equal the JAX package's exactly."""
    jdom, jt, tdom, tt = jax_history(name, 30, seed=len(name))
    for seed in range(5):
        for jtr, ttr in ((jt, tt), (J.Trials(), T.Trials())):
            ref = J.anneal.suggest([100, 101], jdom, jtr, seed)
            got = T.anneal.suggest([100, 101], tdom, ttr, seed)
            assert got == ref, (name, seed)


@pytest.mark.parametrize("name", ["quadratic1", "gauss_wave", "branin", "hartmann6", "q1_choice"])
def test_anneal_quality_on_domains(name):
    d = tdomains.get(name)
    trials = T.Trials()
    T.fmin(d.fn, d.space, algo=T.anneal.suggest, max_evals=d.quality_evals, trials=trials,
           rstate=np.random.default_rng(7), show_progressbar=False, verbose=False)
    best = min(trials.losses())
    assert best < d.quality_threshold, (name, best, d.quality_threshold)


def test_anneal_shrinks_toward_incumbent():
    d = tdomains.get("quadratic1")
    trials = T.Trials()
    T.fmin(d.fn, d.space, algo=T.anneal.suggest, max_evals=120, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, verbose=False)
    xs = np.array([m["vals"]["x"][0] for m in trials.miscs])
    assert np.std(xs[-30:]) < np.std(xs[:30])
    assert abs(np.mean(xs[-30:]) - 3.0) < 1.0


def test_anneal_deterministic():
    d = tdomains.get("branin")
    trials = T.Trials()
    T.fmin(d.fn, d.space, algo=CPU_RAND, max_evals=10, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, verbose=False)
    domain = T.Domain(d.fn, d.space)
    a = T.anneal.suggest([100], domain, trials, seed=3)
    b = T.anneal.suggest([100], domain, trials, seed=3)
    assert a[0]["misc"]["vals"] == b[0]["misc"]["vals"]


def test_anneal_empty_history_uses_prior():
    d = tdomains.get("many_dists")
    docs = T.anneal.suggest([0, 1, 2], T.Domain(d.fn, d.space), T.Trials(), seed=0)
    assert len(docs) == 3
    for doc in docs:
        v = doc["misc"]["vals"]
        assert 4 <= v["c"][0] <= 7 and v["a"][0] in (0, 1, 2)


def test_anneal_respects_bounds():
    d = tdomains.get("branin")
    trials = T.Trials()
    T.fmin(d.fn, d.space, algo=T.anneal.suggest, max_evals=150, trials=trials,
           rstate=np.random.default_rng(1), show_progressbar=False, verbose=False)
    xs = [m["vals"]["x"][0] for m in trials.miscs]
    ys = [m["vals"]["y"][0] for m in trials.miscs]
    assert min(xs) >= -5.0 and max(xs) <= 10.0
    assert min(ys) >= 0.0 and max(ys) <= 15.0


def test_anneal_drops_nan_loss_trials():
    """A NaN-loss trial leaves the per-label observations and T."""
    d = tdomains.get("quadratic1")
    domain = T.Domain(d.fn, d.space)
    trials = T.Trials()
    trials._insert_trial_docs([{
        "tid": i, "spec": None,
        "result": {"status": T.STATUS_OK, "loss": float("nan") if i == 2 else float(i)},
        "misc": {"tid": i, "cmd": None, "idxs": {"x": [i]}, "vals": {"x": [float(i)]}},
        "state": T.JOB_STATE_DONE, "owner": None, "book_time": None,
        "refresh_time": None, "exp_key": None,
    } for i in range(6)])
    trials.refresh()
    algo = tanneal.AnnealingAlgo(domain, trials, seed=0)
    ls, tids, _ = algo.observations["x"]
    assert len(ls) == 5 and 2 not in tids and not np.isnan(ls).any()
    assert algo.shrinking("x") == 1.0 / (1.0 + 5 * algo.shrink_coef)
    out = T.anneal.suggest([100], domain, trials, seed=1)
    assert np.isfinite(out[0]["misc"]["vals"]["x"][0])


def test_anneal_keeps_the_serial_loop():
    """No ``speculation_policy``: fmin's engine treats anneal as strict."""
    from hyperopt_tpu_torch.pipeline import _policy_for

    assert _policy_for(T.anneal.suggest)[0] == "strict"
    assert _policy_for(J.anneal.suggest) == _policy_for(T.anneal.suggest)


# -- mix --------------------------------------------------------------------


def recorder(calls, tag, pkg):
    def algo(new_ids, domain, trials, seed):
        calls.append((tag, seed))
        return pkg.rand.suggest(new_ids, domain, trials, seed,
                                **({"device": "cpu"} if pkg is T else {}))
    return algo


@pytest.mark.parametrize("seed", range(8))
def test_mix_pick_and_seed_equal_reference(seed):
    """The sub-algorithm drawn and the seed handed to it: exact."""
    calls = {J: [], T: []}
    for pkg in (J, T):
        d = (jdomains if pkg is J else tdomains).get("quadratic1")
        p_suggest = [(0.2, recorder(calls[pkg], "a", pkg)), (0.5, recorder(calls[pkg], "b", pkg)),
                     (0.3, recorder(calls[pkg], "c", pkg))]
        pkg.mix.suggest([0], pkg.Domain(d.fn, d.space), pkg.Trials(), seed, p_suggest=p_suggest)
    assert calls[T] == calls[J] and len(calls[T]) == 1


def test_mix_runs_end_to_end():
    d = tdomains.get("quadratic1")
    algo = partial(T.mix.suggest, p_suggest=[
        (0.3, CPU_RAND), (0.3, T.anneal.suggest),
        (0.4, partial(T.tpe.suggest, device="cpu"))])
    trials = T.Trials()
    T.fmin(d.fn, d.space, algo=algo, max_evals=40, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, verbose=False)
    assert len(trials) == 40 and min(trials.losses()) < 1.0


def test_mix_invalid_probs():
    d = tdomains.get("quadratic1")
    algo = partial(T.mix.suggest, p_suggest=[(0.5, CPU_RAND), (0.2, CPU_RAND)])
    with pytest.raises(ValueError):
        T.fmin(d.fn, d.space, algo=algo, max_evals=2, rstate=np.random.default_rng(0),
               show_progressbar=False, verbose=False)


# -- the domain zoo ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jdomains.DOMAINS))
def test_domains_equal_reference(name):
    """Each zoo domain: the same attributes, the same compiled spec table,
    and on 20 sample points (drawn by the JAX sampler) the same nested
    config and objective value, exactly."""
    jd, td = jdomains.get(name), tdomains.get(name)
    for attr in ("name", "quality_threshold", "quality_evals"):
        assert getattr(td, attr) == getattr(jd, attr)
    assert np.isnan(td.fmin) == np.isnan(jd.fmin) and (np.isnan(jd.fmin) or td.fmin == jd.fmin)
    jdom, tdom = J.Domain(jd.fn, jd.space), T.Domain(td.fn, td.space)
    assert {lb: (s.dist, s.params, s.conditions) for lb, s in tdom.space.specs.items()} == \
        {lb: (s.dist, s.params, s.conditions) for lb, s in jdom.space.specs.items()}
    trials = J.Trials()
    J.fmin(jd.fn, jd.space, algo=J.rand.suggest, max_evals=20, trials=trials,
           rstate=np.random.default_rng(0), show_progressbar=False, verbose=False)
    for doc in trials.trials:
        point = {k: v[0] for k, v in doc["misc"]["vals"].items() if v}
        jc, tc = J.space_eval(jd.space, point), T.space_eval(td.space, point)
        assert tc == jc
        assert td.fn(tc) == jd.fn(jc)
