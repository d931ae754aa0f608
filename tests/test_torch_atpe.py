"""The port's ATPE against the JAX package's on the same trials: the
featurizer, the meta layer (with the shipped artifacts and with the
heuristics alone), the cascade's locks, the result filters, the artifact
copies, and whole ``atpe.suggest`` calls fed JAX's own uniform streams.
Everything runs on the CPU (``device="cpu"``); JAX's TPE step scores with
its plain ``pair_score`` there.
"""

import copy
import hashlib
import logging
import os
import shutil
from functools import partial

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu.algos import atpe as jatpe
from hyperopt_tpu.models import domains as jdomains
from hyperopt_tpu_torch.algos import atpe as tatpe
from hyperopt_tpu_torch.algos import tpe as ttpe
from hyperopt_tpu_torch.models import domains as tdomains
from test_torch_tpe import jax_streams  # JAX's uniforms, for injection

SEEDS = range(10)


def jax_history(name, n, seed=0, nan_tid=None):
    """``n`` random-search trials on zoo domain ``name``, run by the JAX
    package (trial ``nan_tid``'s loss then set to NaN, a diverged trial);
    the port's Trials hold copies of the same docs."""
    d = jdomains.get(name)
    jt = J.Trials()
    J.fmin(d.fn, d.space, algo=J.rand.suggest, max_evals=n, trials=jt,
           rstate=np.random.default_rng(seed), show_progressbar=False, verbose=False)
    if nan_tid is not None:
        jt.trials[nan_tid]["result"]["loss"] = float("nan")
        jt.refresh()
    tt = T.trials_from_docs(copy.deepcopy(jt.trials))
    td = tdomains.get(name)
    return J.Domain(d.fn, d.space), jt, T.Domain(td.fn, td.space), tt


@pytest.fixture(scope="module")
def histories():
    return {
        "branin": jax_history("branin", 60, seed=1),
        "many_dists": jax_history("many_dists", 320, seed=2),
        "q1_choice": jax_history("q1_choice", 50, seed=3, nan_tid=7),
    }


# -- featurizer, meta layer, cascade, filters -------------------------------


@pytest.mark.parametrize("name", ["branin", "many_dists", "q1_choice"])
def test_features_equal_reference(histories, name):
    """Every feature and per-parameter correlation to rtol 1e-12 (NaN where
    the reference has NaN), on histories with and without a NaN loss."""
    jdom, jt, tdom, tt = histories[name]
    jf, jc = jatpe.ATPEOptimizer().compute_features(jdom, jt)
    tf, tc = tatpe.ATPEOptimizer().compute_features(tdom, tt)
    assert list(tf) == list(jf) == list(tatpe.FEATURE_NAMES)
    np.testing.assert_allclose([tf[k] for k in tf], [jf[k] for k in jf], rtol=1e-12, atol=0)
    assert list(tc) == list(jc)
    np.testing.assert_allclose(list(tc.values()), list(jc.values()), rtol=1e-12, atol=0)


@pytest.mark.parametrize("model_dir", [None, ""], ids=["artifacts", "heuristics"])
@pytest.mark.parametrize("name", ["branin", "many_dists", "q1_choice"])
def test_predict_meta_equal_reference(histories, name, model_dir):
    """The meta-parameters from each package's shipped artifacts (or from
    the heuristic rules alone, ``model_dir=""``): equal."""
    jdom, jt, tdom, tt = histories[name]
    jopt, topt = jatpe._optimizer_for(model_dir), tatpe._optimizer_for(model_dir)
    assert sorted(topt.models) == sorted(jopt.models)
    jf, _ = jopt.compute_features(jdom, jt)
    tf, _ = topt.compute_features(tdom, tt)
    assert topt.predict_meta(tf) == jopt.predict_meta(jf)


@pytest.mark.parametrize("name", ["branin", "many_dists", "q1_choice"])
def test_locks_equal_reference(histories, name):
    """choose_locks from one seeded rng per seed, then locks_from_labels:
    the same labels and the same (center, radius)."""
    jdom, jt, tdom, tt = histories[name]
    _, jc = jatpe.ATPEOptimizer().compute_features(jdom, jt)
    _, tc = tatpe.ATPEOptimizer().compute_features(tdom, tt)
    assert tatpe.ATPEOptimizer.condition_driver_labels(tdom) == \
        jatpe.ATPEOptimizer.condition_driver_labels(jdom)
    n_locked = 0
    for seed in SEEDS:
        excl = tatpe.ATPEOptimizer.condition_driver_labels(tdom)
        jl = jatpe.ATPEOptimizer.choose_locks(jc, 0.3, np.random.default_rng(seed), excl)
        tl = tatpe.ATPEOptimizer.choose_locks(tc, 0.3, np.random.default_rng(seed), excl)
        assert tl == jl
        assert tatpe.locks_from_labels(tdom, tt, tl) == jatpe.locks_from_labels(jdom, jt, jl)
        n_locked += len(tl)
    assert n_locked > 0 or name == "q1_choice"  # its leaves all carry influence


@pytest.mark.parametrize("mode,mult", [("none", 1.0), ("age", 0.5), ("loss_rank", 0.3),
                                       ("random", 0.7), ("age", 0.01)])
def test_trial_filter_masks_equal_reference(histories, mode, mult):
    _, jt, _, tt = histories["many_dists"]
    jf, tf = jatpe.build_trial_filter(mode, mult), tatpe.build_trial_filter(mode, mult)
    assert (jf is None) == (tf is None)
    if tf is not None:
        np.testing.assert_array_equal(tf(tt.history), jf(jt.history))


def test_artifacts_are_byte_copies():
    """The port's artifact directory holds exactly the reference's files,
    each with the same sha256, and it is the port's default."""
    def digests(path):
        return {f: hashlib.sha256(open(os.path.join(path, f), "rb").read()).hexdigest()
                for f in sorted(os.listdir(path))}

    ref, got = digests(jatpe.DEFAULT_MODEL_DIR), digests(tatpe.DEFAULT_MODEL_DIR)
    assert got == ref and len(got) == 8
    assert os.path.realpath(tatpe.DEFAULT_MODEL_DIR) != os.path.realpath(jatpe.DEFAULT_MODEL_DIR)
    assert os.path.realpath(tatpe.DEFAULT_MODEL_DIR).startswith(
        os.path.realpath(os.path.dirname(T.__file__)))


def test_unloadable_pickle_keeps_the_heuristic(histories, tmp_path, caplog):
    """A pickle that cannot load (as on a machine without sklearn) logs the
    reference's warning and leaves that target on its heuristic rule; the
    meta-parameters equal the reference's under the same artifacts."""
    for f in os.listdir(tatpe.DEFAULT_MODEL_DIR):
        shutil.copy(os.path.join(tatpe.DEFAULT_MODEL_DIR, f), tmp_path / f)
    (tmp_path / "model-secondary_cutoff.pkl").write_bytes(b"not a pickle")
    with caplog.at_level(logging.WARNING):
        topt = tatpe.ATPEOptimizer(model_dir=str(tmp_path))
        jopt = jatpe.ATPEOptimizer(model_dir=str(tmp_path))
    warned = [r for r in caplog.records if "could not load" in r.getMessage()]
    assert [r.name for r in warned] == ["hyperopt_tpu_torch.algos.atpe", "hyperopt_tpu.algos.atpe"]
    assert "secondary_cutoff" not in topt.models and len(topt.models) == 5
    jdom, jt, tdom, tt = histories["branin"]
    tf, _ = topt.compute_features(tdom, tt)
    heuristic = tatpe.ATPEOptimizer._heuristic_meta(tf)
    meta = topt.predict_meta(tf)
    assert meta["secondary_cutoff"] == heuristic["secondary_cutoff"]
    assert meta == jopt.predict_meta(jopt.compute_features(jdom, jt)[0])


# -- whole suggests ---------------------------------------------------------


def assert_winners_match(tdom, tt, out, calls, ids):
    """``out``: {seed: (jax docs, port docs)}.  Winners equal JAX's to
    rtol 1e-5 on >= 95% of (seed, id, label) values, and each mismatch is a
    near-tie: the port's own scorer, at that suggest's exact inputs, puts
    the two values within 1e-4."""
    mismatches, n = [], 0
    for seed, (jdocs, tdocs) in out.items():
        for jd, td in zip(jdocs, tdocs):
            assert td["misc"]["idxs"] == jd["misc"]["idxs"], seed
            for lb, jv in jd["misc"]["vals"].items():
                for a, b in zip(jv, td["misc"]["vals"][lb]):
                    n += 1
                    if not np.isclose(b, a, rtol=1e-5, atol=0):
                        mismatches.append((seed, lb, a, b))
    assert n and len(mismatches) <= 0.05 * n, mismatches
    for seed, lb, a, b in mismatches:
        sa, sb = ttpe.plain_label_scores(ids, tdom, tt, seed, lb, [a, b], **calls[seed])
        assert abs(sa - sb) < 1e-4, (seed, lb, a, b, sa, sb)


@pytest.mark.parametrize("name", ["branin", "many_dists"])
def test_atpe_suggest_winners_match_jax(histories, name, monkeypatch):
    """Whole ``atpe.suggest`` with JAX's streams injected: the same
    meta-parameters, locks and filter reach each package's TPE step, and
    the winners follow the rule of :func:`assert_winners_match`.
    many_dists at 320 trials takes the age filter (over 300 trials), and
    its low-influence labels lock."""
    jdom, jt, tdom, tt = histories[name]
    calls = {}
    real = ttpe.suggest

    def recording(new_ids, domain, trials, seed, **kw):
        calls[seed] = {k: v for k, v in kw.items() if k != "device"}
        return real(new_ids, domain, trials, seed, **kw)

    monkeypatch.setattr(ttpe, "_label_uniforms", jax_streams)
    monkeypatch.setattr(ttpe, "suggest", recording)
    out = {seed: (J.atpe.suggest([1000], jdom, jt, seed),
                  T.atpe.suggest([1000], tdom, tt, seed, device="cpu")) for seed in SEEDS}
    monkeypatch.setattr(ttpe, "suggest", real)
    assert len(calls) == len(SEEDS)
    if name == "many_dists":
        assert all(c["trial_filter"] is not None for c in calls.values())
        assert sum(bool(c["param_locks"]) for c in calls.values()) >= len(SEEDS) // 2
    assert_winners_match(tdom, tt, out, calls, [1000])


def test_atpe_startup_and_determinism():
    d = tdomains.get("quadratic1")
    dom = T.Domain(d.fn, d.space)
    assert len(T.atpe.suggest([0], dom, T.Trials(), seed=0, device="cpu")) == 1
    _, _, tdom, tt = jax_history("branin", 40)
    a = T.atpe.suggest([100], tdom, tt, seed=9, device="cpu")
    b = T.atpe.suggest([100], tdom, tt, seed=9, device="cpu")
    assert a[0]["misc"]["vals"] == b[0]["misc"]["vals"]


def test_atpe_fmin_on_conditional_space():
    d = tdomains.get("q1_choice")
    trials = T.Trials()
    T.fmin(d.fn, d.space, algo=partial(T.atpe.suggest, device="cpu"), max_evals=60,
           trials=trials, rstate=np.random.default_rng(3), show_progressbar=False,
           verbose=False)
    assert len(trials) == 60
    for doc in trials.trials:
        v = doc["misc"]["vals"]
        assert bool(v["xl"]) != bool(v["xr"]) and bool(v["xr"]) == (v["mode"][0] == 1)


def test_locked_branch_driver_keeps_docs_consistent(histories):
    """Hard-locking the choice driver itself gives docs whose active child
    matches the pinned branch, and each evaluates."""
    _, _, tdom, tt = histories["q1_choice"]
    docs = T.tpe.suggest(list(range(1000, 1010)), tdom, tt, seed=7,
                         param_locks={"mode": (1.0, 0.0)}, device="cpu")
    for doc in docs:
        m = doc["misc"]
        assert m["vals"]["mode"][0] == 1 and m["vals"]["xr"] and not m["vals"]["xl"]
        res = tdom.evaluate(T.base.spec_from_misc(m), T.Ctrl(tt))
        assert res["status"] == "ok"


def test_atpe_mesh_is_not_ported(histories):
    _, _, tdom, tt = histories["branin"]
    with pytest.raises(NotImplementedError, match="item 7"):
        T.atpe.suggest([100], tdom, tt, seed=0, device="cpu", mesh=object())
