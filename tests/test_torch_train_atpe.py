"""The port's ATPE meta-model trainer against the JAX package's: the
constants, the config sampler, the labels, the fit (equal scaling, equal
predictions, byte-equal ``scaling_model.json``, pickles loaded across the
packages), the corpus build's features against the reference's on the
same snapshot docs, shards read across the packages, the whole ``--quick``
run, and the guards: no fit without sklearn, no held-out difference from
artifacts that did not load, no move to the CPU on its own.

Everything runs on the CPU (``device="cpu"``, ``--device cpu``).  One
``--quick`` run of the port's ``main`` is shared by the module's tests
(``quick``); its corpus build is recorded on the way.
"""

import copy
import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu.algos import atpe as jatpe
from hyperopt_tpu.models import domains as jdomains
from hyperopt_tpu.models import train_atpe as jta
from hyperopt_tpu_torch.algos import atpe as tatpe
from hyperopt_tpu_torch.models import domains as tdomains
from hyperopt_tpu_torch.models import train_atpe as ta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK_DOMAINS = ("quadratic1", "gauss_wave2")
# tiny shard flags (no --quick): one state of 20 random trials, 2 configs
# of 2 TPE continuation evals
TINY = ["--domains", "quadratic1", "--seeds", "1", "--configs", "2", "--cont-evals", "2",
        "--checkpoints", "20"]


def silent(*_):
    pass


def digests(path):
    return {f: hashlib.sha256(open(os.path.join(path, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """``main(["--quick", "--device", "cpu", "--out", tmp])`` once, with
    its corpus rows recorded from ``build_corpus``, and the shipped
    artifacts' digests before and after."""
    out = str(tmp_path_factory.mktemp("quick_artifacts"))
    shipped = digests(tatpe.DEFAULT_MODEL_DIR)
    built = []
    real = ta.build_corpus

    def recording(*args, **kw):
        built.append((args, kw, real(*args, **kw)))
        return built[-1][2]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta, "build_corpus", recording)
        rc = ta.main(["--quick", "--device", "cpu", "--out", out])
    assert len(built) == 1
    args, kw, rows = built[0]
    return {"rc": rc, "out": out, "rows": rows, "args": args, "kw": kw,
            "shipped_before": shipped, "shipped_after": digests(tatpe.DEFAULT_MODEL_DIR)}


def synthetic_rows(seed, n_domains=4, per_domain=6, n_configs=12):
    """``FEATURE_NAMES`` features over ``n_domains`` ``_domain`` groups,
    labels from ``label_results`` over continuation results whose losses
    depend on the features (so the fits have something to learn)."""
    rng = np.random.default_rng(seed)
    rows = []
    for d in range(n_domains):
        for _ in range(per_domain):
            x = rng.uniform(0.0, 4.0, size=len(tatpe.FEATURE_NAMES))
            feats = {k: float(v) for k, v in zip(tatpe.FEATURE_NAMES, x)}
            feats["_domain"] = f"dom{d}"
            cfgs = ta.sample_configs(n_configs, rng)
            results = [(float(rng.normal() + x[0] * c["gamma"] + x[1] * c["prior_weight"]), c)
                       for c in cfgs]
            rows.append((feats, ta.label_results(results)))
    return rows


# -- 1-3: constants, sampler, labels ----------------------------------------


@pytest.mark.parametrize("name", ["HELD_OUT", "DEFAULT_DOMAINS", "GRID", "CV_R2_MIN",
                                  "CV_ACC_MARGIN"])
def test_constants_equal_reference(name):
    assert getattr(ta, name) == getattr(jta, name)
    assert type(getattr(ta, name)) is type(getattr(jta, name))


@pytest.mark.parametrize("n", [1, 6, 32, 96])
def test_sample_configs_equal_reference(n):
    """The same configs, in the same order and of the same types, over
    several seeds; n = 96 exhausts the 96-point grid."""
    for seed in range(5):
        got = ta.sample_configs(n, np.random.default_rng(seed))
        ref = jta.sample_configs(n, np.random.default_rng(seed))
        assert got == ref
        assert [[type(v) for v in c.values()] for c in got] == \
            [[type(v) for v in c.values()] for c in ref]
    if n == 96:
        assert len({tuple(sorted((k, str(v)) for k, v in c.items())) for c in got}) == 96


@pytest.mark.parametrize("seed", range(4))
def test_label_results_equal_reference(seed):
    """Labels of synthetic continuation results (ties among the losses
    included) and the relabelling of rows with and without ``_results``."""
    rng = np.random.default_rng(seed)
    cfgs = ta.sample_configs(20, rng)
    losses = np.round(rng.normal(size=len(cfgs)), 1)  # rounding makes ties
    results = [(float(b), c) for b, c in zip(losses, cfgs)]
    got, ref = ta.label_results(results), jta.label_results(results)
    assert got == ref
    rows = [({"n_trials": 1.0}, got), ({"n_trials": 2.0}, {"gamma": 0.3})]
    assert ta.relabel_rows(rows) == jta.relabel_rows(rows)
    with pytest.raises(ValueError, match="empty"):
        ta.label_results([])


# -- 4: the fit --------------------------------------------------------------


def test_fit_models_and_artifacts_equal_reference(tmp_path):
    """Equal scaling and equal predictions from every model; a byte-equal
    ``scaling_model.json``; each package's ``ATPEOptimizer`` loads the
    other's pickles and predicts the same meta-parameters."""
    rows = synthetic_rows(0)
    assert len({lab["result_filtering_mode"] for _, lab in rows}) >= 2
    tmodels, tscaling = ta.fit_models(rows, log=silent)
    jmodels, jscaling = jta.fit_models(rows, log=silent)
    assert tscaling == jscaling
    assert sorted(tmodels) == sorted(jmodels) == sorted(tatpe.META_TARGETS)
    probe = np.random.default_rng(1).normal(size=(16, len(tatpe.FEATURE_NAMES)))
    for target in tmodels:
        np.testing.assert_array_equal(tmodels[target].predict(probe),
                                      jmodels[target].predict(probe))
    tdir, jdir = tmp_path / "port", tmp_path / "ref"
    ta.write_artifacts(tmodels, tscaling, str(tdir))
    jta.write_artifacts(jmodels, jscaling, str(jdir))
    assert (tdir / "scaling_model.json").read_bytes() == (jdir / "scaling_model.json").read_bytes()
    t_on_j, j_on_t = tatpe.ATPEOptimizer(model_dir=str(jdir)), jatpe.ATPEOptimizer(model_dir=str(tdir))
    assert sorted(t_on_j.models) == sorted(j_on_t.models) == sorted(tatpe.META_TARGETS)
    for feats, _ in rows[::5]:
        assert t_on_j.predict_meta(feats) == j_on_t.predict_meta(feats)


def test_fit_models_refuses_rows_without_domain():
    rows = synthetic_rows(1, n_domains=3, per_domain=2)
    del rows[0][0]["_domain"]
    with pytest.raises(ValueError, match="_domain"):
        ta.fit_models(rows, log=silent)


# -- 5-6: the corpus build, shards -----------------------------------------


def test_quick_build_rows_and_labels_in_grid(quick):
    """The ``--quick`` build on the CPU: 2 rows, one per domain, every
    feature finite, every label inside the grid's span, no tensor."""
    args, kw, rows = quick["args"], quick["kw"], quick["rows"]
    assert list(args[0]) == list(QUICK_DOMAINS) and str(kw["device"]) == "cpu"
    assert len(rows) == 2 and [f["_domain"] for f, _ in rows] == list(QUICK_DOMAINS)
    g = ta.GRID
    for feats, labels in rows:
        assert list(feats) == [*tatpe.FEATURE_NAMES, "_domain"]
        assert all(math.isfinite(feats[k]) for k in tatpe.FEATURE_NAMES)
        assert min(g["gamma"]) <= labels["gamma"] <= max(g["gamma"])
        assert np.log2(min(g["n_EI_candidates"])) <= labels["n_EI_candidates"] \
            <= np.log2(max(g["n_EI_candidates"]))
        assert min(g["prior_weight"]) <= labels["prior_weight"] <= max(g["prior_weight"])
        assert min(g["secondary_cutoff"]) <= labels["secondary_cutoff"] \
            <= max(g["secondary_cutoff"])
        modes = dict(g["result_filtering"])
        assert labels["result_filtering_mode"] in modes
        assert min(modes.values()) <= labels["result_filtering_multiplier"] <= 1.0
        assert len(labels["_results"]) == 6
    assert ta._tensor_path(rows) is None


@pytest.mark.parametrize("name", QUICK_DOMAINS)
def test_quick_build_features_equal_reference_on_the_snapshot(quick, name):
    """Each row's features equal the reference's ``compute_features`` on
    the same snapshot docs (the base run repeated at its seed, which
    gives the same docs): rtol 1e-6, the f32 resolution of the drawn
    values, though the two agree exactly here."""
    feats = dict(next(f for f, _ in quick["rows"] if f["_domain"] == name))
    del feats["_domain"]
    base = ta._run_base(tdomains.get(name), 0, 20, device="cpu")
    snapshot = [d for d in base.trials if d["tid"] < 20]
    tdom = T.Domain(tdomains.get(name).fn, tdomains.get(name).space)
    again, _ = tatpe.ATPEOptimizer().compute_features(
        tdom, T.trials_from_docs(copy.deepcopy(snapshot)))
    assert again == feats  # the snapshot is the one the build featurized
    jd = jdomains.get(name)
    ref, _ = jatpe.ATPEOptimizer().compute_features(
        J.Domain(jd.fn, jd.space), J.trials_from_docs(copy.deepcopy(snapshot)))
    assert list(ref) == list(feats)
    np.testing.assert_allclose([feats[k] for k in ref], [ref[k] for k in ref], rtol=1e-6,
                               atol=0)


def test_shards_cross_load_both_ways(quick, tmp_path):
    rows = quick["rows"]
    ta.save_rows(rows, str(tmp_path / "port.pkl"))
    jta.save_rows(rows, str(tmp_path / "ref.pkl"))
    assert jta.load_rows([str(tmp_path / "port.pkl")]) == rows
    assert ta.load_rows([str(tmp_path / "ref.pkl")]) == rows
    assert ta.load_rows([str(tmp_path / "port.pkl"), str(tmp_path / "ref.pkl")]) == rows + rows


def test_save_rows_refuses_a_tensor(quick, tmp_path):
    feats, labels = quick["rows"][0]
    bad = [(dict(feats, n_trials=torch.tensor(20.0)), labels)]
    with pytest.raises(TypeError, match="n_trials"):
        ta.save_rows(bad, str(tmp_path / "bad.pkl"))
    assert not (tmp_path / "bad.pkl").exists()


# -- 7: the whole --quick run ------------------------------------------------


def test_quick_main_writes_validated_artifacts(quick):
    """Exit 0; a model per target whose labels vary over the corpus (the
    filtering-mode classifier is skipped where every row votes one mode,
    as in the reference), all loaded by the port's ``atpe``; a scaling
    file with provenance and a finite held-out difference; the shipped
    artifacts untouched."""
    assert quick["rc"] == 0
    rows = quick["rows"]
    varying = [t for t in tatpe.META_TARGETS
               if t != "result_filtering_mode"
               or len({lab[t] for _, lab in rows}) > 1]
    out = quick["out"]
    written = os.listdir(out)
    assert sorted(written) == sorted(
        ["scaling_model.json", *(f"model-{t}.pkl" for t in varying)])
    # the classifier is missing only where the corpus votes one mode; its
    # fit and both packages' loading of it are held on synthetic rows of
    # two modes (test_fit_models_and_artifacts_equal_reference)
    modes = {lab["result_filtering_mode"] for _, lab in rows}
    assert ("model-result_filtering_mode.pkl" in written) == (len(modes) > 1)
    scaling = json.load(open(os.path.join(out, "scaling_model.json")))
    prov = scaling["provenance"]
    assert prov["held_out_domains"] == list(ta.HELD_OUT)
    assert prov["train_domains"] == sorted(QUICK_DOMAINS)
    assert math.isfinite(prov["held_out_mean_regret_diff"])
    assert scaling["corpus_rows"] == 2
    opt = tatpe.ATPEOptimizer(model_dir=out)
    assert sorted(opt.models) == sorted(varying)
    assert quick["shipped_after"] == quick["shipped_before"] == digests(jatpe.DEFAULT_MODEL_DIR)


# -- 8-11: the guards ---------------------------------------------------------


def test_fitting_without_sklearn_fails_before_any_build(tmp_path, monkeypatch):
    """With sklearn unimportable, the direct path and ``--fit-from`` raise
    naming it before any row is built or loaded; ``--rows-out`` works."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    calls = []
    monkeypatch.setattr(ta, "build_corpus", lambda *a, **k: calls.append("build"))
    monkeypatch.setattr(ta, "load_rows", lambda *a, **k: calls.append("load"))
    shard = str(tmp_path / "shard.pkl")
    with pytest.raises(RuntimeError, match="sklearn"):
        ta.main(["--quick", "--device", "cpu", "--out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="sklearn"):
        ta.main(["--fit-from", shard, "--device", "cpu", "--out", str(tmp_path / "out")])
    assert calls == [] and not (tmp_path / "out").exists()
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "sklearn", None)
    assert ta.main([*TINY, "--device", "cpu", "--rows-out", shard]) == 0
    rows = ta.load_rows([shard])
    assert len(rows) == 1 and rows[0][0]["_domain"] == "quadratic1"


class Unloadable:
    """Pickles, and raises when unpickled (a skewed or absent library)."""

    def __reduce__(self):
        return (_refuse_load, ())


def _refuse_load():
    raise ImportError("this model cannot be loaded here")


def test_held_out_regret_raises_when_a_model_does_not_load():
    rows = synthetic_rows(2, n_domains=3, per_domain=3)
    models, scaling = ta.fit_models(rows, log=silent)
    models["secondary_cutoff"] = Unloadable()
    cached = set(tatpe._optimizer_cache)
    with pytest.raises(RuntimeError, match="secondary_cutoff"):
        ta._held_out_regret(models, scaling, seeds=(0,), max_evals=25, log=silent,
                            device="cpu")
    assert set(tatpe._optimizer_cache) == cached  # the removed directory is forgotten


_NO_JAX_NO_SKLEARN = (
    "import importlib.abc, runpy, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'hyperopt_tpu', 'orbax', 'sklearn'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = ['train_atpe'] + sys.argv[1:]\n"
    "runpy.run_module('hyperopt_tpu_torch.models.train_atpe', run_name='__main__',"
    " alter_sys=True)\n"
)


def test_cli_rows_out_without_jax_or_sklearn(tmp_path):
    """``python -m hyperopt_tpu_torch.models.train_atpe --rows-out`` in a
    process where jax, ``hyperopt_tpu``, orbax and sklearn cannot import;
    the shard loads in the reference's ``load_rows``."""
    shard = str(tmp_path / "shard.pkl")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_NO_SKLEARN, *TINY, "--device", "cpu",
                           "--rows-out", shard], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "saved 1 rows" in proc.stdout
    rows = jta.load_rows([shard])
    assert len(rows) == 1 and all(math.isfinite(rows[0][0][k]) for k in tatpe.FEATURE_NAMES)


def test_no_device_means_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """Without ``--device`` the run asks for the card; with none it raises
    ``resolve_device``'s error before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    real, calls = ta.build_corpus, []
    monkeypatch.setattr(ta, "build_corpus", lambda *a, **k: calls.append("build"))
    shard = tmp_path / "shard.pkl"
    with pytest.raises(RuntimeError, match="CUDA device"):
        ta.main([*TINY, "--rows-out", str(shard)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        real(["quadratic1"], [0], (20,), 1, 1, log=silent)
    assert calls == [] and not shard.exists()
