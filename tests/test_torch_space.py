"""Space layer of the PyTorch port against the JAX package: pyll/hp specs,
conditions, activity masks and idxs/vals, plus random search by
distribution.  Everything runs on the CPU (``device="cpu"``)."""

import subprocess
import sys

import numpy as np
import pytest
from scipy import stats

import hyperopt_tpu as J
import hyperopt_tpu_torch as T
from hyperopt_tpu import rdists
from hyperopt_tpu.vectorize import CompiledSpace as JSpace
from hyperopt_tpu.vectorize import idxs_vals_from_batch as j_idxs_vals
from hyperopt_tpu_torch.vectorize import CompiledSpace as TSpace
from hyperopt_tpu_torch.vectorize import branch_activity
from hyperopt_tpu_torch.vectorize import idxs_vals_from_batch as t_idxs_vals


def quickstart(hp):
    """The README quick-start space."""
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-1)),
        "layers": hp.uniformint("layers", 1, 8),
        "arch": hp.choice("arch", [
            {"kind": "mlp", "width": hp.quniform("width", 64, 1024, 64)},
            {"kind": "cnn", "kernel": hp.choice("kernel", [3, 5, 7])},
        ]),
    }


def flat(hp):
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-1)),
        "n": hp.randint("n", 8),
        "m": hp.quniform("m", 0, 100, 10),
    }


def all_dists(hp):
    return {
        "u": hp.uniform("u", -1, 1),
        "qu": hp.quniform("qu", 0, 10, 0.5),
        "ui": hp.uniformint("ui", 0, 5),
        "lu": hp.loguniform("lu", 0, 2),
        "qlu": hp.qloguniform("qlu", 0, 3, 1),
        "n": hp.normal("n", 3, 2),
        "qn": hp.qnormal("qn", 0, 2, 1),
        "ln": hp.lognormal("ln", 0, 1),
        "qln": hp.qlognormal("qln", 0, 1, 1),
        "ri": hp.randint("ri", 2, 9),
        "c": hp.pchoice("c", [(0.2, "a"), (0.8, "b")]),
    }


def conditional(hp):
    return hp.choice("model", [
        {"kind": "svm", "C": hp.loguniform("C", -3, 3)},
        {"kind": "rf", "depth": hp.randint("depth", 10)},
    ])


def nested(hp):
    inner = hp.choice("inner", [{"a": hp.uniform("a", 0, 1)}, {"b": hp.normal("b", 0, 1)}])
    return hp.choice("outer", [inner, {"c": hp.uniform("c", 0, 1)}])


SPACES = {"quickstart": quickstart, "flat": flat, "all_dists": all_dists,
          "conditional": conditional, "nested": nested}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_specs_and_conditions_match(name):
    js, ts = JSpace(SPACES[name](J.hp)), TSpace(SPACES[name](T.hp))
    assert ts.compiled and js.compiled
    assert ts.labels == js.labels
    for lb in js.labels:
        a, b = js.specs[lb], ts.specs[lb]
        assert (b.dist, b.params, b.conditions) == (a.dist, a.params, a.conditions)
        assert (b.is_integer, b.upper) == (a.is_integer, a.upper)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_activity_masks_and_idxs_vals_match(name):
    js, ts = JSpace(SPACES[name](J.hp)), TSpace(SPACES[name](T.hp))
    n = 300
    vals, active = js.sample_batch(3, n)
    got = branch_activity(ts.specs, vals, n)
    for lb in js.labels:
        np.testing.assert_array_equal(got[lb], active[lb])
    tids = list(range(100, 100 + n))
    assert t_idxs_vals(tids, vals, got, ts.specs) == j_idxs_vals(tids, vals, active, js.specs)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_port_draws_respect_support_and_masks(name):
    ts = TSpace(SPACES[name](T.hp))
    n = 400
    vals, active = ts.sample_batch(5, n, device="cpu")
    assert set(vals) == set(ts.labels)
    for lb, sp in ts.specs.items():
        assert vals[lb].shape == (n,)
        if sp.upper is not None:
            low = sp.params.get("low", 0) if sp.dist == "randint" else 0
            assert np.all((vals[lb] >= low) & (vals[lb] < low + sp.upper))
    ref = branch_activity(ts.specs, vals, n)
    for lb in ts.labels:
        np.testing.assert_array_equal(active[lb], ref[lb])
    v2, _ = ts.sample_batch(5, n, device="cpu")
    for lb in ts.labels:
        np.testing.assert_array_equal(v2[lb], vals[lb])


def _rand_draws(space, n, seed=0):
    domain = T.Domain(lambda c: 0.0, space)
    trials = T.Trials()
    docs = T.rand.suggest(list(range(n)), domain, trials, seed, device="cpu")
    return {lb: np.array([d["misc"]["vals"][lb][0] for d in docs
                          if d["misc"]["vals"][lb]])
            for lb in domain.space.labels}


@pytest.mark.parametrize("label,cdf", [
    ("u", stats.uniform(-1, 2).cdf),
    ("lu", rdists.loguniform_gen(0, 2).cdf),
    ("n", stats.norm(3, 2).cdf),
    ("ln", rdists.lognorm_tx_gen(0, 1).cdf),
])
def test_rand_suggest_ks_against_rdists(label, cdf):
    draws = _rand_draws(all_dists(T.hp), 2000)[label]
    assert stats.kstest(draws, cdf).pvalue > 1e-3


def test_rand_suggest_quantized_chi2_against_rdists():
    draws = _rand_draws(all_dists(T.hp), 4000)["qu"]
    ref = rdists.quniform_gen(0, 10, 0.5)
    grid = ref.support()
    counts = np.array([np.sum(np.isclose(draws, g)) for g in grid])
    assert counts.sum() == len(draws)
    expected = ref.pmf(grid) * len(draws)
    assert stats.chisquare(counts, expected / expected.sum() * len(draws)).pvalue > 1e-3


def test_conditional_branches_by_rand_suggest():
    draws = _rand_draws(conditional(T.hp), 2000)
    assert len(draws["C"]) + len(draws["depth"]) == 2000
    assert abs(len(draws["C"]) / 2000 - 0.5) < 0.05
    assert np.all((draws["depth"] >= 0) & (draws["depth"] < 10))


def test_entry_points_need_a_card_or_an_explicit_cpu():
    code = (
        "import torch, numpy as np\n"
        "torch.cuda.is_available = lambda: False\n"
        "import hyperopt_tpu_torch as T\n"
        "space = {'x': T.hp.uniform('x', 0, 1)}\n"
        "try:\n"
        "    T.fmin(lambda c: c['x'], space, max_evals=2, show_progressbar=False)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "    print('refused')\n"
        "T.fmin(lambda c: c['x'], space, max_evals=2, show_progressbar=False,\n"
        "       algo=T.partial(T.rand.suggest, device='cpu'))\n"
        "print('cpu ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["refused", "cpu", "ok"]


def test_import_hygiene():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hyperopt_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, 'hyperopt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'hyperopt_tpu' or m.startswith('hyperopt_tpu.')]\n"
        "assert not bad, bad\n"
        "need = ['hyperopt_tpu_torch.' + m for m in ('rdists', 'algos.algobase',\n"
        "        'algos.anneal', 'algos.criteria', 'algos.mix', 'algos.atpe',\n"
        "        'models.domains', 'parallel.torch_trials')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "print(sum(m.startswith('hyperopt_tpu_torch') for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
