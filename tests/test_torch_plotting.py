"""The port's ``plotting``: ``tests/test_plotting.py``'s plotting cases
against ``hyperopt_tpu_torch.plotting`` (Agg backend), and the same trial
docs drawn by both packages give figures with the same data."""

import matplotlib

matplotlib.use("Agg")

from functools import partial

import numpy as np
import pytest

from hyperopt_tpu import base as jbase
from hyperopt_tpu import plotting as jplot
import hyperopt_tpu_torch as T
from hyperopt_tpu_torch.plotting import (
    main_plot_1D_attachment,
    main_plot_histogram,
    main_plot_history,
    main_plot_vars,
)


@pytest.fixture(scope="module")
def run_trials():
    trials = T.Trials()
    space = {
        "x": T.hp.uniform("x", -5, 5),
        "lr": T.hp.loguniform("lr", np.log(1e-6), np.log(1.0)),
    }
    T.fmin(
        lambda c: (c["x"] - 3) ** 2 + abs(np.log10(c["lr"]) + 3) * 0.1,
        space,
        algo=partial(T.rand.suggest, device="cpu"),
        max_evals=30,
        trials=trials,
        rstate=np.random.default_rng(0),
        show_progressbar=False,
        verbose=False,
    )
    return trials


def _data(fig):
    """Every line's and scatter collection's data, axis by axis."""
    out = []
    for ax in fig.get_axes():
        out.append((ax.get_title(), ax.get_xscale(),
                    [np.asarray(ln.get_xydata()).tolist() for ln in ax.get_lines()],
                    [np.asarray(c.get_offsets()).tolist() for c in ax.collections],
                    [round(p.get_height(), 12) for p in ax.patches]))
    return out


def test_plot_history(run_trials):
    fig = main_plot_history(run_trials, do_show=False)
    assert fig is not None
    matplotlib.pyplot.close("all")


def test_plot_histogram(run_trials):
    fig = main_plot_histogram(run_trials, do_show=False)
    assert fig is not None
    matplotlib.pyplot.close("all")


def test_plot_vars_log_detection(run_trials):
    fig = main_plot_vars(run_trials, do_show=False, colorize_best=3)
    assert fig is not None
    scales = {ax.get_title(): ax.get_xscale() for ax in fig.get_axes() if ax.get_title()}
    assert scales.get("lr") == "log"  # spans > 2 decades
    assert scales.get("x") == "linear"
    matplotlib.pyplot.close("all")


def test_plot_empty_trials():
    t = T.Trials()
    assert main_plot_histogram(t, do_show=False) is None
    assert main_plot_vars(t, do_show=False) is None
    matplotlib.pyplot.close("all")


def test_plot_1d_attachment(run_trials):
    for t in run_trials.trials[::3]:
        run_trials.trial_attachments(t)["curve"] = np.linspace(
            t["result"]["loss"] + 1.0, t["result"]["loss"], 20
        )
    fig = main_plot_1D_attachment(run_trials, "curve", do_show=False)
    assert fig is not None
    assert len(fig.gca().lines) == len(run_trials.trials[::3])
    matplotlib.pyplot.close("all")


def test_plot_1d_attachment_absent_warns(run_trials, caplog):
    with caplog.at_level("WARNING"):
        main_plot_1D_attachment(run_trials, "nope", do_show=False)
    assert any("nope" in r.message for r in caplog.records)
    matplotlib.pyplot.close("all")


def test_plot_1d_attachment_non_ok_trial_alpha_clamped(run_trials):
    # a failed trial with a loss worse than every OK loss must not
    # produce a negative alpha
    bad = run_trials.trials[0]
    worst = max(t["result"]["loss"] for t in run_trials.trials)
    orig = dict(bad["result"])
    bad["result"] = {"status": "fail", "loss": worst + 100.0}
    try:
        run_trials.trial_attachments(bad)["curve2"] = np.linspace(1, 0, 5)
        fig = main_plot_1D_attachment(run_trials, "curve2", do_show=False)
        assert fig is not None
    finally:
        bad["result"] = orig
    matplotlib.pyplot.close("all")


@pytest.mark.parametrize("name", ["main_plot_history", "main_plot_histogram", "main_plot_vars"])
def test_same_figure_data_as_the_jax_package(run_trials, name):
    jtrials = jbase.trials_from_docs([dict(d) for d in run_trials.trials])
    got = _data(getattr(T.plotting, name)(run_trials, do_show=False))
    matplotlib.pyplot.close("all")
    want = _data(getattr(jplot, name)(jtrials, do_show=False))
    matplotlib.pyplot.close("all")
    assert got == want
