"""Post-hoc visualization of trials.

Reference parity: ``hyperopt_tpu/plotting.py`` (after
``hyperopt/plotting.py``) —
``main_plot_history`` (loss vs trial time, colored by status),
``main_plot_histogram``, ``main_plot_vars`` (per-hyperparameter scatter of
loss with log-scale detection), ``main_plot_1D_attachment`` (per-trial
1-D attachment curves, darker for lower loss).

matplotlib is imported lazily so headless installs without it can use the
rest of the framework; pass ``do_show=False`` to compose into figures.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from .base import STATUS_OK

logger = logging.getLogger(__name__)

default_status_colors = {
    "new": "k",
    "running": "g",
    "ok": "b",
    "fail": "r",
}


def _plt():
    import matplotlib.pyplot as plt

    return plt


def main_plot_history(trials, do_show=True, status_colors=None, title="Loss History"):
    """Scatter of loss per trial index, colored by status, with a
    best-so-far line."""
    plt = _plt()
    if status_colors is None:
        status_colors = default_status_colors

    Xs, Ys, Cs, ok = [], [], [], []
    for i, trial in enumerate(trials.trials):
        status = trial["result"].get("status", "new")
        loss = trial["result"].get("loss")
        if loss is None or (isinstance(loss, float) and math.isnan(loss)):
            continue
        Xs.append(i)
        Ys.append(float(loss))
        Cs.append(status_colors.get(status, "k"))
        if status == STATUS_OK:
            ok.append((i, float(loss)))
    plt.scatter(Xs, Ys, c=Cs, s=12)
    if ok:  # best-so-far envelope over ok trials
        xs, ys = zip(*ok)
        best = np.minimum.accumulate(ys)
        plt.plot(xs, best, color="g", label="best so far")
        plt.legend()
    plt.xlabel("trial")
    plt.ylabel("loss")
    plt.title(title)
    if do_show:
        plt.show()
    return plt.gcf()


def main_plot_histogram(trials, do_show=True, title="Loss Histogram"):
    """Histogram of completed-trial losses."""
    plt = _plt()
    status_ok = [
        float(t["result"]["loss"])
        for t in trials.trials
        if t["result"].get("status") == STATUS_OK
        and t["result"].get("loss") is not None
    ]
    if not status_ok:
        logger.warning("main_plot_histogram: no ok trials")
        return None
    plt.hist(status_ok, bins=min(50, max(10, len(status_ok) // 5)))
    plt.xlabel("loss")
    plt.ylabel("frequency")
    plt.title(f"{title}: {len(status_ok)} ok trials")
    if do_show:
        plt.show()
    return plt.gcf()


def main_plot_1D_attachment(
    trials,
    attachment_name,
    do_show=True,
    colorize_by_loss=True,
    max_darkness=0.5,
    num_trials=None,
    preprocessing_fn=lambda x: x,
):
    """One line per trial of a 1-D per-trial attachment (e.g. a learning
    curve stored via ``ctrl.attachments[name] = …``), darker for lower
    loss (reference parity: ``hyperopt/plotting.py —
    main_plot_1D_attachment``).

    ``preprocessing_fn`` maps the stored attachment value (often pickled
    bytes) to a 1-D sequence; ``num_trials`` limits to the most recent N.
    """
    plt = _plt()
    docs = trials.trials if num_trials is None else trials.trials[-num_trials:]
    losses = [
        t["result"].get("loss")
        for t in docs
        if t["result"].get("status") == STATUS_OK
        and t["result"].get("loss") is not None
    ]
    lo = min(losses) if losses else 0.0
    hi = max(losses) if losses else 1.0
    span = (hi - lo) or 1.0
    n_plotted = 0
    for t in docs:
        att = trials.trial_attachments(t)
        if attachment_name not in att:
            continue
        ys = np.asarray(preprocessing_fn(att[attachment_name]), dtype=float)
        if ys.ndim != 1:
            logger.warning(
                "main_plot_1D_attachment: %r on tid %s is not 1-D (shape %s)",
                attachment_name, t.get("tid"), ys.shape,
            )
            continue
        loss = t["result"].get("loss")
        if colorize_by_loss and loss is not None:
            # lo/hi come from OK trials only, but any doc may carry the
            # attachment (e.g. a failed trial with a worse loss) — clamp
            # so the alpha stays a valid color component
            frac = (float(loss) - lo) / span
            darkness = max_darkness * min(1.0, max(0.0, 1.0 - frac))
        else:
            darkness = max_darkness
        plt.plot(ys, color=(0.0, 0.0, 0.0, min(1.0, darkness + 0.1)))
        n_plotted += 1
    if not n_plotted:
        logger.warning(
            "main_plot_1D_attachment: no trials carry attachment %r",
            attachment_name,
        )
    plt.xlabel("index")
    plt.ylabel(attachment_name)
    plt.title(f"{attachment_name} across {n_plotted} trials")
    if do_show:
        plt.show()
    return plt.gcf()


def _looks_log_scaled(vals):
    vals = np.asarray(vals, dtype=float)
    if len(vals) < 4 or np.any(vals <= 0):
        return False
    spread = vals.max() / max(vals.min(), 1e-300)
    return spread > 100.0


def main_plot_vars(
    trials,
    do_show=True,
    colorize_best=None,
    columns=3,
    arrange_by_loss=False,
):
    """Per-hyperparameter scatter of (value, loss); log-scales axes for
    parameters spanning >2 decades (the reference's heuristic)."""
    plt = _plt()
    if not trials.trials:
        logger.warning("main_plot_vars: no trials")
        return None
    idxs, vals = trials.idxs_vals
    losses = trials.losses()
    loss_by_tid = {
        t["tid"]: t["result"].get("loss")
        for t in trials.trials
        if t["result"].get("status") == STATUS_OK
    }
    labels = sorted(vals.keys())
    if not labels:
        return None
    rows = int(np.ceil(len(labels) / columns))
    fig, axes = plt.subplots(
        rows, columns, figsize=(4 * columns, 3 * rows), squeeze=False
    )
    finite_losses = [l for l in losses if l is not None]
    if colorize_best and finite_losses:
        cutoff = float(np.sort(finite_losses)[: int(colorize_best)][-1])
    else:
        cutoff = None
    for ax_i, label in enumerate(labels):
        ax = axes[ax_i // columns][ax_i % columns]
        pts = [
            (v, loss_by_tid[t])
            for t, v in zip(idxs[label], vals[label])
            if loss_by_tid.get(t) is not None
        ]
        if not pts:
            ax.set_title(f"{label} (no data)")
            continue
        xs, ys = zip(*pts)
        if cutoff is not None:
            colors = ["r" if y <= cutoff else "b" for y in ys]
        else:
            colors = "b"
        ax.scatter(xs, ys, c=colors, s=8)
        try:
            if _looks_log_scaled(xs):
                ax.set_xscale("log")
        except (TypeError, ValueError):
            pass
        ax.set_title(label)
        ax.set_ylabel("loss")
    for ax_i in range(len(labels), rows * columns):
        axes[ax_i // columns][ax_i % columns].axis("off")
    fig.tight_layout()
    if do_show:
        plt.show()
    return fig
